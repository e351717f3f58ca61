"""Overflow-adaptive replanning: the reference's ``with_replan``.

A plan built at a static capacity (the Gconv3 output budget, the octree
directory) raises :class:`~repro_torch.core.plan.CapacityOverflow` when
the scene needs more. :func:`with_replan` catches it and rebuilds at
``max(capacity * growth, needed)``, at most :func:`replan_retries` times,
and memoizes the last good capacity per key, so the next build of the
same shape class starts there: a loop pays the failed probe once.

The port builds plans eagerly, so the overflow always surfaces as the
raise; there is no post-trace overflow flag to read.

Flag: ``REPRO_GUARD_REPLAN`` (read per call).
"""
from __future__ import annotations

import logging
import os

from repro_torch.core.plan import CapacityOverflow

log = logging.getLogger("repro_torch.guard")

#: replan key -> last known-good capacity
_CAPACITY_HINTS: dict = {}

#: capacity escalations since the last reset
REPLANS = [0]


def replan_retries() -> int:
    """``REPRO_GUARD_REPLAN``: most capacity escalations of one build
    (default 6; 0 turns replanning off)."""
    return int(os.environ.get("REPRO_GUARD_REPLAN", "6"))


def with_replan(build, capacity: int, *, retries: int | None = None,
                growth: int = 2, key=None):
    """``build(capacity)``, escalating the capacity on overflow.

    Args:
      build: ``build(capacity) -> plan``; may raise
        :class:`CapacityOverflow`, which triggers a rebuild at
        ``max(capacity * growth, overflow.needed)``.
      capacity: the starting capacity, raised to the memoized one for
        ``key`` when that is larger.
      retries: most escalations (None: :func:`replan_retries`; 0 re-raises
        the first overflow).
      growth: geometric factor per escalation.
      key: hashable identity of the shape class for the capacity memo
        (None: no memo).

    Returns the plan; raises the last :class:`CapacityOverflow` once the
    retries are spent.
    """
    retries = replan_retries() if retries is None else retries
    cap = capacity
    if key is not None:
        cap = max(cap, _CAPACITY_HINTS.get(key, 0))
    for attempt in range(retries + 1):
        try:
            plan = build(cap)
        except CapacityOverflow as e:
            if attempt >= retries:
                raise
            REPLANS[0] += 1
            nxt = max(cap * growth, int(e.needed or 0))
            log.warning("capacity overflow at %d (%s); replanning at %d",
                        cap, e, nxt)
            cap = nxt
            continue
        if key is not None and cap > capacity:
            _CAPACITY_HINTS[key] = cap
        return plan
    raise AssertionError("unreachable")
