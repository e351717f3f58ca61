"""Guarded runtime: health counters, the ingress policy, adaptive replan.

* :class:`RuntimeHealth` is the one counter bag that guard events land in
  (the sanitizer's ``validate.<class>`` counts, ``pinned.collision``).
  ``health().snapshot()`` gives a copy, ``delta()`` the increments since
  one.
* :func:`validate_policy` reads ``REPRO_GUARD_VALIDATE``: the
  :class:`~repro_torch.core.validate.CloudPolicy` that ingestion runs the
  sanitizer under, or None to skip it.
* :func:`with_replan` is overflow-adaptive replanning. A plan built at a
  static capacity (the Gconv3 output budget, the octree directory) raises
  :class:`~repro_torch.core.plan.CapacityOverflow` when the scene needs
  more; :func:`with_replan` catches it and rebuilds at ``max(capacity *
  growth, needed)``, at most :func:`replan_retries` times, and memoizes
  the last good capacity per key, so the next build of the same shape
  class starts there: a loop pays the failed probe once. The port builds
  plans eagerly, so the overflow always surfaces as the raise; there is
  no post-trace overflow flag to read.

Flags (read per call): ``REPRO_GUARD_VALIDATE``, ``REPRO_GUARD_REPLAN``.
"""
from __future__ import annotations

import logging
import os
import threading

from repro_torch.core import validate
from repro_torch.core.plan import CapacityOverflow

log = logging.getLogger("repro_torch.guard")


class RuntimeHealth:
    """Flat, thread-safe counter bag for every guard event."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def note(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def delta(self, since: dict) -> dict:
        """Counter increments since a prior :meth:`snapshot` (names that
        did not move are left out)."""
        now = self.snapshot()
        return {k: v - since.get(k, 0) for k, v in now.items()
                if v != since.get(k, 0)}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


_HEALTH = RuntimeHealth()


def health() -> RuntimeHealth:
    """The process-wide health counters."""
    return _HEALTH


def reset_health() -> None:
    """Clear the counters and the capacity memo (tests)."""
    _HEALTH.reset()
    _CAPACITY_HINTS.clear()


def validate_policy() -> validate.CloudPolicy | None:
    """``REPRO_GUARD_VALIDATE``: ``repair`` (default) | ``strict`` |
    ``off`` (None: no sanitizer)."""
    mode = os.environ.get("REPRO_GUARD_VALIDATE", "repair")
    if mode == "off":
        return None
    if mode == "strict":
        return validate.STRICT
    return validate.REPAIR

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
