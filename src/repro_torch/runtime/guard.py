"""Guarded runtime: health counters, backend fallback, adaptive replan.

* :class:`RuntimeHealth` is the one counter bag that guard events land in
  (the sanitizer's ``validate.<class>`` counts, injected faults,
  fallbacks, quarantines, replans, runner recoveries, the serving
  engine's ledger). ``health().snapshot()`` gives a copy, ``delta()`` the
  increments since one; :func:`scoped_health` swaps in a fresh bag for a
  with-block, and :func:`dump_health_json` writes the snapshot for the
  ``--health-json`` flags.
* :func:`dispatch` runs one impl of a site (``search`` or ``gemm``) with a
  fallback chain (:data:`FALLBACK_CHAINS`): the primary is tried twice, so
  that a transient fault recovers with the same impl and bit-identical
  results; a persistent one quarantines (site, impl, shape class) for
  :func:`fallback_cooldown` calls and serves the first fallback that
  works. **The port differs from the reference twice:**
  ``REPRO_GUARD_FALLBACK`` defaults to ``"0"``, and the chain
  (:func:`fallback_chain`) is empty for tensors on the card, since there
  the port launches the kernel or raises, and the guard must never hide a
  kernel failure behind its plain version. With ``"1"`` on the CPU the
  semantics are the reference's; on the card the kernel is retried,
  quarantined and skipped as there, and every call it cannot serve
  raises.
* :func:`validate_policy` reads ``REPRO_GUARD_VALIDATE``: the
  :class:`~repro_torch.core.validate.CloudPolicy` that ingestion runs the
  sanitizer under, or None to skip it.
* :func:`with_replan` is overflow-adaptive replanning. A plan built at a
  static capacity (the Gconv3 output budget, the octree directory) raises
  :class:`~repro_torch.core.validate.CapacityOverflow` when the scene
  needs more; :func:`with_replan` catches it (``replan.overflow``) and
  rebuilds at ``max(capacity * growth, needed)``, at most
  :func:`replan_retries` times (``replan.recovered`` when a rebuild
  succeeds), and memoizes the last good capacity per key, so the next
  build of the same shape class starts there. The port builds plans
  eagerly, so the overflow always surfaces as the raise; there is no
  post-trace overflow flag to read.

Flags (read per call; all of the port's are in ``runtime/flags.py``):
``REPRO_GUARD_VALIDATE``, ``REPRO_GUARD_REPLAN``,
``REPRO_GUARD_FALLBACK``, ``REPRO_GUARD_COOLDOWN``.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading

from repro_torch.core import validate

log = logging.getLogger("repro_torch.guard")

#: per-site fallback chains of CPU tensors: primary impl -> the plain
#: versions it falls back to (see :func:`fallback_chain`)
FALLBACK_CHAINS = {
    "search": {"kernel": ("ref",), "dense": ("ref",), "ref": ()},
    "gemm": {"kernel": ("ref",), "ref": ()},
}


def fallback_chain(site: str, impl: str, device) -> tuple:
    """The impls :func:`dispatch` may serve after ``impl`` fails at
    ``site`` on tensors of ``device``: :data:`FALLBACK_CHAINS` on the CPU,
    none on the card, where a kernel that fails raises."""
    if getattr(device, "type", device) != "cpu":
        return ()
    return FALLBACK_CHAINS[site][impl]


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
    """Clear the counters, the quarantine and the capacity memo (tests)."""
    _HEALTH.reset()
    _QUARANTINE.clear()
    _CAPACITY_HINTS.clear()


@contextlib.contextmanager
def scoped_health():
    """A fresh :class:`RuntimeHealth`, empty quarantine and capacity memo
    for the with-block; the previous bag and state come back on exit.
    Yields the scoped bag (``health()`` returns it inside the block)."""
    global _HEALTH
    prev_health = _HEALTH
    prev_quarantine = dict(_QUARANTINE)
    prev_hints = dict(_CAPACITY_HINTS)
    _HEALTH = RuntimeHealth()
    _QUARANTINE.clear()
    _CAPACITY_HINTS.clear()
    try:
        yield _HEALTH
    finally:
        _HEALTH = prev_health
        _QUARANTINE.clear()
        _QUARANTINE.update(prev_quarantine)
        _CAPACITY_HINTS.clear()
        _CAPACITY_HINTS.update(prev_hints)


def dump_health_json(path: str, meta: dict | None = None) -> dict:
    """Write ``{"health": <snapshot>, "meta": <meta or {}>}`` as JSON with
    sorted keys (the ``--health-json`` flag of ``launch/train.py`` and
    ``launch/spconv_serve.py``); returns the payload."""
    payload = {"health": _HEALTH.snapshot(), "meta": dict(meta or {})}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    return payload


# ---------------------------------------------------------------------------
# Flags (read per call)
# ---------------------------------------------------------------------------

def validate_policy() -> validate.CloudPolicy | None:
    """``REPRO_GUARD_VALIDATE``: ``repair`` (default) | ``strict`` |
    ``off`` (None: no sanitizer)."""
    mode = os.environ.get("REPRO_GUARD_VALIDATE", "repair")
    if mode == "off":
        return None
    if mode == "strict":
        return validate.STRICT
    return validate.REPAIR


def replan_retries() -> int:
    """``REPRO_GUARD_REPLAN``: most capacity escalations of one build
    (default 6; 0 turns replanning off)."""
    return int(os.environ.get("REPRO_GUARD_REPLAN", "6"))


def fallback_enabled() -> bool:
    """``REPRO_GUARD_FALLBACK``: ``"1"`` turns the fallback chain on. The
    port's default is ``"0"`` (the reference's is on): a failing kernel
    raises to the caller instead of being served by its plain version."""
    return os.environ.get("REPRO_GUARD_FALLBACK", "0") != "0"


def fallback_cooldown() -> int:
    """``REPRO_GUARD_COOLDOWN``: calls a quarantined impl sits out
    (default 32)."""
    return int(os.environ.get("REPRO_GUARD_COOLDOWN", "32"))


# ---------------------------------------------------------------------------
# Backend fallback chain with quarantine and cooldown
# ---------------------------------------------------------------------------

#: (site, impl, *shape key) -> remaining cooldown calls
_QUARANTINE: dict = {}


def _quarantined(qkey) -> bool:
    left = _QUARANTINE.get(qkey, 0)
    if left <= 0:
        return False
    _QUARANTINE[qkey] = left - 1
    return True


def dispatch(site: str, impl: str, fallbacks, call, *, key=()):
    """``call(impl)`` with retry-then-fallback semantics.

    Args:
      site: ``"search"`` or ``"gemm"``, keyed into the health counters.
      impl: the primary impl.
      fallbacks: impls to try, in order, after the primary fails
        persistently (from :data:`FALLBACK_CHAINS`).
      call: ``call(one_impl) -> result``; must be safe to call again.
      key: shape-class tuple: quarantine is per (site, impl, key), so a
        failure at one shape class does not bench the impl for others.

    With the chain off (:func:`fallback_enabled`, the port's default) this
    is ``call(impl)``: the first error propagates. With it on, the
    primary is tried twice (``retry.ok.<site>`` when the second try
    succeeds); a second failure quarantines it for
    :func:`fallback_cooldown` calls (``quarantine.enter.<site>``; each
    call that then skips it counts ``quarantine.skip.<site>``) and serves
    the first working fallback (``fallback.served.<site>`` and
    ``fallback.served.<site>.<impl>``). Every failed try counts
    ``fallback.error.<site>``.
    """
    if not fallback_enabled():
        return call(impl)
    qkey = (site, impl) + tuple(key)
    err = None
    if _quarantined(qkey):
        _HEALTH.note(f"quarantine.skip.{site}")
    else:
        for attempt in (0, 1):
            try:
                out = call(impl)
                if attempt:
                    _HEALTH.note(f"retry.ok.{site}")
                return out
            except Exception as e:              # noqa: BLE001
                err = e
                _HEALTH.note(f"fallback.error.{site}")
                log.warning("%s impl=%r failed (attempt %d): %s",
                            site, impl, attempt + 1, e)
        _QUARANTINE[qkey] = fallback_cooldown()
        _HEALTH.note(f"quarantine.enter.{site}")
        log.warning("%s impl=%r quarantined for %d calls; falling back %r",
                    site, impl, fallback_cooldown(), tuple(fallbacks))
    for fb in fallbacks:
        if fb == impl:
            continue
        try:
            out = call(fb)
            _HEALTH.note(f"fallback.served.{site}")
            _HEALTH.note(f"fallback.served.{site}.{fb}")
            return out
        except Exception as e:                  # noqa: BLE001
            err = e
            _HEALTH.note(f"fallback.error.{site}")
            log.warning("%s fallback impl=%r failed too: %s", site, fb, e)
    if err is None:
        raise RuntimeError(
            f"{site}: impl {impl!r} quarantined and no fallback available")
    raise err


# ---------------------------------------------------------------------------
# Overflow-adaptive replanning
# ---------------------------------------------------------------------------

#: replan key -> last known-good capacity
_CAPACITY_HINTS: dict = {}


def with_replan(build, capacity: int, *, retries: int | None = None,
                growth: int = 2, key=None):
    """``build(capacity)``, escalating the capacity on overflow.

    Args:
      build: ``build(capacity) -> plan``; may raise
        :class:`~repro_torch.core.validate.CapacityOverflow`, which
        triggers a rebuild at ``max(capacity * growth, overflow.needed)``
        and counts ``replan.overflow``.
      capacity: the starting capacity, raised to the memoized one for
        ``key`` when that is larger.
      retries: most escalations (None: :func:`replan_retries`; 0 re-raises
        the first overflow).
      growth: geometric factor per escalation.
      key: hashable identity of the shape class for the capacity memo
        (None: no memo).

    Returns the plan (``replan.recovered`` when it took a rebuild); raises
    the last overflow once the retries are spent.
    """
    retries = replan_retries() if retries is None else retries
    cap = capacity
    if key is not None:
        cap = max(cap, _CAPACITY_HINTS.get(key, 0))
    for attempt in range(retries + 1):
        try:
            plan = build(cap)
        except validate.CapacityOverflow as e:
            if attempt >= retries:
                raise
            _HEALTH.note("replan.overflow")
            nxt = max(cap * growth, int(e.needed or 0))
            log.warning("capacity overflow at %d (%s); replanning at %d",
                        cap, e, nxt)
            cap = nxt
            continue
        if attempt:
            _HEALTH.note("replan.recovered")
        if key is not None and cap > capacity:
            _CAPACITY_HINTS[key] = cap
        return plan
    raise AssertionError("unreachable")
