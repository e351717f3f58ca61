"""Deterministic fault injection and the fault-tolerant training runner.

Fault injection: a :class:`FaultPlan` fires :class:`InjectedFault` at
named sites, by per-site call index (``schedule``) or by a seeded hash
``rate``, as the reference's plan does (``src/repro/runtime/fault.py``):

  ``search``       kernels/octent/ops.build_kmap (inside the per-impl call)
  ``gemm``         kernels/spconv_gemm/ops.apply_tiles (per-impl call)
  ``plan``         core/plan.py plan builders (inside the build)
  ``fingerprint``  core/plan.content_fingerprint (the words are zeroed,
                   not raised: a content-key collision, which a verifying
                   cache detects and rebuilds)
  ``checkpoint``   checkpoint.save (before any file I/O)
  ``admit``        runtime/admission.AdmissionQueue.submit (retried once;
                   a persistent fault isolates that request)
  ``batch``        launch/spconv_serve.ServeEngine tick (retried once; a
                   persistent fault isolates that tick's requests)
  ``persist.save`` runtime/persist.SnapshotStore.put (absorbed: the
                   write is skipped and counted)
  ``persist.load`` runtime/persist.SnapshotStore.get (absorbed: a cold
                   read)
  ``kill``         schedule only, never in ``rate`` mode: SIGKILLs the
                   process at the fired call (inside checkpoint and
                   snapshot writes, at each serve tick and train step)

Faults are one-shot per call index, so a retry with the same impl
recovers them with bit-identical results. Activate a plan with
``inject(plan)`` (a context manager) or :func:`install` /
:func:`uninstall`. Each fired fault (the kill excepted) counts
``fault.<site>`` in :func:`repro_torch.runtime.guard.health`.

The runner: :class:`TrainRunner` drives a ``(state, batch) -> (state,
metrics)`` step with checkpoint and restart. A failed step is retried from
the newest verified checkpoint, a batch that keeps failing is skipped
within a budget, and past that budget the run aborts; its events count
``runner.recovery``, ``runner.skipped_batch`` and ``runner.ckpt_failure``
in the health bag, beside its own counters.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import signal
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint

log = logging.getLogger("repro_torch.fault")

#: every named injection site
FAULT_SITES = ("search", "gemm", "plan", "fingerprint", "checkpoint",
               "admit", "batch", "persist.save", "persist.load")

#: the hard-kill site: a firing ``check("kill")`` SIGKILLs the process.
#: Not in FAULT_SITES, so a ``rate`` plan never kills by accident.
KILL_SITE = "kill"

#: the sites the training demo reaches
TRAIN_FAULT_SITES = ("search", "gemm", "plan", "fingerprint", "checkpoint")

#: the sites the serving engine reaches
SERVE_FAULT_SITES = ("search", "gemm", "plan", "fingerprint", "admit",
                     "batch")


class InjectedFault(RuntimeError):
    """A deliberately injected failure (never raised in production)."""

    def __init__(self, site: str, index: int):
        super().__init__(f"injected fault at site={site!r} call={index}")
        self.site = site
        self.index = index


def _hash01(seed: int, site: str, idx: int) -> float:
    return zlib.crc32(f"{seed}/{site}/{idx}".encode()) / 2 ** 32


class FaultPlan:
    """Deterministic schedule of faults by (site, call index).

    Args:
      schedule: site -> call indices that fail (the n-th ``check(site)``
        since the plan was installed).
      rate: also fail each call with this probability, decided by a
        seeded hash of (seed, site, index): the same in every process.
      seed: the hash seed of ``rate``.
      sites: the sites ``rate`` applies to (default: the scheduled sites
        if there is a schedule, else every site of FAULT_SITES).

    ``fired`` maps site -> the indices that fired, ``calls`` site -> the
    calls seen.
    """

    def __init__(self, schedule: dict | None = None, *, seed: int = 0,
                 rate: float = 0.0, sites=None):
        self.schedule = {k: frozenset(v) for k, v in (schedule or {}).items()}
        self.seed = seed
        self.rate = rate
        self.sites = tuple(sites) if sites is not None else \
            (tuple(self.schedule) or FAULT_SITES)
        self.calls: dict[str, int] = {}
        self.fired: dict[str, list] = {}

    def fires(self, site: str) -> bool:
        idx = self.calls.get(site, 0)
        self.calls[site] = idx + 1
        hit = idx in self.schedule.get(site, frozenset())
        if not hit and self.rate > 0 and site in self.sites:
            hit = _hash01(self.seed, site, idx) < self.rate
        if hit:
            self.fired.setdefault(site, []).append(idx)
        return hit


_ACTIVE: list = [None]


def active() -> FaultPlan | None:
    return _ACTIVE[0]


def install(plan: FaultPlan | None) -> None:
    _ACTIVE[0] = plan


def uninstall() -> None:
    _ACTIVE[0] = None


@contextlib.contextmanager
def inject(plan: FaultPlan | None):
    """Activate ``plan`` for the with-block (None is a no-op)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = plan
    try:
        yield plan
    finally:
        _ACTIVE[0] = prev


def check(site: str) -> None:
    """Raise :class:`InjectedFault` iff the active plan fires here; at
    :data:`KILL_SITE`, SIGKILL the process instead (no cleanup, no
    atexit: what a node loss looks like)."""
    plan = _ACTIVE[0]
    if plan is not None and plan.fires(site):
        idx = plan.fired[site][-1]
        if site == KILL_SITE:
            log.warning("injected SIGKILL at call=%d", idx)
            os.kill(os.getpid(), signal.SIGKILL)
        _note_fault(site)
        log.warning("injecting fault at site=%r call=%d", site, idx)
        raise InjectedFault(site, idx)


def mangle(site: str, words):
    """``words`` zeroed (same shape and dtype) iff the plan fires here:
    the non-raising injection of the fingerprint site."""
    plan = _ACTIVE[0]
    if plan is not None and plan.fires(site):
        _note_fault(site)
        log.warning("mangling value at site=%r call=%d", site,
                    plan.fired[site][-1])
        return np.zeros_like(np.asarray(words))
    return words


def _note_fault(site: str) -> None:
    from repro_torch.runtime import guard
    guard.health().note(f"fault.{site}")


# ---------------------------------------------------------------------------
# Fault-tolerant training runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_retries_per_step: int = 2
    #: poison batches skipped (after retries exhaust) before aborting
    max_skipped_batches: int = 1


class TrainRunner:
    """Drives ``train_step`` with checkpoint/restart fault tolerance.

    Escalation ladder per step: retry from the latest checkpoint up to
    ``max_retries_per_step`` times; then skip the batch (``skipped_batches``
    counts, budget ``max_skipped_batches``); then abort with RuntimeError.
    Set ``max_skipped_batches=0`` when bit-identical replay matters more
    than liveness: a skipped batch changes the final state by
    construction. A failed checkpoint write is retried once and otherwise
    tolerated (the atomic rename keeps the previous one). ``save_ms``
    holds the host time of each save call. ``save(blocking=False)``
    returns once the state is on the host and writes it on a thread, which
    the next save joins; :meth:`run` saves blocking.
    """

    def __init__(self, cfg: RunnerConfig, train_step: Callable,
                 batch_at: Callable[[int], Any], state: Any):
        self.cfg = cfg
        self.train_step = train_step
        self.batch_at = batch_at
        self.state = state
        self.step = 0
        self.failures: dict[int, int] = {}
        self.recoveries = 0
        self.skipped_batches = 0
        self.ckpt_failures = 0
        self.save_ms: list[float] = []
        self._skip: set[int] = set()
        self._pending_save = None

    def save(self, blocking: bool = True):
        t0 = time.perf_counter()
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None
        for attempt in (0, 1):
            try:
                self._pending_save = checkpoint.save(
                    self.cfg.ckpt_dir, self.step, self.state,
                    keep=self.cfg.keep, blocking=blocking)
                break
            except Exception as e:               # noqa: BLE001
                self.ckpt_failures += 1
                self._note("runner.ckpt_failure")
                log.warning(
                    "checkpoint save at step %d failed (%s); %s", self.step,
                    e, "retrying" if attempt == 0 else
                    "continuing on the previous checkpoint (atomic rename "
                    "keeps it intact)")
        self.save_ms.append((time.perf_counter() - t0) * 1e3)

    def restore_latest(self) -> bool:
        """Restore the newest verified checkpoint into the state's own
        tensors, in place: a donated step's CUDA graph holds them as its
        buffers, so the runner's state objects never change."""
        last = checkpoint.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return False
        restored = checkpoint.restore(self.cfg.ckpt_dir, last, self.state)
        with torch.no_grad():
            for dst, src in zip(checkpoint.tree_leaves(self.state),
                                checkpoint.tree_leaves(restored)):
                dst.copy_(src)
        self.step = last
        return True

    @staticmethod
    def _note(name: str) -> None:
        from repro_torch.runtime import guard
        guard.health().note(name)

    def run(self, n_steps: int, *,
            fail_hook: Callable[[int], None] | None = None):
        """Run to ``self.step == n_steps``; returns the losses of the steps
        taken. ``fail_hook(step)`` may raise to simulate node failures."""
        self.save()                                   # step-0 baseline
        history = []
        while self.step < n_steps:
            step = self.step
            if step in self._skip:
                self._skip.discard(step)
                self.skipped_batches += 1
                self._note("runner.skipped_batch")
                log.warning("skipping poison batch at step %d "
                            "(%d/%d skips used)", step, self.skipped_batches,
                            self.cfg.max_skipped_batches)
                self.step = step + 1
                continue
            try:
                if fail_hook is not None:
                    fail_hook(step)
                batch = self.batch_at(step)
                self.state, metrics = self.train_step(self.state, batch)
                loss = float(metrics.get("loss", metrics.get("ce", 0.0)))
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss at {step}: {loss}")
            except Exception as e:                     # noqa: BLE001
                self.failures[step] = self.failures.get(step, 0) + 1
                self.recoveries += 1
                self._note("runner.recovery")
                log.warning("step %d failed (%s); recovering", step, e)
                if self.failures[step] > self.cfg.max_retries_per_step:
                    budget = self.cfg.max_skipped_batches
                    if self.skipped_batches + len(self._skip) < budget:
                        # replay from the checkpoint, then skip the poison
                        # step when the rewound loop reaches it again
                        self._skip.add(step)
                        log.warning("step %d exhausted %d retries; will "
                                    "skip its batch", step,
                                    self.failures[step])
                    else:
                        raise RuntimeError(
                            f"step {step} failed {self.failures[step]} times "
                            f"and the skip budget ({budget}) is exhausted"
                        ) from e
                if not self.restore_latest():
                    raise
                continue
            self.step = step + 1
            history.append(loss)
            if self.step % self.cfg.ckpt_every == 0:
                self.save()
        self.save()
        return history
