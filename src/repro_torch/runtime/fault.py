"""Fault-tolerant training runner (the reference's ``TrainRunner``).

Drives a ``(state, batch) -> (state, metrics)`` step with checkpoint and
restart: a failed step is retried from the newest verified checkpoint, a
batch that keeps failing is skipped within a budget, and past that budget
the run aborts. The reference's fault plan and its injection sites are
not ported yet; the runner keeps its own counters (``recoveries``,
``skipped_batches``, ``ckpt_failures``) in place of the health bag.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable

from repro_torch.checkpoint import checkpoint

log = logging.getLogger(__name__)


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
    construction. ``save_ms`` holds the host time of each save call.
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

    def save(self):
        t0 = time.perf_counter()
        for attempt in (0, 1):
            try:
                checkpoint.save(self.cfg.ckpt_dir, self.step, self.state,
                                keep=self.cfg.keep)
                break
            except Exception as e:               # noqa: BLE001
                self.ckpt_failures += 1
                log.warning(
                    "checkpoint save at step %d failed (%s); %s", self.step,
                    e, "retrying" if attempt == 0 else
                    "continuing on the previous checkpoint (atomic rename "
                    "keeps it intact)")
        self.save_ms.append((time.perf_counter() - t0) * 1e3)

    def restore_latest(self) -> bool:
        last = checkpoint.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return False
        self.state = checkpoint.restore(self.cfg.ckpt_dir, last, self.state)
        self.step = last
        return True

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
