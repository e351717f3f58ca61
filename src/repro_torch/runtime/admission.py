"""Serving admission control: bounded queue, padding buckets, shedding.

The ingress of the serving engine, host-side and eager, as the
reference's (``src/repro/runtime/admission.py``):

  * **Padding-bucket quantization**: a request's valid rows are compacted
    to the front and zero-padded to the smallest bucket class that holds
    them (:func:`bucket_classes`), so every shape downstream is a function
    of the bucket.
  * **Admission validation**: the cloud sanitizer
    (:func:`repro_torch.core.validate.sanitize_cloud`) under the serving
    policy (:func:`serve_policy`, ``REPRO_SERVE_VALIDATE``, default
    ``strict``), the ``oversize`` class against the largest bucket
    included. A rejected cloud is a typed :class:`Rejection` for that
    request only.
  * **Bounded queueing and deadline shedding**: a submit beyond the queue
    capacity is shed at once (:data:`SHED_QUEUE_FULL`, explicit
    backpressure); at dequeue, a request whose deadline has passed, or
    would pass before the bucket's estimated service time, is shed with
    :data:`SHED_DEADLINE`.

The ``admit`` fault site (runtime/fault.py) attacks the queue: a transient
fault is retried and the request admitted; a persistent one isolates that
request alone (:data:`ISOLATED_FAULT`). Every outcome counts ``admit.*``
in :func:`repro_torch.runtime.guard.health`.

Flags (read per queue construction; ``runtime/flags.py`` lists all of the
port's): ``REPRO_SERVE_BUCKETS``,
``REPRO_SERVE_QUEUE_CAP``, ``REPRO_SERVE_DEADLINE_MS``,
``REPRO_SERVE_VALIDATE``.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np

from repro_torch.core import validate
from repro_torch.runtime import fault, guard

#: queue at capacity — explicit backpressure, resubmit later
SHED_QUEUE_FULL = "queue_full"
#: deadline already passed (or cannot be met) at dequeue
SHED_DEADLINE = "deadline"
#: the engine sheds its queue (the degradation ladder's last rung)
SHED_OVERLOAD = "overload"
#: the sanitizer rejected the cloud
REJECT_INVALID = "invalid"
#: more valid voxels than the largest padding bucket admits
REJECT_OVERSIZE = "oversize"
#: a persistent fault isolated this request
ISOLATED_FAULT = "fault"
#: journaled when the process died; its deadline expired before the
#: restarted engine could queue it again
SHED_RESTART = "restart"

#: reasons counted as shed (load, not a defect of the request)
SHED_REASONS = (SHED_QUEUE_FULL, SHED_DEADLINE, SHED_OVERLOAD, SHED_RESTART)
REJECT_REASONS = (REJECT_INVALID, REJECT_OVERSIZE)

#: default padding-bucket classes (voxel budgets)
DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384)


def bucket_classes() -> tuple[int, ...]:
    """Active padding-bucket classes, ascending (``REPRO_SERVE_BUCKETS``:
    comma-separated voxel budgets; default :data:`DEFAULT_BUCKETS`)."""
    env = os.environ.get("REPRO_SERVE_BUCKETS", "")
    if not env.strip():
        return DEFAULT_BUCKETS
    return tuple(sorted(int(x) for x in env.split(",") if x.strip()))


def bucket_for(n_valid: int, buckets=None) -> int | None:
    """Smallest bucket holding ``n_valid`` voxels; None if none does."""
    for b in buckets or bucket_classes():
        if n_valid <= b:
            return int(b)
    return None


def queue_capacity() -> int:
    """``REPRO_SERVE_QUEUE_CAP``: bounded queue depth (default 64)."""
    return int(os.environ.get("REPRO_SERVE_QUEUE_CAP", "64"))


def default_deadline_s() -> float:
    """``REPRO_SERVE_DEADLINE_MS``: per-request deadline (default 60 s)."""
    return float(os.environ.get("REPRO_SERVE_DEADLINE_MS", "60000")) / 1e3


def serve_policy() -> validate.CloudPolicy | None:
    """``REPRO_SERVE_VALIDATE``: ``strict`` (default: admission rejects
    rather than repairs) | ``repair`` | ``off`` (None: no sanitizer)."""
    mode = os.environ.get("REPRO_SERVE_VALIDATE", "strict")
    if mode == "off":
        return None
    if mode == "repair":
        return validate.REPAIR
    return validate.STRICT


@dataclasses.dataclass
class Rejection:
    """Typed admission/shedding outcome for one request. ``kind`` holds the
    sanitizer's failure class for :data:`REJECT_INVALID` /
    :data:`REJECT_OVERSIZE`."""

    rid: str
    reason: str
    detail: str = ""
    kind: str | None = None

    @property
    def shed(self) -> bool:
        return self.reason in SHED_REASONS


@dataclasses.dataclass
class Request:
    """One admitted request: bucket-quantized numpy arrays + bookkeeping.

    ``deadline`` is an absolute clock time; ``n_valid`` the live row count.
    """

    rid: str
    coords: np.ndarray
    batch: np.ndarray
    valid: np.ndarray
    feats: np.ndarray
    bucket: int
    n_valid: int
    deadline: float
    submitted_at: float


def quantize_to_bucket(coords, batch, valid, feats, bucket: int):
    """Compact valid rows to the front (stable) and zero-pad to ``bucket``.

    Deterministic: the same raw cloud always gives byte-identical buffers.
    """
    c = np.asarray(coords)
    b = np.asarray(batch)
    v = np.asarray(valid).astype(bool)
    f = np.asarray(feats)
    live = np.flatnonzero(v)[:bucket]
    n = live.size
    cq = np.zeros((bucket, 3), np.int32)
    bq = np.zeros((bucket,), np.int32)
    vq = np.zeros((bucket,), bool)
    fq = np.zeros((bucket, f.shape[1]), np.float32)
    cq[:n] = c[live]
    bq[:n] = b[live]
    vq[:n] = True
    fq[:n] = f[live]
    return cq, bq, vq, fq, n


class AdmissionQueue:
    """Bounded FIFO of bucket-quantized requests with typed shedding.

    Args:
      capacity: queue depth bound (None: :func:`queue_capacity`).
      buckets: padding-bucket classes (None: :func:`bucket_classes`).
      policy: the sanitizer's
        :class:`~repro_torch.core.validate.CloudPolicy` (None:
        :func:`serve_policy`; ``False`` skips the sanitizer).
      grid_bits, batch_bits: the grid contract requests are checked
        against (the model's).
      clock: monotonic time source (injectable for tests).

    ``submit`` returns a :class:`Request` or a typed :class:`Rejection`;
    ``take`` dequeues up to ``max_n`` requests, shedding the
    deadline-hopeless ones; every outcome counts an ``admit.*`` health
    counter.
    """

    def __init__(self, capacity: int | None = None, *, buckets=None,
                 policy=None, grid_bits: int = 7, batch_bits: int = 4,
                 clock=time.monotonic):
        self.capacity = queue_capacity() if capacity is None else capacity
        self.buckets = tuple(buckets) if buckets is not None \
            else bucket_classes()
        self.policy = serve_policy() if policy is None else \
            (None if policy is False else policy)
        self.grid_bits = grid_bits
        self.batch_bits = batch_bits
        self.clock = clock
        self._q: collections.deque[Request] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    @staticmethod
    def _note(name: str) -> None:
        guard.health().note(name)

    def submit(self, rid: str, coords, batch, valid, feats, *,
               deadline_s: float | None = None) -> Request | Rejection:
        """Admit one raw cloud, or shed/reject it with a typed outcome.

        Cheapest check first: queue-full backpressure, the ``admit`` fault
        site (retried once: a transient fault admits normally, a
        persistent one isolates this request), the sanitizer under the
        serving policy (``oversize`` against the largest bucket included),
        bucket quantization, enqueue. ``deadline_s`` is relative to now
        (None: :func:`default_deadline_s`); negative models a request
        already late (shed at dequeue).
        """
        now = self.clock()
        if len(self._q) >= self.capacity:
            self._note("admit.shed.queue_full")
            return Rejection(rid, SHED_QUEUE_FULL,
                             f"queue at capacity {self.capacity}")
        for attempt in (0, 1):
            try:
                fault.check("admit")
                break
            except fault.InjectedFault as e:
                if attempt:
                    self._note("admit.isolated_fault")
                    return Rejection(rid, ISOLATED_FAULT, str(e))
                self._note("admit.retry")

        if self.policy is not None:
            try:
                coords, batch, valid, feats, _ = validate.sanitize_cloud(
                    coords, batch, valid, feats, grid_bits=self.grid_bits,
                    batch_bits=self.batch_bits, policy=self.policy,
                    max_valid=self.buckets[-1])
            except validate.CloudValidationError as e:
                reason = REJECT_OVERSIZE if e.kind == "oversize" \
                    else REJECT_INVALID
                self._note(f"admit.reject.{reason}")
                return Rejection(rid, reason, str(e), kind=e.kind)

        n_valid = int(np.asarray(valid).astype(bool).sum())
        bucket = bucket_for(n_valid, self.buckets)
        if bucket is None:
            # without a sanitizer budget a cloud can still overshoot the
            # largest bucket; the shape contract holds regardless
            self._note(f"admit.reject.{REJECT_OVERSIZE}")
            return Rejection(rid, REJECT_OVERSIZE,
                             f"{n_valid} valid voxels exceed the largest "
                             f"bucket {self.buckets[-1]}", kind="oversize")
        cq, bq, vq, fq, n = quantize_to_bucket(coords, batch, valid, feats,
                                               bucket)
        ddl = now + (default_deadline_s() if deadline_s is None
                     else deadline_s)
        req = Request(rid, cq, bq, vq, fq, bucket, n, ddl, now)
        self._q.append(req)
        self._note("admit.ok")
        return req

    def restore(self, req: Request) -> Request | Rejection:
        """Queue an already-quantized request again (the journal's restart
        path): no validation or quantization, the journaled buffers are
        the admitted ones; the capacity still holds, and a deadline
        expired by now is shed as :data:`SHED_RESTART`."""
        if len(self._q) >= self.capacity:
            self._note("admit.shed.queue_full")
            return Rejection(req.rid, SHED_QUEUE_FULL,
                             f"queue at capacity {self.capacity}")
        if self.clock() > req.deadline:
            self._note(f"admit.shed.{SHED_RESTART}")
            return Rejection(req.rid, SHED_RESTART,
                             "deadline expired across the restart")
        self._q.append(req)
        self._note("admit.restored")
        return req

    def take(self, max_n: int, *, est_service_s=None):
        """Dequeue up to ``max_n`` serviceable requests.

        ``est_service_s``: optional ``bucket -> seconds`` estimate; a
        request whose remaining budget is below it is shed with
        :data:`SHED_DEADLINE`. Returns ``(requests, shed)``.
        """
        out: list[Request] = []
        shed: list[Rejection] = []
        while self._q and len(out) < max_n:
            req = self._q.popleft()
            now = self.clock()
            est = 0.0
            if est_service_s is not None:
                est = float(est_service_s(req.bucket) or 0.0)
            if now + est > req.deadline:
                self._note("admit.shed.deadline")
                shed.append(Rejection(
                    req.rid, SHED_DEADLINE,
                    f"deadline missed by {now + est - req.deadline:.3f}s "
                    f"(est service {est:.3f}s)"))
                continue
            out.append(req)
        return out, shed

    def shed_all(self, reason: str = SHED_OVERLOAD) -> list[Rejection]:
        """Drain the whole queue with a typed rejection (the degradation
        ladder's last rung: the engine refuses work)."""
        shed = []
        while self._q:
            req = self._q.popleft()
            self._note(f"admit.shed.{reason}")
            shed.append(Rejection(req.rid, reason, "engine shedding mode"))
        return shed
