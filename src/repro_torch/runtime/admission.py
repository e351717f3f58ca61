"""Serving admission control: bounded queue, padding buckets, shedding.

The ingress of the serving engine, host-side and eager:

  * **Padding-bucket quantization** — a request's valid rows are compacted
    to the front and zero-padded to the smallest bucket class that holds
    them (:func:`bucket_classes`), so every shape downstream is a function
    of the bucket.
  * **Oversize rejection** — more valid voxels than the largest bucket is a
    typed :class:`Rejection` for that request only.
  * **Bounded queueing + deadline shedding** — a submit beyond the queue
    capacity is shed at once (:data:`SHED_QUEUE_FULL`, explicit
    backpressure); at dequeue, a request whose deadline has passed, or
    would pass before the bucket's estimated service time, is shed with
    :data:`SHED_DEADLINE`.

Flags: ``REPRO_SERVE_BUCKETS``, ``REPRO_SERVE_QUEUE_CAP``,
``REPRO_SERVE_DEADLINE_MS`` (read per queue construction).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np

#: queue at capacity — explicit backpressure, resubmit later
SHED_QUEUE_FULL = "queue_full"
#: deadline already passed (or cannot be met) at dequeue
SHED_DEADLINE = "deadline"
#: more valid voxels than the largest padding bucket admits
REJECT_OVERSIZE = "oversize"

SHED_REASONS = (SHED_QUEUE_FULL, SHED_DEADLINE)

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


@dataclasses.dataclass
class Rejection:
    """Typed admission/shedding outcome for one request."""

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

    ``submit`` returns a :class:`Request` (admitted) or a typed
    :class:`Rejection`; ``take`` dequeues up to ``max_n`` requests, shedding
    the deadline-hopeless ones.
    """

    def __init__(self, capacity: int | None = None, *, buckets=None,
                 clock=time.monotonic):
        self.capacity = queue_capacity() if capacity is None else capacity
        self.buckets = tuple(buckets) if buckets is not None \
            else bucket_classes()
        self.clock = clock
        self._q: collections.deque[Request] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, rid: str, coords, batch, valid, feats, *,
               deadline_s: float | None = None) -> Request | Rejection:
        """Admit one raw cloud, or shed/reject it with a typed outcome.

        ``deadline_s`` is relative to now (None: :func:`default_deadline_s`).
        """
        now = self.clock()
        if len(self._q) >= self.capacity:
            return Rejection(rid, SHED_QUEUE_FULL,
                             f"queue at capacity {self.capacity}")
        n_valid = int(np.asarray(valid).astype(bool).sum())
        bucket = bucket_for(n_valid, self.buckets)
        if bucket is None:
            return Rejection(rid, REJECT_OVERSIZE,
                             f"{n_valid} valid voxels exceed the largest "
                             f"bucket {self.buckets[-1]}", kind="oversize")
        cq, bq, vq, fq, n = quantize_to_bucket(coords, batch, valid, feats,
                                               bucket)
        ddl = now + (default_deadline_s() if deadline_s is None
                     else deadline_s)
        req = Request(rid, cq, bq, vq, fq, bucket, n, ddl, now)
        self._q.append(req)
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
                shed.append(Rejection(
                    req.rid, SHED_DEADLINE,
                    f"deadline missed by {now + est - req.deadline:.3f}s "
                    f"(est service {est:.3f}s)"))
                continue
            out.append(req)
        return out, shed
