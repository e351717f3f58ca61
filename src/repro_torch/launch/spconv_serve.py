"""Continuous-batching SpConv serving engine over MinkUNet.

Requests enter the bounded, bucket-quantizing
:class:`~repro_torch.runtime.admission.AdmissionQueue`; each tick drains up
to ``max_batch`` of them, builds each request's plans through one
long-lived, content-keyed :class:`~repro_torch.core.plan.PlanCache` (map
search on the card through the OCTENT kernel; a re-submitted scene hits by
content and costs no search) and runs the forward through the gather-GEMM
kernel. PyTorch runs eagerly, so there is no
per-bucket compiled executable; each request's logits come back to the host with a
sha256 digest and its submit-to-result latency.

CLI (MinkUNet-large, one 65,536-voxel bucket, on the card):

    PYTHONPATH=src python -m repro_torch.launch.spconv_serve --requests 4
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.core.spconv import SparseTensor
from repro_torch.device import resolve_device
from repro_torch.models import minkunet
from repro_torch.runtime import admission


@dataclasses.dataclass
class ServeResult:
    """Terminal outcome of one request."""

    rid: str
    status: str                  # completed | shed | rejected
    reason: str | None = None    # admission.* reason for non-completed
    bucket: int | None = None
    latency_s: float | None = None   # submit -> result on the host
    digest: str | None = None    # sha256 of the logits bytes
    logits: np.ndarray | None = None


class ServeEngine:
    """Continuous-batching engine over a :class:`MinkUNet`.

    Args:
      model: the served model; moved to ``device``.
      device: None runs on the card (raises without one); ``"cpu"`` runs
        the plain versions of the kernels.
      queue: an AdmissionQueue (None: one built from the flags).
      max_batch: requests drained per tick.
      clock: injectable time source.
    """

    def __init__(self, model: minkunet.MinkUNet, *,
                 device: str | torch.device | None = None,
                 queue: admission.AdmissionQueue | None = None,
                 max_batch: int = 8, clock=time.monotonic):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = model.cfg
        self.clock = clock
        self.queue = queue if queue is not None \
            else admission.AdmissionQueue(clock=clock)
        self.max_batch = max_batch
        # sized as the reference's: eight requests' plans stay resident
        self.cache = planlib.PlanCache(
            capacity=max(64, 8 * (2 * (len(self.cfg.enc)
                                       + len(self.cfg.dec)) + 2)))
        self._ewma: dict[int, float] = {}    # bucket -> service seconds
        self.results: list[ServeResult] = []
        self.ticks = 0

    def submit(self, rid: str, coords, batch, valid, feats, *,
               deadline_s: float | None = None):
        """Admit one raw request; a typed rejection is terminal and is
        recorded at once."""
        out = self.queue.submit(rid, coords, batch, valid, feats,
                                deadline_s=deadline_s)
        if isinstance(out, admission.Rejection):
            self._record_rejection(out)
        return out

    def _record_rejection(self, rej: admission.Rejection) -> None:
        status = "shed" if rej.shed else "rejected"
        self.results.append(ServeResult(rej.rid, status, reason=rej.reason))

    def _note_service(self, bucket: int, dt: float) -> None:
        prev = self._ewma.get(bucket)
        self._ewma[bucket] = dt if prev is None else 0.8 * prev + 0.2 * dt

    def _run_one(self, req: admission.Request) -> ServeResult:
        dev = self.device
        st = SparseTensor(torch.as_tensor(req.coords, device=dev),
                          torch.as_tensor(req.batch, device=dev),
                          torch.as_tensor(req.valid, device=dev),
                          torch.as_tensor(req.feats, device=dev))
        plans = minkunet.build_plans(st.coords, st.batch, st.valid, self.cfg,
                                     cache=self.cache, n_max=req.bucket,
                                     device=dev)
        logits = minkunet.forward(self.model, st, plans=plans)
        logits = logits.cpu().numpy()
        done = self.clock()
        self._note_service(req.bucket, done - req.submitted_at)
        return ServeResult(req.rid, "completed", bucket=req.bucket,
                           latency_s=done - req.submitted_at,
                           digest=hashlib.sha256(logits.tobytes()).hexdigest(),
                           logits=logits)

    def step(self) -> list[ServeResult]:
        """One tick: dequeue a batch (shedding deadline-hopeless requests)
        and serve it. Returns this tick's terminal results."""
        self.ticks += 1
        reqs, shed = self.queue.take(self.max_batch,
                                     est_service_s=self._ewma.get)
        tick: list[ServeResult] = []
        for rej in shed:
            self._record_rejection(rej)
            tick.append(self.results[-1])
        for req in reqs:
            res = self._run_one(req)
            self.results.append(res)
            tick.append(res)
        return tick

    def drain(self, max_ticks: int = 10_000) -> list[ServeResult]:
        """Tick until the queue is empty; returns all terminal results."""
        while len(self.queue) and max_ticks > 0:
            self.step()
            max_ticks -= 1
        return self.results

    def stats(self) -> dict:
        by = {"completed": 0, "shed": 0, "rejected": 0}
        for r in self.results:
            by[r.status] += 1
        lat = sorted(r.latency_s for r in self.results
                     if r.status == "completed")
        return {
            "requests": len(self.results), **by, "ticks": self.ticks,
            "latency_p50_s": float(np.percentile(lat, 50)) if lat else None,
            "latency_p99_s": float(np.percentile(lat, 99)) if lat else None,
            "cache": self.cache.stats(),
        }


def profile_request(model: minkunet.MinkUNet, coords, batch, valid, feats,
                    *, bucket: int, device=None) -> dict:
    """Where one request's time goes: the plan build and the forward timed
    apart (host clock around synchronized work, after one warm-up), then
    both again under ``torch.profiler`` for the device time by kernel name.
    The idle share divides that device time by the unprofiled plan build
    plus forward: the profiler's own host overhead stretches the profiled
    window (reported as ``profiled_wall_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    st = SparseTensor(*(torch.as_tensor(a, device=dev)
                        for a in (coords, batch, valid, feats)))

    def plans():
        return minkunet.build_plans(st.coords, st.batch, st.valid, model.cfg,
                                    n_max=bucket, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    minkunet.forward(model, st, plans=plans())          # warm-up
    sync()
    t0 = time.perf_counter()
    p = plans()
    sync()
    t1 = time.perf_counter()
    minkunet.forward(model, st, plans=p).cpu()
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t3 = time.perf_counter()
        minkunet.forward(model, st, plans=plans()).cpu()
        t4 = time.perf_counter()

    # device-side events only (kernels, copies): the op rows that launched
    # them report the same time again
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"voxels": int(st.valid.sum()), "plan_ms": (t1 - t0) * 1e3,
            "forward_ms": (t2 - t1) * 1e3,
            "profiled_wall_ms": (t4 - t3) * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / ((t2 - t0) * 1e3),
            "top": [{"name": n[:80], "device_ms": ms, "calls": c}
                    for n, ms, c in rows[:15]]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="after serving, print a JSON time breakdown of "
                         "each request (plan build, forward, device time "
                         "by kernel, idle share)")
    args = ap.parse_args()

    from repro_torch.data import pointcloud
    bucket = 65536
    model = minkunet.MinkUNet(minkunet.LARGE, device=args.device,
                              generator=torch.Generator().manual_seed(
                                  args.seed))
    engine = ServeEngine(model, device=args.device,
                         queue=admission.AdmissionQueue(
                             buckets=(bucket,)))
    scenes = []
    for i in range(args.requests):
        rng = np.random.default_rng(args.seed + i)
        kind = "indoor" if i % 2 else "lidar"
        vb = pointcloud.make_batch(rng, kind, 1, bucket,
                                   voxel_size=0.0125 if kind == "lidar"
                                   else 0.05)
        scenes.append((kind, vb))
        engine.submit(f"req-{i}", vb.coords, vb.batch, vb.valid, vb.feats)
    engine.drain()
    s = engine.stats()
    print(f"served {s['completed']}/{s['requests']} "
          f"(shed={s['shed']} rejected={s['rejected']}) "
          f"p50={1e3 * (s['latency_p50_s'] or 0):.1f}ms "
          f"p99={1e3 * (s['latency_p99_s'] or 0):.1f}ms")
    if args.profile:
        import json
        name = torch.cuda.get_device_name(engine.device) \
            if engine.device.type == "cuda" else "cpu"
        for kind, vb in scenes:
            print(json.dumps({"profile": kind, "device": name,
                              **profile_request(model, vb.coords, vb.batch,
                                                vb.valid, vb.feats,
                                                bucket=bucket,
                                                device=engine.device)}))


if __name__ == "__main__":
    main()
