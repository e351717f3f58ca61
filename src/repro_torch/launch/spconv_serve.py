"""Continuous-batching SpConv serving engine over MinkUNet.

Requests enter the bounded, bucket-quantizing
:class:`~repro_torch.runtime.admission.AdmissionQueue` (the strict
sanitizer by default); each tick drains up to ``max_batch`` of them,
builds each request's plans through one long-lived, content-keyed
:class:`~repro_torch.core.plan.PlanCache` (map search on the card through
the OCTENT kernel; a re-submitted scene hits by content and costs no
search) and runs the forward through the gather-GEMM kernel, as a
**per-bucket executable**: the plans split into their tensors and a
hashable skeleton (:func:`split_plans`, the reference's), and the engine
keeps one entry per ``(skeleton, impl)``, so it "compiles" once per bucket
class, never once per request geometry (``compiled`` in :meth:`ServeEngine.
stats`, noted as ``serve.compile``). On the card an entry is a CUDA graph
of ``minkunet.forward`` (``runtime/graph.py``, the port's ``jax.jit``),
captured at its first request after a warm-up and replayed for every
request of its class: the request's tensors are copied into the graph's
static buffers and its logits cloned out. On the CPU an entry runs the
eager forward, counted the same way. Each request's logits come back to
the host with a sha256 digest and its submit-to-result latency.

While a :class:`~repro_torch.runtime.fault.FaultPlan` is installed or the
ladder is above level 0, the card runs the entry's forward eagerly, with
the same kernels: the fault sites and ``guard.dispatch`` are Python, which
a replay does not run, so a graph would fire them once, at capture. The
reference's trace-time semantics differ there; phase ``chaos`` of
``chip_smoke.py`` expects a fault per request.

Robustness, as the reference's engine (``src/repro/launch/
spconv_serve.py``):

  * **Per-request fault isolation**: each request's plan build and forward
    run under retry-once (``forward_multicloud``'s ``on_error`` hook). A
    transient fault recovers with the same impl and bit-identical logits
    (``serve.build_retry`` / ``serve.exec_retry``); a persistent one
    isolates that request alone (:data:`~repro_torch.runtime.admission.
    ISOLATED_FAULT`).
  * **Degradation ladder**, driven by each tick's health delta: a tick
    with an isolation, a fallback error, a quarantine or a replan climbs
    one level; ``recover_after`` healthy ticks step one down. Level 1
    halves the batch, level 2 forces the plain versions (``impl="ref"``)
    for the forward on the CPU (on the card, where the port launches the
    kernel or raises, it keeps the kernel at the halved batch), level 3
    (:data:`LADDER_MAX`) sheds the queue.
  * **Deadline shedding** at dequeue, from a per-bucket EWMA of service
    time.
  * The ``batch`` fault site attacks batch assembly (retried once; a
    persistent fault isolates that tick's requests), and the ``kill``
    site SIGKILLs the process at a tick.
  * **Durability** (``persist_dir``): plans and pinned search structures
    write through to ``<persist_dir>/snap``, so a restarted engine serves
    a seen geometry with no search, and every admitted request is
    journaled in ``<persist_dir>/journal`` until its result is final;
    :meth:`ServeEngine.recover` queues the journaled requests again.

CLI (MinkUNet-large, one 65,536-voxel bucket, on the card):

    PYTHONPATH=src python -m repro_torch.launch.spconv_serve --requests 4 \\
        --persist-dir /tmp/serve --health-json /tmp/health.json
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.core.spconv import SparseTensor
from repro_torch.device import resolve_device
from repro_torch.models import minkunet
from repro_torch.runtime import admission, fault, graph, guard

# ---------------------------------------------------------------------------
# Plan splitting: tensors vs static skeleton
# ---------------------------------------------------------------------------


def _flatten(node, leaves: list):
    """The treedef of ``node``, a tree of tuples (NamedTuples among them),
    its leaves appended to ``leaves``; None is an empty subtree, as in
    ``jax.tree_util``. A treedef is nested tuples: hashable."""
    if node is None:
        return None
    if isinstance(node, tuple):
        return type(node), tuple(_flatten(c, leaves) for c in node)
    leaves.append(node)
    return "*"


def _unflatten(treedef, leaves):
    if treedef is None:
        return None
    if treedef == "*":
        return next(leaves)
    typ, children = treedef
    vals = [_unflatten(c, leaves) for c in children]
    return typ(*vals) if hasattr(typ, "_fields") else typ(vals)


def split_plans(plans):
    """Partition a :class:`~repro_torch.models.minkunet.MinkPlans` tree into
    its tensors and a hashable static skeleton, as the reference's.

    Returns ``(dyn, treedef, static, skeleton)``: ``dyn`` the leaf list with
    every other leaf replaced by None, ``static`` the complement (the
    Python values: each plan's ``kind``, ``n_out``, ``n_taps``, the tiles'
    ``bo``); ``skeleton`` a hashable key, the treedef, the static leaves
    and the tensors' shapes and dtypes, the same for every geometry of one
    padding bucket, which holds the engine's entry count to the bucket
    classes.
    """
    leaves: list = []
    treedef = _flatten(plans, leaves)
    dyn = [lf if isinstance(lf, torch.Tensor) else None for lf in leaves]
    static = tuple(None if isinstance(lf, torch.Tensor) else lf
                   for lf in leaves)
    shapes = tuple((tuple(lf.shape), str(lf.dtype)) for lf in leaves
                   if isinstance(lf, torch.Tensor))
    return dyn, treedef, static, (treedef, static, shapes)


def merge_plans(treedef, static, dyn):
    """Inverse of :func:`split_plans`. Leaves are never None (None is an
    empty subtree), so None marks where ``dyn`` holds the tensor."""
    return _unflatten(treedef, iter(s if d is None else d
                                    for d, s in zip(dyn, static)))


class _Executable:
    """One bucket class's forward: :func:`minkunet.forward` over plans
    merged from a request's tensors and the class's skeleton. On the card
    a CUDA graph, captured at the first call that is not ``eager``; on the
    CPU, or with ``eager``, the eager forward with the same kernels."""

    def __init__(self, model, treedef, static, impl: str):
        self.model, self.treedef, self.static = model, treedef, static
        self.impl = impl
        self.graph: graph.Graph | None = None

    def _forward(self, st: SparseTensor, dyn):
        return minkunet.forward(self.model, st, impl=self.impl,
                                plans=merge_plans(self.treedef, self.static,
                                                  dyn))

    def _run(self, coords, batch, valid, feats, *tensors):
        it = iter(tensors)
        dyn = [next(it) if s is None else None for s in self.static]
        return self._forward(SparseTensor(coords, batch, valid, feats), dyn)

    def __call__(self, st: SparseTensor, dyn, *, eager: bool):
        dev = st.coords.device
        if dev.type != "cuda" or eager:
            return self._forward(st, dyn)
        args = (*st, *(d for d in dyn if d is not None))
        if self.graph is None:
            g = graph.Graph(self._run, dev)
            g.warm_up(*args)
            g.capture(*args)
            self.graph = g
        return self.graph(*args)


@dataclasses.dataclass
class ServeResult:
    """Terminal outcome of one request."""

    rid: str
    status: str                  # completed | shed | rejected | isolated
    reason: str | None = None    # admission.* reason for non-completed
    bucket: int | None = None
    latency_s: float | None = None   # submit -> result on the host
    degraded: bool = False       # served while the ladder was engaged
    digest: str | None = None    # sha256 of the logits bytes
    logits: np.ndarray | None = None


#: ladder levels: 0 healthy, 1 halve the batch, 2 plain versions (on the
#: CPU only), 3 shed
LADDER_MAX = 3


def serve_max_batch() -> int:
    """``REPRO_SERVE_MAX_BATCH`` (``runtime/flags.py``): requests a tick
    drains when the engine is built with ``max_batch=None`` (default 8)."""
    return int(os.environ.get("REPRO_SERVE_MAX_BATCH", "8"))


class ServeEngine:
    """Continuous-batching engine over a :class:`MinkUNet`.

    Args:
      model: the served model; moved to ``device``.
      device: None runs on the card (raises without one); ``"cpu"`` runs
        the plain versions of the kernels.
      impl: the forward's execution (``"kernel"``, the default, or
        ``"ref"``); ladder level 2 forces ``"ref"`` on the CPU, never on
        the card.
      queue: an AdmissionQueue (None: one built from the flags, with the
        model's grid contract).
      max_batch: requests drained per tick (None:
        :func:`serve_max_batch`, read here).
      clock: injectable time source.
      verify_cache: content hits of the plan cache compare the key tensors
        (an injected fingerprint collision is then rebuilt).
      recover_after: healthy ticks before the ladder steps down a level.
      persist_dir: the durability root (``snap`` and ``journal`` stores
        under it; ``REPRO_PERSIST_MAX_BYTES`` bounds each); None: memory
        only.

    ``submit`` + ``drain`` replay a batch of requests; terminal outcomes
    accumulate in ``results`` and in the ``serve.*`` / ``admit.*`` health
    counters, and the two ledgers agree exactly.
    """

    def __init__(self, model: minkunet.MinkUNet, *,
                 device: str | torch.device | None = None,
                 impl: str = "kernel",
                 queue: admission.AdmissionQueue | None = None,
                 max_batch: int | None = None, clock=time.monotonic,
                 verify_cache: bool = False, recover_after: int = 2,
                 persist_dir: str | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = model.cfg
        self.impl = impl
        self.clock = clock
        self.queue = queue if queue is not None \
            else admission.AdmissionQueue(grid_bits=self.cfg.grid_bits,
                                          batch_bits=self.cfg.batch_bits,
                                          clock=clock)
        self.max_batch = serve_max_batch() if max_batch is None \
            else max_batch
        self.persist = self.journal = None
        pinned = None
        if persist_dir:
            from repro_torch.runtime import feature_cache, persist
            self.persist = persist.SnapshotStore(
                os.path.join(persist_dir, "snap"), device=self.device)
            self.journal = persist.SnapshotStore(
                os.path.join(persist_dir, "journal"))
            pinned = feature_cache.PinnedStore(persist=self.persist)
        # sized as the reference's: eight requests' plans stay resident
        self.cache = planlib.PlanCache(
            capacity=max(64, 8 * (2 * (len(self.cfg.enc)
                                       + len(self.cfg.dec)) + 2)),
            verify=verify_cache, persist=self.persist, pinned=pinned)
        self.recover_after = recover_after
        self.level = 0
        self._healthy_ticks = 0
        self._exec: dict = {}    # (skeleton, impl) -> _Executable
        self.compiled = 0
        self._ewma: dict[int, float] = {}    # bucket -> service seconds
        self.results: list[ServeResult] = []
        self.ticks = 0

    # -- admission ----------------------------------------------------------

    def submit(self, rid: str, coords, batch, valid, feats, *,
               deadline_s: float | None = None):
        """Admit one raw request; a typed rejection is terminal and is
        recorded at once. An admitted request is journaled (with a
        persist dir) until its result is final."""
        out = self.queue.submit(rid, coords, batch, valid, feats,
                                deadline_s=deadline_s)
        if isinstance(out, admission.Rejection):
            self._record_rejection(out)
        elif self.journal is not None:
            # a monotonic deadline means nothing in another process: the
            # journal keeps the remaining budget as a wall-clock expiry
            self.journal.put(("req", out.rid), {
                "rid": out.rid, "coords": out.coords, "batch": out.batch,
                "valid": out.valid, "feats": out.feats,
                "bucket": out.bucket, "n_valid": out.n_valid,
                "wall_deadline": time.time()
                + (out.deadline - self.queue.clock())})
        return out

    def recover(self) -> dict:
        """Queue the journaled requests again after a restart.

        Each verified entry whose deadline still holds goes back into the
        queue (``serve.recovered``); an expired one gets a terminal
        :data:`~repro_torch.runtime.admission.SHED_RESTART`. A corrupt
        journal file is dropped by the store (``persist.dropped``).
        Returns ``{"recovered", "shed"}``.
        """
        if self.journal is None:
            return {"recovered": 0, "shed": 0}
        recovered = shed = 0
        for key, val in list(self.journal.items()):
            if not (isinstance(key, tuple) and len(key) == 2
                    and key[0] == "req"):
                continue
            remaining = float(val["wall_deadline"]) - time.time()
            now = self.clock()
            req = admission.Request(
                val["rid"], np.asarray(val["coords"]),
                np.asarray(val["batch"]), np.asarray(val["valid"]),
                np.asarray(val["feats"]), int(val["bucket"]),
                int(val["n_valid"]), now + remaining, now)
            out = self.queue.restore(req)
            if isinstance(out, admission.Rejection):
                self._record_rejection(out)
                self.journal.delete(key)
                shed += 1
            else:
                guard.health().note("serve.recovered")
                recovered += 1
        return {"recovered": recovered, "shed": shed}

    def _record_rejection(self, rej: admission.Rejection) -> None:
        if rej.reason == admission.ISOLATED_FAULT:
            status = "isolated"
        elif rej.shed:
            status = "shed"
        else:
            status = "rejected"
        guard.health().note(f"serve.{status}")
        self.results.append(ServeResult(rej.rid, status, reason=rej.reason))

    # -- the tick -------------------------------------------------------------

    def _impl_now(self) -> str:
        # the plain versions never stand in for a kernel on the card
        if self.level >= 2 and self.device.type == "cpu":
            return "ref"
        return self.impl

    def _executable(self, skeleton, treedef, static,
                    impl: str) -> _Executable:
        """The entry of ``(skeleton, impl)``, made (``compiled`` + 1,
        ``serve.compile``) at the key's first request."""
        key = (skeleton, impl)
        fn = self._exec.get(key)
        if fn is None:
            fn = self._exec[key] = _Executable(self.model, treedef, static,
                                               impl)
            self.compiled += 1
            guard.health().note("serve.compile")
        return fn

    def _forward_fn(self, model, st: SparseTensor, plans):
        dyn, treedef, static, skeleton = split_plans(plans)
        fn = self._executable(skeleton, treedef, static, self._impl_now())
        return fn(st, dyn,
                  eager=fault.active() is not None or self.level > 0)

    def _note_service(self, bucket: int, dt: float) -> None:
        prev = self._ewma.get(bucket)
        self._ewma[bucket] = dt if prev is None else 0.8 * prev + 0.2 * dt

    def step(self) -> list[ServeResult]:
        """One tick: assemble a batch, serve it with per-request isolation,
        update the ladder. Returns this tick's terminal results; their
        journal entries are deleted, so a kill during the tick (the
        ``kill`` site) leaves them for :meth:`recover`."""
        fault.check(fault.KILL_SITE)         # mid-tick SIGKILL point
        results = self._step()
        if self.journal is not None:
            for r in results:
                self.journal.delete(("req", r.rid))
        return results

    def _step(self) -> list[ServeResult]:
        self.ticks += 1
        h0 = guard.health().snapshot()
        tick: list[ServeResult] = []
        if self.level >= LADDER_MAX:
            for rej in self.queue.shed_all():
                self._record_rejection(rej)
                tick.append(self.results[-1])
            self._ladder_update(h0, had_failures=False)
            return tick

        batch_n = max(1, self.max_batch // (2 if self.level >= 1 else 1))
        reqs, shed = self.queue.take(batch_n, est_service_s=self._ewma.get)
        for rej in shed:
            self._record_rejection(rej)
            tick.append(self.results[-1])
        if not reqs:
            self._ladder_update(h0, had_failures=False)
            return tick

        # the batch site: a one-shot fault recovers on the retry, a
        # persistent one isolates this tick's requests only
        batch_dead = False
        for attempt in (0, 1):
            try:
                fault.check("batch")
                break
            except fault.InjectedFault:
                if attempt:
                    batch_dead = True
                else:
                    guard.health().note("serve.batch_retry")
        if batch_dead:
            for req in reqs:
                res = self._isolate(req)
                self.results.append(res)
                tick.append(res)
            self._ladder_update(h0, had_failures=True)
            return tick

        done = self._execute_batch(reqs)
        tick.extend(done)
        self._ladder_update(
            h0, had_failures=any(r.status == "isolated" for r in done))
        return tick

    def _execute_batch(self, reqs) -> list[ServeResult]:
        degraded = self.level > 0
        dev = self.device
        sts: list = [None] * len(reqs)
        built: list = [None] * len(reqs)
        results: list[ServeResult | None] = [None] * len(reqs)

        def build_one(req):
            st = SparseTensor(*(torch.as_tensor(a, device=dev) for a in (
                req.coords, req.batch, req.valid, req.feats)))
            plans = minkunet.build_plans(st.coords, st.batch, st.valid,
                                         self.cfg, cache=self.cache,
                                         n_max=req.bucket, device=dev)
            return st, plans

        for i, req in enumerate(reqs):
            try:
                sts[i], built[i] = build_one(req)
            except Exception:                        # noqa: BLE001
                try:                                 # a transient fault
                    sts[i], built[i] = build_one(req)  # recovers here
                    guard.health().note("serve.build_retry")
                except Exception:                    # noqa: BLE001
                    results[i] = self._isolate(req)

        live = [i for i in range(len(reqs)) if results[i] is None]

        def on_error(j, exc):
            # j indexes the live sublist: retry once with the same impl
            # (a one-shot fault recovers bit-identically), then isolate
            i = live[j]
            try:
                out = self._forward_fn(self.model, sts[i], built[i])
                guard.health().note("serve.exec_retry")
                return out
            except Exception:                        # noqa: BLE001
                results[i] = self._isolate(reqs[i])
                return None

        outs = minkunet.forward_multicloud(
            self.model, [sts[i] for i in live], plans=[built[i] for i in live],
            forward_fn=self._forward_fn, on_error=on_error)

        for j, i in enumerate(live):
            if results[i] is not None:
                continue
            logits = outs[j].cpu().numpy()
            done = self.clock()
            req = reqs[i]
            self._note_service(req.bucket, done - req.submitted_at)
            guard.health().note("serve.completed")
            if degraded:
                guard.health().note("serve.degraded")
            results[i] = ServeResult(
                req.rid, "completed", bucket=req.bucket,
                latency_s=done - req.submitted_at, degraded=degraded,
                digest=hashlib.sha256(logits.tobytes()).hexdigest(),
                logits=logits)
        final = [r for r in results if r is not None]
        self.results.extend(final)
        return final

    @staticmethod
    def _isolate(req) -> ServeResult:
        guard.health().note("serve.isolated")
        return ServeResult(req.rid, "isolated",
                           reason=admission.ISOLATED_FAULT, bucket=req.bucket)

    def _ladder_update(self, h0: dict, *, had_failures: bool) -> None:
        """Walk the degradation ladder from this tick's health delta."""
        delta = guard.health().delta(h0)
        bad = had_failures or any(
            k.startswith(("fallback.error", "quarantine.enter",
                          "replan.overflow")) for k in delta)
        if bad:
            self._healthy_ticks = 0
            if self.level < LADDER_MAX:
                self.level += 1
                guard.health().note("serve.degrade.enter")
                guard.health().note(f"serve.degrade.level{self.level}")
        else:
            self._healthy_ticks += 1
            if self.level > 0 and self._healthy_ticks >= self.recover_after:
                self.level -= 1
                self._healthy_ticks = 0
                guard.health().note("serve.degrade.exit")

    # -- driving --------------------------------------------------------------

    def drain(self, max_ticks: int = 10_000) -> list[ServeResult]:
        """Tick until the queue is empty; returns all terminal results."""
        while len(self.queue) and max_ticks > 0:
            self.step()
            max_ticks -= 1
        return self.results

    def stats(self) -> dict:
        by = {"completed": 0, "shed": 0, "rejected": 0, "isolated": 0}
        degraded = 0
        for r in self.results:
            by[r.status] += 1
            degraded += int(r.status == "completed" and r.degraded)
        lat = sorted(r.latency_s for r in self.results
                     if r.status == "completed")
        return {
            "requests": len(self.results), **by, "degraded": degraded,
            "ticks": self.ticks, "level": self.level,
            "compiled": self.compiled,
            "latency_p50_s": float(np.percentile(lat, 50)) if lat else None,
            "latency_p99_s": float(np.percentile(lat, 99)) if lat else None,
            "cache": self.cache.stats(),
            # ``is not None``: an empty store has len 0, and is falsy
            "persist": self.persist.stats()
            if self.persist is not None else None,
            "journal": self.journal.stats()
            if self.journal is not None else None,
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="requests drained per tick (default: "
                         "REPRO_SERVE_MAX_BATCH, else 8)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (default: "
                         "REPRO_SERVE_DEADLINE_MS)")
    ap.add_argument("--persist-dir", default=None,
                    help="durability root for warm restarts and the request "
                         "journal (default: REPRO_PERSIST_DIR; unset: "
                         "memory only)")
    ap.add_argument("--health-json", default=None,
                    help="write the health counters and the engine's stats "
                         "as JSON to this path")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, print a JSON time breakdown of "
                         "each request (plan build, forward, device time "
                         "by kernel, idle share)")
    args = ap.parse_args(argv)

    from repro_torch.data import pointcloud
    from repro_torch.runtime import persist
    bucket = 65536
    model = minkunet.MinkUNet(minkunet.LARGE, device=args.device,
                              generator=torch.Generator().manual_seed(
                                  args.seed))
    engine = ServeEngine(model, device=args.device,
                         queue=admission.AdmissionQueue(buckets=(bucket,)),
                         max_batch=args.max_batch,
                         persist_dir=args.persist_dir or persist.default_dir())
    rec = engine.recover()
    if rec["recovered"] or rec["shed"]:
        print(f"journal recovery: queued {rec['recovered']} again, shed "
              f"{rec['shed']} past their deadline")
    scenes = []
    for i in range(args.requests):
        rng = np.random.default_rng(args.seed + i)
        kind = "indoor" if i % 2 else "lidar"
        vb = pointcloud.make_batch(rng, kind, 1, bucket,
                                   voxel_size=0.0125 if kind == "lidar"
                                   else 0.05)
        scenes.append((kind, vb))
        engine.submit(f"req-{i}", vb.coords, vb.batch, vb.valid, vb.feats,
                      deadline_s=args.deadline_s)
    engine.drain()
    s = engine.stats()
    print(f"served {s['completed']}/{s['requests']} "
          f"(shed={s['shed']} rejected={s['rejected']} "
          f"isolated={s['isolated']} degraded={s['degraded']}) "
          f"p50={1e3 * (s['latency_p50_s'] or 0):.1f}ms "
          f"p99={1e3 * (s['latency_p99_s'] or 0):.1f}ms")
    if s["persist"] is not None and s["persist"]["evictions"]:
        print(f"warning: the snapshot budget ({engine.persist.max_bytes} "
              f"bytes, REPRO_PERSIST_MAX_BYTES) evicted "
              f"{s['persist']['evictions']} entries; a restart searches "
              f"their geometries again")
    if args.health_json:
        guard.dump_health_json(args.health_json, meta={
            "engine": "spconv_serve",
            **{k: v for k, v in s.items() if not isinstance(v, dict)}})
        print(f"health snapshot -> {args.health_json}")
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
