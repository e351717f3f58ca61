"""Training with the port's kernels, AdamW and checkpoint/restart: the
model families of the API (the decoder LMs, dense and MoE, Mamba2,
RecurrentGemma, the HuBERT encoder and the LLaVA VLM) and MinkUNet.

:func:`make_train_step`, :func:`init_state` and :func:`make_stream` are
the reference's step, state and data: the step is eager (there is no
``jax.jit`` counterpart): the family's loss, ``torch.autograd.grad`` over
the parameters, then AdamW on the ``state_dict``. Its attention forward
runs kernel 5 on the card; under the default remat mode each layer's (a
RecurrentGemma group's) forward is recomputed in the backward, so a step
launches the kernel twice an attention layer.

MinkUNet steps run eagerly over prebuilt plans from a long-lived,
content-keyed plan cache.

:func:`run_spconv_demo` is the reference's demo (``src/repro/launch/
train.py``): every step re-voxelizes the scene into freshly allocated
tensors (with ``replay=True`` the same scene every step), builds its plans
through one :class:`~repro_torch.core.plan.PlanCache`, whose content keys
make the replayed cloud hit, so the whole run searches ``2 * len(enc) + 1``
times however many steps it takes, and runs the step under a
:class:`~repro_torch.runtime.fault.TrainRunner` with a zero skip budget,
so that an injected :class:`~repro_torch.runtime.fault.FaultPlan`
(``faults=``) must be survived by retry and replay alone. With
``persist_dir`` the plan cache and the pinned tier write through to a
:class:`~repro_torch.runtime.persist.SnapshotStore`, and a restarted run
over the same directory searches no geometry it has seen.

CLI (reduced configs on the CPU; ``--full-config`` trains the published
widths, on the card by default):

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --device cpu --steps 20 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch minkunet \\
        --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch minkunet \\
        --full-config --voxels 65536 --steps 3
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import tempfile
import time
import weakref

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.configs import get_config
from repro_torch.core import plan as planlib
from repro_torch.data.tokens import FrameStream, TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import api, minkunet
from repro_torch.optim import adamw
from repro_torch.runtime import fault as faultlib
from repro_torch.runtime import feature_cache, guard, persist
from repro_torch.runtime.fault import RunnerConfig, TrainRunner

#: the reference demo's model
DEMO_CFG = minkunet.MinkUNetConfig(name="minkunet-demo", stem=8,
                                   enc=(8, 16), dec=(16, 8), classes=4,
                                   blocks=1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------

def lm_loss_and_grads(model: api.Model, params: dict, batch: dict, *,
                      impl: str = "kernel"):
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params`` (a flat
    ``state_dict`` of ``model.module``, not modified) on ``batch`` (arrays
    or tensors: the family's inputs, moved to the parameters' device);
    ``grads`` has the keys of ``params``. ``impl`` goes to the attention
    (``"ref"``: the plain version)."""
    dev = next(iter(params.values())).device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, metrics = model.loss(model.nest(leaves), batch, impl=impl)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(leaves, grads)))


def make_train_step(model: api.Model, opt_cfg: adamw.AdamWConfig, *,
                    impl: str = "kernel", timings: list | None = None):
    """``(state, batch) -> (state, metrics)`` of any model family:
    :func:`lm_loss_and_grads`, then AdamW.

    ``state`` is ``(params, opt_state)``: ``params`` a flat
    ``state_dict`` of ``model.module`` and ``opt_state`` from
    :func:`adamw.init`. The tensors of the old state are not modified.
    With ``timings`` (a list) it appends each step's forward+backward and
    optimizer ms (host clock around synchronized work).
    """
    def step(state, batch):
        params, opt_state = state
        dev = next(iter(params.values())).device
        _sync(dev)
        t0 = time.perf_counter()
        loss, metrics, grads = lm_loss_and_grads(model, params, batch,
                                                 impl=impl)
        _sync(dev)
        t1 = time.perf_counter()
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        if timings is not None:
            _sync(dev)
            timings.append({"forward_backward_ms": (t1 - t0) * 1e3,
                            "optimizer_ms": (time.perf_counter() - t1)
                            * 1e3})
        return (params, opt_state), {**metrics, "loss": loss, **om}

    return step


def init_state(model: api.Model, seed: int = 0):
    """``(params, opt_state)``: the ``state_dict`` of ``model.module``
    drawn from a generator on ``model.device`` seeded ``seed``, and zero
    AdamW moments."""
    module = model.module(torch.Generator(model.device).manual_seed(seed))
    params = dict(module.state_dict())
    return params, adamw.init(params)


class VLMStream:
    """The reference's VLM batches: ``TokenStream``'s tokens plus float32
    patch embeddings (B, n_patches, vision_dim) drawn from the seed
    sequence ``[seed, step, 2]``."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0):
        self.base = TokenStream(vocab=cfg.vocab, batch=batch, seq=seq,
                                seed=seed)
        self.shape = (batch, cfg.n_patches, cfg.vision_dim)
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 2]))
        b = self.base.batch_at(step)
        b["patches"] = rng.standard_normal(self.shape).astype(np.float32)
        return b


def make_stream(cfg, batch: int, seq: int, seed: int = 0):
    """The reference's synthetic data of ``cfg``'s family, bit for bit:
    :class:`~repro_torch.data.tokens.FrameStream` for the encoder,
    :class:`VLMStream` for the VLM, a
    :class:`~repro_torch.data.tokens.TokenStream` for the others."""
    if cfg.family == "encoder":
        return FrameStream(dim=cfg.frontend_dim, vocab=cfg.vocab,
                           batch=batch, seq=seq, seed=seed)
    if cfg.family == "vlm":
        return VLMStream(cfg, batch, seq, seed)
    return TokenStream(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)


def run_lm(arch: str, *, steps: int, batch: int, seq: int, lr: float,
           ckpt_dir: str | None = None, ckpt_every: int = 50,
           full_config: bool = False, seed: int = 0,
           total_steps: int | None = None,
           device: str | torch.device | None = None) -> dict:
    """Train model ``arch`` of any family (its reduced config unless
    ``full_config``) for ``steps`` steps on ``make_stream``'s tokens under
    a :class:`~repro_torch.runtime.fault.TrainRunner`, resuming from the
    newest verified checkpoint in ``ckpt_dir`` (None: a temporary
    directory, removed at the end). ``total_steps`` (None: ``steps``) is
    the learning-rate horizon. Returns ``losses``, ``resumed_from``,
    ``state_digest``, per-step ``timings``, ``save_ms`` and the runner's
    ``recoveries`` and ``ckpt_failures``."""
    cfg = get_config(arch)
    if not full_config:
        cfg = cfg.reduced()
    model = api.build_model(cfg, device=device)
    horizon = total_steps or steps
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=horizon,
                                warmup_steps=max(horizon // 20, 5))
    timings: list = []
    step_fn = make_train_step(model, opt_cfg, timings=timings)
    stream = make_stream(cfg, batch, seq, seed=seed)
    with (contextlib.nullcontext(ckpt_dir) if ckpt_dir is not None
          else tempfile.TemporaryDirectory(prefix="lm-ckpt-")) as d:
        runner = TrainRunner(RunnerConfig(ckpt_dir=d, ckpt_every=ckpt_every),
                             step_fn, stream.batch_at,
                             init_state(model, seed))
        resumed_from = runner.step if runner.restore_latest() else None
        losses = runner.run(steps)
    return {"config": cfg.name, "losses": losses,
            "resumed_from": resumed_from,
            "state_digest": state_digest(runner.state), "timings": timings,
            "save_ms": runner.save_ms, "recoveries": runner.recoveries,
            "ckpt_failures": runner.ckpt_failures}


# ---------------------------------------------------------------------------
# MinkUNet training
# ---------------------------------------------------------------------------

def loss_and_grads(model: minkunet.MinkUNet, params: dict, batch: dict, *,
                   plans: minkunet.MinkPlans | None = None,
                   impl: str | None = None, stamps: list | None = None):
    """``(loss, metrics, grads)`` of :func:`minkunet.segmentation_loss` at
    ``params`` (a ``state_dict`` of ``model``, copied into it first).

    ``grads`` has every key of ``params``: the BatchNorm statistics are
    leaves of the reference's parameter tree with zero gradient (the
    training forward normalizes by batch statistics), so AdamW only
    decays them, as in the reference. With ``stamps`` (a list) it appends
    the host clock at the start, after the forward and after the
    backward, each after the device has finished.
    """
    dev = next(iter(params.values())).device

    def stamp():
        if stamps is not None:
            _sync(dev)
            stamps.append(time.perf_counter())

    with torch.no_grad():
        for k, t in model.state_dict().items():
            t.copy_(params[k])
    model.zero_grad(set_to_none=True)
    stamp()
    loss, metrics = minkunet.segmentation_loss(model, batch, plans=plans,
                                               impl=impl)
    stamp()
    loss.backward()
    trainable = dict(model.named_parameters())
    grads = {k: trainable[k].grad if k in trainable
             and trainable[k].grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    stamp()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_spconv_step(model: minkunet.MinkUNet, opt_cfg: adamw.AdamWConfig,
                     plans: minkunet.MinkPlans, *, impl: str | None = None,
                     timings: list | None = None):
    """``(state, batch) -> (state, metrics)`` over prebuilt ``plans``.

    ``state`` is ``(params, opt_state)``: ``params`` a ``state_dict`` of
    ``model`` and ``opt_state`` from :func:`adamw.init`. The step runs
    :func:`loss_and_grads` and AdamW and returns the new state; the
    tensors of the old state are not modified. With ``timings`` (a list)
    it appends each step's forward, backward and optimizer ms (host clock
    around synchronized work).
    """
    def step(state, batch):
        params, opt_state = state
        stamps = [] if timings is not None else None
        loss, metrics, grads = loss_and_grads(model, params, batch,
                                              plans=plans, impl=impl,
                                              stamps=stamps)
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        if timings is not None:
            _sync(loss.device)
            t0, t1, t2 = stamps
            timings.append({"forward_ms": (t1 - t0) * 1e3,
                            "backward_ms": (t2 - t1) * 1e3,
                            "optimizer_ms": (time.perf_counter() - t2)
                            * 1e3})
        return (params, opt_state), {**metrics, "loss": loss, **om}

    return step


def state_digest(state) -> str:
    """sha256 over every leaf's bytes, in checkpoint order."""
    digest = hashlib.sha256()
    for leaf in checkpoint.tree_leaves(state):
        digest.update(checkpoint.host_array(leaf).tobytes())
    return digest.hexdigest()


def run_spconv_demo(steps: int = 2, *, voxels: int = 128,
                    cfg: minkunet.MinkUNetConfig | None = None,
                    impl: str | None = None, seed: int = 0,
                    cache: planlib.PlanCache | None = None,
                    scene: str = "indoor", replay: bool = True,
                    ckpt_dir: str | None = None,
                    max_blocks: int | None = None,
                    verify_cache: bool = False,
                    max_retries_per_step: int = 2, resume: bool = False,
                    total_steps: int | None = None,
                    faults: faultlib.FaultPlan | None = None,
                    persist_dir: str | None = None,
                    device: str | torch.device | None = None) -> dict:
    """Train MinkUNet for ``steps`` steps with cross-step plan caching.

    ``cfg`` defaults to :data:`DEMO_CFG`; weights are seeded from
    ``seed``. ``impl`` selects the rulebook execution as in
    :func:`minkunet.forward` (None: the kernels on the card, their plain
    versions on the CPU; ``"ref"`` the plain versions anywhere).
    ``device`` None runs on the card and raises without one. The
    checkpoints go to ``ckpt_dir`` (None: a temporary directory removed
    at the end); ``resume=True`` continues from its newest verified step,
    and ``total_steps`` pins the learning-rate horizon, so a run stopped
    and resumed reaches the state of the uninterrupted run (bit for bit on
    the CPU; on the card the plain backward's ``index_add_`` sums in
    atomics, in no fixed order). ``faults`` is a
    :class:`~repro_torch.runtime.fault.FaultPlan` installed for the run
    (the ``kill`` site also fires at the start of each step);
    ``persist_dir`` backs the plan cache and its pinned tier with a
    snapshot store under ``<persist_dir>/snap``, so a run over a warm
    directory makes no map search.

    Returns ``losses``, ``mapsearch_calls``, ``searches_per_cloud`` (the
    flat count a replayed run must show), ``plan_sets`` (distinct plan
    sets used), the cache's ``stats()``, ``state_digest``, the runner's
    ``recoveries`` / ``skipped_batches`` / ``ckpt_failures``,
    ``resumed_from``, per-step ``timings`` (plan build, forward, backward,
    optimizer ms), ``save_ms`` (each checkpoint save), the snapshot
    store's ``persist`` stats (None without one) and the run's ``health``
    counter delta.
    """
    from repro_torch.data import pointcloud
    dev = resolve_device(device)
    cfg = cfg or DEMO_CFG
    model = minkunet.MinkUNet(cfg, device=dev,
                              generator=torch.Generator().manual_seed(seed))
    opt_cfg = adamw.AdamWConfig(lr=1e-3,
                                total_steps=max(total_steps or steps, 2),
                                warmup_steps=1)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = (params, adamw.init(params))
    pstore = None
    if persist_dir:
        pstore = persist.SnapshotStore(os.path.join(persist_dir, "snap"),
                                       device=dev)
    if cache is None:
        cache = planlib.PlanCache(
            verify=verify_cache, persist=pstore,
            pinned=feature_cache.PinnedStore(persist=pstore)
            if pstore is not None else None)
    planlib.reset_mapsearch_counter()
    h0 = guard.health().snapshot()

    def cloud_at(step: int) -> dict:
        rng = np.random.default_rng(seed if replay else seed + step)
        vb = pointcloud.make_batch(rng, scene, batch_size=1,
                                   max_voxels=voxels)
        b = {k: torch.as_tensor(np.array(v), device=dev)   # fresh buffers
             for k, v in vb._asdict().items()}
        b["labels"] = b["labels"].clamp(0, cfg.classes - 1)
        return b

    # distinct plan sets used: a content hit returns the same plan objects;
    # each set is told by its first kmap, held weakly (a dead set's id may
    # be recycled, and the entry goes with it)
    live_sets = weakref.WeakValueDictionary()
    plan_sets = [0]
    timings: list = []

    def runner_step(state, batch):
        faultlib.check(faultlib.KILL_SITE)     # mid-step SIGKILL point
        _sync(dev)
        t0 = time.perf_counter()
        plans = minkunet.build_plans(
            batch["coords"], batch["batch"], batch["valid"], cfg,
            cache=cache, n_max=max_blocks,
            search_impl=None if impl == "scan" else impl, device=dev)
        _sync(dev)
        plan_ms = (time.perf_counter() - t0) * 1e3
        kmap = plans.subm[0].kmap
        if live_sets.get(id(kmap)) is not kmap:
            live_sets[id(kmap)] = kmap
            plan_sets[0] += 1
        out = make_spconv_step(model, opt_cfg, plans, impl=impl,
                               timings=timings)(state, batch)
        timings[-1]["plan_ms"] = plan_ms
        return out

    with (contextlib.nullcontext(ckpt_dir) if ckpt_dir is not None
          else tempfile.TemporaryDirectory(prefix="spconv-ckpt-")) as d:
        # zero skip budget: a skipped batch changes the final state
        runner = TrainRunner(
            RunnerConfig(ckpt_dir=d, ckpt_every=1, keep=2,
                         max_retries_per_step=max_retries_per_step,
                         max_skipped_batches=0),
            runner_step, cloud_at, state)
        resumed_from = None
        if resume and runner.restore_latest():
            resumed_from = runner.step
        with faultlib.inject(faults):
            losses = runner.run(steps)
    return {
        "steps": steps,
        "losses": losses,
        "mapsearch_calls": planlib.mapsearch_call_count(),
        "searches_per_cloud": 2 * len(cfg.enc) + 1,
        "plan_sets": plan_sets[0],
        "cache": cache.stats(),
        "state_digest": state_digest(runner.state),
        "recoveries": runner.recoveries,
        "skipped_batches": runner.skipped_batches,
        "ckpt_failures": runner.ckpt_failures,
        "resumed_from": resumed_from,
        "timings": timings,
        "save_ms": runner.save_ms,
        "persist": pstore.stats() if pstore is not None else None,
        "health": guard.health().delta(h0),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="minkunet or a model config (tinyllama-1.1b, "
                         "mixtral-8x7b, mamba2-2.7b, recurrentgemma-2b, "
                         "hubert-xlarge, llava-next-mistral-7b, ...)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="LM sequences a step")
    ap.add_argument("--seq", type=int, default=128, help="LM tokens a row")
    ap.add_argument("--lr", type=float, default=3e-4, help="LM peak lr")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="LM steps between checkpoints")
    ap.add_argument("--voxels", type=int, default=512,
                    help="the cloud's row budget (minkunet)")
    ap.add_argument("--full-config", action="store_true",
                    help="the published widths: MinkUNet-large, or the "
                         "LM's full config (default: the demo's tiny "
                         "config, the LM's reduced one)")
    ap.add_argument("--impl", default="auto",
                    choices=("auto", "kernel", "ref", "scan"),
                    help="rulebook execution: auto/kernel (the kernels on "
                         "the card, plain versions on the CPU), ref, scan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one); "
                         "an LM run resumes from its newest verified step")
    ap.add_argument("--resume", action="store_true",
                    help="resume minkunet from the newest verified "
                         "checkpoint in --ckpt-dir")
    ap.add_argument("--total-steps", type=int, default=None,
                    help="lr-schedule horizon when resuming a partial run "
                         "(default: --steps)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--persist-dir", default=None,
                    help="snapshot store for warm restarts (default: "
                         "REPRO_PERSIST_DIR; unset: memory only)")
    ap.add_argument("--health-json", default=None,
                    help="write the health counters as JSON to this path "
                         "after the run")
    args = ap.parse_args(argv)
    if args.arch != "minkunet":
        t0 = time.perf_counter()
        res = run_lm(args.arch, steps=args.steps, batch=args.batch,
                     seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     full_config=args.full_config, seed=args.seed,
                     total_steps=args.total_steps, device=args.device)
        losses = res["losses"] or [float("nan")]
        if res["resumed_from"] is not None:
            print(f"resumed from step {res['resumed_from']}")
        dt = time.perf_counter() - t0
        print(f"arch={res['config']} steps={len(res['losses'])} "
              f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
              f"({dt / max(len(losses), 1):.3f}s/step) "
              f"digest={res['state_digest'][:12]}")
        if args.health_json:
            guard.dump_health_json(args.health_json, meta={
                "arch": res["config"], "steps": len(losses),
                "digest": res["state_digest"]})
        return
    if args.resume and args.ckpt_dir is None:
        ap.error("--resume needs --ckpt-dir")
    res = run_spconv_demo(
        steps=args.steps, voxels=args.voxels,
        cfg=minkunet.LARGE if args.full_config else None,
        impl=None if args.impl == "auto" else args.impl, seed=args.seed,
        ckpt_dir=args.ckpt_dir, resume=args.resume,
        total_steps=args.total_steps, device=args.device,
        persist_dir=args.persist_dir or persist.default_dir())
    # over a warm persist dir every plan is read from disk: zero searches
    # is the best case, not a broken flat count
    warm = res["persist"] is not None and res["mapsearch_calls"] == 0
    flat = res["mapsearch_calls"] == res["searches_per_cloud"]
    print(f"arch=minkunet steps={res['steps']} "
          f"first_loss={res['losses'][0]:.4f} "
          f"last_loss={res['losses'][-1]:.4f} "
          f"map_searches={res['mapsearch_calls']} "
          f"(flat={'warm' if warm else 'yes' if flat else 'NO'}) "
          f"plan_sets={res['plan_sets']} "
          f"content_hits={res['cache']['content_hits']} "
          f"recoveries={res['recoveries']} "
          f"digest={res['state_digest'][:12]}")
    if args.health_json:
        guard.dump_health_json(args.health_json, meta={
            "arch": "minkunet", "steps": res["steps"],
            "digest": res["state_digest"]})


if __name__ == "__main__":
    main()
