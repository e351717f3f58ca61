"""MinkowskiUNet — the paper's segmentation benchmark.

Sparse UNet over the SpOctA core: Subm3 feature blocks, Gconv2
downsampling, Tconv2 upsampling with exact coordinate recovery + skip
concat. ``SMALL`` ~ Seg(i) (ScanNet-sized), ``LARGE`` ~ Seg(o)
(SemanticKITTI-sized), both as published in the reference.

:class:`MinkUNet` holds the parameters as an ``nn.Module`` whose
``state_dict`` keys are the reference's parameter-tree paths
(``stem.conv.w``, ``enc0.block1.bn.var``, ``head.w``, ...), so
:func:`params_from_jax` carries trained or seeded reference weights across
(and :func:`adamw_state_from_jax` the optimizer state). :func:`forward`
runs inference under ``torch.no_grad`` unless ``training=True``;
:func:`segmentation_loss` is the training objective.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import plan as planlib
from repro_torch.core import spconv
from repro_torch.core.spconv import SparseTensor
from repro_torch.device import resolve_device
from repro_torch.runtime import guard


@dataclass(frozen=True)
class MinkUNetConfig:
    name: str = "minkunet-small"
    in_ch: int = 4
    classes: int = 20
    stem: int = 32
    enc: tuple = (32, 64, 128, 256)
    dec: tuple = (128, 96, 96, 96)
    blocks: int = 1                 # Subm3 convs per stage
    grid_bits: int = 7
    batch_bits: int = 4
    map_method: str = "octree"      # octree | sorted
    spac: bool = True               # §V-B sparsity-aware elision
    bm: int = 128                   # rulebook tile rows
    bo: int | None = None           # output-block rows (None: 512)
    fused_epilogue: bool = False    # fuse BN+ReLU into the Subm3 kernel and
                                    # thread activation sparsity between
                                    # stacked blocks


SMALL = MinkUNetConfig()
LARGE = MinkUNetConfig(name="minkunet-large", stem=32,
                       enc=(64, 128, 256, 512), dec=(256, 192, 128, 128),
                       blocks=2)


class Conv(nn.Module):
    """SpConv weights in the reference layout: w (K, Cin, Cout), b (Cout,)."""

    def __init__(self, k_taps: int, c_in: int, c_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(k_taps, c_in, c_out))
        self.b = nn.Parameter(torch.zeros(c_out))


class BatchNorm(nn.Module):
    """BatchNorm: affine parameters plus running statistics (buffers)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def stats(self) -> dict:
        return {"scale": self.scale, "bias": self.bias, "mean": self.mean,
                "var": self.var}


class ConvBN(nn.Module):
    def __init__(self, k_taps: int, c_in: int, c_out: int):
        super().__init__()
        self.conv = Conv(k_taps, c_in, c_out)
        self.bn = BatchNorm(c_out)


class MinkPlans(NamedTuple):
    """Every geometry-determined plan of one MinkUNet pass."""

    subm: tuple   # per resolution r = 0..len(enc): the Subm3 stage plan
    down: tuple   # per encoder stage: the Gconv2 plan (carries .maps)
    up: tuple     # per decoder stage: the Tconv2 plan


class MinkUNet(nn.Module):
    """MinkUNet parameters plus the forward.

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; None
    uses a fresh one seeded 0) with He-normal scaling as in the reference's
    init, then moved to ``device`` (None: the card; raises without one).
    """

    def __init__(self, cfg: MinkUNetConfig = SMALL, *,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if len(cfg.dec) > len(cfg.enc):
            raise ValueError("decoder deeper than encoder")
        self.cfg = cfg
        dev = resolve_device(device)
        self.stem = ConvBN(27, cfg.in_ch, cfg.stem)
        c_prev, skips = cfg.stem, [cfg.stem]
        for i, c in enumerate(cfg.enc):
            stage = nn.ModuleDict({"down": ConvBN(8, c_prev, c)})
            for b in range(cfg.blocks):
                stage[f"block{b}"] = ConvBN(27, c, c)
            setattr(self, f"enc{i}", stage)
            c_prev = c
            skips.append(c)
        for i, c in enumerate(cfg.dec):
            skip_c = skips[-(i + 2)]
            stage = nn.ModuleDict({"up": ConvBN(8, c_prev, c)})
            for b in range(cfg.blocks):
                stage[f"block{b}"] = ConvBN(27, c + skip_c if b == 0 else c, c)
            setattr(self, f"dec{i}", stage)
            c_prev = c
        self.head = Conv(1, c_prev, cfg.classes)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Conv):
                    k, cin, _ = mod.w.shape
                    mod.w.copy_(torch.randn(mod.w.shape, generator=gen)
                                * (2.0 / (k * cin)) ** 0.5)
        self.to(dev)

    def forward(self, st: SparseTensor, *, plans: MinkPlans | None = None,
                cache: planlib.PlanCache | None = None,
                impl: str | None = None,
                training: bool = False) -> torch.Tensor:
        """Per-voxel class logits (N, classes); see :func:`forward`."""
        return forward(self, st, plans=plans, cache=cache, impl=impl,
                       training=training)


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a reference parameter tree (nested dicts of arrays, e.g.
    ``repro.models.minkunet.init_model`` mapped through ``np.asarray``) into
    a :class:`MinkUNet` ``state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        else:
            out[prefix[:-1]] = torch.from_numpy(
                np.array(node, dtype=np.float32))

    walk("", tree)
    return out


def adamw_state_from_jax(state: Mapping) -> dict:
    """The reference's AdamW state ``{"m", "v", "count"}`` (numpy leaves) as
    the port's (:func:`repro_torch.optim.adamw.init`'s layout)."""
    return {"m": params_from_jax(state["m"]),
            "v": params_from_jax(state["v"]),
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32)}


def _as_tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def build_plans(coords, batch, valid, cfg: MinkUNetConfig, *,
                cache: planlib.PlanCache | None = None,
                n_max: int | None = None, search_impl: str | None = None,
                replan: bool | None = None,
                device: str | torch.device | None = None) -> MinkPlans:
    """Build (or fetch from ``cache``) the full plan set of one cloud.

    Pure geometry. A fresh cloud pays ``len(enc)`` Gconv2 searches and
    ``len(enc) + 1`` Subm3 searches; Tconv2 reuses the Gconv2 maps. The
    coordinate arrays (numpy or tensors) are placed on ``device`` (None:
    the card; raises without one). ``n_max`` is the octree directory
    capacity (default: the row budget, which no scene can overflow).
    ``cfg.map_method`` picks each Subm3 search (``subm3_plan``'s
    ``method``), ``search_impl`` the octree engine (None:
    ``octent.ops.search_impl()``, so under a device mesh that splits the
    block-key axes every Subm3 search runs sharded,
    ``kernels/octent/sharded.py``; every rank of the mesh then builds the
    same cloud's plans together).

    ``replan`` wraps every Subm3 build in :func:`guard.with_replan`: a
    scene that occupies more 16^3 blocks than ``n_max`` rebuilds at an
    escalated ``max_blocks`` instead of raising, and the escalation is
    memoized per shape class, so a replayed cloud searches no more from
    its second build on. None resolves from ``REPRO_GUARD_REPLAN`` (on
    unless 0).

    With a ``cache``, an identity miss is keyed by the content of its
    level's coordinate set, as in the reference: the set's fingerprint
    (one host sync, taken at most once a level and only on a miss) keys
    that level's Subm3 and Gconv2 lookups and the Tconv2 lookup back onto
    it (whose maps and target the set determines). A replayed cloud
    hashes once: its content hit returns plans whose derived sets then hit
    by identity. A fresh cloud hashes every level, so that a coarse level
    it shares with a cached cloud hits, and costs the searches that the
    reference's cache would.
    """
    if replan is None:
        replan = guard.replan_retries() > 0
    dev = resolve_device(device)
    coords = _as_tensor(coords, torch.int32, dev).contiguous()
    batch = _as_tensor(batch, torch.int32, dev).contiguous()
    valid = _as_tensor(valid, torch.bool, dev).contiguous()
    n_max = coords.shape[0] if n_max is None else n_max
    gb, bb = cfg.grid_bits, cfg.batch_bits

    def content_key(c, b, v):
        return functools.cache(lambda: (planlib.content_fingerprint(
            (c, b, v)), gb, bb))

    def subm(c, b, v, key):
        def build(mb):
            return planlib.subm3_plan(c, b, v, max_blocks=mb,
                                      method=cfg.map_method, grid_bits=gb,
                                      batch_bits=bb, bm=cfg.bm, bo=cfg.bo,
                                      search_impl=search_impl, cache=cache,
                                      content_key=key)
        if not replan:
            return build(n_max)
        return guard.with_replan(build, n_max,
                                 key=("minkunet-subm3", c.shape[0], gb, bb))

    cur = (coords, batch, valid)
    keys = [content_key(*cur)]
    subms, downs, stack = [subm(*cur, keys[0])], [], [cur]
    for level in range(len(cfg.enc)):
        d = planlib.gconv2_plan(*cur, grid_bits=gb, batch_bits=bb, bm=cfg.bm,
                                bo=cfg.bo, cache=cache,
                                content_key=keys[level])
        cur = (d.out_coords, d.out_batch, d.out_valid)
        keys.append(content_key(*cur))
        downs.append(d)
        subms.append(subm(*cur, keys[-1]))
        stack.append(cur)
    ups = []
    for i in range(len(cfg.dec)):
        level = len(stack) - i - 2                 # the Tconv2's output level
        ups.append(planlib.tconv2_plan(downs[level].maps, *stack[level],
                                       bm=cfg.bm, bo=cfg.bo, cache=cache,
                                       content_key=keys[level]))
    return MinkPlans(tuple(subms), tuple(downs), tuple(ups))


def _apply_subm(model_cfg, st, cb: ConvBN, plan, impl, training, act=None):
    """One Subm3 + BN + ReLU block; returns ``(st, act)`` where act is the
    fused epilogue's liveness (None on the unfused path). Training always
    takes the unfused path: the epilogue is inference BatchNorm."""
    if model_cfg.fused_epilogue and not training:
        return spconv.subm_conv3_bn_relu(
            st, cb.conv.w, cb.conv.b, cb.bn.stats(), max_blocks=st.n_max,
            spac=model_cfg.spac, act=act, plan=plan, impl=impl)
    st = spconv.subm_conv3(st, cb.conv.w, cb.conv.b, max_blocks=st.n_max,
                           spac=model_cfg.spac, act=act, plan=plan, impl=impl)
    st, _ = spconv.batch_norm(st, cb.bn.stats(), training=training)
    return spconv.relu(st), None


def forward(model: MinkUNet, st: SparseTensor, *,
            plans: MinkPlans | None = None,
            cache: planlib.PlanCache | None = None,
            impl: str | None = None, training: bool = False) -> torch.Tensor:
    """Per-voxel class logits (N, classes), zero on invalid rows.

    ``plans`` (from :func:`build_plans`) skips every plan lookup; without
    it the plans are built here through ``cache``. impl: None / ``"kernel"``
    runs both kernels (on the card), ``"ref"`` their plain versions;
    ``"scan"`` executes every layer by the plain tap scan
    (``plan.execute``), the reference's ``impl="xla"``, and searches with
    the kernel. The tensors of ``st`` must be on the model's device.

    Inference (the default) runs under ``torch.no_grad`` with the running
    BatchNorm statistics. ``training=True`` records the graph for
    autograd and normalizes by batch statistics, discarding the updated
    running statistics as the reference does.
    """
    with contextlib.nullcontext() if training else torch.no_grad():
        return _forward(model, st, plans, cache, impl, training)


def _forward(model, st, plans, cache, impl, training):
    cfg = model.cfg
    if plans is None:
        plans = build_plans(st.coords, st.batch, st.valid, cfg, cache=cache,
                            search_impl=None if impl == "scan" else impl,
                            device=st.coords.device)
    n_enc = len(cfg.enc)
    st = spconv.mask_feats(st._replace(feats=st.feats.float()))
    st, _ = _apply_subm(cfg, st, model.stem, plans.subm[0], impl, training)

    skips, maps_stack = [st], []
    for i in range(n_enc):
        stage = getattr(model, f"enc{i}")
        down, maps = spconv.gconv2(st, stage["down"].conv.w,
                                   stage["down"].conv.b, plan=plans.down[i],
                                   impl=impl)
        down, _ = spconv.batch_norm(down, stage["down"].bn.stats(),
                                    training=training)
        st = spconv.relu(down)
        act = None    # new resolution/channels: previous masks don't apply
        for b in range(cfg.blocks):
            st, act = _apply_subm(cfg, st, stage[f"block{b}"],
                                  plans.subm[i + 1], impl, training, act=act)
        maps_stack.append(maps)
        skips.append(st)

    for i in range(len(cfg.dec)):
        stage = getattr(model, f"dec{i}")
        target = skips[-(i + 2)]
        up = spconv.tconv2(st, stage["up"].conv.w, stage["up"].conv.b,
                           maps_stack[-(i + 1)], target, plan=plans.up[i],
                           impl=impl)
        up, _ = spconv.batch_norm(up, stage["up"].bn.stats(),
                                  training=training)
        up = spconv.relu(up)
        st = up.replace_feats(torch.cat([up.feats, target.feats], dim=-1))
        act = None    # concat changed the channel layout: masks are stale
        for b in range(cfg.blocks):
            st, act = _apply_subm(cfg, st, stage[f"block{b}"],
                                  plans.subm[n_enc - 1 - i], impl, training,
                                  act=act)

    logits = torch.matmul(st.feats, model.head.w[0]) + model.head.b
    return torch.where(st.valid[:, None], logits, 0.0)


def forward_multicloud(model: MinkUNet, clouds, *, plans=None,
                       cache: planlib.PlanCache | None = None,
                       impl: str | None = None, forward_fn=None,
                       on_error=None) -> list:
    """Per-voxel logits for each cloud; each keeps its own plans
    (``plans[i]`` prebuilt, or built through one shared ``cache``).

    Under an active device mesh (``runtime.sharding.set_mesh``) every
    Subm3 search routes through the sharded engine by ``search_impl``'s
    ``auto``, while each cloud still searches once a resolution; the plan
    keys carry the mesh fingerprint, so plans built under one mesh never
    serve another.

    The serving engine drives it with two hooks, as the reference's does:
    ``forward_fn(model, st, plans_i) -> logits`` replaces the forward of
    one cloud, and ``on_error(i, exc) -> result`` receives an exception
    raised by cloud ``i`` (a retry, or a placeholder once the engine
    isolated it) instead of aborting the clouds after it. None keeps the
    raise."""
    if cache is None and plans is None:
        per_cloud = 2 * (len(model.cfg.enc) + len(model.cfg.dec)) + 2
        cache = planlib.PlanCache(capacity=max(64, per_cloud * len(clouds)))
    out = []
    for i, st in enumerate(clouds):
        plans_i = plans[i] if plans is not None else None
        try:
            if forward_fn is not None:
                r = forward_fn(model, st, plans_i)
            else:
                r = forward(model, st, cache=cache, impl=impl, plans=plans_i)
        except Exception as e:                       # noqa: BLE001
            if on_error is None:
                raise
            r = on_error(i, e)
        out.append(r)
    return out


def segmentation_loss(model: MinkUNet, batch: Mapping[str, torch.Tensor], *,
                      plans: MinkPlans | None = None,
                      impl: str | None = None):
    """Masked per-voxel cross-entropy of a training forward.

    ``batch`` holds the :class:`SparseTensor` fields (``coords``, ``batch``,
    ``valid``, ``feats``) and ``labels`` (N,) int, as tensors on the
    model's device; ``plans`` and ``impl`` as in :func:`forward`. Returns
    ``(loss, {"ce": loss, "acc": acc})``: the float32 ``logsumexp`` NLL and
    the argmax accuracy, both averaged over the valid rows.
    """
    st = SparseTensor(batch["coords"], batch["batch"], batch["valid"],
                      batch["feats"])
    labels = batch["labels"].long()
    logits = forward(model, st, plans=plans, impl=impl,
                     training=True).float()
    lse = torch.logsumexp(logits, -1)
    # the label's logit as a masked sum, not a gather: the same value, and
    # a backward with no scatter (a gather's is an atomic scatter-add on
    # the card, which would make the step's result vary run to run)
    hit = torch.arange(logits.shape[-1], device=logits.device) \
        == labels[:, None]
    ll = torch.where(hit, logits, 0.0).sum(-1)
    nll = torch.where(st.valid, lse - ll, 0.0)
    n = st.valid.sum().clamp(min=1)
    loss = nll.sum() / n
    acc = (st.valid & (logits.argmax(-1) == labels)).sum() / n
    return loss, {"ce": loss, "acc": acc}
