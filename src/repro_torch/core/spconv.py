"""SpConv layers: Subm3 / Gconv2 / Gconv3 / Tconv2 (paper §II-A3, §IV-D).

Functional layers over a padded, mask-carrying :class:`SparseTensor`. Each
layer is map search (a cached :class:`~repro_torch.core.plan.ConvPlan`) plus
rulebook execution through the gather-GEMM kernel. Weights keep the
reference layout ``(K, Cin, Cout)``. BatchNorm has the reference's training
form (batch statistics of the valid rows) and its inference form.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from repro_torch.core import plan as planlib
from repro_torch.core import rulebook, validate
from repro_torch.core.mapsearch import StridedMaps
from repro_torch.core.sparsity import ActSparsity
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.runtime import guard


class SparseTensor(NamedTuple):
    """COO sparse tensor (eq. 1) with a static row budget + validity mask."""

    coords: torch.Tensor   # (N, 3) int32 voxel coordinates
    batch: torch.Tensor    # (N,) int32 batch index
    valid: torch.Tensor    # (N,) bool
    feats: torch.Tensor    # (N, C) float32

    @property
    def n_max(self) -> int:
        return self.coords.shape[0]

    def replace_feats(self, feats: torch.Tensor) -> "SparseTensor":
        return self._replace(feats=feats)


def _zero_invalid(valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def mask_feats(st: SparseTensor) -> SparseTensor:
    """Zero features on invalid rows (keeps padding inert through matmuls)."""
    return st.replace_feats(_zero_invalid(st.valid, st.feats))


def make_sparse_tensor(coords, batch, valid, feats, *, grid_bits: int = 7,
                       batch_bits: int = 4, policy=None):
    """The ingress guard's constructor: runs
    :func:`~repro_torch.core.validate.sanitize_cloud` over the raw stream
    (non-finite coordinates, out-of-grid voxels, duplicates, dtype drift)
    under ``policy`` (None: ``REPRO_GUARD_VALIDATE``), then wraps it.

    Repairs only clear ``valid`` bits and cast dtypes; shapes never
    change. Returns ``(SparseTensor, CloudReport)``, the report None when
    the policy is ``off``; a clean cloud passes the original objects
    through, so a plan cache's identity keys still hit.
    """
    pol = policy if policy is not None else guard.validate_policy()
    if pol is not None:
        coords, batch, valid, feats, report = validate.sanitize_cloud(
            coords, batch, valid, feats, grid_bits=grid_bits,
            batch_bits=batch_bits, policy=pol)
    else:
        report = None
    return SparseTensor(coords=coords, batch=batch, valid=valid,
                        feats=feats), report


def subm_conv3(st: SparseTensor, w: torch.Tensor, b: torch.Tensor | None,
               *, max_blocks: int, method: str = "octree",
               grid_bits: int = 7, batch_bits: int = 4,
               spac: bool = True, act: ActSparsity | None = None,
               plan: planlib.ConvPlan | None = None,
               cache: planlib.PlanCache | None = None,
               impl: str | None = None, search_impl: str | None = None,
               bm: int = 128, bo: int | None = None) -> SparseTensor:
    """Submanifold 3x3x3 SpConv (Subm3): coordinates unchanged.

    Pass ``cache`` to share the map search across stacked blocks, or
    ``plan`` to reuse a prebuilt one. ``act`` threads the previous layer's
    epilogue-emitted liveness instead of a fresh row sweep.
    """
    if plan is None:
        plan = planlib.subm3_plan(st.coords, st.batch, st.valid,
                                  max_blocks=max_blocks, method=method,
                                  grid_bits=grid_bits, batch_bits=batch_bits,
                                  bm=bm, bo=bo, search_impl=search_impl,
                                  cache=cache)
    out = planlib.execute(plan, st.feats, w, b, spac=spac, act=act,
                          impl=impl)
    return st.replace_feats(_zero_invalid(st.valid, out))


def fold_bn_inference(conv_bias: torch.Tensor | None,
                      bn: Mapping[str, torch.Tensor], *, eps: float = 1e-5):
    """Fold conv bias + inference BatchNorm into the epilogue affine.

    ``y = (conv + b - mean) * rsqrt(var + eps) * scale + bias`` becomes
    ``y = conv * s + t`` with ``s = scale * rsqrt(var + eps)`` and
    ``t = (b - mean) * s + bias``. Returns ``(s, t)`` float32.
    """
    s = bn["scale"].float() * torch.rsqrt(bn["var"].float() + eps)
    b = 0.0 if conv_bias is None else conv_bias.float()
    t = (b - bn["mean"].float()) * s + bn["bias"].float()
    return s, t


def subm_conv3_bn_relu(st: SparseTensor, w: torch.Tensor,
                       b: torch.Tensor | None, bn: Mapping[str, torch.Tensor],
                       *, max_blocks: int, grid_bits: int = 7,
                       batch_bits: int = 4, spac: bool = True,
                       act: ActSparsity | None = None, eps: float = 1e-5,
                       plan: planlib.ConvPlan | None = None,
                       cache: planlib.PlanCache | None = None,
                       impl: str | None = None,
                       search_impl: str | None = None, bm: int = 128,
                       bo: int | None = None):
    """Subm3 + inference BatchNorm + ReLU with the fused kernel epilogue.

    Returns ``(SparseTensor, ActSparsity)``; thread the act into the next
    Subm3 at the same resolution to skip its liveness sweep.
    """
    if plan is None:
        plan = planlib.subm3_plan(st.coords, st.batch, st.valid,
                                  max_blocks=max_blocks, grid_bits=grid_bits,
                                  batch_bits=batch_bits, bm=bm, bo=bo,
                                  search_impl=search_impl, cache=cache)
    scale, shift = fold_bn_inference(b, bn, eps=eps)
    epi = sg_ops.FusedEpilogue(scale=scale, shift=shift, valid=st.valid)
    out, out_act = planlib.execute(plan, st.feats, w, None, spac=spac,
                                   act=act, epilogue=epi, impl=impl)
    return st.replace_feats(out), out_act


def gconv2(st: SparseTensor, w: torch.Tensor, b: torch.Tensor | None, *,
           grid_bits: int = 7, batch_bits: int = 4,
           plan: planlib.ConvPlan | None = None,
           cache: planlib.PlanCache | None = None, impl: str | None = None,
           bm: int = 128,
           bo: int | None = None) -> tuple[SparseTensor, StridedMaps]:
    """Generalized 2x2x2 stride-2 SpConv (downsampling). Returns the new
    tensor and the maps, so Tconv2 can reuse them."""
    if plan is None:
        plan = planlib.gconv2_plan(st.coords, st.batch, st.valid,
                                   grid_bits=grid_bits, batch_bits=batch_bits,
                                   bm=bm, bo=bo, cache=cache)
    out = planlib.execute(plan, st.feats, w, b, spac=False, impl=impl)
    new = SparseTensor(coords=plan.out_coords, batch=plan.out_batch,
                       valid=plan.out_valid,
                       feats=_zero_invalid(plan.out_valid, out))
    return new, plan.maps


def gconv3(st: SparseTensor, w: torch.Tensor, b: torch.Tensor | None, *,
           grid_bits: int = 7, batch_bits: int = 4,
           dataflow: str = "output_stationary",
           plan: planlib.ConvPlan | None = None,
           cache: planlib.PlanCache | None = None, impl: str | None = None,
           bm: int = 128,
           bo: int | None = None) -> tuple[SparseTensor, StridedMaps]:
    """Generalized 3x3x3 stride-2 SpConv (downsampling), in either dataflow:
    ``"output_stationary"`` executes the plan's tiles through the
    gather-GEMM kernel, ``"input_stationary"`` scatter-adds per-tap partial
    sums over the plan's maps (:func:`rulebook.apply_maps_scatter`).

    The output budget starts at ``st.n_max``; a stride-2 window can reach
    more output sites than there are inputs, so an overflowing build is
    replanned at an escalated budget (``runtime.guard.with_replan``,
    memoized per shape class, so a loop pays the failed probe once). With
    ``REPRO_GUARD_REPLAN=0`` the overflow raises instead. Returns the new
    tensor (``budget`` rows) and the maps.
    """
    if dataflow not in ("output_stationary", "input_stationary"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if plan is None:
        def build(budget):
            return planlib.gconv3_plan(
                st.coords, st.batch, st.valid, grid_bits=grid_bits,
                batch_bits=batch_bits, out_budget=budget, bm=bm, bo=bo,
                with_tiles=dataflow != "input_stationary", cache=cache)

        if guard.replan_retries() > 0:
            plan = guard.with_replan(
                build, st.n_max,
                key=("gconv3", st.n_max, grid_bits, batch_bits, dataflow))
        else:
            plan = build(st.n_max)
    if dataflow == "input_stationary":
        out = rulebook.apply_maps_scatter(st.feats, w, plan.maps, b,
                                          n_out=plan.n_out, n_taps=27)
    else:
        out = _zero_invalid(plan.out_valid, planlib.execute(
            plan, st.feats, w, b, spac=False, impl=impl))
    new = SparseTensor(coords=plan.out_coords, batch=plan.out_batch,
                       valid=plan.out_valid, feats=out)
    return new, plan.maps


def tconv2(st: SparseTensor, w: torch.Tensor, b: torch.Tensor | None,
           gconv2_maps: StridedMaps, target: SparseTensor, *,
           plan: planlib.ConvPlan | None = None,
           cache: planlib.PlanCache | None = None, impl: str | None = None,
           bm: int = 128, bo: int | None = None) -> SparseTensor:
    """Transposed 2x2x2 stride-2 SpConv: recovers the coordinate set from
    before the paired Gconv2 by transposing its maps."""
    if plan is None:
        plan = planlib.tconv2_plan(gconv2_maps, target.coords, target.batch,
                                   target.valid, bm=bm, bo=bo, cache=cache)
    out = planlib.execute(plan, st.feats, w, b, spac=False, impl=impl)
    return SparseTensor(coords=target.coords, batch=target.batch,
                        valid=target.valid,
                        feats=_zero_invalid(target.valid, out))


def batch_norm(st: SparseTensor, bn: Mapping[str, torch.Tensor], *,
               training: bool, momentum: float = 0.9, eps: float = 1e-5):
    """Masked BatchNorm over the valid rows; returns ``(st, new_stats)``.

    Training normalizes by the batch statistics of the valid rows (``n =
    max(valid.sum(), 1)``, biased variance) and returns ``bn`` with the
    momentum-updated running ``mean`` and ``var``; inference uses the
    running statistics and returns ``bn`` as it is.
    """
    f = st.feats.float()
    mask = st.valid[:, None]
    if training:
        n = st.valid.sum().clamp(min=1).float()
        mean = (f * mask).sum(0) / n
        var = ((f - mean) ** 2 * mask).sum(0) / n
        new_stats = {**bn,
                     "mean": momentum * bn["mean"] + (1 - momentum) * mean,
                     "var": momentum * bn["var"] + (1 - momentum) * var}
    else:
        mean, var = bn["mean"].float(), bn["var"].float()
        new_stats = bn
    y = (f - mean) * torch.rsqrt(var + eps) * bn["scale"] + bn["bias"]
    return (st.replace_feats(_zero_invalid(st.valid, y).to(st.feats.dtype)),
            new_stats)


def relu(st: SparseTensor) -> SparseTensor:
    """The source of the paper's 40-60% inherent sparsity."""
    return st.replace_feats(torch.relu(st.feats))
