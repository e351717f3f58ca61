"""SECOND — the paper's detection benchmark (Det(k)/Det(n)).

A sparse middle feature extractor over the SpOctA core (per stage one
Gconv3 stride-2 downsampling, then ``blocks`` Subm3 blocks), densified to a
bird's-eye-view (BEV) grid, then a small dense 2D RPN head. As in the
reference, the detection head is per-cell objectness plus box regression
on synthetic targets; the SpConv workload is the faithful part. Stage 0's
Gconv3 runs the paper's input-stationary dataflow (§IV-D3), the later
stages the output-stationary one through the gather-GEMM kernel.

:class:`SECOND` holds the parameters as an ``nn.Module`` whose
``state_dict`` keys are the reference's parameter-tree paths
(``stage0.down.conv.w``, ``stage1.block0.bn.var``, ``rpn.conv1``, ...); the
RPN weights are stored OIHW for ``F.conv2d`` where the reference keeps
HWIO, and :func:`params_from_jax` transposes them. :func:`forward` runs
inference under ``torch.no_grad``; :func:`detection_loss` is the training
objective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import plan as planlib
from repro_torch.core import segment
from repro_torch.core import spconv
from repro_torch.core.spconv import SparseTensor
from repro_torch.device import resolve_device
from repro_torch.models.minkunet import Conv, ConvBN
from repro_torch.models.minkunet import params_from_jax as _flatten


@dataclass(frozen=True)
class SECONDConfig:
    name: str = "second-small"
    in_ch: int = 4
    channels: tuple = (16, 32, 64)     # one per downsample stage
    blocks: int = 2                    # Subm3 per stage
    bev_hw: int = 64                   # BEV grid (after 3 downsamples)
    bev_z: int = 2                     # z-planes folded into channels
    head_ch: int = 128
    box_dim: int = 7                   # (x, y, z, w, l, h, yaw)
    grid_bits: int = 7
    batch_bits: int = 4
    n_batch: int = 2
    map_method: str = "octree"         # octree | sorted
    spac: bool = True
    bm: int = 128                      # rulebook tile rows
    bo: int | None = None              # output-block rows (None: 512)


SMALL = SECONDConfig()
LARGE = SECONDConfig(name="second-large", channels=(32, 64, 128), blocks=2,
                     bev_hw=128, head_ch=256)

#: the RPN head's weights, in the reference's order
_RPN = ("conv1", "conv2", "cls", "box")


class SECOND(nn.Module):
    """SECOND parameters plus the forward.

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; None
    uses a fresh one seeded 0): He-normal SpConv weights as in the
    reference's ``init_conv``, RPN weights normal x 0.05 as in its
    ``init_model``; then moved to ``device`` (None: the card; raises
    without one).
    """

    def __init__(self, cfg: SECONDConfig = SMALL, *,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        c_prev = cfg.in_ch
        for i, c in enumerate(cfg.channels):
            stage = nn.ModuleDict({"down": ConvBN(27, c_prev, c)})
            for b in range(cfg.blocks):
                stage[f"block{b}"] = ConvBN(27, c, c)
            setattr(self, f"stage{i}", stage)
            c_prev = c
        bev_c, h = c_prev * cfg.bev_z, cfg.head_ch
        shapes = {"conv1": (h, bev_c, 3, 3), "conv2": (h, h, 3, 3),
                  "cls": (1, h, 1, 1), "box": (cfg.box_dim, h, 1, 1)}
        self.rpn = nn.ParameterDict({k: nn.Parameter(torch.empty(shapes[k]))
                                     for k in _RPN})
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Conv):
                    k, cin, _ = mod.w.shape
                    mod.w.copy_(torch.randn(mod.w.shape, generator=gen)
                                * (2.0 / (k * cin)) ** 0.5)
            for k in _RPN:
                self.rpn[k].copy_(torch.randn(shapes[k], generator=gen)
                                  * 0.05)
        self.to(dev)

    def forward(self, st: SparseTensor, *,
                cache: planlib.PlanCache | None = None,
                impl: str | None = None):
        """``(cls (B, H, W), box (B, H, W, box_dim))``; see
        :func:`forward`."""
        return forward(self, st, cache=cache, impl=impl)


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A reference parameter tree (``repro.models.second.init_model``'s,
    or its gradients, leaves as numpy arrays) as a :class:`SECOND`
    ``state_dict``: the RPN weights go from HWIO to OIHW."""
    out = _flatten(tree)
    for k in _RPN:
        out[f"rpn.{k}"] = out[f"rpn.{k}"].permute(3, 2, 0, 1).contiguous()
    return out


def middle_extractor(model: SECOND, st: SparseTensor, *,
                     training: bool = False,
                     cache: planlib.PlanCache | None = None,
                     impl: str | None = None) -> SparseTensor:
    """The sparse backbone: per stage a Gconv3 (input-stationary in stage
    0, output-stationary after it) + BatchNorm + ReLU, then ``blocks``
    Subm3 + BatchNorm + ReLU blocks.

    One :class:`PlanCache` per call (``cache``, or a fresh one), so the
    Subm3 blocks of a stage share one map search: a forward searches 2 x
    ``len(channels)`` times, plus one failed probe per Gconv3 whose output
    budget overflows (the escalated budget is memoized, so only the first
    forward of a shape class pays it). impl: None / ``"kernel"`` runs both
    kernels (on the card), ``"ref"`` their plain versions; ``"scan"``
    executes every layer by the plain tap scan and searches with the
    kernel.
    """
    cfg = model.cfg
    if cache is None:
        cache = planlib.PlanCache()
    search_impl = None if impl == "scan" else impl
    kw = dict(grid_bits=cfg.grid_bits, batch_bits=cfg.batch_bits,
              cache=cache, impl=impl, bm=cfg.bm, bo=cfg.bo)
    st = spconv.mask_feats(st._replace(feats=st.feats.float()))
    for i in range(len(cfg.channels)):
        stage = getattr(model, f"stage{i}")
        down, _ = spconv.gconv3(
            st, stage["down"].conv.w, stage["down"].conv.b,
            dataflow="input_stationary" if i == 0 else "output_stationary",
            **kw)
        down, _ = spconv.batch_norm(down, stage["down"].bn.stats(),
                                    training=training)
        st = spconv.relu(down)
        for b in range(cfg.blocks):
            blk = stage[f"block{b}"]
            st = spconv.subm_conv3(st, blk.conv.w, blk.conv.b,
                                   max_blocks=st.n_max,
                                   method=cfg.map_method, spac=cfg.spac,
                                   search_impl=search_impl, **kw)
            st, _ = spconv.batch_norm(st, blk.bn.stats(), training=training)
            st = spconv.relu(st)
    return st


def to_bev(st: SparseTensor, cfg: SECONDConfig) -> torch.Tensor:
    """Scatter the sparse voxels into a dense (B, H, W, Z * C) BEV tensor.

    Coordinates are clipped into the (bev_hw, bev_hw, bev_z) grid; invalid
    rows and rows whose batch index is ``n_batch`` or more are dropped.
    Voxels that land in one cell add up in ascending row order, the
    reference's scatter order (:func:`segment.ordered_sum`: one launch
    of the segment-sum kernel on the card, and two runs give the same
    bits). On the card nothing is read back to the host.
    """
    hw, z = cfg.bev_hw, cfg.bev_z
    size = cfg.n_batch * hw * hw * z
    x = st.coords[:, 0].clamp(0, hw - 1).long()
    y = st.coords[:, 1].clamp(0, hw - 1).long()
    zz = st.coords[:, 2].clamp(0, z - 1).long()
    flat = ((st.batch.long() * hw + x) * hw + y) * z + zz
    flat = torch.where(st.valid, flat, size)
    bev = segment.ordered_sum(st.feats, segment.segments((flat, size))[0])
    return bev.reshape(cfg.n_batch, hw, hw, z * st.feats.shape[-1])


def rpn_relu(x: torch.Tensor) -> torch.Tensor:
    """The RPN head's ReLU, looked up at call time like ``spconv.relu``, so
    a caller can wrap both to record or pin every ReLU mask of a pass."""
    return torch.relu(x)


class _Conv(torch.autograd.Function):
    """``F.conv2d`` at stride 1 whose backward runs with cuDNN held to its
    deterministic algorithms. cuDNN's default weight and input gradients
    at the RPN's shapes add partial sums in an order that changes from run
    to run (two ``detection_loss`` steps of SECOND-large on an H100 gave
    different gradients); XLA's convolutions in the reference do not."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return F.conv2d(x, w, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [ctx.padding] * 2, [1, 1], False,
                [0, 0], 1, [*ctx.needs_input_grad[:2], False])
        finally:
            torch.backends.cudnn.deterministic = prev
        return gx, gw, None


def rpn_head(rpn: Mapping[str, torch.Tensor], bev: torch.Tensor):
    """Two 3x3 convolutions with ReLU, then 1x1 objectness and box heads.

    ``bev`` is NHWC as :func:`to_bev` lays it out; the reference's "SAME"
    stride-1 convolutions are ``F.conv2d(padding=1)`` on its NCHW view,
    with a backward that gives the same bits from run to run (``_Conv``).
    Returns ``cls`` (B, H, W) and ``box`` (B, H, W, box_dim).
    """
    x = bev.permute(0, 3, 1, 2)
    h = rpn_relu(_Conv.apply(x, rpn["conv1"].to(x.dtype), 1))
    h = rpn_relu(_Conv.apply(h, rpn["conv2"].to(x.dtype), 1))
    cls = _Conv.apply(h, rpn["cls"].to(x.dtype), 0)[:, 0]
    box = _Conv.apply(h, rpn["box"].to(x.dtype), 0).permute(0, 2, 3, 1)
    return cls, box


def forward(model: SECOND, st: SparseTensor, *,
            cache: planlib.PlanCache | None = None, impl: str | None = None):
    """Inference: ``middle_extractor`` (running BatchNorm statistics),
    ``to_bev`` and ``rpn_head`` under ``torch.no_grad``. The tensors of
    ``st`` must be on the model's device."""
    with torch.no_grad():
        mid = middle_extractor(model, st, cache=cache, impl=impl)
        return rpn_head(model.rpn, to_bev(mid, model.cfg))


def detection_loss(model: SECOND, batch: Mapping[str, torch.Tensor], *,
                   impl: str | None = None):
    """The reference's training objective on a training forward.

    ``batch`` holds the :class:`SparseTensor` fields (``coords``, ``batch``,
    ``valid``, ``feats``), ``objectness`` (B, H, W) and ``boxes`` (B, H, W,
    box_dim), as tensors on the model's device. BatchNorm normalizes by
    the batch statistics, and the updated running statistics are
    discarded, as the reference does. Returns ``(loss, {"cls", "box"})``:
    the mean logistic loss of the objectness logits plus twice the Huber
    loss of the boxes over the positive cells.
    """
    st = SparseTensor(batch["coords"], batch["batch"], batch["valid"],
                      batch["feats"])
    mid = middle_extractor(model, st, training=True, impl=impl)
    cls, box = rpn_head(model.rpn, to_bev(mid, model.cfg))
    obj = batch["objectness"].float()
    cls32 = cls.float()
    # maximum, not relu: its gradient at a tie is 1/2, as the reference's
    cls_loss = torch.mean(torch.maximum(cls32, torch.zeros_like(cls32))
                          - cls32 * obj
                          + torch.log1p(torch.exp(-cls32.abs())))
    diff = box.float() - batch["boxes"].float()
    huber = torch.where(diff.abs() < 1.0, 0.5 * diff ** 2, diff.abs() - 0.5)
    box_loss = (huber * obj[..., None]).sum() / obj.sum().clamp(min=1.0)
    return cls_loss + 2.0 * box_loss, {"cls": cls_loss, "box": box_loss}


def loss_and_grads(model: SECOND, batch: Mapping[str, torch.Tensor], *,
                   impl: str | None = None):
    """``(loss, metrics, grads)`` of :func:`detection_loss` at the model's
    current weights. ``grads`` has every ``state_dict`` key: the BatchNorm
    statistics, leaves of the reference's tree, get zeros."""
    model.zero_grad(set_to_none=True)
    loss, metrics = detection_loss(model, batch, impl=impl)
    loss.backward()
    trainable = dict(model.named_parameters())
    grads = {k: trainable[k].grad if k in trainable
             and trainable[k].grad is not None else torch.zeros_like(t)
             for k, t in model.state_dict().items()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads
