"""Plain sparse convolution in PyTorch: the benchmark's reference layers.

Independent of the program under test: every kernel map is worked out
here from the coordinates, by sorting integer keys and binary search, and
every layer is a per-tap gather, matrix product and scatter in float32.
Rows are compact (no padding): a cloud is ``coords`` (N, 3) int and
``batch`` (N,) int of its valid voxels only.

Layer semantics (SpOctA section II-A3):

* Subm3: output i takes input j through tap t when ``coords[j] ==
  coords[i] + OFFSETS27[t]`` in the same batch item; taps run x fastest.
* Gconv2 (k 2, s 2): input i feeds its parent ``coords[i] >> 1`` through
  tap ``(x & 1) | (y & 1) << 1 | (z & 1) << 2``.
* Tconv2: the transpose of the paired Gconv2, back onto its input rows.

``precision="tf32"`` rounds both operands of every product to TF32's
10-bit mantissa (round to nearest even) and sums in float32: the
arithmetic of the tensor cores with TF32 on, the precision just below the
float32 that the configurations state. It is the control of the
benchmark's comparison. Float32 runs with TF32 off (:func:`float32_mode`).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

#: the 27 Subm3 offsets in tap order (x fastest, then y, then z)
OFFSETS27 = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
             for dx in (-1, 0, 1)]

_SPAN = 1 << 13          # key radix: coordinates in [-1, 8190]


@contextlib.contextmanager
def float32_mode():
    """TF32 off for matrix products and cuDNN convolutions, restored on
    exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    i = torch.where(i > 0x7FFFFFFF, i - (1 << 32), i)
    return i.to(torch.int32).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return tf32_round(a) @ tf32_round(b)
    return a @ b


def _key(coords: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    c = coords.long() + 1
    return ((batch.long() * _SPAN + c[:, 0]) * _SPAN + c[:, 1]) * _SPAN \
        + c[:, 2]


class Down(NamedTuple):
    """A strided layer's geometry: the output set and its gather map."""

    coords: torch.Tensor   # (M, 3) int64
    batch: torch.Tensor    # (M,) int64
    kmap: torch.Tensor     # (M, K) int64 input row, -1 none


def subm3_kmap(coords: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """(N, 27) int64: the input row of each output and tap, -1 none."""
    n = coords.shape[0]
    skey, order = torch.sort(_key(coords, batch))
    kmap = torch.full((n, 27), -1, dtype=torch.int64, device=coords.device)
    if n == 0:
        return kmap
    for t, off in enumerate(OFFSETS27):
        q = _key(coords + torch.tensor(off, device=coords.device), batch)
        pos = torch.searchsorted(skey, q).clamp(max=n - 1)
        kmap[:, t] = torch.where(skey[pos] == q, order[pos], -1)
    return kmap


def _unique_outputs(out_coords, out_batch, src, tap, n_taps) -> Down:
    """The unique ``(out_coords, out_batch)`` sites and the gather map that
    sends ``src[m]`` to its site through ``tap[m]``."""
    key = _key(out_coords, out_batch)
    uniq, inv = torch.unique(key, return_inverse=True)
    m = uniq.shape[0]
    coords = torch.zeros((m, 3), dtype=torch.int64, device=key.device)
    batch = torch.zeros((m,), dtype=torch.int64, device=key.device)
    coords[inv] = out_coords.long()
    batch[inv] = out_batch.long()
    kmap = torch.full((m, n_taps), -1, dtype=torch.int64, device=key.device)
    kmap[inv, tap] = src
    return Down(coords, batch, kmap)


def gconv2_geometry(coords: torch.Tensor, batch: torch.Tensor) -> Down:
    c = coords.long()
    tap = (c[:, 0] & 1) | ((c[:, 1] & 1) << 1) | ((c[:, 2] & 1) << 2)
    src = torch.arange(c.shape[0], device=c.device)
    return _unique_outputs(c >> 1, batch, src, tap, 8)


def transpose_kmap(down: Down, n_in: int) -> torch.Tensor:
    """The Tconv2 gather map (n_in, 8) of a Gconv2: each row of the finer
    set takes its parent through its own tap."""
    kmap = torch.full((n_in, 8), -1, dtype=torch.int64,
                      device=down.kmap.device)
    out_rows, taps = (down.kmap >= 0).nonzero(as_tuple=True)
    kmap[down.kmap[out_rows, taps], taps] = out_rows
    return kmap


def gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """``max |out - ref| / max |ref|``; ``out`` may have more rows than
    ``ref`` (padding), which count against zero."""
    out = torch.as_tensor(out).float().to(ref.device)
    ref = ref.float()
    if out.shape[0] > ref.shape[0]:
        ref = torch.cat([ref, ref.new_zeros((out.shape[0] - ref.shape[0],)
                                            + tuple(ref.shape[1:]))])
    if out.shape != ref.shape:
        return float("inf")
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def pairs(kmap: torch.Tensor) -> int:
    return int((kmap >= 0).sum())


def conv(feats: torch.Tensor, kmap: torch.Tensor, w: torch.Tensor,
         b: torch.Tensor | None, precision: str) -> torch.Tensor:
    """``out[i] = b + sum_t feats[kmap[i, t]] @ w[t]``, taps in order."""
    out = torch.zeros((kmap.shape[0], w.shape[2]), dtype=torch.float32,
                      device=feats.device)
    for t in range(kmap.shape[1]):
        rows = (kmap[:, t] >= 0).nonzero().squeeze(1)
        if rows.numel():
            out[rows] += matmul(feats[kmap[rows, t]], w[t], precision)
    return out if b is None else out + b


def bn_relu(x: torch.Tensor, p: dict, name: str,
            eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm with the running statistics, then ReLU."""
    y = (x - p[f"{name}.mean"]) * torch.rsqrt(p[f"{name}.var"] + eps) \
        * p[f"{name}.scale"] + p[f"{name}.bias"]
    return torch.relu(y)


def conv_bn_relu(x, kmap, p: dict, name: str, precision: str):
    """The ``ConvBN`` block ``name``: conv (``name.conv.w``, ``.b``), BN,
    ReLU."""
    return bn_relu(conv(x, kmap, p[f"{name}.conv.w"], p[f"{name}.conv.b"],
                        precision), p, f"{name}.bn")


class Layer(NamedTuple):
    """One layer's geometry for the work counts (``bench/workcount.py``)."""

    name: str       # the weight prefix, as the state_dict names it
    kind: str       # subm3 | gconv2 | tconv2 | dense
    taps: int
    cin: int
    cout: int
    pairs: int      # input-output-tap triples (dense: rows x taps)
    n_in: int       # valid input rows
    n_out: int      # valid output rows


class Search(NamedTuple):
    """One Subm3 map search: the coordinate set of one resolution."""

    name: str
    rows: int


def spconv_spec(k: int, cin: int, cout: int, name: str) -> dict:
    """The weight spec of one ``ConvBN`` block (``bench/weights.py``)."""
    return {f"{name}.conv.w": ((k, cin, cout), ("normal", (2.0 / (k * cin))
                                                ** 0.5)),
            f"{name}.conv.b": ((cout,), ("uniform", -0.1, 0.1)),
            f"{name}.bn.scale": ((cout,), ("uniform", 0.5, 1.5)),
            f"{name}.bn.bias": ((cout,), ("uniform", -0.2, 0.2)),
            f"{name}.bn.mean": ((cout,), ("uniform", -0.2, 0.2)),
            f"{name}.bn.var": ((cout,), ("uniform", 0.5, 2.0))}
