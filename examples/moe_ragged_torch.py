"""The rulebook machinery wearing MoE clothes, on the PyTorch port: token
dispatch through ``build_tap_tiles`` and the materialized tiled GEMM
(``spconv_gemm``, csrc/spconv_gemm.cu).

A router assignment table is an IN-OUT map: (token -> expert) plays
(window -> tap). ``build_tap_tiles`` sorts the map stream per expert and
pads it to bm-row tiles, and the kernel multiplies each tile by its
expert's weights, skipping the padded ones (DESIGN.md §5). The port of
``examples/moe_ragged.py``: on the card the CUDA kernel runs, on the CPU
(``--device cpu``) its plain version; either is checked against the dense
per-expert loop (rtol = atol = 1e-4, the reference example's).

    PYTHONPATH=src python examples/moe_ragged_torch.py --device cpu
    PYTHONPATH=src python examples/moe_ragged_torch.py     # on the card
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.kernels.spconv_gemm.kernel import spconv_gemm
from repro_torch.models import moe

TOL = 1e-4     # rtol and atol against the dense loop, as the reference
T, D, F, E, K = 256, 64, 128, 4, 2     # tokens, dims, experts, top-k
BM = 8                                 # rows of a tile


def make_inputs(t: int, d: int, f: int, e: int, *, seed: int = 0,
                device=None):
    """x (T, D), the router (D, E) and the experts' weights (E, D, F),
    float32, drawn as the reference example draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d))
    w_router = rng.standard_normal((d, e)) * 0.1
    w_in = rng.standard_normal((e, d, f)) * 0.1
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (x, w_router, w_in))


def route(x: torch.Tensor, w_router: torch.Tensor, k: int) -> torch.Tensor:
    """The (T, E) kernel map of the router's top-k: token t's row holds t
    at its k experts and -1 elsewhere."""
    t, e = x.shape[0], w_router.shape[1]
    _, top = moe.top_k(x @ w_router, k)
    kmap = torch.full((t, e), -1, dtype=torch.int32, device=x.device)
    rows = torch.arange(t, dtype=torch.int32, device=x.device)
    return kmap.scatter_(1, top, rows[:, None].expand(t, k).contiguous())


def expert_gemm(x: torch.Tensor, w_in: torch.Tensor,
                tiles: sg_ops.TapTiles) -> torch.Tensor:
    """Kernel 3 over the tiles: (M_pad, F) rows, one a map slot, zeros for
    the padded slots. F must be a multiple of 128 (the kernel's column
    groups)."""
    lhs = x[tiles.gather_idx.long()]
    lhs.masked_fill_(~tiles.slot_valid[:, None], 0.0)
    return spconv_gemm(lhs, w_in, tiles.tile_tap, tiles.tile_nz,
                       bm=tiles.bm)


def dense_rows(x: torch.Tensor, w_in: torch.Tensor,
               tiles: sg_ops.TapTiles) -> torch.Tensor:
    """The dense per-expert loop: each valid slot's token times its
    expert's weights, in slot order."""
    valid = tiles.slot_valid
    tap = tiles.tile_tap.repeat_interleave(tiles.bm)[valid]
    src = tiles.gather_idx[valid].long()
    out = torch.empty((src.numel(), w_in.shape[2]), dtype=torch.float32,
                      device=x.device)
    for ee in range(w_in.shape[0]):
        sel = tap == ee
        out[sel] = x[src[sel]] @ w_in[ee]
    return out


def run(x: torch.Tensor, w_router: torch.Tensor, w_in: torch.Tensor, *,
        k: int, bm: int) -> dict:
    """Route, tile and multiply; returns the ``kmap``, the ``tiles``, the
    kernel's output ``h``, its valid rows ``got`` and the dense loop's
    ``want``."""
    kmap = route(x, w_router, k)
    tiles = sg_ops.build_tap_tiles(kmap, bm=bm)
    h = expert_gemm(x, w_in, tiles)
    return {"kmap": kmap, "tiles": tiles, "h": h,
            "got": h[tiles.slot_valid], "want": dense_rows(x, w_in, tiles)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x, w_router, w_in = make_inputs(T, D, F, E, device=dev)
    res = run(x, w_router, w_in, k=K, bm=BM)
    np.testing.assert_allclose(res["got"].cpu().numpy(),
                               res["want"].cpu().numpy(), rtol=TOL, atol=TOL)
    tiles = res["tiles"]
    live = int(tiles.tile_nz.sum())
    padded = int((~tiles.slot_valid).sum())
    print(f"routed {T} tokens x top-{K} through {E} experts as {live} live "
          f"tiles ({padded} padded slots skipped) on {dev}; kernel matches "
          f"dense loop")


if __name__ == "__main__":
    main()
