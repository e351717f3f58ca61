"""The work a request asks of the model, counted from the reference's
kernel maps (``bench/reference``), never from the program's plans.

A layer (``bench.reference.sparse.Layer``) costs ``2 x pairs x cin x
cout`` operations, where a pair is one (input, output, tap) of its kernel
map, or a dense layer's rows x taps. Its bytes are its valid input rows read once, its
output rows written once and its weights read once, in float32. A Subm3
map search (``bench.reference.sparse.Search``) moves each query's key (three coordinates
and a batch index) once, the table's key of each voxel once and the
27-tap kernel map of each voxel once.

Kernel maps never cross batch items and the head acts row by row, so the
layers of a request of several sweeps add up sweep by sweep
(:func:`merge`).
"""
from __future__ import annotations

FLOAT = 4
SPARSE = ("subm3", "gconv2", "tconv2")
SEARCH_BYTES_A_ROW = 4 * FLOAT + 4 + 27 * 4


def merge(per_sweep: list) -> list:
    """One request's layers from its sweeps' layer lists."""
    return [group[0]._replace(pairs=sum(g.pairs for g in group),
                              n_in=sum(g.n_in for g in group),
                              n_out=sum(g.n_out for g in group))
            for group in zip(*per_sweep)]


def flops(layers) -> int:
    return sum(2 * ly.pairs * ly.cin * ly.cout for ly in layers)


def gemm_bytes(layers) -> int:
    return sum(FLOAT * (ly.n_in * ly.cin + ly.n_out * ly.cout
                        + ly.taps * ly.cin * ly.cout) for ly in layers)


def search_bytes(searches) -> int:
    return sum(s.rows * SEARCH_BYTES_A_ROW for s in searches)


def sweep_work(ref, model: dict, coords, device) -> tuple:
    """``(layers, searches)`` of one sweep (batch item 0) of the family
    whose reference module is ``ref``."""
    import torch
    c = torch.as_tensor(coords, device=device)
    with torch.no_grad():
        g = ref.geometry(model, c, torch.zeros(c.shape[0], dtype=torch.int64,
                                               device=device))
    return ref.layers(model, g), ref.searches(model, g)


def request_work(sweeps: list) -> tuple:
    """``(layers, searches)`` of a request from its sweeps' works."""
    return (merge([s[0] for s in sweeps]),
            [s for sw in sweeps for s in sw[1]])
