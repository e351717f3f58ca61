"""The work counts against hand-counted geometries, and their
independence of the program's tiling."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench import testing, workcount
from bench.reference import minkunet as ref_mk


def _layers(ref, model, coords):
    return workcount.sweep_work(ref, model, np.asarray(coords), "cpu")


def test_a_2x2x2_cube_by_hand():
    """Eight voxels of one cube: each sees all eight in its 3x3x3 window,
    so every Subm3 has 64 pairs at level 0; Gconv2 sends the eight to one
    parent (8 pairs), and Tconv2 back (8)."""
    model = {"in_ch": 4, "classes": 5, "stem": 8, "enc": [16], "dec": [8],
             "blocks": 1, "grid_bits": 7, "batch_bits": 4}
    cube = [[x, y, z] for x in (2, 3) for y in (2, 3) for z in (2, 3)]
    layers, searches = _layers(ref_mk, model, cube)
    got = {ly.name: (ly.pairs, ly.n_in, ly.n_out) for ly in layers}
    assert got == {"stem": (64, 8, 8), "enc0.down": (8, 8, 1),
                   "enc0.block0": (1, 1, 1), "dec0.up": (8, 1, 8),
                   "dec0.block0": (64, 8, 8), "head": (8, 8, 8)}
    assert [s.rows for s in searches] == [8, 1]
    flops = workcount.flops(layers)
    assert flops == 2 * (64 * 4 * 8 + 8 * 8 * 16 + 16 * 16 + 8 * 16 * 8
                         + 64 * 16 * 8 + 8 * 8 * 5)
    assert workcount.search_bytes(searches) == 9 * (16 + 4 + 27 * 4)


def test_two_sweeps_add_up_layer_by_layer():
    """Kernel maps never cross batch items and the head acts row by row,
    so a request of two sweeps counts what the two count apart."""
    model = testing.small_config("minkunet-semkitti")["model"]
    a = [[10, 10, 10], [11, 10, 10], [12, 12, 12]]
    b = [[40, 40, 9], [41, 41, 9]]
    wa, wb = _layers(ref_mk, model, a), _layers(ref_mk, model, b)
    layers, searches = workcount.request_work([wa, wb])
    whole = torch.tensor(a + b)
    g = ref_mk.geometry(model, whole, torch.tensor([0, 0, 0, 1, 1]))
    direct = ref_mk.layers(model, g)
    assert [(ly.name, ly.pairs, ly.n_in, ly.n_out) for ly in layers] == \
        [(ly.name, ly.pairs, ly.n_in, ly.n_out) for ly in direct]
    assert len(searches) == 2 * (len(model["enc"]) + 1)
    assert layers[-1].name == "head" and layers[-1].pairs == 5


def test_counts_do_not_move_with_the_programs_tiling():
    """The program's rulebook tile rows (``bm``) and output blocks
    (``bo``) are no input of the counts: the same cloud counts the same
    under the port's configurations at other tilings."""
    from repro_torch.models import minkunet
    base = np.random.default_rng(4).integers(0, 40, (300, 3))
    base = np.unique(base, axis=0)
    counts = set()
    for bm, bo in ((128, None), (64, 256), (256, 1024)):
        cfg = dataclasses.replace(minkunet.SMALL, bm=bm, bo=bo)
        model = {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in dataclasses.asdict(cfg).items()}
        layers, searches = _layers(ref_mk, model, base)
        counts.add((workcount.flops(layers), workcount.gemm_bytes(layers),
                    workcount.search_bytes(searches)))
    assert len(counts) == 1


def test_kernel2_bound_leaves_out_the_linear_head():
    from bench import harness
    mod = harness._load(testing.ROOT, "metrics", "spconv_gemm_roofline")
    model = testing.small_config("minkunet-semkitti")["model"]
    layers, _ = _layers(ref_mk, model, [[10, 10, 10], [11, 11, 11]])
    on = [ly for ly in layers if ly.name != "head"]
    assert len(on) == len(layers) - 1
    assert mod.bound_s(layers) == mod.bound_s(on) > 0
