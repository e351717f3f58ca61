"""The traffic generator: seeded, fresh geometry never repeats, the
relabellings keep every layer's pair counts, the revisit hot set."""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from bench import testing, workcount
from bench.reference import minkunet as ref_mk
from bench.traffic import lidar

CONFIG = "minkunet-semkitti"


def _stream(cell: str, seed: int) -> lidar.Stream:
    return lidar.Stream(testing.small_params(f"{CONFIG}.{cell}"),
                        testing.small_config(CONFIG), seed)


def _key(req) -> str:
    """The content key the program's plan cache sees: coordinates, batch
    and the valid rows."""
    return hashlib.sha256(req["coords"].tobytes() + req["batch"].tobytes()
                          + len(req["coords"]).to_bytes(8, "little")
                          ).hexdigest()


@pytest.mark.parametrize("cell", ["fresh", "revisit"])
def test_a_seed_gives_the_same_requests(cell):
    a, b = _stream(cell, 2**40 + 1), _stream(cell, 2**40 + 1)
    c = _stream(cell, 2**40 + 2)
    for i in (0, 5, 17):
        ra, rb, rc = a.request(i), b.request(i), c.request(i)
        for k in ("coords", "batch", "feats"):
            assert np.array_equal(ra[k], rb[k])
        assert not np.array_equal(ra["feats"], rc["feats"])
    if cell == "fresh":
        assert [_key(a.request(i)) for i in range(8)] != \
            [_key(c.request(i)) for i in range(8)]


def test_fresh_requests_never_share_a_content_key():
    s = _stream("fresh", 77)
    n = min(s.capacity(), 400)
    keys = {_key(s.request(i)) for i in range(n)}
    assert len(keys) == n
    with pytest.raises(RuntimeError):
        s.request(s.capacity())


def test_every_base_is_dealt_once_a_round():
    s = _stream("fresh", 5)
    b = len(s.bases)
    for r in range(3):
        used = sorted(s.request(r * b + j)["parts"][0][0] for j in range(b))
        assert used == list(range(b))


def test_the_revisit_hot_set_holds_four_geometries():
    s = _stream("revisit", 9)
    keys = [_key(s.request(i)) for i in range(60)]
    assert len(set(keys[:4])) == 4 and set(keys) == set(keys[:4])
    feats = {s.request(i)["feats"].tobytes() for i in range(60)}
    assert len(feats) == 60


def _pairs(ref, model, coords):
    layers, searches = workcount.sweep_work(ref, model, coords, "cpu")
    return [(ly.name, ly.pairs, ly.n_in, ly.n_out) for ly in layers], \
        [s.rows for s in searches]


@pytest.mark.parametrize("sym", range(8))
def test_relabellings_keep_every_layers_pair_counts(sym):
    config = testing.small_config(CONFIG)
    rel = config["relabel"]
    base = lidar.base_sweep(3, 0, testing.SENSOR, 4096, 2048)
    want = _pairs(ref_mk, config["model"], base)
    for shift in (0, 7 * rel["z_step"]):
        c = lidar.relabel(base, rel["symmetries"], sym, shift, 2048)
        assert c.min() >= 0 and c.max() < 2048
        assert _pairs(ref_mk, config["model"], c) == want, (sym, shift)


def test_a_shift_off_the_z_step_would_change_pair_counts():
    """Why the z shift is a multiple of 16: four stride-2 levels group
    coordinates by 16, and a shift of 8 regroups them."""
    model = testing.small_config(CONFIG)["model"]
    base = lidar.base_sweep(3, 0, testing.SENSOR, 4096, 2048)
    moved = lidar.relabel(base, "d4", 0, 8, 2048)
    assert _pairs(ref_mk, model, moved) != _pairs(ref_mk, model, base)


def test_request_rows_stay_inside_the_admission_contract():
    s = _stream("fresh", 123)
    for i in range(0, 200, 7):
        r = s.request(i)
        assert r["coords"].dtype == np.int32 and r["coords"].min() >= 0
        assert r["coords"].max() < 2048
        assert len(np.unique(r["coords"], axis=0)) == len(r["coords"])
        assert r["feats"].shape == (len(r["coords"]), 4)
        assert torch.as_tensor(r["feats"]).isfinite().all()
