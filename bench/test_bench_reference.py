"""The plain reference against the port's CPU path, at small presets and
small scenes, and its parts against hand-made cases."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench import testing, weights
from bench.reference import minkunet as ref_mk
from bench.reference import sparse
from bench.traffic import lidar


def _cloud(seed: int, n_sweeps: int, bucket: int):
    """Small LiDAR sweeps as compact rows and as the port's padded
    tensors."""
    coords = [lidar.base_sweep(seed, i, testing.SENSOR, bucket // n_sweeps,
                               2048) for i in range(n_sweeps)]
    batch = np.concatenate([np.full(len(c), i, np.int32)
                            for i, c in enumerate(coords)])
    coords = np.concatenate(coords)
    n = coords.shape[0]
    feats = np.random.default_rng(seed).random((n, 4), np.float32)
    pad = [np.zeros((bucket, 3), np.int32), np.zeros(bucket, np.int32),
           np.zeros(bucket, bool), np.zeros((bucket, 4), np.float32)]
    pad[0][:n], pad[1][:n], pad[2][:n], pad[3][:n] = coords, batch, True, \
        feats
    return {"coords": coords, "batch": batch, "feats": feats}, pad


def _config(which: str) -> dict:
    """The small preset, or the real configuration's widths with the small
    preset's bucket (the CPU path at full width on a small scene)."""
    small = testing.small_config("minkunet-semkitti")
    if which == "small":
        return small
    real = json.loads((testing.ROOT / "bench/configs/minkunet-semkitti.json")
                      .read_text())
    return dict(real, bucket=small["bucket"])


@pytest.mark.parametrize("which", ["small", "config"])
def test_minkunet_reference_matches_the_port(which):
    from repro_torch.core.spconv import SparseTensor
    from repro_torch.models import minkunet
    cfg = _config(which)
    m = cfg["model"]
    p = weights.make(ref_mk.weight_spec(m), 2**40 + 3, "cpu")
    model = minkunet.MinkUNet(minkunet.MinkUNetConfig(
        in_ch=m["in_ch"], classes=m["classes"], stem=m["stem"],
        enc=tuple(m["enc"]), dec=tuple(m["dec"]), blocks=m["blocks"]),
        device="cpu")
    model.load_state_dict(p, strict=True)
    req, pad = _cloud(11, 1, cfg["bucket"])
    st = SparseTensor(*(torch.as_tensor(a) for a in pad))
    out = minkunet.forward(model, st, impl="ref")
    ref = ref_mk.reference(p, m, req)
    assert ref["logits"].shape == (req["coords"].shape[0], m["classes"])
    assert ref_mk.gaps({"logits": out}, ref)["logit_gap"] < 1e-6
    tf32 = ref_mk.reference(p, m, req, precision="tf32")
    assert ref_mk.gaps(tf32, ref)["logit_gap"] > 1e-4


def _brute_subm3(coords, batch):
    index = {(int(b), *map(int, c)): i
             for i, (c, b) in enumerate(zip(coords, batch))}
    return np.array([[index.get((int(b), *(int(v) for v in c + np.array(o))),
                                -1) for o in sparse.OFFSETS27]
                      for c, b in zip(coords, batch)])


def test_subm3_kmap_against_a_dictionary():
    rng = np.random.default_rng(0)
    coords = np.unique(rng.integers(0, 6, (60, 3)), axis=0)
    batch = rng.integers(0, 2, coords.shape[0])
    got = sparse.subm3_kmap(torch.as_tensor(coords), torch.as_tensor(batch))
    assert np.array_equal(got.numpy(), _brute_subm3(coords, batch))


def test_gconv2_and_its_transpose():
    coords = torch.tensor([[0, 0, 0], [1, 0, 0], [1, 1, 1], [2, 0, 0]])
    batch = torch.zeros(4, dtype=torch.int64)
    d = sparse.gconv2_geometry(coords, batch)
    assert d.coords.tolist() == [[0, 0, 0], [1, 0, 0]]
    assert d.kmap.tolist() == [[0, 1, -1, -1, -1, -1, -1, 2],
                               [3, -1, -1, -1, -1, -1, -1, -1]]
    up = sparse.transpose_kmap(d, 4)
    assert up.tolist() == [[0, -1, -1, -1, -1, -1, -1, -1],
                           [-1, 0, -1, -1, -1, -1, -1, -1],
                           [-1, -1, -1, -1, -1, -1, -1, 0],
                           [1, -1, -1, -1, -1, -1, -1, -1]]


@pytest.mark.parametrize("x", [1.0, -1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                               -(1.0 + 2 ** -10 + 2 ** -11), 3.14159265,
                               1e-20, -7.5e30])
def test_tf32_round_keeps_ten_mantissa_bits_to_nearest_even(x):
    got = float(sparse.tf32_round(torch.tensor([x], dtype=torch.float32)))
    m, e = np.frexp(np.float32(x))
    want = float(np.ldexp(np.round(m * 2 ** 11) / 2 ** 11, e))
    assert got == pytest.approx(want, rel=0, abs=0)


def test_weights_are_seeded_and_shaped():
    spec = ref_mk.weight_spec(
        testing.small_config("minkunet-semkitti")["model"])
    a = weights.make(spec, 2**33 + 5, "cpu")
    b = weights.make(spec, 2**33 + 5, "cpu")
    c = weights.make(spec, 2**33 + 6, "cpu")
    assert set(a) == set(spec)
    assert all(a[k].shape == spec[k][0] and torch.equal(a[k], b[k])
               for k in spec)
    assert not torch.equal(a["stem.conv.w"], c["stem.conv.w"])
    var = a["stem.bn.var"]
    assert float(var.min()) >= 0.5 and float(var.max()) <= 2.0


def test_the_configuration_has_its_sources_widths():
    """SPVNAS's SemanticKITTI MinkUNet at cr 1.0 (the configuration's
    ``source``): ``cs = [32, 32, 64, 128, 256, 256, 128, 96, 96]``, 4 input
    features, 19 classes; nothing in ``reduced``."""
    cfg = json.loads((testing.ROOT / "bench/configs/minkunet-semkitti.json")
                     .read_text())
    m, cs = cfg["model"], [32, 32, 64, 128, 256, 256, 128, 96, 96]
    assert [m["stem"], *m["enc"], *m["dec"]] == cs
    assert (m["in_ch"], m["classes"], cfg["reduced"]) == (4, 19, [])
