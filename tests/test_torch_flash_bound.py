"""The least time of one attention call that ``chip_smoke.py`` holds
kernel 5 against (``_flash_bound``): bf16 at the bf16 tensor-core rate,
float32 at the float32-exact 3xTF32 rate with the CUDA cores' bound beside
it. Runs on the CPU: importing ``chip_smoke`` needs only numpy."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# TinyLlama-1.1B's served prefill: B 4, Hq 32, Hkv 4, S 512, D 64, causal
TINYLLAMA = (4, 32, 4, 512, 512, 64, True, 0)


def test_float32_bound_is_the_3xtf32_rate(cs):
    r = cs._flash_bound(*TINYLLAMA, 4)
    assert r["live_pairs"] == 4 * 32 * 512 * 513 // 2
    assert r["flops"] == 4_303_355_904
    assert r["bound_by"] == "operations"
    assert r["bound_ms"] == pytest.approx(4_303_355_904 / (495e12 / 3) * 1e3)
    assert r["bound_ms"] == pytest.approx(0.02608, abs=5e-6)
    assert r["bound_ms_f32_cores"] == pytest.approx(0.06423, abs=5e-6)
    # 37.7 MB of q, k, v and o
    assert r["bytes"] == 4 * (2 * 4 * 32 * 512 * 64 + 2 * 4 * 4 * 512 * 64)
    assert r["bytes_ms"] == pytest.approx(0.01127, abs=5e-6)


def test_bf16_bound_is_unchanged(cs):
    r = cs._flash_bound(*TINYLLAMA, 2)
    assert r["flops"] == 4_303_355_904
    assert r["bound_by"] == "bytes"
    assert r["bound_ms"] == pytest.approx(0.00563, abs=5e-6)
    assert "bound_ms_f32_cores" not in r


@pytest.mark.parametrize("sq,skv,causal,window", [
    (500, 700, True, 0), (64, 300, True, 40), (200, 200, False, 0),
    (256, 256, True, 1)])
def test_live_pairs_count_the_mask(cs, sq, skv, causal, window):
    """The pairs are those the plain version's mask keeps."""
    q_pos = np.arange(sq)[:, None] + skv - sq
    k_pos = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), dtype=bool)
    if causal:
        keep &= k_pos <= q_pos
    if window > 0:
        keep &= k_pos > q_pos - window
    for elt in (2, 4):
        r = cs._flash_bound(2, 8, 2, sq, skv, 128, causal, window, elt)
        assert r["live_pairs"] == 2 * 8 * int(keep.sum())
        assert r["flops"] == 4.0 * 128 * r["live_pairs"]
