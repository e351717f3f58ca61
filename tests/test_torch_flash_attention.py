"""Parity of the port's attention (repro_torch) against the JAX package.

The plain version ``attention_ref`` and the kernel wrapper (its plain
version on the CPU) against the reference's ``attention_ref`` and, on the
block-divisible cases, against its Pallas kernel in interpret mode: the
cases of the reference's own sweep plus ragged Sq < Skv, MQA, D = 80 and a
window shorter than a kernel block. Tolerances are the reference's own:
2e-5 in float32 (summation order), 3e-2 in bf16 (rounding of the output).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention.kernel import (
    flash_attention as jflash_attention)
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

F32, BF16 = "float32", "bfloat16"

CASES = [
    # (b, hq, hkv, sq, skv, d, causal, window, dtype)
    (1, 2, 2, 128, 128, 64, True, 0, F32),
    (2, 4, 2, 128, 256, 64, True, 0, F32),      # GQA + longer kv
    (1, 2, 1, 256, 256, 128, True, 96, F32),    # SWA
    (1, 2, 2, 128, 128, 64, False, 0, F32),     # encoder (no mask)
    (1, 4, 4, 128, 128, 64, True, 0, BF16),
    (2, 4, 2, 50, 70, 64, True, 0, F32),        # ragged, Sq < Skv
    (2, 4, 2, 96, 160, 128, True, 0, BF16),     # ragged in bf16
    (1, 4, 1, 128, 128, 64, True, 0, F32),      # MQA
    (1, 2, 2, 40, 40, 80, False, 0, F32),       # D = 80 (hubert)
    (1, 2, 1, 128, 128, 64, True, 20, F32),     # window < one block
    (1, 2, 2, 64, 200, 256, False, 48, F32),    # D = 256, window, no causal
]
BLOCKY = [c for c in CASES if c[3] % 64 == 0 and c[4] % 64 == 0]


def _inputs(b, hq, hkv, sq, skv, d, dtype, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(port, ref, dtype):
    tol = 3e-2 if dtype == BF16 else 2e-5
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,dtype", CASES)
@pytest.mark.parametrize("chunk", [1024, 32])
def test_attention_ref_matches_reference(b, hq, hkv, sq, skv, d, causal,
                                         window, dtype, chunk):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, dtype)
    want = jattention_ref(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                          causal=causal, window=window, chunk=chunk)
    got = attention_ref(*(_torch(a, dtype) for a in (q, k, v)),
                        causal=causal, window=window, chunk=chunk)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,dtype", BLOCKY)
def test_wrapper_matches_reference_kernel_interpret(b, hq, hkv, sq, skv, d,
                                                    causal, window, dtype):
    """The kernel wrapper (plain version on the CPU) and the dispatch
    against the reference's Pallas kernel, run by the interpreter."""
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, dtype)
    want = jflash_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                            causal=causal, window=window, bq=64, bkv=64,
                            interpret=True)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    before = fa_kernel.launches
    got = fa_kernel.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert fa_kernel.launches == before      # no launch on the CPU
    _close(got, want, dtype)
    for impl in ("kernel", "ref"):
        _close(fa_ops.attention(tq, tk, tv, causal=causal, window=window,
                                impl=impl), want, dtype)


def test_fully_masked_leading_block_stays_finite():
    """A window far shorter than the chunk leaves rows whose first chunks
    see no live key: the finite NEG_INF wipes them (exp(0) = 1, then
    alpha = 0) where -inf would give NaN."""
    q, k, v = _inputs(1, 2, 1, 96, 96, 64, F32, seed=5)
    got = attention_ref(*(_torch(a, F32) for a in (q, k, v)), causal=True,
                        window=8, chunk=16)
    assert torch.isfinite(got).all()
    # row i attends keys (i - 8, i]: an explicit softmax over them
    s = np.einsum("hqd,hkd->hqk", q[0], np.repeat(k[0], 2, 0)) / 8.0
    i, j = np.arange(96)[:, None], np.arange(96)[None, :]
    s = np.where((j <= i) & (j > i - 8), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("hqk,hkd->hqd", p / p.sum(-1, keepdims=True),
                     np.repeat(v[0], 2, 0))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-5, atol=2e-5)


def test_dispatch_rejects_unknown_impl():
    q, k, v = (_torch(a, F32) for a in _inputs(1, 2, 2, 8, 8, 64, F32))
    with pytest.raises(ValueError, match="unknown attention impl"):
        fa_ops.attention(q, k, v, impl="pallas")
