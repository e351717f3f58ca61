"""Parity of the port's RecurrentGemma (repro_torch.models.rglru) against
the JAX package, on the CPU at the reduced config (float32, an 8-token
local window), with 5 layers where a tail of recurrent layers matters
(one (rec, rec, attn) group and two tail layers).

Within 1e-4 x max |value| (float32, another summation order and the
log-depth scan in place of ``lax.associative_scan``): ``rg_lru_full``
with and without ``h0``, and ``rg_lru_step``; ``lm_loss`` and every
gradient against ``jax.value_and_grad``; ``prefill`` past the window and
three ``decode_step``s, the caches included (``pos`` bit for bit). Greedy
``generate`` token for token.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import rglru as jrglru
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import api, rglru

TOL = 1e-4     # float32, another summation order, relative to max |value|
ARCH = "recurrentgemma-2b"


def _close(port, ref, tol=TOL):
    p = port.detach().float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1e-30, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _setup(seed=1, n_layers=5):
    cfg = dataclasses.replace(configs.get_config(ARCH).reduced(),
                              n_layers=n_layers)
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(),
                               n_layers=n_layers)
    jparams = jrglru.init_lm(jcfg, jax.random.key(seed))
    lm = rglru.RGLRULM(cfg, device="cpu")
    lm.load_state_dict(rglru.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return cfg, jcfg, jparams, lm


@pytest.mark.parametrize("n_layers", [3, 5])
def test_names_and_pattern(n_layers):
    cfg, _, jparams, lm = _setup(n_layers=n_layers)
    assert cfg.local_window == 8
    sd = lm.state_dict()
    assert set(sd) == set(rglru.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    nested = api.Model.nest(sd)
    assert len(nested["groups"]) == 1
    assert len(nested.get("tail", [])) == n_layers - 3
    assert nested["groups"][0]["rec1"]["lam"] is sd["groups.0.rec1.lam"]
    bf = rglru.RGLRULM(dataclasses.replace(cfg, dtype="bfloat16"),
                       device="cpu").state_dict()
    assert bf["groups.0.rec0.lam"].dtype == torch.float32
    assert bf["groups.0.rec0.w_x"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_reference(with_h0):
    cfg, jcfg, jparams, lm = _setup(seed=2)
    lp = lm.params()["groups"][0]["rec0"]
    jlp = jax.tree.map(lambda a: a[0], jparams["groups"]["rec0"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 19, cfg.lru_width)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width)).astype(np.float32) \
        if with_h0 else None
    y, hl = rglru.rg_lru_full(lp, torch.from_numpy(x), cfg,
                              None if h0 is None else torch.from_numpy(h0))
    jy, jhl = jrglru.rg_lru_full(jlp, jnp.asarray(x), jcfg,
                                 None if h0 is None else jnp.asarray(h0))
    _close(y, jy)
    _close(hl, jhl)
    # one step from the scan's last state
    x1 = rng.standard_normal((2, 1, cfg.lru_width)).astype(np.float32)
    y1, h1 = rglru.rg_lru_step(lp, torch.from_numpy(x1), cfg, hl)
    jy1, jh1 = jrglru.rg_lru_step(jlp, jnp.asarray(x1), jcfg, jhl)
    _close(y1, jy1)
    _close(h1, jh1)


def test_lm_loss_and_grads_match_reference():
    cfg, jcfg, jparams, lm = _setup(seed=4)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 21)).astype(
        np.int32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jrglru.lm_loss(p, {"tokens": jnp.asarray(toks)}, jcfg),
        has_aux=True))(jparams)
    loss, _, grads = train.lm_loss_and_grads(
        api.build_model(cfg, device="cpu"), dict(lm.state_dict()),
        {"tokens": toks})
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    want = rglru.params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for key, g in grads.items():
        _close(g, want[key])


def _check_cache(cache, jcache):
    assert cache["step"].dtype == torch.int32
    assert np.array_equal(cache["step"].numpy(),
                          np.asarray(jcache["step"]))
    assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for key in ("rec_h", "rec_conv", "k", "v", "tail_h", "tail_conv"):
        _close(cache[key], jcache[key])


def test_prefill_and_decode_past_window_match_reference():
    cfg, jcfg, jparams, lm = _setup(seed=6)
    params = lm.params()
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 10))
    logits, cache = rglru.prefill(params, torch.from_numpy(toks), cfg,
                                  max_context=32)
    jlogits, jcache = jax.jit(lambda p, t: jrglru.prefill(
        p, t, jcfg, max_context=32))(jparams, jnp.asarray(toks, jnp.int32))
    assert cache["k"].shape[2] == cfg.local_window
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    jdecode = jax.jit(lambda p, c, t: jrglru.decode_step(p, c, t, jcfg))
    nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for _ in range(3):
        logits, cache = rglru.decode_step(params, cache,
                                          torch.from_numpy(nxt), cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        _close(logits, jlogits)
        _check_cache(cache, jcache)
        nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None].astype(
            np.int32)


def test_greedy_generate_matches_reference():
    cfg, jcfg, jparams, lm = _setup(seed=3, n_layers=3)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (3, 10))
    got, stats = serve.generate(api.build_model(cfg, device="cpu"),
                                lm.params(), {"tokens": toks},
                                max_context=24, n_steps=8, device="cpu")
    want, _ = jserve.generate(japi.build_model(jcfg), jparams,
                              {"tokens": jnp.asarray(toks, jnp.int32)},
                              max_context=24, n_steps=8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert stats["nonfinite_stops"] == 0
