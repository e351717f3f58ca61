"""Parity of the port's Mamba2 (repro_torch.models.mamba2) against the JAX
package, on the CPU at the reduced config (float32, 8-token chunks).

Within 1e-4 x max |value| (float32, another summation order):
``ssd_chunked`` at a length that is and one that is not a multiple of the
chunk, with and without ``init_state``; ``lm_loss`` and every gradient
against ``jax.value_and_grad``; ``prefill`` (a prompt that is not a chunk
multiple) and three ``decode_step``s, the caches included; three
``make_train_step`` steps. Greedy ``generate`` token for token. A 2-token
prompt, which the reference's cache cannot decode (ROADMAP §3 item 12),
decodes in the port, each step held to the teacher-forced prefill.
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
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import mamba2 as jmamba2
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import api, mamba2
from repro_torch.optim import adamw

TOL = 1e-4     # float32, another summation order, relative to max |value|
ARCH = "mamba2-2.7b"


def _close(port, ref, tol=TOL):
    p = port.detach().float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1e-30, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _setup(seed=1):
    cfg = configs.get_config(ARCH).reduced()
    jcfg = jconfigs.get_config(ARCH).reduced()
    jparams = jmamba2.init_lm(jcfg, jax.random.key(seed))
    lm = mamba2.Mamba2LM(cfg, device="cpu")
    lm.load_state_dict(mamba2.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return cfg, jcfg, jparams, lm


def test_reduced_config_and_names():
    cfg, _, jparams, lm = _setup()
    assert cfg.ssm_chunk == 8 and cfg.n_layers == 3
    sd = lm.state_dict()
    assert set(sd) == set(mamba2.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    bf = mamba2.Mamba2LM(dataclasses.replace(cfg, dtype="bfloat16"),
                         device="cpu").state_dict()
    for key in ("A_log", "D_skip", "dt_bias"):     # float32 in any model
        assert bf[f"layers.0.{key}"].dtype == torch.float32
    assert bf["layers.0.in_proj"].dtype == torch.bfloat16
    # load_state_dict keeps them float32
    mamba2.Mamba2LM(dataclasses.replace(cfg, dtype="bfloat16"),
                    device="cpu").load_state_dict(sd)


@pytest.mark.parametrize("s,init", [(16, False), (13, False), (16, True),
                                    (13, True)])
def test_ssd_chunked_matches_reference(s, init):
    rng = np.random.default_rng(s + 10 * init)
    b, h, p, n, chunk = 2, 3, 4, 5, 8
    u = rng.standard_normal((b, s, h, p)).astype(np.float32)
    loga = (-0.5 * rng.random((b, s, h))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if init \
        else None
    y, fin = mamba2.ssd_chunked(
        *map(torch.from_numpy, (u, loga, bm, cm)), chunk,
        init_state=None if st is None else torch.from_numpy(st))
    jy, jfin = jmamba2.ssd_chunked(
        *map(jnp.asarray, (u, loga, bm, cm)), chunk,
        init_state=None if st is None else jnp.asarray(st))
    _close(y, jy)
    _close(fin, jfin)


def test_lm_loss_and_grads_match_reference():
    cfg, jcfg, jparams, lm = _setup(seed=2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 21)).astype(
        np.int32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmamba2.lm_loss(p, {"tokens": jnp.asarray(toks)}, jcfg),
        has_aux=True))(jparams)
    loss, metrics, grads = train.lm_loss_and_grads(
        api.build_model(cfg, device="cpu"), dict(lm.state_dict()),
        {"tokens": toks})
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert float(metrics["ce"]) == float(loss)
    want = mamba2.params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for key, g in grads.items():
        _close(g, want[key])
    for key in ("A_log", "dt_bias", "D_skip"):
        assert float(grads[f"layers.0.{key}"].abs().max()) > 0


def _check_cache(cache, jcache):
    assert cache["step"].dtype == torch.int32
    assert np.array_equal(cache["step"].numpy(),
                          np.asarray(jcache["step"]))
    _close(cache["conv"], jcache["conv"])
    _close(cache["ssm"], jcache["ssm"])


def test_prefill_and_decode_match_reference():
    cfg, jcfg, jparams, lm = _setup(seed=4)
    params = lm.params()
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 13))
    logits, cache = mamba2.prefill(params, torch.from_numpy(toks), cfg,
                                   max_context=32)
    jlogits, jcache = jax.jit(lambda p, t: jmamba2.prefill(
        p, t, jcfg, max_context=32))(jparams, jnp.asarray(toks, jnp.int32))
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    jdecode = jax.jit(lambda p, c, t: jmamba2.decode_step(p, c, t, jcfg))
    nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for _ in range(3):
        logits, cache = mamba2.decode_step(params, cache,
                                           torch.from_numpy(nxt), cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        _close(logits, jlogits)
        _check_cache(cache, jcache)
        nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None].astype(
            np.int32)


def test_short_prompt_decodes_as_teacher_forced_prefill():
    cfg, jcfg, jparams, lm = _setup(seed=6)
    params = lm.params()
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 2)))
    # the reference keeps one pre-conv row of a 2-token prompt, not three
    _, jcache = jmamba2.prefill(jparams, jnp.asarray(toks.numpy(),
                                                     jnp.int32), jcfg,
                                max_context=8)
    assert jcache["conv"].shape[2] == 1
    logits, cache = mamba2.prefill(params, toks, cfg, max_context=8)
    assert cache["conv"].shape[2] == cfg.conv_width - 1
    assert float(cache["conv"][:, :, 0].abs().max()) == 0.0   # before t=0
    seq = toks
    for _ in range(4):
        nxt = logits.reshape(2, -1).argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], 1)
        logits, cache = mamba2.decode_step(params, cache, nxt, cfg)
        full, _ = mamba2.prefill(params, seq, cfg, max_context=8)
        scale = float(full.abs().max())
        assert float((logits[:, 0] - full).abs().max()) <= TOL * scale


def test_greedy_generate_matches_reference():
    cfg, jcfg, jparams, lm = _setup(seed=3)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (3, 10))
    got, stats = serve.generate(api.build_model(cfg, device="cpu"),
                                lm.params(), {"tokens": toks},
                                max_context=24, n_steps=8, device="cpu")
    want, _ = jserve.generate(japi.build_model(jcfg), jparams,
                              {"tokens": jnp.asarray(toks, jnp.int32)},
                              max_context=24, n_steps=8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert stats["nonfinite_stops"] == 0


def test_three_train_steps_match_reference():
    cfg, jcfg, jparams, lm = _setup(seed=4)
    opt = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jstep = jax.jit(jtrain.make_train_step(japi.build_model(jcfg),
                                           jadamw.AdamWConfig(**opt)))
    step = train.make_train_step(api.build_model(cfg, device="cpu"),
                                 adamw.AdamWConfig(**opt))
    jstate = (jparams, jadamw.init(jparams))
    params = {k: v.clone() for k, v in lm.state_dict().items()}
    state = (params, adamw.init(params))
    stream = train.make_stream(cfg, 2, 20, seed=5)
    jstream = jtrain.make_stream(jcfg, 2, 20, seed=5)
    for i in range(3):
        b, jb = stream.batch_at(i), jstream.batch_at(i)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            TOL * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            TOL * abs(float(jm["grad_norm"]))
    want = mamba2.params_from_jax(jax.tree.map(np.asarray, jstate[0]))
    for k, p in state[0].items():
        _close(p, want[k])
