"""Parity of the port's HuBERT encoder (repro_torch.models.encoder) and
LLaVA VLM (repro_torch.models.vlm) against the JAX package, on the CPU at
their reduced configs.

Float32, within 1e-4 x max |value|: ``encode``, ``masked_prediction_loss``
and every gradient; three ``make_train_step`` steps of the encoder on
``FrameStream`` batches; the VLM's ``lm_loss`` and every gradient,
``prefill`` over ``[patches | prompt]`` and three ``decode_step``s (the
caches included, ``pos`` bit for bit); greedy ``generate`` token for
token. Type promotion at a bf16 reduced config: float32 frames or patches
give the reference's float32 hidden states, logits and cache (within 1e-4
x max: the same float32 arithmetic on bf16 weights), bf16 ones its bf16
outputs (within 2e-2 x max).
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
from repro.models import encoder as jencoder
from repro.models import vlm as jvlm
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.launch import serve, train
from repro_torch.models import api, encoder, vlm
from repro_torch.optim import adamw

TOL = 1e-4     # float32, another summation order, relative to max |value|
TOL_BF16 = 2e-2


def _close(port, ref, tol=TOL):
    p = port.detach().float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1e-30, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _setup(arch, seed=1, **repl):
    mod, jmod, cls = ((encoder, jencoder, encoder.EncoderModel)
                      if arch == "hubert-xlarge"
                      else (vlm, jvlm, vlm.VLMModel))
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **repl)
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **repl)
    jparams = jmod.init_model(jcfg, jax.random.key(seed))
    model = cls(cfg, device="cpu")
    model.load_state_dict(mod.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return cfg, jcfg, jparams, model


def _frames_batch(cfg, seed=2, b=2, s=24):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(
                np.float32),
            "mask": rng.random((b, s)) < 0.3,
            "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _vlm_batch(cfg, seed=2, b=2, s=12):
    rng = np.random.default_rng(seed)
    return {"patches": rng.standard_normal(
                (b, cfg.n_patches, cfg.vision_dim)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _loss_and_grads(arch, mod, jmod, loss_name, seed):
    cfg, jcfg, jparams, model = _setup(arch, seed=seed)
    batch = _frames_batch(cfg) if arch == "hubert-xlarge" \
        else _vlm_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: getattr(jmod, loss_name)(p, jb, jcfg),
        has_aux=True))(jparams)
    loss, _, grads = train.lm_loss_and_grads(
        api.build_model(cfg, device="cpu"), dict(model.state_dict()), batch)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    want = mod.params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for key, g in grads.items():
        _close(g, want[key])
    return grads


def test_encode_matches_reference():
    cfg, jcfg, jparams, model = _setup("hubert-xlarge", seed=3)
    assert not cfg.causal and "embed" not in model.state_dict()
    frames = _frames_batch(cfg)["frames"]
    h = encoder.encode(model.params(), torch.from_numpy(frames), cfg)
    jh = jax.jit(lambda p, f: jencoder.encode(p, f, jcfg))(
        jparams, jnp.asarray(frames))
    _close(h, jh)
    # the API's "prefill" of an encoder is the encode
    m = api.build_model(cfg, device="cpu")
    assert m.init_cache is None and m.decode_step is None
    _close(m.prefill(model.params(), {"frames": torch.from_numpy(frames)},
                     0), jh)


def test_masked_prediction_loss_and_grads_match_reference():
    grads = _loss_and_grads("hubert-xlarge", encoder, jencoder,
                            "masked_prediction_loss", seed=4)
    assert float(grads["mask_emb"].abs().max()) > 0


def test_encoder_three_train_steps_match_reference():
    cfg, jcfg, jparams, model = _setup("hubert-xlarge", seed=5)
    opt = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jstep = jax.jit(jtrain.make_train_step(japi.build_model(jcfg),
                                           jadamw.AdamWConfig(**opt)))
    step = train.make_train_step(api.build_model(cfg, device="cpu"),
                                 adamw.AdamWConfig(**opt))
    jstate = (jparams, jadamw.init(jparams))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    state = (params, adamw.init(params))
    stream = train.make_stream(cfg, 2, 40, seed=5)
    jstream = jtrain.make_stream(jcfg, 2, 40, seed=5)
    for i in range(3):
        b, jb = stream.batch_at(i), jstream.batch_at(i)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= \
                TOL * abs(float(jm[key]))
    want = encoder.params_from_jax(jax.tree.map(np.asarray, jstate[0]))
    for k, p in state[0].items():
        _close(p, want[k])


def test_vlm_lm_loss_and_grads_match_reference():
    grads = _loss_and_grads("llava-next-mistral-7b", vlm, jvlm, "lm_loss",
                            seed=6)
    assert float(grads["proj_in"].abs().max()) > 0


def test_vlm_prefill_and_decode_match_reference():
    cfg, jcfg, jparams, model = _setup("llava-next-mistral-7b", seed=7)
    params = model.params()
    batch = _vlm_batch(cfg, seed=8)
    ctx = cfg.n_patches + 12 + 6
    logits, cache = vlm.prefill(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        max_context=ctx)
    jlogits, jcache = jax.jit(lambda p, b: jvlm.prefill(
        p, b, jcfg, max_context=ctx))(jparams,
                                      {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    _close(logits, jlogits)

    def check(cache, jcache):
        assert cache["step"].dtype == torch.int32
        assert np.array_equal(cache["step"].numpy(),
                              np.asarray(jcache["step"]))
        assert np.array_equal(cache["pos"].numpy(),
                              np.asarray(jcache["pos"]))
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])

    check(cache, jcache)
    jdecode = jax.jit(lambda p, c, t: jvlm.decode_step(p, c, t, jcfg))
    nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for _ in range(3):
        logits, cache = vlm.decode_step(params, cache,
                                        torch.from_numpy(nxt), cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        _close(logits, jlogits)
        check(cache, jcache)
        nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None].astype(
            np.int32)


def test_vlm_greedy_generate_matches_reference():
    cfg, jcfg, jparams, model = _setup("llava-next-mistral-7b", seed=9)
    batch = _vlm_batch(cfg, seed=10, b=3, s=10)
    ctx = cfg.n_patches + 10 + 8
    got, stats = serve.generate(api.build_model(cfg, device="cpu"),
                                model.params(), batch, max_context=ctx,
                                n_steps=8, device="cpu")
    want, _ = jserve.generate(japi.build_model(jcfg), jparams,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              max_context=ctx, n_steps=8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert stats["nonfinite_stops"] == 0


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_input_dtype_promotes_as_reference(in_dtype):
    tol = TOL if in_dtype == "float32" else TOL_BF16
    jdt, tdt = jnp.dtype(in_dtype), getattr(torch, in_dtype)

    # the encoder: hidden states
    cfg, jcfg, jparams, model = _setup("hubert-xlarge", seed=11,
                                       dtype="bfloat16")
    frames = _frames_batch(cfg)["frames"]
    h = encoder.encode(model.params(), torch.from_numpy(frames).to(tdt), cfg)
    jh = jencoder.encode(jparams, jnp.asarray(frames, jdt), jcfg)
    assert _dtype_name(h) == jnp.dtype(jh.dtype).name == in_dtype
    _close(h, jh.astype(jnp.float32), tol)

    # the VLM: loss, prefill logits and cache
    cfg, jcfg, jparams, model = _setup("llava-next-mistral-7b", seed=12,
                                       dtype="bfloat16")
    batch = _vlm_batch(cfg, seed=13)
    tb = {"patches": torch.from_numpy(batch["patches"]).to(tdt),
          "tokens": torch.from_numpy(batch["tokens"])}
    jb = {"patches": jnp.asarray(batch["patches"], jdt),
          "tokens": jnp.asarray(batch["tokens"])}
    params = model.params()
    loss, _ = vlm.lm_loss(params, tb, cfg)
    jloss, _ = jvlm.lm_loss(jparams, jb, jcfg)
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
    ctx = cfg.n_patches + 12
    logits, cache = vlm.prefill(params, tb, cfg, max_context=ctx)
    jlogits, jcache = jvlm.prefill(jparams, jb, jcfg, max_context=ctx)
    for got, want in ((logits, jlogits), (cache["k"], jcache["k"]),
                      (cache["v"], jcache["v"])):
        assert _dtype_name(got) == jnp.dtype(want.dtype).name == in_dtype
        _close(got, want.astype(jnp.float32), tol)
