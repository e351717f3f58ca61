"""Parity of the port's decoder LM (repro_torch) against the JAX package,
on the CPU at reduced sizes.

Field for field: every ported ``CONFIG`` and its ``reduced()``. Within
float32 summation order: ``rms_norm``, ``layer_norm``, ``rope`` and
``mlp``; ``attend_full``, ``attend_decode`` and ``cache_from_prefill`` (s
both below and at or past the capacity), with the cache's ``pos`` bit for
bit; ``prefill`` and every ``decode_step`` of a few steps, through
``lm_params_from_jax``, for tinyllama (GQA), qwen3 (qk-norm, tied
embeddings), yi and deepseek (their reduced configs, which the card
serves at published width), tinyllama with a 16-token sliding window (rolling cache,
decoded past the window) and the two mixtrals (MoE, their reduced
drop-free capacity, a 16-token window), logits within 1e-4 * max|logit|; greedy
``generate`` token for token. The non-finite guard and the sampled path
of ``generate`` on a stub model, as the reference's own tests run them.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import api, attention, common, transformer

TOL = 1e-4     # float32, another summation order, relative to max |value|


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port, ref, tol=TOL):
    p = port.float().numpy() if isinstance(port, torch.Tensor) else port
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1e-6, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _cfgs(name, **repl):
    """The reduced config of ``name`` in both packages, with ``repl``."""
    port = dataclasses.replace(configs.get_config(name).reduced(), **repl)
    ref = dataclasses.replace(jconfigs.get_config(name).reduced(), **repl)
    return port, ref


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_equal_reference(arch):
    assert configs.list_archs() == jconfigs.list_archs()
    port, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for prop in ("has_decode", "sub_quadratic"):
        assert getattr(port, prop) == getattr(ref, prop)
    if ref.n_heads:                          # mamba2 has no attention heads
        assert port.head_dim_ == ref.head_dim_


def test_common_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    _close(common.rms_norm(_t(x), _t(w)), jcommon.rms_norm(x, w))
    _close(common.layer_norm(_t(x), _t(1 + w), _t(bias)),
           jcommon.layer_norm(x, 1 + w, bias))
    pos = np.array([0, 3, 7, 100, 4095], np.int32)
    _close(common.rope(_t(x), _t(pos), 1e4), jcommon.rope(x, pos, 1e4))
    bpos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    _close(common.rope(_t(x), _t(bpos), 1e6), jcommon.rope(x, bpos, 1e6))
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    for gated, act in ((True, "silu"), (False, "gelu")):
        p = _np(jcommon.init_mlp(jax.random.key(1), 32, 48, jnp.float32,
                                 gated=gated))
        _close(common.mlp(_t(p), _t(h), act), jcommon.mlp(p, h, act))


def _attn_setup(cfg_name="qwen3-1.7b", **repl):
    cfg, jcfg = _cfgs(cfg_name, **repl)
    p = _np(jattention.init_attention(jax.random.key(2), jcfg, jnp.float32))
    p = {k: v + 0.05 if k.endswith("norm") else v for k, v in p.items()}
    return cfg, jcfg, p


@pytest.mark.parametrize("arch,window", [("qwen3-1.7b", None),
                                         ("tinyllama-1.1b", 6)])
def test_attend_full_and_cache_match_reference(arch, window):
    cfg, jcfg, p = _attn_setup(arch)
    x = np.random.default_rng(3).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    o, (k, v) = attention.attend_full(_t(p), _t(x), cfg, window=window)
    jo, (jk, jv) = jattention.attend_full(p, x, jcfg, window=window)
    _close(o, jo)
    _close(k, jk)
    _close(v, jv)
    for cap in (20, 12, 5):                  # s < cap, s == cap, s > cap
        c = attention.cache_from_prefill(k, v, cap)
        jc = jattention.cache_from_prefill(jk, jv, cap)
        assert np.array_equal(c.pos.numpy(), np.asarray(jc.pos))
        assert c.pos.dtype == torch.int32
        _close(c.k, jc.k)
        _close(c.v, jc.v)


@pytest.mark.parametrize("cap,window", [(16, None), (5, 5)])
def test_attend_decode_matches_reference(cap, window):
    cfg, jcfg, p = _attn_setup()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    _, (jk, jv) = jattention.attend_full(p, x, jcfg)
    jc = jattention.cache_from_prefill(jk, jv, cap)
    c = attention.KVCache(*(_t(np.asarray(a)) for a in jc))
    for step in range(9, 13):                # wraps the 5-slot cache
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        c.pos[step % cap] = step             # the caller's write, per step
        o, c = attention.attend_decode(
            _t(p), _t(xt), cfg, c, torch.tensor(step, dtype=torch.int32),
            window=window)
        jo, jc = jattention.attend_decode(p, xt, jcfg, jc, jnp.int32(step),
                                          window=window)
        _close(o, jo)
        assert np.array_equal(c.pos.numpy(), np.asarray(jc.pos))
        _close(c.k, jc.k)
        _close(c.v, jc.v)


def test_write_at_on_dtensors_equals_index_copy(tmp_path):
    """``common.write_at``, the decode step's slot write at a device
    position, on DTensors of a one-rank gloo mesh: a cache whole along the
    slot dim (each rank writes its shard), one sharded along it (the
    one-hot mask) and the replicated ``pos``, each equal to
    ``index_copy_`` on plain tensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import mesh as meshlib
    from repro_torch.runtime import sharding as rs
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = meshlib.make_test_mesh(1, 1)
        g = torch.Generator().manual_seed(0)
        k = torch.randn((2, 6, 4, 8), generator=g)
        new = torch.randn((2, 1, 4, 8), generator=g)
        pos = torch.arange(6, dtype=torch.int32)
        step = torch.tensor(9, dtype=torch.int32)
        slot = attention.decode_slot(step, 6)
        with rs.set_mesh(mesh):              # as the models run on a mesh
            for placed in ((Shard(0), Shard(2)), (Shard(0), Shard(1))):
                kd = distribute_tensor(k.clone(), mesh, placed)
                common.write_at(kd, 1, distribute_tensor(
                    slot, mesh, (Replicate(), Replicate())),
                    distribute_tensor(new, mesh, placed))
                assert torch.equal(kd.full_tensor(),
                                   k.clone().index_copy_(1, slot, new))
            pd = distribute_tensor(pos.clone(), mesh,
                                   (Replicate(), Replicate()))
            common.write_at(pd, 0, slot, step.reshape(1))
        assert torch.equal(pd.full_tensor(),
                           pos.clone().index_copy_(0, slot, step.reshape(1)))
    finally:
        dist.destroy_process_group()


def _lm(arch, seed=1, **repl):
    cfg, jcfg = _cfgs(arch, **repl)
    jparams = jtransformer.init_lm(jcfg, jax.random.key(seed))
    model = transformer.DecoderLM(cfg, device="cpu")
    model.load_state_dict(transformer.lm_params_from_jax(_np(jparams)))
    return cfg, jcfg, model.params(), jparams


def _check_cache(cache, jcache):
    assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert cache["step"].dtype == torch.int32
    assert np.array_equal(cache["step"].numpy(),
                          np.asarray(jcache["step"]))
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


@pytest.mark.parametrize("arch,repl,s,steps", [
    ("tinyllama-1.1b", {}, 16, 3),
    ("qwen3-1.7b", {}, 16, 3),
    ("tinyllama-1.1b", {"swa_window": 16}, 24, 5),   # rolling cache
    ("mixtral-8x7b", {}, 20, 3),                     # MoE, rolling cache
    ("mixtral-8x22b", {}, 20, 3),
    ("yi-9b", {}, 16, 3),
    ("deepseek-67b", {}, 16, 3),
])
def test_prefill_and_decode_match_reference(arch, repl, s, steps):
    cfg, jcfg, params, jparams = _lm(arch, **repl)
    ctx = s + steps + 4
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, s))
    logits, cache = transformer.prefill(params, torch.from_numpy(toks), cfg,
                                        max_context=ctx)
    jlogits, jcache = jax.jit(lambda p, t: jtransformer.prefill(
        p, t, jcfg, max_context=ctx))(jparams, jnp.asarray(toks, jnp.int32))
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    if repl.get("swa_window"):
        assert cache["k"].shape[2] == 16
    jdecode = jax.jit(lambda p, c, t: jtransformer.decode_step(p, c, t,
                                                               jcfg))
    nxt = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
    for _ in range(steps):
        logits, cache = transformer.decode_step(
            params, cache, torch.from_numpy(nxt), cfg)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        _close(logits, jlogits)
        _check_cache(cache, jcache)
        nxt = np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None].astype(
            np.int32)


def test_greedy_generate_matches_reference():
    cfg, jcfg, params, jparams = _lm("tinyllama-1.1b", seed=3)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (3, 10))
    got, stats = serve.generate(api.build_model(cfg, device="cpu"), params,
                                {"tokens": toks}, max_context=24, n_steps=8,
                                device="cpu")
    want, _ = jserve.generate(japi.build_model(jcfg), jparams,
                              {"tokens": jnp.asarray(toks, jnp.int32)},
                              max_context=24, n_steps=8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert stats["nonfinite_stops"] == 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b"])
def test_decoder_lm_names_match_reference_tree(arch):
    cfg, jcfg = _cfgs(arch)
    sd = transformer.lm_params_from_jax(_np(jtransformer.init_lm(
        jcfg, jax.random.key(0))))
    model = transformer.DecoderLM(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    nested = transformer.nest_params(sd)
    assert len(nested["layers"]) == cfg.n_layers
    assert nested["layers"][1]["attn"]["wq"] is sd["layers.1.attn.wq"]
    if cfg.n_experts:
        assert sd["layers.1.moe.w_down"].shape == (cfg.n_experts, cfg.d_ff,
                                                   cfg.d_model)
        assert model.state_dict()["layers.0.moe.router"].dtype == \
            torch.float32
    else:
        assert "lm_head" not in sd and "layers.2.attn.q_norm" in sd
        assert sd["layers.1.mlp.w_gate"].shape == (cfg.d_model, cfg.d_ff)


def test_unported_families_raise():
    """Once the refusal of the unported families, kept under its name: no
    family is left unported and none raises. Every config of the repo
    builds, inits and runs on the CPU (a prefill and a decode step, the
    encoder's encode)."""
    for arch in configs.list_archs():
        cfg = configs.get_config(arch).reduced()
        model = api.build_model(cfg, device="cpu")
        params = model.init()
        if cfg.family == "encoder":
            h = model.prefill(params, {"frames": torch.zeros(
                (2, 5, cfg.frontend_dim))}, 0)
            assert h.shape == (2, 5, cfg.d_model)
            continue
        batch = {"tokens": torch.zeros((2, 5), dtype=torch.int64)}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((2, cfg.n_patches,
                                            cfg.vision_dim))
        logits, cache = model.prefill(params, batch, 5 + cfg.n_patches + 2)
        logits, _ = model.decode_step(params, cache, torch.zeros(
            (2, 1), dtype=torch.int64))
        assert logits.shape == (2, 1, cfg.vocab), arch
        assert bool(torch.isfinite(logits.float()).all()), arch
    # the MoE decoders build, init and serve
    cfg = dataclasses.replace(configs.get_config("mixtral-8x7b").reduced(),
                              dtype="bfloat16")
    model = api.build_model(cfg, device="cpu")
    params = model.init()
    lp = params["layers"][0]
    assert "mlp" not in lp and set(lp["moe"]) == {"router", "w_gate",
                                                  "w_up", "w_down"}
    assert lp["moe"]["router"].dtype == torch.float32      # as the reference
    assert lp["moe"]["w_gate"].dtype == torch.bfloat16
    assert lp["moe"]["w_gate"].shape == (cfg.n_experts, cfg.d_model,
                                         cfg.d_ff)
    logits, cache = model.prefill(params, {"tokens": torch.zeros(
        (2, 5), dtype=torch.int64)}, 8)
    logits, _ = model.decode_step(params, cache, torch.zeros(
        (2, 1), dtype=torch.int64))
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


def test_generate_notes_nonfinite_stops_in_health():
    from repro_torch.runtime import guard
    h0 = guard.health().snapshot()
    _, stats = serve.generate(_stub(7, nan_from=2), None,
                              {"tokens": np.zeros((2, 3), np.int64)},
                              max_context=8, n_steps=5, device="cpu")
    assert stats["nonfinite_stops"] == 1
    assert guard.health().delta(h0).get("serve.nonfinite_stops") == 1


def _stub(v_size, nan_from=None, peak=1.0):
    def prefill(params, batch, max_context):
        n = batch["tokens"].shape[0]
        logits = torch.zeros((n, v_size))
        logits[:, 3] = 1.0
        return logits, 0

    def decode_step(params, cache, tok):
        step = cache + 1
        logits = torch.zeros((tok.shape[0], 1, v_size))
        logits[:, 0, step % v_size] = peak
        if nan_from is not None and step >= nan_from:
            logits[0] = float("nan")
        return logits, step

    return types.SimpleNamespace(prefill=prefill, decode_step=decode_step)


def test_generate_freezes_nonfinite_sequences():
    toks, stats = serve.generate(_stub(7, nan_from=2), None,
                                 {"tokens": np.zeros((2, 4), np.int64)},
                                 max_context=16, n_steps=5, device="cpu")
    toks = toks.numpy()
    assert stats["nonfinite_stops"] == 1
    assert (toks >= 0).all()
    assert (toks[0, 2:] == toks[0, 1]).all()   # frozen at last good token
    assert len(set(toks[1].tolist())) > 1      # healthy seq kept decoding


def test_generate_sampled_defaults_generator():
    kw = dict(max_context=8, n_steps=4, greedy=False, device="cpu")
    batch = {"tokens": np.zeros((2, 4), np.int64)}
    toks, stats = serve.generate(_stub(7, peak=5.0), {}, batch, **kw)
    assert toks.shape == (2, 4) and stats["nonfinite_stops"] == 0
    toks2, _ = serve.generate(_stub(7, peak=5.0), {}, batch, **kw)
    assert torch.equal(toks, toks2)            # the default is seeded
