"""Parity of the port's decoder-LM training (repro_torch) against the JAX
package, on the CPU at reduced sizes, float32.

* ``cross_entropy`` and ``shift_labels``, with and without a mask (an
  all-zero mask divides by 1): within 1e-6 relative.
* ``lm_loss`` and every gradient against ``jax.value_and_grad`` of the
  reference's, for tinyllama (GQA), qwen3 (qk-norm, tied embeddings) and
  mixtral at capacity factor 1.25 (copies dropped), with and without
  ``loss_mask``, weights through ``lm_params_from_jax``: the loss and
  ``ce`` within 1e-5 relative, ``moe_aux`` and ``moe_drop_frac`` within
  1e-6 relative, each gradient within 1e-5 x its own max |g| (float32,
  another summation order; measured at most 3.7e-6).
* The three remat modes give bit-identical gradients, and so do the
  ``backward`` of a :class:`DecoderLM` set to ``requires_grad_()`` and the
  kernel path's attention Function (its backward is the plain version's
  VJP).
* Three steps of ``make_train_step`` against the reference's jitted step
  on ``TokenStream`` batches, which are bit-equal to the reference's:
  each loss and ``grad_norm`` within 1e-4 relative, the learning rate
  exact, and every parameter after the third step within 1e-4 x its
  tensor's max |p|.
* ``TokenStream`` / ``FrameStream`` bit for bit, and ``make_stream``'s
  encoder and VLM streams; a bf16 checkpoint the reference wrote restores
  bit for bit; the LM CLI stopped after 2 of 4 steps and resumed reaches
  the uninterrupted run's digest.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jcheckpoint
from repro.data import tokens as jtokens
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.checkpoint import checkpoint
from repro_torch.data import tokens
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import train
from repro_torch.models import api, common, transformer
from repro_torch.optim import adamw

ARCHS = [("tinyllama-1.1b", {}), ("qwen3-1.7b", {}),
         ("mixtral-8x7b", {"capacity_factor": 1.25})]


def _rel(a, b):
    a = float(a.detach()) if isinstance(a, torch.Tensor) else float(a)
    b = float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def _close(port, ref, tol):
    p = port.detach().float().numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = max(1e-30, float(np.abs(r).max(initial=0.0)))
    assert float(np.abs(p - r).max(initial=0.0)) <= tol * scale


def _setup(arch, repl, seed=1):
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **repl)
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **repl)
    jparams = jtransformer.init_lm(jcfg, jax.random.key(seed))
    model = transformer.DecoderLM(cfg, device="cpu")
    model.load_state_dict(transformer.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return cfg, jcfg, jparams, dict(model.state_dict())


def _batch(cfg, mask: bool, seed=2):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((2, 24)) < 0.7).astype(np.float32)
    return b


def _loss_and_grads(cfg, flat, batch, impl="kernel"):
    return train.lm_loss_and_grads(api.build_model(cfg, device="cpu"), flat,
                                   batch, impl=impl)


def test_cross_entropy_and_shift_labels_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 7)).astype(np.int32)
    for mask in (None, (rng.random((2, 7)) < 0.5).astype(np.float32),
                 np.zeros((2, 7), np.float32)):
        got = common.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if mask is None else torch.from_numpy(mask))
        want = jcommon.cross_entropy(logits, targets, mask)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)),
                                                           1.0)
    toks = rng.integers(0, 50, (3, 9)).astype(np.int32)
    for got, want in zip(common.shift_labels(torch.from_numpy(toks)),
                         jcommon.shift_labels(toks)):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("arch,repl", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, repl, mask):
    cfg, jcfg, jparams, flat = _setup(arch, repl)
    batch = _batch(cfg, mask)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.lm_loss(p, b, jcfg), has_aux=True))(
        jparams, batch)
    loss, m, grads = _loss_and_grads(cfg, flat, batch)
    assert _rel(loss, jloss) <= 1e-5 and _rel(m["ce"], jm["ce"]) <= 1e-5
    for key in ("moe_aux", "moe_drop_frac"):
        assert abs(float(m[key]) - float(jm[key])) <= 1e-6 * max(
            abs(float(jm[key])), 1e-30)
    if cfg.n_experts:
        assert float(m["moe_drop_frac"]) > 0
    jg = transformer.lm_params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(jg) == set(grads)
    for k, g in grads.items():
        _close(g, jg[k], 1e-5)


@pytest.mark.parametrize("arch,repl", ARCHS)
def test_remat_modes_give_identical_gradients(arch, repl):
    cfg, _, _, flat = _setup(arch, repl)
    batch = _batch(cfg, True)
    grads = {}
    try:
        for mode in transformer.REMAT_SAVED_OPS:
            transformer.set_remat_mode(mode)
            grads[mode] = _loss_and_grads(cfg, flat, batch)[2]
    finally:
        transformer.set_remat_mode("full")
    for mode in ("dots", "dots_no_batch"):
        for k, g in grads["full"].items():
            assert torch.equal(grads[mode][k], g), (mode, k)
    with pytest.raises(ValueError):
        transformer.set_remat_mode("everything")


def test_trainable_decoder_lm_backward_and_plain_attention_agree():
    cfg, _, _, flat = _setup("qwen3-1.7b", {})
    batch = _batch(cfg, False)
    _, _, grads = _loss_and_grads(cfg, flat, batch)
    model = transformer.DecoderLM(cfg, device="cpu")
    model.load_state_dict(flat)
    model.requires_grad_()
    loss, _ = transformer.lm_loss(
        model.params(), {"tokens": torch.from_numpy(batch["tokens"])}, cfg)
    loss.backward()
    for k, p in model.named_parameters():
        assert torch.equal(p.grad, grads[k]), k
    # the kernel path's Function differentiates as the plain version does
    _, _, ref_grads = _loss_and_grads(cfg, flat, batch, impl="ref")
    for k, g in grads.items():
        assert torch.equal(g, ref_grads[k]), k


@pytest.mark.parametrize("window", [0, 5])
def test_attention_function_grad_equals_plain(window):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_() for s in ((2, 4, 9, 16), (2, 2, 9, 16),
                                           (2, 2, 9, 16)))
    g = torch.from_numpy(rng.standard_normal((2, 4, 9, 16)).astype(
        np.float32))
    out = attn_ops.attention(q, k, v, window=window)
    assert out.grad_fn.name().endswith("_KernelAttentionBackward")
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(attention_ref(q, k, v, window=window),
                               (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert attn_ops.attention(q, k, v).grad_fn is None


def test_token_streams_bit_equal():
    for seed, step in ((0, 0), (0, 5), (3, 1)):
        got = tokens.TokenStream(vocab=97, batch=3, seq=20,
                                 seed=seed).batch_at(step)
        want = jtokens.TokenStream(vocab=97, batch=3, seq=20,
                                   seed=seed).batch_at(step)
        assert got["tokens"].dtype == want["tokens"].dtype
        assert np.array_equal(got["tokens"], want["tokens"])
        got = tokens.FrameStream(dim=8, vocab=11, batch=2, seq=40,
                                 seed=seed).batch_at(step)
        want = jtokens.FrameStream(dim=8, vocab=11, batch=2, seq=40,
                                   seed=seed).batch_at(step)
        for key in want:
            assert np.array_equal(got[key], want[key]), key
    # make_stream: the encoder's frames and the VLM's patches and tokens
    for arch in ("hubert-xlarge", "llava-next-mistral-7b"):
        for step in (0, 3):
            got = train.make_stream(configs.get_config(arch).reduced(), 2,
                                    16, seed=4).batch_at(step)
            want = jtrain.make_stream(jconfigs.get_config(arch).reduced(),
                                      2, 16, seed=4).batch_at(step)
            assert set(got) == set(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("arch,repl", [ARCHS[0], ARCHS[2]])
def test_three_train_steps_match_reference(arch, repl):
    cfg, jcfg, jparams, flat = _setup(arch, repl, seed=4)
    opt = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jstep = jax.jit(jtrain.make_train_step(japi.build_model(jcfg),
                                           jadamw.AdamWConfig(**opt)))
    step = train.make_train_step(api.build_model(cfg, device="cpu"),
                                 adamw.AdamWConfig(**opt))
    jstate = (jparams, jadamw.init(jparams))
    params = {k: v.clone() for k, v in flat.items()}
    state = (params, adamw.init(params))
    stream = train.make_stream(cfg, 2, 24, seed=5)
    jstream = jtrain.make_stream(jcfg, 2, 24, seed=5)
    for i in range(3):
        b, jb = stream.batch_at(i), jstream.batch_at(i)
        assert np.array_equal(b["tokens"], jb["tokens"])
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        assert _rel(m["loss"], jm["loss"]) <= 1e-4
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= 1e-4
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), abs=1e-9)
    want = transformer.lm_params_from_jax(jax.tree.map(np.asarray,
                                                       jstate[0]))
    for k, p in state[0].items():
        _close(p, want[k], 1e-4)
    assert int(state[1]["count"]) == int(jstate[1]["count"]) == 3


def test_reference_bf16_checkpoint_restores(tmp_path):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    tree = {"w": jnp.asarray(a, jnp.bfloat16), "n": jnp.arange(4)}
    jcheckpoint.save(str(tmp_path), 7, tree)
    like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "n": torch.zeros(4, dtype=torch.int32)}
    got = checkpoint.restore(str(tmp_path), 7, like)
    want = torch.from_numpy(np.asarray(tree["w"]).astype(np.float32))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), want)
    assert torch.equal(got["n"], torch.arange(4, dtype=torch.int32))
    # and the port's own bf16 save reads back bit for bit
    checkpoint.save(str(tmp_path / "port"), 1, got)
    again = checkpoint.restore(str(tmp_path / "port"), 1, like)
    assert torch.equal(again["w"].view(torch.int16),
                       got["w"].view(torch.int16))


def test_lm_cli_resume_reaches_uninterrupted_state(tmp_path, capsys):
    kw = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--batch", "2",
          "--seq", "16", "--ckpt-every", "1", "--total-steps", "4"]
    train.main([*kw, "--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    full = capsys.readouterr().out.split("digest=")[1].split()[0]
    train.main([*kw, "--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    capsys.readouterr()
    train.main([*kw, "--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "steps=2 " in out
    assert out.split("digest=")[1].split()[0] == full
    assert checkpoint.latest_step(str(tmp_path / "b")) == 4
