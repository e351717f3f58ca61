"""The port's GPipe pipeline (``runtime/pipeline.py``) and int8-compressed
all-reduce (``runtime/compress.py``) against the JAX package's, on the CPU.

One 4-rank gloo spawn (``launch/spconv_sharded.spawn_ranks``: one
process a rank, each loading its arguments from a file the parent wrote)
runs the port's side; one subprocess with 8 host devices
(``tests.proptest.run_script``) the reference's, handed over as an
``.npz`` that a thread of the parent writes while the ranks start. Both
start together in the module fixture: the spawn only reads the inputs'
tensors, so that thread reads what the ranks get.

* (a) The reference's ``test_pipeline_matches_sequential`` shapes (L 8,
  D 16, M 6, MB 4, tanh layers) on a 4-way ``pod`` mesh: the forward
  within 2e-5 of the reference's ``pipeline_apply`` (on its (pod 4,
  data 2) mesh) and of the sequential stack; the gradients of
  ``sum(y * ct)`` in each rank's stage weights and in the input within
  1e-5 of ``jax.grad`` through the reference's pipeline; every rank
  holds the same, whole input gradient.
* (b) TinyLlama reduced, 4 layers in 2 stages (``dataclasses.replace(
  cfg.reduced(), n_layers=4)``) on a (pod 2, data 2) mesh, 4 microbatches:
  the pipelined loss and every gradient a rank holds (the embedding, the
  final norm and the head on every rank, a stage's layers on its ranks)
  within 1e-5 of the port's single-device ``lm_loss`` (relative; each
  gradient against its own max |g|) and of the reference's
  ``jax.value_and_grad`` of its ``lm_loss`` on the same weights
  (``lm_params_from_jax``), the tolerance of
  ``tests/test_torch_lm_train.py``; the pipelined logits within 1e-5 of
  the single-device forward's.
* (c) ``quantize_int8`` / ``dequantize`` bit-equal to the reference's on
  random float32 and bf16 inputs, all zeros, ties at .5 (both round half
  to even) and values at the clip; ``compressed_psum_mean`` over the 4
  ranks bit-equal to the reference's ``shard_map`` over ``pod`` 4 on the
  same inputs (float32 and bf16, zeros, ties, clip; the same float32
  operations in the same order: max, divide by 127, divide, round, clip,
  an exact int32 sum, multiply, divide by n);
  ``grad_allreduce_compressed`` on the (pod 2, data 2) mesh within
  scale / 2 of the exact mean (plus float32 rounding), alike on the
  ``data`` replicas.
* The spawn leaves the caller's tensors where they were: none was moved
  into shared memory while the reference's thread read it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train
from repro_torch.launch.spconv_sharded import make_mesh, spawn_ranks
from repro_torch.models import api
from repro_torch.runtime import compress
from repro_torch.runtime import pipeline as pp

L, D, M, MB = 8, 16, 6, 4          # the reference's test shapes
LM_LAYERS, LM_BATCH, LM_SEQ, LM_MICRO = 4, 4, 24, 4
COMP_CASES = ("f32", "bf16", "zeros", "ties", "clip")


def _layer_stack(w, h):
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i])
    return h


def _comp_inputs() -> dict:
    """(4, 8, 16) float32 per case: rank r contributes row r."""
    rng = np.random.default_rng(1)
    out = {"f32": rng.standard_normal((4, 8, 16)).astype(np.float32),
           "bf16": rng.standard_normal((4, 8, 16)).astype(np.float32),
           "zeros": np.zeros((4, 8, 16), np.float32)}
    # every rank's max |x| is 127: x / scale lands on .5 exactly
    ties = np.tile(np.arange(-63.5, 64.5, 1.0, dtype=np.float32)[:128]
                   .reshape(8, 16), (4, 1, 1))
    ties[:, -1, -1] = 127.0
    out["ties"] = ties
    clip = rng.standard_normal((4, 8, 16)).astype(np.float32)
    clip[:, 0, :4] = [[3.0, -3.0, 2.9999998, -2.9999998]]
    clip[:, 1, 0] = [7.0, -7.0, 3.0, 1.0]     # the shared scale clips others
    out["clip"] = clip
    return out


def _cast(case, a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.bfloat16() if case == "bf16" else t


def _rank(rank, w, x, ct, flat, batch, comp):
    torch.set_num_threads(1)
    mesh4 = make_mesh((4,), ("pod",))
    mesh22 = make_mesh((2, 2), ("pod", "data"))
    out = {}
    # (a) the reference's shapes over pod 4
    st = pp.local_stage(pp.stack_stages(w, 4), mesh4).clone() \
        .requires_grad_()
    xx = x.clone().requires_grad_()
    y = pp.pipeline_apply(st, xx, _layer_stack, mesh=mesh4)
    gx, gw = torch.autograd.grad((y * ct).sum(), [xx, st])
    out["a"] = {"y": y.detach(), "gx": gx, "gw": gw,
                "stage": pp.stage_index(mesh4)}
    # (b) TinyLlama, 4 layers in 2 stages, replicated over data
    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b").reduced(),
                              n_layers=LM_LAYERS)
    loss, grads = pp.lm_pipeline_loss_and_grads(
        flat, batch, cfg, mesh=mesh22, n_micro=LM_MICRO)
    params, _ = pp.lm_stage_params(flat, cfg.n_layers, mesh22)
    with torch.no_grad():
        logits = pp.lm_pipeline_logits(params, batch["tokens"], cfg,
                                       mesh=mesh22, n_micro=LM_MICRO)
    out["b"] = {"loss": float(loss), "grads": grads, "logits": logits}
    # (c) the compressed mean over pod 4 and over pod 2 x data 2
    out["c"] = {c: compress.compressed_psum_mean(_cast(c, comp[c][rank]),
                                                 "pod", mesh4)
                for c in COMP_CASES}
    pod = pp.stage_index(mesh22)
    tree = {"w": _cast("f32", comp["f32"][pod]),
            "b": [_cast("clip", comp["clip"][pod][0])]}
    out["c22"] = compress.grad_allreduce_compressed(tree, mesh22)
    return out


REF_SCRIPT = r"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.runtime.sharding_compat import AxisType, make_mesh, set_mesh, shard_map
from repro.runtime.pipeline import pipeline_apply, stack_stages
from repro.runtime.compress import compressed_psum_mean

d = np.load(@IN@)
w, x, ct = (jnp.asarray(d[k]) for k in ("w", "x", "ct"))
mesh = make_mesh((4, 2), ("pod", "data"), axis_types=(AxisType.Auto,) * 2)

def stage_fn(params, h):
    for i in range(params.shape[0]):
        h = jnp.tanh(h @ params[i])
    return h

def loss(w, x):
    y = pipeline_apply(stack_stages(w, 4), x, stage_fn, mesh=mesh,
                       axis="pod")
    return (y * ct).sum(), y

with set_mesh(mesh):
    (_, y), (gw, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(w, x)
out = {"y": np.asarray(y), "gw": np.asarray(gw), "gx": np.asarray(gx)}
mesh4 = make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,))
for case in @CASES@:
    g = jnp.asarray(d["comp_" + case])
    if case == "bf16":
        g = g.astype(jnp.bfloat16)
    fn = shard_map(lambda a: compressed_psum_mean(a[0], "pod"), mesh=mesh4,
                   in_specs=(P("pod"),), out_specs=P(), check_vma=False)
    with set_mesh(mesh4):
        out["comp_" + case] = np.asarray(fn(g).astype(jnp.float32))
np.savez(@OUT@, **out)
print("REF_OK")
"""


def _reference(tmp, w, x, ct, comp):
    from tests.proptest import run_script
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
    np.savez(src, w=w.numpy(), x=x.numpy(), ct=ct.numpy(),
             **{"comp_" + k: v for k, v in comp.items()})
    body = (REF_SCRIPT.replace("@IN@", json.dumps(src))
            .replace("@OUT@", json.dumps(dst))
            .replace("@CASES@", repr(COMP_CASES)))
    assert "REF_OK" in run_script(body)
    with np.load(dst) as z:
        return dict(z)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    # the JAX package is imported here, not by the module, which the
    # spawned ranks import
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as jtransformer
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((L, D, D)) * 0.2)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, MB, D)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((M, MB, D)).astype(np.float32))
    comp = _comp_inputs()
    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b").reduced(),
                              n_layers=LM_LAYERS)
    jcfg = dataclasses.replace(
        jconfigs.get_config("tinyllama-1.1b").reduced(), n_layers=LM_LAYERS)
    jparams = jtransformer.init_lm(jcfg, jax.random.key(1))
    from repro_torch.models import transformer
    flat = transformer.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = {k: torch.as_tensor(v) for k, v in TokenStream(
        vocab=cfg.vocab, batch=LM_BATCH, seq=LM_SEQ, seed=0).batch_at(0)
        .items()}
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    inputs = (w, x, ct, flat["embed"], batch["tokens"])
    ptrs = [t.data_ptr() for t in inputs]
    with ThreadPoolExecutor(1) as pool:
        ref_job = pool.submit(_reference, tmp, w, x, ct, comp)
        ranks = spawn_ranks(_rank, 4, backend="gloo",
                            init_file=os.path.join(tmp, "init"),
                            args=(w, x, ct, flat, batch, comp),
                            timeout_s=240)
        ref = ref_job.result()
    assert not dist.is_initialized()
    moved = [t.is_shared() or t.data_ptr() != p
             for t, p in zip(inputs, ptrs)]
    # the sequential stack, the port's single-device LM and the
    # reference's jax.grad of its lm_loss, here
    wr, xr = w.clone().requires_grad_(), x.clone().requires_grad_()
    seq = _layer_stack(wr, xr)
    sgx, sgw = torch.autograd.grad((seq * ct).sum(), [xr, wr])
    loss, _, grads = train.lm_loss_and_grads(
        api.build_model(cfg, device="cpu"), flat, batch)
    from repro_torch.models import common
    with torch.no_grad():
        h, _, _ = transformer.forward_embeds(
            common.nest_params(flat),
            common.embed(flat["embed"], batch["tokens"]), cfg)
        logits = transformer.logits_fn(common.nest_params(flat), h, cfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.lm_loss(p, b, jcfg), has_aux=True))(
        jparams, {k: v.numpy() for k, v in batch.items()})
    return {"ranks": ranks, "ref": ref, "comp": comp, "moved": moved,
            "seq": (seq.detach(), sgx, sgw),
            "single": {"loss": float(loss), "grads": grads,
                       "logits": logits},
            "jax": {"loss": float(jloss), "grads": transformer
                    .lm_params_from_jax(jax.tree.map(np.asarray, jgrads))}}


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_pipeline_matches_reference_and_sequential(run):
    ref, (seq, sgx, sgw) = run["ref"], run["seq"]
    per = L // 4
    stages = set()
    for r in run["ranks"]:
        a = r["a"]
        stages.add(a["stage"])
        assert _gap(a["y"], ref["y"]) <= 2e-5
        assert _gap(a["y"], seq) <= 2e-5
        i = a["stage"]
        assert _gap(a["gw"], ref["gw"][i * per:(i + 1) * per]) <= 1e-5
        assert _gap(a["gw"], sgw[i * per:(i + 1) * per]) <= 1e-5
        assert _gap(a["gx"], ref["gx"]) <= 1e-5
        assert _gap(a["gx"], sgx) <= 1e-5
        # the replicated input's gradient, whole on every rank
        assert torch.equal(a["gx"], run["ranks"][0]["a"]["gx"])
    assert stages == {0, 1, 2, 3}
    assert float(np.abs(ref["gx"]).max()) > 0.1


def test_spawn_only_reads_the_callers_tensors(run):
    """``spawn_ranks`` hands the arguments over in a file: no input tensor
    of the spawn was moved into shared memory under the reference's
    thread, which wrote the same tensors to its input file meanwhile."""
    assert run["moved"] == [False] * 5


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def test_pipelined_lm_loss_and_grads_match_single_device_and_reference(run):
    single, jref = run["single"], run["jax"]
    n_stage = LM_LAYERS // 2
    for rank, r in enumerate(run["ranks"]):
        b = r["b"]
        assert _rel(b["loss"], single["loss"]) <= 1e-5
        assert _rel(b["loss"], jref["loss"]) <= 1e-5
        stage = rank // 2                      # (pod, data) = divmod(r, 2)
        own = {f"layers.{i}." for i in range(stage * n_stage,
                                             (stage + 1) * n_stage)}
        want_keys = {k for k in single["grads"]
                     if not k.startswith("layers.")
                     or any(k.startswith(p) for p in own)}
        assert set(b["grads"]) == want_keys
        for k, g in b["grads"].items():
            for want in (single["grads"][k], jref["grads"][k]):
                want = torch.as_tensor(want)
                scale = max(float(want.abs().max()), 1e-30)
                assert float((g - want).abs().max()) <= 1e-5 * scale, k
        assert _gap(b["logits"], single["logits"]) <= 1e-5


def test_quantize_and_dequantize_bit_equal_to_reference():
    import jax.numpy as jnp
    from repro.runtime import compress as jcompress
    comp = _comp_inputs()
    for case in COMP_CASES:
        for row in comp[case]:
            x = _cast(case, row)
            jx = jnp.asarray(row)
            if case == "bf16":
                jx = jx.astype(jnp.bfloat16)
            q, s = compress.quantize_int8(x)
            jq, js = jcompress.quantize_int8(jx)
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert np.array_equal(q.numpy(), np.asarray(jq)), case
            assert s.numpy().tobytes() == np.asarray(js).tobytes(), case
            assert np.array_equal(compress.dequantize(q, s).numpy(),
                                  np.asarray(jcompress.dequantize(jq, js)))
    # the ties: half to even, as jnp.round
    q, _ = compress.quantize_int8(_cast("ties", comp["ties"][0]))
    assert q.flatten()[:4].tolist() == [-64, -62, -62, -60]


def test_compressed_psum_mean_bit_equal_to_reference(run):
    ref, comp = run["ref"], run["comp"]
    for r in run["ranks"]:
        for case in COMP_CASES:
            got = r["c"][case]
            assert got.dtype == (torch.bfloat16 if case == "bf16"
                                 else torch.float32)
            assert np.array_equal(got.float().numpy(), ref["comp_" + case]), \
                case
    # within scale / 2 of the exact mean, as the reference's own test
    exact = comp["f32"].astype(np.float64).mean(0)
    scale = np.float32(np.abs(comp["f32"]).max()) / np.float32(127)
    assert _gap(run["ranks"][0]["c"]["f32"], exact) <= scale / 2 + 1e-6


def test_grad_allreduce_compressed_on_pod_and_data(run):
    comp = run["comp"]
    for name, rows in (("w", comp["f32"][:2]),
                       ("b", comp["clip"][:2, 0])):
        exact = rows.astype(np.float64).mean(0)
        scale = float(np.float32(np.abs(rows).max()) / np.float32(127))
        bound = scale / 2 + 4 * np.finfo(np.float32).eps * \
            float(np.abs(exact).max())
        outs = [r["c22"][name] if name == "w" else r["c22"][name][0]
                for r in run["ranks"]]
        for o in outs:
            assert _gap(o, exact) <= bound, name
            assert torch.equal(o, outs[0])       # alike on every rank
    assert isinstance(run["ranks"][0]["c22"]["b"], list)
