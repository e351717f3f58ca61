"""Guard rails of the PyTorch port.

* Neither ``chip_smoke.py``, the port's examples (``examples/*_torch.py``)
  nor any module of ``src/repro_torch`` imports ``jax`` or the JAX
  package ``repro`` (the card's machine has neither).
* ``import repro_torch`` and every module in it work with no ``nvcc`` and
  no card: kernels are built at first launch, never at import, and no
  module starts a ``torch.distributed`` process group.
* Entry points called without ``device="cpu"`` on a host with no card
  raise; there is no silent CPU run (the serving CLI, its persist dir
  and the ``--worker-serve`` mode of ``chip_smoke.py`` included).
* The kernel wrappers raise on a wrong dtype, shape or a non-contiguous
  input (the flash-attention wrapper also on an unsupported head dim,
  Sq > Skv and Hq % Hkv != 0).
* Every CUDA source under ``csrc/`` is built by ``kernels/build.py`` and
  opens with a note naming the TPU kernel it replaces, which exists.
* Every scatter-add left in ``src/repro_torch`` (``index_add``,
  ``scatter_add``, ``index_put`` / ``put`` with ``accumulate``,
  ``scatter_reduce``, a weighted ``bincount``) is on a list, each float
  sum with the audited reason its order cannot change its bits and each
  integer one marked so: on a card these add a row's terms in no fixed
  order, and the port's float sums go through ``core/segment.py``.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _port_files():
    return [REPO / "chip_smoke.py",
            *sorted((REPO / "examples").glob("*_torch.py")),
            *sorted(PKG.rglob("*.py"))]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_never_imports_jax_or_repro():
    files = _port_files()
    assert len(files) > 15 and files[0].exists()
    for mod in ("optim/adamw.py", "checkpoint/checkpoint.py",
                "runtime/fault.py", "launch/train.py", "models/second.py",
                "runtime/guard.py", "core/stream.py", "core/validate.py",
                "runtime/feature_cache.py", "launch/spconv_stream.py",
                "runtime/persist.py", "runtime/admission.py",
                "launch/spconv_serve.py", "runtime/sharding.py",
                "kernels/octent/sharded.py", "launch/spconv_sharded.py",
                "models/moe.py", "data/tokens.py", "models/mamba2.py",
                "models/rglru.py", "models/encoder.py", "models/vlm.py",
                "models/api.py", "launch/mesh.py", "launch/shardings.py",
                "launch/hlo_analysis.py", "launch/dryrun.py",
                "runtime/pipeline.py", "runtime/compress.py",
                "runtime/flags.py", "runtime/graph.py"):
        assert PKG / mod in files, mod
    for ex in ("moe_ragged_torch.py", "train_minkunet_torch.py",
               "quickstart_torch.py", "serve_lm_torch.py"):
        assert REPO / "examples" / ex in files, ex
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p)
                                            & {"jax", "jaxlib", "repro"})
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_import_needs_no_nvcc_and_no_card():
    mods = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
            for p in sorted(PKG.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    for m in ("mesh", "shardings", "hlo_analysis", "dryrun"):
        assert f"repro_torch.launch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH="", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO / "src"),
               REPRO_TORCH_BUILD_DIR=str(REPO / "build" / "never-created"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    assert not (REPO / "build" / "never-created").exists()


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.launch.spconv_serve import ServeEngine
    from repro_torch.models import minkunet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = minkunet.MinkUNetConfig(stem=4, enc=(4,), dec=(4,), classes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minkunet.MinkUNet(cfg)
    model = minkunet.MinkUNet(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model)
    z = np.zeros((8, 3), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minkunet.build_plans(z, z[:, 0], z[:, 0] == 0, cfg)
    # the explicit CPU request runs
    minkunet.build_plans(z, z[:, 0], z[:, 0] == 0, cfg, device="cpu")


def test_sharded_serving_raises_without_a_card(monkeypatch):
    from repro_torch.launch import spconv_sharded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spconv_sharded.main(["--shape", "1"])


def test_every_cuda_source_is_built_and_names_its_tpu_kernel():
    import re
    from repro_torch.kernels import build
    sources = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert sources == sorted(build.SOURCES.values())
    assert len(sources) >= 5
    for name, src in build.SOURCES.items():
        text = (PKG / "csrc" / src).read_text()
        head = text[:text.index("#include")]
        m = re.search(r"Replaces: the Pallas TPU kernel `(\w+)` in\s*//\s*"
                      r"(src/repro/\S+\.py)", head)
        assert m, f"{src} does not say which TPU kernel it replaces"
        tpu = (REPO / m.group(2)).read_text()
        assert f"def {m.group(1)}(" in tpu and "pallas_call" in tpu
        assert "What bounds it on the H100" in head, src
        assert f'extern "C" int {name}_launch(' in text, src


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_spconv_demo(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "minkunet", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "tinyllama-1.1b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_lm("mixtral-8x7b", steps=1, batch=1, seq=8, lr=1e-3)
    # the explicit CPU request runs, and writes only where it is told to
    res = train.run_spconv_demo(1, ckpt_dir=str(tmp_path), device="cpu")
    assert res["recoveries"] == 0 and len(res["losses"]) == 1
    assert any(p.name.startswith("step-") for p in tmp_path.iterdir())


def test_second_raises_without_a_card(monkeypatch):
    from repro_torch.models import second
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = second.SECONDConfig(channels=(4, 4, 8), blocks=1, bev_hw=8,
                              head_ch=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        second.SECOND(cfg)
    # the explicit CPU request builds
    model = second.SECOND(cfg, device="cpu")
    assert model.rpn["conv1"].shape == (8, 16, 3, 3)


def test_stream_raises_without_a_card(monkeypatch):
    from repro_torch.core import stream
    from repro_torch.launch import spconv_stream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = spconv_stream.CONFIGS["tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.StreamSession(cfg, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spconv_stream.run_stream(cfg, 1, 128, log=None)
    # the explicit CPU request runs
    res = spconv_stream.run_stream(cfg, 2, 128, window=16, depth=8,
                                   device="cpu", log=None)
    assert res["frames"] == 2


def _octent_args():
    from repro_torch.kernels.octent import ops
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.integers(0, 20, (16, 3)).astype(np.int32))
    b = torch.zeros(16, dtype=torch.int32)
    v = torch.ones(16, dtype=torch.bool)
    qt = ops.build_query_table(c, b, v, max_blocks=16)
    offs = torch.zeros((1, 3), dtype=torch.int32)
    return [c, b, v, offs, qt.ublocks, qt.tkey, qt.tval, qt.n_blocks]


def test_octent_wrapper_rejects_bad_inputs():
    from repro_torch.kernels.octent.kernel import octent_query
    args = _octent_args()
    assert octent_query(*args).shape == (16, 1)
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(TypeError, match="coords must be torch.int32"):
        octent_query(*bad)
    bad = list(args)
    bad[0] = args[0].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        octent_query(*bad)
    bad = list(args)
    bad[2] = args[2].int()
    with pytest.raises(TypeError, match="valid must be torch.bool"):
        octent_query(*bad)
    bad = list(args)
    bad[5] = args[5][:-1]
    with pytest.raises(ValueError):
        octent_query(*bad)


def test_gemm_wrapper_rejects_bad_inputs():
    from repro_torch.kernels.spconv_gemm import ops
    from repro_torch.kernels.spconv_gemm.kernel import spconv_gemm_fused
    kmap = torch.full((8, 27), -1, dtype=torch.int32)
    kmap[:, 13] = torch.arange(8, dtype=torch.int32)
    t = ops.build_tap_tiles(kmap, bm=16, bo=16)
    f = torch.ones(8, 64)
    w = torch.ones(27, 64, 128)
    args = [f, w, t.gather_idx, t.scatter_idx, t.tile_tap, t.tile_nz,
            t.tile_ob]
    kw = dict(bm=16, bo=16, n_out_pad=16)
    assert spconv_gemm_fused(*args, **kw).shape == (16, 128)
    bad = list(args)
    bad[0] = f.double()
    with pytest.raises(TypeError, match="feats must be torch.float32"):
        spconv_gemm_fused(*bad, **kw)
    bad = list(args)
    bad[1] = torch.ones(27, 128, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        spconv_gemm_fused(*bad, **kw)
    bad = list(args)
    bad[1] = torch.ones(27, 64, 100)
    with pytest.raises(ValueError, match="multiple of 128"):
        spconv_gemm_fused(*bad, **kw)
    bad = list(args)
    bad[2] = t.gather_idx.long()
    with pytest.raises(TypeError, match="gather_idx must be torch.int32"):
        spconv_gemm_fused(*bad, **kw)
    with pytest.raises(ValueError, match="multiple of 32"):
        spconv_gemm_fused(*args, bk=16, **kw)
    with pytest.raises(TypeError, match="epi_scale"):
        spconv_gemm_fused(*args, epilogue=True, epi_scale=None, **kw)


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    import importlib.util
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api, transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build_model(get_config("mixtral-8x7b").reduced())
    from repro_torch.models import encoder, mamba2, rglru, vlm
    for cls, arch in ((mamba2.Mamba2LM, "mamba2-2.7b"),
                      (rglru.RGLRULM, "recurrentgemma-2b"),
                      (encoder.EncoderModel, "hubert-xlarge"),
                      (vlm.VLMModel, "llava-next-mistral-7b")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(get_config(arch).reduced())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.build_model(get_config(arch).reduced())
    spec = importlib.util.spec_from_file_location(
        "moe_ragged_torch", REPO / "examples" / "moe_ragged_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
    model = api.build_model(cfg, device="cpu")
    params = transformer.DecoderLM(cfg, device="cpu").params()
    batch = {"tokens": np.zeros((2, 5), np.int64)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate(model, params, batch, max_context=8, n_steps=2)
    # the explicit CPU request runs
    toks, stats = serve.generate(model, params, batch, max_context=8,
                                 n_steps=2, device="cpu")
    assert toks.shape == (2, 2) and stats["nonfinite_stops"] == 0


def test_flash_wrapper_rejects_bad_inputs():
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    q, k, v = (torch.ones(1, 4, 8, 64), torch.ones(1, 2, 8, 64),
               torch.ones(1, 2, 8, 64))
    assert flash_attention(q, k, v).shape == (1, 4, 8, 64)
    with pytest.raises(TypeError, match="bfloat16 or torch.float32"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="k must be torch.float32"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                        v)
    with pytest.raises(ValueError, match="head dim 32"):
        flash_attention(*(t[..., :32].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="Sq=8 > Skv=4"):
        flash_attention(q, k[:, :, :4].contiguous(), v[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="not a multiple of Hkv=3"):
        flash_attention(q, torch.ones(1, 3, 8, 64), torch.ones(1, 3, 8, 64))
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k, v[:, :1].contiguous())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_wrapper_rejects_misaligned_base(dtype):
    """The 16-byte alignment that the bf16 route's TMA loads need is checked
    before the CPU branch, so both devices reject the same inputs; a view
    16 bytes into its storage is aligned and goes through."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    n = 1 * 2 * 8 * 64
    buf = torch.randn(n + 16, dtype=torch.float32).to(dtype)
    k = torch.ones(1, 2, 8, 64, dtype=dtype)

    def view(offset_bytes):
        off = offset_bytes // buf.element_size()
        return buf[off:off + n].view(1, 2, 8, 64)

    assert buf.data_ptr() % 16 == 0 and view(8).data_ptr() % 16 == 8
    for args in ((view(8), k, k), (k, view(8), k), (k, k, view(8))):
        with pytest.raises(ValueError, match="16-byte boundary"):
            flash_attention(*args)
    assert flash_attention(view(16), k, k).shape == (1, 2, 8, 64)


def test_serving_cli_and_persistence_raise_without_a_card(monkeypatch,
                                                          tmp_path):
    from repro_torch.launch import spconv_serve
    from repro_torch.runtime import persist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spconv_serve.main(["--requests", "1", "--persist-dir",
                           str(tmp_path / "p"), "--health-json",
                           str(tmp_path / "h.json")])
    assert not (tmp_path / "h.json").exists()
    assert persist.open_default() is None       # no persist dir by default
    # the worker mode of chip_smoke.py refuses to start without a card
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                        "--worker-serve", "--persist-dir",
                        str(tmp_path / "w"), "--out",
                        str(tmp_path / "w.json")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and not (tmp_path / "w.json").exists()
    assert "no CUDA device" in r.stderr


#: the port's float scatter-adds, each with the reason its order is safe
ORDER_SAFE_FLOAT_SUMS = {
    ("models/moe.py", "_combine", "index_add"):
        "at most top_k = 2 copies add into a token's row (the empty slots "
        "go to the sliced-off row), and two terms added from zero give "
        "the same bits in either order",
    ("core/rulebook.py", "_GatherSpac.backward", "index_add_"):
        "one tap a call: on a kmap that a plan build makes a source row takes "
        "at most one real term a call (the misses add exact zeros to row "
        "0), so the calls' order fixes the sum",
    ("data/pointcloud.py", "voxelize", "bincount"):
        "numpy's bincount on the host adds a bin's weights in ascending "
        "point order",
}
#: integer scatter-adds: exact in any order
INTEGER_SUMS = {
    ("core/mapsearch.py", "build_block_table", "scatter_reduce_"),
    ("core/stream.py", "_splice", "index_add_"),
    ("models/moe.py", "_dispatch_one", "scatter_add_"),
}
_ALWAYS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
           "scatter_reduce", "scatter_reduce_", "index_reduce",
           "index_reduce_", "segment_reduce"}


def _is_scatter_add(call: ast.Call) -> bool:
    name = call.func.attr
    kw = {k.arg: k.value for k in call.keywords}
    if name in _ALWAYS:
        return True
    if name in ("index_put", "index_put_", "put", "put_"):
        acc = kw.get("accumulate")
        if acc is None and name != "put" and len(call.args) >= 3:
            acc = call.args[2]
        return acc is not None and not (isinstance(acc, ast.Constant)
                                        and acc.value is False)
    if name in ("scatter", "scatter_"):
        return "reduce" in kw
    if name == "bincount":
        return "weights" in kw or len(call.args) >= 2
    return False


def _scatter_add_sites():
    sites = []
    for path in sorted(PKG.rglob("*.py")):
        rel = str(path.relative_to(PKG))

        def walk(node, scope):
            for ch in ast.iter_child_nodes(node):
                if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    walk(ch, scope + [ch.name])
                    continue
                if (isinstance(ch, ast.Call)
                        and isinstance(ch.func, ast.Attribute)
                        and _is_scatter_add(ch)):
                    sites.append((rel, ".".join(scope), ch.func.attr))
                walk(ch, scope)

        walk(ast.parse(path.read_text(), str(path)), [])
    return sites


def test_every_scatter_add_is_audited_order_safe_or_integer():
    """A new floating-point scatter-add cannot come in unseen: each one
    left is listed, and the three that summed in no fixed order
    (``scatter_valid``, ``to_bev``, ``apply_maps_scatter``) go through
    ``segment.ordered_sum`` instead."""
    sites = _scatter_add_sites()
    known = set(ORDER_SAFE_FLOAT_SUMS) | INTEGER_SUMS
    assert sorted(set(sites) - known) == []
    assert sorted(known - set(sites)) == []
    assert all(ORDER_SAFE_FLOAT_SUMS.values())
    fixed = {("kernels/spconv_gemm/ops.py", "scatter_valid"),
             ("models/second.py", "to_bev"),
             ("core/rulebook.py", "apply_maps_scatter")}
    assert not [s for s in sites if s[:2] in fixed]
    for rel, fn in fixed:
        src = (PKG / rel).read_text()
        body = src[src.index(f"def {fn}("):]
        end = body.find("\ndef ")
        assert "segment.ordered_sum(" in body[:end if end > 0 else None], \
            (rel, fn)
