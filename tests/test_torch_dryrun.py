"""The port's dry run (``launch/dryrun.py``, ``launch/hlo_analysis.py``)
against the JAX package's, on the CPU.

* ``param_count`` and ``model_flops`` equal the reference's for every
  arch x shape cell (arithmetic, so exactly).
* ``roofline_terms`` gives the expected terms on hand-made inputs, at the
  H100's constants.
* The eager count at full depth equals the reference's depth-1/2
  extrapolation ``d1 + (units - 1)(d2 - d1)`` (FLOPs, bytes accessed,
  collective bytes by kind), on a dense, an MoE and a RecurrentGemma
  config (reduced widths, three depth units each, RecurrentGemma's with
  its two-layer tail; on a fake (2, 4) mesh, the train cell below, and
  for RecurrentGemma, whose log-depth scans take thrice the ops, its
  prefill).
  The peak of live bytes (``temp_bytes``) extrapolates exactly where
  one phase sets it at every depth (TinyLlama's train cell: the layer
  inputs remat saves; RecurrentGemma's prefill); Mixtral's train cell is
  not held to it, since there the phase that peaks at depths 1 and 2 is
  not the one that peaks at full depth (a max of terms growing at
  different rates is not linear in depth).
* ``run_cell`` on a fake (2, 4) mesh at a reduced TinyLlama train cell
  (seq 64, batch 8, the reference's slow dry-run test) returns ``"status":
  "ok"``, ``impl`` ``ref``, a positive ``temp_bytes`` that ``fits`` adds
  to the arguments, and each device's parameter, optimizer and batch
  bytes those of the cell's build, which
  ``tests/test_torch_shardings.py`` holds to the reference's
  ``NamedSharding`` shard shapes on 8 host devices.
* ``CostMode``'s walk of live bytes on a hand-counted chain of ``meta``
  ops: views, in-place ops and the arguments add nothing, a storage
  leaves when its last tensor (a view included) is freed.
* The vocab-sharded loss gathers no logits: ``common.cross_entropy`` and
  its backward on the reduced TinyLlama train cell's logits, sharded on
  the vocab over ``model`` of the fake (2, 4) mesh, issue three
  all-reduces of a (B, S) float32 row each (the log-sum-exp's max and
  sum, the target's logit) and no all-gather.
* ``--donate`` (the reference's ``donate_argnums``): a reduced train
  cell (batch 2, where the update phase sets the peak) run donated
  carries ``"donate": True`` and its ``temp_bytes`` lies below the
  copying cell's by at least 0.95 of the parameter and optimizer bytes a
  device (0.981 at that cell); prefill and decode cells give the same
  record either way; ``main(["--donate", ...])`` writes its records
  under their own file tag, apart from the copying ones.
* The fake world is left on exit: no process group stays initialized.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch import hlo_analysis as jhlo
from repro_torch import configs
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as meshlib
from repro_torch.models import api


def test_param_count_and_model_flops_equal_reference():
    for arch in configs.list_archs():
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for active in (False, True):
            assert hlo_analysis.param_count(cfg, active) == \
                jhlo.param_count(jcfg, active), arch
        for name, cell in configs.SHAPE_CELLS.items():
            assert hlo_analysis.model_flops(cfg, cell) == \
                jhlo.model_flops(jcfg, jconfigs.SHAPE_CELLS[name]), \
                (arch, name)


def test_roofline_terms_at_h100_constants():
    assert hlo_analysis.PEAK_FLOPS_BF16 == 989e12
    assert hlo_analysis.HBM_BW == 3.35e12
    assert hlo_analysis.NVLINK_BW == 450e9
    n = 4
    t = hlo_analysis.roofline_terms(flops=2 * n * 989e12,
                                    hbm_bytes=0.25 * n * 3.35e12,
                                    collective_bytes=3 * n * 450e9,
                                    n_chips=n)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(0.25)
    assert t["collective_s"] == pytest.approx(3.0)
    assert t["dominant"] == "collective_s"
    assert t["roofline_fraction"] == pytest.approx(2 / 3)
    z = hlo_analysis.roofline_terms(0.0, 0.0, 0.0, 1)
    assert z["roofline_fraction"] == 0.0


def _small(shape):
    """``shape``'s cell at the reference's slow dry-run test's size."""
    return dataclasses.replace(configs.SHAPE_CELLS[shape], seq_len=64,
                               global_batch=8)


def _cfg(arch, layers):
    return dataclasses.replace(configs.get_config(arch).reduced(),
                               n_layers=layers)


@functools.lru_cache(maxsize=None)
def _small_cell(arch, layers, shape="train_4k"):
    """``run_cell`` of ``_small(shape)`` on the fake (2, 4) mesh (one
    record shared by the tests that read it)."""
    return dryrun.run_cell(arch, shape, "test", cfg=_cfg(arch, layers),
                           cell=_small(shape))


@pytest.mark.parametrize("arch,layers,shape,exact_peak", [
    pytest.param("tinyllama-1.1b", 3, "train_4k", True, id="tinyllama-1.1b"),
    pytest.param("mixtral-8x7b", 3, "train_4k", False, id="mixtral-8x7b"),
    pytest.param("recurrentgemma-2b", 11, "prefill_32k", True,
                 id="recurrentgemma-2b")])
def test_full_depth_count_equals_depth_extrapolation(arch, layers, shape,
                                                     exact_peak):
    cfg = _cfg(arch, layers)
    rec = _small_cell(arch, layers, shape)
    assert rec["status"] == "ok", rec
    assert rec["depth_units"] == 3
    with meshlib.fake_world(8):
        mesh = meshlib.make_test_mesh(2, 4)
        ext = dryrun.measure_costs(cfg, _small(shape), mesh)
    assert not dist.is_initialized()
    assert ext["depth_units"] == rec["depth_units"]
    assert rec["hlo_flops"] == ext["flops"] > 0
    assert rec["hlo_bytes"] == ext["bytes"] > 0
    assert rec["collective_bytes"] == ext["collective_bytes"] > 0
    assert rec["collective_bytes_by_kind"] == \
        ext["collective_bytes_by_kind"]
    assert rec["temp_bytes"] > 0 and ext["temp_bytes"] > 0
    if exact_peak:
        assert rec["temp_bytes"] == ext["temp_bytes"]


def test_run_cell_on_a_fake_test_mesh():
    cfg = configs.get_config("tinyllama-1.1b").reduced()
    assert _cfg("tinyllama-1.1b", cfg.n_layers) == cfg
    rec = _small_cell("tinyllama-1.1b", cfg.n_layers)
    assert not dist.is_initialized()
    # the cell's build, whose bytes a device tests/test_torch_shardings.py
    # holds to the reference's shard shapes
    with meshlib.fake_world(8):
        want = dryrun.device_bytes(dryrun.build_cell(
            api.build_model(cfg, device="meta"), _small("train_4k"),
            meshlib.make_test_mesh(2, 4)))
    assert rec["status"] == "ok" and rec["impl"] == "ref"
    assert rec["n_chips"] == 8 and rec["temp_bytes"] > 0
    assert rec["bytes_per_device"] == want
    assert rec["argument_bytes"] == sum(want.values()) and rec["fits"]
    assert rec["fits"] == (rec["argument_bytes"] + rec["temp_bytes"]
                           <= dryrun.H100_HBM_BYTES)
    assert rec["hlo_flops"] > rec["model_flops"] > 0
    assert 0 < rec["useful_flops_ratio"] < 1
    # a (2, 4) mesh's tensor parallelism reduces over 'model'
    assert rec["collective_count_by_kind"].get("all-reduce", 0) > 0
    skip = dryrun.run_cell("hubert-xlarge", "decode_32k", "single")
    assert skip["status"] == "skip" and "decode" in skip["skip_reason"]


def test_live_bytes_walk_of_a_hand_counted_chain():
    a = torch.empty(1000, device="meta")              # an argument: 0
    with hlo_analysis.CostMode() as cm:
        b = a * 2                                     # 4000
        c = b + 1                                     # 8000 (the peak)
        del b                                         # 4000
        d = c.view(10, 100)                           # a view: 4000
        c.add_(1)                                     # in place: 4000
        a.mul_(3)                                     # the argument's: 4000
        e = torch.ones(500, device="meta")            # 6000
        f = d.sum(0)                                  # 6400
        del c                                         # d holds it: 6400
        assert cm.live_bytes == 6400
        del d                                         # 2400
        g = torch.cat([e, e])                         # 6400
        del e, f, g                                   # 0
    assert cm.live_bytes == 0
    assert cm.peak_bytes == 8000


def test_vocab_sharded_loss_gathers_no_logits():
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import common
    from repro_torch.runtime import sharding as rs
    cfg, cell = _cfg("tinyllama-1.1b", 2), _small("train_4k")
    b, s, v = cell.global_batch, cell.seq_len - 1, cfg.vocab
    with meshlib.fake_world(8):
        mesh = meshlib.make_test_mesh(2, 4)
        with rs.set_mesh(mesh):
            spec = rs.resolve("batch", None, "model", shape=(b, s, v))
            assert spec == ("data", None, "model")
            logits = distribute_tensor(
                torch.empty((b, s, v), device="meta"), mesh,
                rs.placements(spec, mesh)).requires_grad_()
            targets = torch.zeros((b, s), dtype=torch.int32, device="meta")
            with hlo_analysis.CostMode() as cm:
                common.cross_entropy(logits, targets).backward()
            assert logits.grad.placements == logits.placements
    assert not dist.is_initialized()
    row = (b // 2) * s * 4                  # a (B, S) float32 row a device
    assert cm.collectives.count_by_kind == {"all-reduce": 3}
    assert cm.collectives.bytes_by_kind == {"all-reduce": 3 * row}


def test_donated_train_cell_drops_one_state_of_temporaries():
    cfg = configs.get_config("tinyllama-1.1b").reduced()
    cell = dataclasses.replace(configs.SHAPE_CELLS["train_4k"], seq_len=16,
                               global_batch=2)
    copy, don = (dryrun.run_cell("tinyllama-1.1b", "train_4k", "test",
                                 cfg=cfg, cell=cell, donate=d)
                 for d in (False, True))
    assert not dist.is_initialized()
    assert copy["status"] == don["status"] == "ok"
    assert copy["donate"] is False and don["donate"] is True
    assert don["bytes_per_device"] == copy["bytes_per_device"]
    assert don["hlo_flops"] == copy["hlo_flops"]
    state = (copy["bytes_per_device"]["params"]
             + copy["bytes_per_device"]["optimizer"])
    assert copy["temp_bytes"] - don["temp_bytes"] >= 0.95 * state
    assert don["fits"] == (don["argument_bytes"] + don["temp_bytes"]
                           <= dryrun.H100_HBM_BYTES)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_donate_leaves_prefill_and_decode_cells_alike(shape):
    cfg = _cfg("tinyllama-1.1b", 2)
    copy, don = (dryrun.run_cell("tinyllama-1.1b", shape, "test", cfg=cfg,
                                 cell=_small(shape), donate=d)
                 for d in (False, True))
    assert (copy["donate"], don["donate"]) == (False, True)
    for rec in (copy, don):
        assert rec["status"] == "ok"
        for key in ("donate", "build_s", "count_s"):
            del rec[key]
    assert copy == don


def test_main_donate_keeps_its_own_files(tmp_path, capsys):
    out = str(tmp_path)
    # a donated record already there is cached; the copying one is not it
    done = dryrun.result_path(out, "tinyllama-1.1b", "train_4k", "single",
                              dryrun.file_tag("", True))
    with open(done, "w") as f:
        f.write("{}")
    dryrun.main(["--donate", "--arch", "tinyllama-1.1b", "--shape",
                 "train_4k", "--mesh", "single", "--out", out])
    assert "[cached] tinyllama-1.1b train_4k single" in capsys.readouterr().out
    # a skipped cell, donated and tagged: written beside, not over, others
    dryrun.main(["--donate", "--tag", "t", "--arch", "hubert-xlarge",
                 "--shape", "decode_32k", "--mesh", "single", "--out", out])
    path = dryrun.result_path(out, "hubert-xlarge", "decode_32k", "single",
                              "t__donate")
    with open(path) as f:
        rec = json.load(f)
    assert rec["status"] == "skip" and rec["donate"] is True
    assert rec["tag"] == "t"
    assert dryrun.file_tag("t", False) == "t"
    assert dryrun.file_tag("", False) == ""
