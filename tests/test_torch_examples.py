"""The port's counterparts of ``examples/quickstart.py`` and
``examples/serve_lm.py`` on the CPU, at reduced sizes.

* ``examples/quickstart_torch.py``: the OCTENT search's map count and tap
  counts bit-equal to the reference's ``build_kmap_octree`` on the same
  scan, the caching saving equal to the reference's ``caching.saving`` of
  those counts, finite layer output.
* ``examples/serve_lm_torch.py``: greedy tokens of the reduced TinyLlama,
  served with the reference's ``model.init(jax.random.key(0))`` weights,
  equal to the reference's ``generate`` (``examples/serve_lm.py``) on the
  example's prompt batch; decoded eagerly on the CPU (``graphed`` is the
  card's).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import caching as jcaching
from repro.core import mapsearch as jmapsearch
from repro.core import morton as jmorton
from repro.core import rulebook as jrulebook
from repro.data import pointcloud as jpointcloud
from repro.launch import serve as jserve
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.models import transformer

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_quickstart_matches_reference():
    res = _load("quickstart_torch").main(["--device", "cpu",
                                          "--voxels", "1024"])
    vb = jpointcloud.make_batch(np.random.default_rng(0), "lidar",
                                batch_size=1, max_voxels=1024)
    kmap = jmapsearch.build_kmap_octree(
        jnp.asarray(vb.coords), jnp.asarray(vb.batch), jnp.asarray(vb.valid),
        jnp.asarray(jmorton.subm3_offsets()), max_blocks=1024)
    counts = np.asarray(jrulebook.tap_counts(kmap))
    assert res["voxels"] == int(vb.valid.sum())
    assert res["maps"] == int((np.asarray(kmap) >= 0).sum())
    assert np.array_equal(res["tap_counts"], counts)
    assert res["saving"] == jcaching.saving(counts, 64, 64,
                                            capacity_bytes=27 * 32 * 32)
    assert res["finite"] and 0.0 < res["element_sparsity"] < 1.0


def test_serve_lm_generates_greedily_on_the_cpu():
    import jax
    jmodel = japi.build_model(jget_config("tinyllama-1.1b").reduced())
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_config("tinyllama-1.1b").reduced()
    lm = transformer.DecoderLM(cfg, device="cpu")
    lm.load_state_dict(transformer.lm_params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    res = _load("serve_lm_torch").main(
        ["--device", "cpu", "--batch", "2", "--gen", "4"], params=lm.params())
    # the example's prompts: default_rng(0), (batch, 24) tokens
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    want, _ = jserve.generate(jmodel, jparams,
                              {"tokens": jnp.asarray(toks, jnp.int32)},
                              max_context=128, n_steps=4)
    assert res["tokens"].shape == (2, 4) and not res["graphed"]
    assert np.array_equal(res["tokens"].numpy(), np.asarray(want))
    assert res["nonfinite_stops"] == 0
