"""The port's durability layer against the JAX package, on the CPU.

``runtime/persist.py`` (codec, ``SnapshotStore``), the durable plan cache
and pinned tier, the serving journal with ``recover``, and the checkpoint
fault sites:

* the codec round-trips the port's plans bit for bit and refuses foreign
  classes;
* every defect of a file (truncation, bit flips, another salt or
  version, foreign bytes) reads as a counted cold entry, never a raise,
  and the injected ``persist.*`` faults are absorbed; the same operations
  on both packages' stores give the same counters;
* a warm ``PlanCache`` / ``PinnedStore`` performs no map search, and so
  does a warm training demo, as the reference's;
* ``recover`` queues journaled requests again, or sheds expired ones, as
  the reference's engine;
* the ``checkpoint`` site fires before any file I/O and the runner counts
  its events as the reference's;
* SIGKILL: a TINY serving process killed in the middle of a snapshot
  write, and a training process killed in the middle of a checkpoint,
  each restarted to the uninterrupted run's digests.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from repro.core import plan as jplan
from repro.launch import spconv_serve as jserve
from repro.launch.train import run_spconv_demo as jrun_demo
from repro.models import minkunet as jminkunet
from repro.runtime import admission as jadmission, fault as jfault
from repro.runtime import guard as jguard, persist as jpersist
from repro_torch.checkpoint import checkpoint
from repro_torch.core import plan as planlib
from repro_torch.data import pointcloud
from repro_torch.launch import spconv_serve
from repro_torch.launch.train import run_spconv_demo
from repro_torch.models import minkunet
from repro_torch.runtime import admission, fault, feature_cache, guard
from repro_torch.runtime import persist
from repro_torch.runtime.fault import RunnerConfig, TrainRunner

for _name in ("repro.guard", "repro.fault", "repro.persist",
              "repro_torch.guard", "repro_torch.fault",
              "repro_torch.persist"):
    logging.getLogger(_name).setLevel(logging.ERROR)

ROOT = Path(__file__).resolve().parents[1]

#: the restart gate's model and request shapes (benchmarks/restart_replay.py)
TINY = dict(stem=8, enc=(8, 16), dec=(16, 8), classes=4, blocks=1)
SERVE_BUCKETS = (48, 96)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tests run thousands of
    small ops, which the default thread pool slows by an order of
    magnitude when parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_guard_state():
    fault.uninstall()
    with guard.scoped_health():
        yield
    fault.uninstall()


def _store(tmp_path, **kw):
    return persist.SnapshotStore(str(tmp_path / "snap"), **kw)


def _cloud(seed: int, n: int, ext: int = 16):
    """``n`` distinct voxels of one batch; row counts of their own, since
    the search counter and capacity memo are process-wide."""
    rng = np.random.default_rng(seed)
    lin = rng.choice(ext ** 3, size=n, replace=False)
    c = np.stack([lin % ext, (lin // ext) % ext, lin // ext ** 2],
                 -1).astype(np.int32)
    return (torch.from_numpy(c), torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool))


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def test_codec_round_trips_a_plan_bit_for_bit():
    c, b, v = _cloud(1, 61)
    cache = planlib.PlanCache(pinned=feature_cache.PinnedStore())
    plans = minkunet.build_plans(c, b, v, minkunet.MinkUNetConfig(**TINY),
                                 cache=cache, device="cpu")
    spec, arrays = persist.encode(plans)
    spec = json.loads(json.dumps(spec))             # JSON-able
    back = persist.decode(spec, arrays)
    assert type(back) is minkunet.MinkPlans
    _equal_trees(tuple(back), tuple(plans))
    tree = {"n": np.arange(5, dtype=np.int16), "t": torch.arange(3),
            "x": [1, 2.5, "s", None, True], "y": (np.float32(2),)}
    out = persist.decode(*persist.encode(tree))
    assert isinstance(out["n"], np.ndarray) and out["n"].dtype == np.int16
    assert isinstance(out["t"], torch.Tensor) and out["x"] == tree["x"]
    assert isinstance(out["x"], list) and isinstance(out["y"], tuple)


def test_codec_refuses_foreign_classes():
    Foreign = namedtuple("Foreign", "a")
    with pytest.raises(TypeError, match="foreign"):
        persist.encode(Foreign(1))
    # the reference's own plans are foreign here: "repro." is not
    # "repro_torch."
    with pytest.raises(TypeError, match="foreign"):
        persist.encode(jplan.ConvPlan("subm3", None, None, 1, 27, None,
                                      None, None, None))
    for bad in ({"t": "nt", "cls": "os:path", "v": []},
                {"t": "nt", "cls": "repro.core.plan:ConvPlan", "v": []}):
        with pytest.raises(ValueError, match="foreign"):
            persist.decode(bad, [])
    with pytest.raises(TypeError):
        persist.encode({1: "int key"})
    with pytest.raises(TypeError):
        persist.encode(object())


def test_salt_folds_in_the_torch_version(monkeypatch):
    monkeypatch.delenv("REPRO_PERSIST_SALT", raising=False)
    assert persist.default_salt().endswith(f"torch-{torch.__version__}")
    monkeypatch.setenv("REPRO_PERSIST_SALT", "bumped")
    assert persist.default_salt() == "bumped"
    monkeypatch.setenv("REPRO_PERSIST_MAX_BYTES", "123")
    assert persist.default_max_bytes() == jpersist.default_max_bytes() == 123
    monkeypatch.setenv("REPRO_PERSIST_DIR", "/nowhere")
    assert persist.open_default().directory == "/nowhere"
    monkeypatch.delenv("REPRO_PERSIST_DIR")
    assert persist.open_default() is None


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

def _script(mod, directory, **kw):
    """One sequence of store operations; returns the counters and what
    each read gave."""
    st = mod.SnapshotStore(directory, **kw)
    reads = []
    st.put(("a",), {"x": np.arange(10, dtype=np.int32)})
    st.put(("b", 2), [np.ones(3, np.float32), 7])
    reads.append(st.get(("a",)) is not None)
    reads.append(st.get(("missing",)) is None)
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[:-7])                  # truncate the first entry
        break
    reads.append([k for k, _ in st.items()])
    st.put(("c",), np.zeros(4, np.int64))
    st.delete(("c",))
    reads.append(st.get(("c",)))
    stats = st.stats()
    for k in ("resident_bytes", "bytes_written", "write_ms"):
        stats.pop(k, None)
    return stats, reads


def test_store_counters_match_reference(tmp_path):
    with guard.scoped_health() as h, jguard.scoped_health() as jh:
        got = _script(persist, str(tmp_path / "port"))
        want = _script(jpersist, str(tmp_path / "ref"))
        assert h.snapshot() == jh.snapshot()
    assert got == want
    assert got[0]["dropped"] == 1 and got[0]["saves"] == 3


def test_writes_are_atomic_and_measured(tmp_path):
    st = _store(tmp_path)
    assert st.put(("k",), torch.arange(1000))
    names = os.listdir(st.directory)
    assert len(names) == 1 and names[0].endswith(".snap")
    s = st.stats()
    assert s["bytes_written"] == s["resident_bytes"] > 8000
    assert s["write_ms"] > 0
    assert torch.equal(st.get(("k",)), torch.arange(1000))


def test_byte_budget_evicts_oldest_and_skips_oversize(tmp_path):
    st = _store(tmp_path, max_bytes=6000)
    for i in range(4):
        assert st.put(("k", i), np.zeros(300, np.float32))
    assert st.evictions >= 1 and st.get(("k", 3)) is not None
    assert st.get(("k", 0)) is None
    assert not st.put(("big",), np.zeros(4000, np.float32))
    assert st.save_skips == 1


def _one_entry(tmp_path):
    st = _store(tmp_path)
    st.put(("k",), {"a": torch.arange(8, dtype=torch.float32)})
    (path,) = [os.path.join(st.directory, n)
               for n in os.listdir(st.directory) if n.endswith(".snap")]
    with open(path, "rb") as f:
        return st, path, f.read()


def test_truncation_sweep_reads_cold(tmp_path):
    st, path, blob = _one_entry(tmp_path)
    cuts = sorted({0, 1, len(persist._MAGIC), len(blob) // 3,
                   len(blob) // 2, len(blob) - 1})
    for n, cut in enumerate(cuts, 1):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        assert st.get(("k",)) is None
        assert guard.health().get("persist.dropped") == n
        assert not os.path.exists(path)


def test_bit_flip_sweep_reads_cold(tmp_path):
    st, path, blob = _one_entry(tmp_path)
    offsets = list(range(0, len(blob), max(1, len(blob) // 23))) + [-1]
    for n, off in enumerate(offsets, 1):
        body = bytearray(blob)
        body[off] ^= 0x40
        with open(path, "wb") as f:
            f.write(bytes(body))
        assert st.get(("k",)) is None, off
        assert st.dropped == n
    with open(path, "wb") as f:
        f.write(blob)
    assert torch.equal(st.get(("k",))["a"], torch.arange(8.0))


def test_version_salt_and_foreign_files_read_cold(tmp_path):
    st, path, blob = _one_entry(tmp_path)
    rest = blob[len(persist._MAGIC):]
    nl = rest.index(b"\n")
    header = json.loads(rest[:nl])
    header["version"] += 1
    with open(path, "wb") as f:
        f.write(persist._MAGIC + json.dumps(header).encode() + b"\n"
                + rest[nl + 1:])
    assert st.get(("k",)) is None and st.dropped == 1
    _store(tmp_path, salt="code-v1").put(("s",), 1)
    assert _store(tmp_path, salt="code-v2").get(("s",)) is None
    # a reference snapshot is a foreign file to the port
    jpersist.SnapshotStore(str(tmp_path / "snap")).put(("j",), 1)
    with open(os.path.join(st.directory, "junk.snap"), "wb") as f:
        f.write(b"garbage")
    with open(os.path.join(st.directory, "README"), "w") as f:
        f.write("not a snapshot")
    st.put(("k",), 5)
    assert [k for k, _ in st.items()] == [("k",)]
    assert guard.health().get("persist.dropped") == 4


def test_injected_persist_faults_are_absorbed(tmp_path):
    st = _store(tmp_path)
    with fault.inject(fault.FaultPlan(schedule={"persist.save": [0],
                                                "persist.load": [0]})):
        assert not st.put(("k",), 1)
        assert st.put(("k",), 1)
        assert st.get(("k",)) is None
        assert st.get(("k",)) == 1
    assert st.faults == 2 and guard.health().get("persist.fault") == 2


# ---------------------------------------------------------------------------
# The durable plan cache and pinned tier
# ---------------------------------------------------------------------------

def test_warm_plan_cache_and_pinned_store_search_nothing(tmp_path):
    cfg = minkunet.MinkUNetConfig(**TINY)
    c, b, v = _cloud(2, 67)

    def caches():
        st = _store(tmp_path)
        return planlib.PlanCache(
            persist=st, pinned=feature_cache.PinnedStore(persist=st))

    first = caches()
    n0 = planlib.MAPSEARCH_CALLS[0]
    p1 = minkunet.build_plans(c, b, v, cfg, cache=first, device="cpu")
    assert planlib.MAPSEARCH_CALLS[0] - n0 == 2 * len(cfg.enc) + 1
    warm = caches()
    n0 = planlib.MAPSEARCH_CALLS[0]
    p2 = minkunet.build_plans(c.clone(), b.clone(), v.clone(), cfg,
                              cache=warm, device="cpu")
    assert planlib.MAPSEARCH_CALLS[0] - n0 == 0
    assert warm.persist_hits == 7 and warm.misses == 0
    _equal_trees(tuple(p2), tuple(p1))
    # the pinned tier reads through to disk too (not verifying)
    ps = feature_cache.PinnedStore(persist=_store(tmp_path))
    keys = [k for k, _ in _store(tmp_path).items() if k[0] == "pinned"]
    assert len(keys) == len(cfg.enc) + 1
    assert ps.get(keys[0][1]) is not None and ps.persist_hits == 1
    # save / load without write-through
    fresh = planlib.PlanCache(pinned=feature_cache.PinnedStore())
    other = persist.SnapshotStore(str(tmp_path / "other"))
    minkunet.build_plans(c, b, v, cfg, cache=first, device="cpu")
    assert first.save(other) == 7 and fresh.load(other) == 7
    n0 = planlib.MAPSEARCH_CALLS[0]
    minkunet.build_plans(c.clone(), b, v, cfg, cache=fresh, device="cpu")
    assert planlib.MAPSEARCH_CALLS[0] - n0 == 0


def test_pinned_store_rehydrates_anchorless(tmp_path):
    ps = feature_cache.PinnedStore(persist=_store(tmp_path))
    ps.put(("qtable", "fp"), {"q": torch.arange(6)})
    ps2 = feature_cache.PinnedStore(persist=_store(tmp_path))
    assert torch.equal(ps2.get(("qtable", "fp"))["q"], torch.arange(6))
    assert ps2.persist_hits == 1
    # a verifying reader neither reads through nor serves an entry
    # loaded without its anchor
    ps3 = feature_cache.PinnedStore(persist=_store(tmp_path))
    assert ps3.get(("qtable", "fp"), anchor=(torch.arange(6),),
                   verify=True) is None
    assert ps3.load() == 1 and ps3.save(_store(tmp_path / "x")) == 1
    assert ps3.get(("qtable", "fp"), anchor=(torch.arange(6),),
                   verify=True) is None


def test_warm_training_demo_searches_as_the_reference(tmp_path):
    got = []
    for run, extra in ((run_spconv_demo, {"device": "cpu"}),
                       (jrun_demo, {"impl": "ref"})):
        d = str(tmp_path / run.__module__)
        counts = [run(steps=2, voxels=93, persist_dir=d, **extra)[
            "mapsearch_calls"] for _ in range(2)]
        got.append(counts)
    assert got[0] == got[1] == [5, 0]


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------

def _serve_requests():
    """The restart gate's four requests."""
    reqs = []
    for i in range(4):
        rng = np.random.default_rng(100 + i)
        vb = pointcloud.make_batch(rng, "indoor" if i % 2 else "lidar", 1,
                                   36 if i % 2 else 72)
        reqs.append((f"req-{i}", vb))
    return reqs


def _engine(persist_dir, cfg=None):
    cfg = cfg or minkunet.MinkUNetConfig(**TINY)
    model = minkunet.MinkUNet(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    return spconv_serve.ServeEngine(
        model, device="cpu", max_batch=1, persist_dir=persist_dir,
        queue=admission.AdmissionQueue(buckets=SERVE_BUCKETS))


def test_recover_requeues_and_sheds_as_the_reference(tmp_path):
    reqs = _serve_requests()
    ref = _engine(None)
    for rid, vb in reqs:
        ref.submit(rid, vb.coords, vb.batch, vb.valid, vb.feats)
    want = {r.rid: r.digest for r in ref.drain()}

    pdir = str(tmp_path / "p")
    eng = _engine(pdir)
    for i, (rid, vb) in enumerate(reqs):
        eng.submit(rid, vb.coords, vb.batch, vb.valid, vb.feats,
                   deadline_s=-1.0 if i == 3 else 600.0)
    eng.step()                               # one served, three journaled
    assert len(eng.journal) == 3
    with guard.scoped_health() as h:
        again = _engine(pdir)
        assert again.recover() == {"recovered": 2, "shed": 1}
        done = {r.rid: r.digest for r in again.drain()
                if r.status == "completed"}
        assert done == {k: want[k] for k in ("req-1", "req-2")}
        assert len(again.journal) == 0
        port_h = h.snapshot()
    # the reference's engine over its own journal: the same outcome
    jcfg = jminkunet.MinkUNetConfig(**TINY)
    jparams = jminkunet.init_model(jcfg, jax.random.key(0))

    def jengine():
        return jserve.ServeEngine(
            jparams, jcfg, impl="ref", max_batch=1,
            persist_dir=str(tmp_path / "j"),
            queue=jadmission.AdmissionQueue(buckets=SERVE_BUCKETS))

    jeng = jengine()
    for i, (rid, vb) in enumerate(reqs):
        jeng.submit(rid, vb.coords, vb.batch, vb.valid, vb.feats,
                    deadline_s=-1.0 if i == 3 else 600.0)
    jeng.step()
    with jguard.scoped_health() as jh:
        jagain = jengine()
        assert jagain.recover() == {"recovered": 2, "shed": 1}
        jagain.drain()
        assert [(r.rid, r.status, r.reason) for r in jagain.results] == \
            [(r.rid, r.status, r.reason) for r in again.results]
        ref_h = jh.snapshot()
    assert port_h == ref_h
    assert port_h["serve.recovered"] == 2
    assert port_h["admit.shed.restart"] == 1


# ---------------------------------------------------------------------------
# Checkpoint and runner
# ---------------------------------------------------------------------------

def test_checkpoint_site_fires_before_any_file_io(tmp_path):
    d = str(tmp_path / "ckpt")
    with fault.inject(fault.FaultPlan(schedule={"checkpoint": [0]})):
        with pytest.raises(fault.InjectedFault):
            checkpoint.save(d, 0, {"w": torch.ones(3)})
        assert not os.path.exists(d)
        checkpoint.save(d, 1, {"w": torch.ones(3)})
    assert checkpoint.latest_step(d) == 1
    assert guard.health().get("fault.checkpoint") == 1


def test_runner_notes_its_events_as_the_reference(tmp_path):
    def step(state, batch):
        return state + batch, {"loss": float(state)}

    def hook(s):
        if s == 1 and fails[0] < 2:
            fails[0] += 1
            raise RuntimeError("node lost")

    got = []
    for mod, g, like in ((fault, guard, torch.zeros(())),
                         (jfault, jguard, np.zeros((), np.float32))):
        fails = [0]
        with g.scoped_health() as h, mod.inject(mod.FaultPlan(
                schedule={"checkpoint": [2]})):
            runner = mod.TrainRunner(
                mod.RunnerConfig(ckpt_dir=str(tmp_path / mod.__name__),
                                 ckpt_every=1, max_skipped_batches=1),
                step, lambda s: 1.0, like)
            losses = runner.run(3, fail_hook=hook)
            got.append(([float(x) for x in losses], runner.recoveries,
                         runner.ckpt_failures, h.snapshot()))
    assert got[0] == got[1]
    assert got[0][3] == {"runner.recovery": 2, "runner.ckpt_failure": 1,
                         "fault.checkpoint": 1}


def test_async_save_of_the_runner(tmp_path):
    """``save(blocking=False)`` writes on a thread that the next save
    joins, so both checkpoints land."""
    runner = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path)),
                         lambda s, b: (s + b, {"loss": 0.0}),
                         lambda s: torch.ones(2), torch.zeros(2))
    runner.save(blocking=False)
    runner.step, runner.state = 1, torch.ones(2)
    runner.save()
    assert checkpoint.all_steps(str(tmp_path)) == [0, 1]
    assert torch.equal(checkpoint.restore(str(tmp_path), 1, torch.zeros(2)),
                       torch.ones(2))
    assert len(runner.save_ms) == 2


# ---------------------------------------------------------------------------
# SIGKILL and restart (subprocesses on the CPU)
# ---------------------------------------------------------------------------

_SERVE_WORKER = """
import numpy as np, torch
from repro_torch.data import pointcloud
from repro_torch.launch import spconv_serve
from repro_torch.models import minkunet
from repro_torch.runtime import admission, fault
model = minkunet.MinkUNet(minkunet.MinkUNetConfig(**{tiny!r}), device="cpu",
                          generator=torch.Generator().manual_seed(0))
eng = spconv_serve.ServeEngine(
    model, device="cpu", max_batch=1, persist_dir={pdir!r},
    queue=admission.AdmissionQueue(buckets={buckets!r}))
for i in range(4):
    vb = pointcloud.make_batch(np.random.default_rng(100 + i),
                               "indoor" if i % 2 else "lidar", 1,
                               36 if i % 2 else 72)
    eng.submit(f"req-{{i}}", vb.coords, vb.batch, vb.valid, vb.feats,
               deadline_s=600)
with fault.inject(fault.FaultPlan(schedule={{fault.KILL_SITE: [{kill}]}})):
    eng.drain()
"""

_TRAIN_WORKER = """
from repro_torch.launch.train import run_spconv_demo
from repro_torch.runtime import fault
run_spconv_demo(steps=3, total_steps=3, voxels=89, device="cpu",
                ckpt_dir={ckpt!r},
                faults=fault.FaultPlan(schedule={{fault.KILL_SITE: [{kill}]}}))
"""


def _run_killed(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]


def test_serve_killed_mid_snapshot_recovers_the_digests(tmp_path):
    cfg = minkunet.MinkUNetConfig(**TINY)
    ref = _engine(None)
    for rid, vb in _serve_requests():
        ref.submit(rid, vb.coords, vb.batch, vb.valid, vb.feats)
    want = {r.rid: r.digest for r in ref.drain()}
    # kill-site calls a fresh request: its tick, then one per snapshot
    # write (Subm3, Gconv2 and Tconv2 plans, pinned tables); the kill
    # lands on the second request's fourth write
    puts = 2 * (len(cfg.enc) + 1) + len(cfg.enc) + len(cfg.dec)
    pdir = str(tmp_path / "p")
    _run_killed(_SERVE_WORKER.format(tiny=TINY, pdir=pdir,
                                     buckets=SERVE_BUCKETS,
                                     kill=(1 + puts) + 1 + 3))
    snap = os.path.join(pdir, "snap")
    assert any(n.startswith(".tmp-") for n in os.listdir(snap))
    eng = _engine(pdir)
    assert eng.recover() == {"recovered": 3, "shed": 0}
    got = {r.rid: r.digest for r in eng.drain() if r.status == "completed"}
    assert got == {k: want[k] for k in ("req-1", "req-2", "req-3")}
    assert len(eng.journal) == 0 and eng.persist.hits > 0


def test_training_killed_mid_checkpoint_resumes_bit_equal(tmp_path):
    want = run_spconv_demo(steps=3, total_steps=3, voxels=89,
                           device="cpu")["state_digest"]
    ckpt = str(tmp_path / "ckpt")
    # kill-site calls: each save's write, then each step; call 4 is the
    # checkpoint after step 2, between its temporary write and the rename
    _run_killed(_TRAIN_WORKER.format(ckpt=ckpt, kill=4))
    assert any(n.startswith(".tmp-") for n in os.listdir(ckpt))
    res = run_spconv_demo(steps=3, total_steps=3, voxels=89, device="cpu",
                          ckpt_dir=ckpt, resume=True)
    assert res["resumed_from"] == 1 and res["state_digest"] == want
