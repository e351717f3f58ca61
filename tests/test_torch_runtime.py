"""Parity of the port's guarded runtime against the JAX package.

The fault plan, the fallback dispatch, the replan counters, admission
control and the serving engine of ``repro_torch`` are held to ``repro`` on
the same numpy inputs, on the CPU:

* ``FaultPlan`` fires at the same calls in both packages (schedule and
  seeded-rate modes), and ``check`` / ``mangle`` count the same health;
* ``dispatch`` retries, quarantines, cools down and counts as the
  reference's with ``REPRO_GUARD_FALLBACK=1`` on both sides; the port's
  default (``"0"``) never serves the plain version, and on the card's
  tensors neither does ``"1"`` (an empty chain);
* admission outcomes, typed reasons and ``admit.*`` counters under
  ``strict`` and ``repair``, backpressure, deadline shedding, ``restore``
  and ``shed_all``;
* the reference's serve-replay mix (``benchmarks/serve_replay.py``)
  through both engines, clean and under its fault plan: the same outcomes,
  ledgers and health deltas, logits within 1e-4 of their scale, and
  digests equal across the clean and faulted replays;
* the degradation ladder's climb, shed and recovery (level 2 forces the
  plain versions on the CPU only).
"""
from __future__ import annotations

import logging

import numpy as np
import jax
import pytest
import torch

from benchmarks import serve_replay
from repro.core import plan as jplan
from repro.launch import spconv_serve as jserve
from repro.models import minkunet as jminkunet
from repro.runtime import admission as jadmission, fault as jfault
from repro.runtime import guard as jguard
from repro_torch.core import plan as planlib
from repro_torch.kernels.octent import ops as oct_ops
from repro_torch.kernels.spconv_gemm import ops as sg_ops
from repro_torch.launch import spconv_serve
from repro_torch.models import minkunet
from repro_torch.runtime import admission, fault, guard

logging.getLogger("repro.guard").setLevel(logging.ERROR)
logging.getLogger("repro.fault").setLevel(logging.ERROR)
logging.getLogger("repro_torch.guard").setLevel(logging.ERROR)
logging.getLogger("repro_torch.fault").setLevel(logging.ERROR)

#: the serving gates' model (benchmarks/serve_replay.py)
JCFG = jminkunet.MinkUNetConfig(stem=8, enc=(8, 16), dec=(16, 8), classes=4,
                                blocks=1)
CFG = minkunet.MinkUNetConfig(stem=8, enc=(8, 16), dec=(16, 8), classes=4,
                              blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tests run thousands of
    small ops, which the default thread pool slows by an order of
    magnitude when parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jparams():
    return jminkunet.init_model(JCFG, jax.random.key(0))


def _model(jparams):
    m = minkunet.MinkUNet(CFG, device="cpu")
    m.load_state_dict(minkunet.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return m


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

def test_fault_site_names_match_reference():
    assert fault.FAULT_SITES == jfault.FAULT_SITES
    assert fault.KILL_SITE == jfault.KILL_SITE
    assert fault.TRAIN_FAULT_SITES == jfault.TRAIN_FAULT_SITES
    assert fault.SERVE_FAULT_SITES == jfault.SERVE_FAULT_SITES


@pytest.mark.parametrize("kw", [
    dict(schedule={"search": [0, 3], "gemm": [1], "admit": [2, 3]}),
    dict(rate=0.3, seed=7),
    dict(rate=0.5, seed=1, sites=("plan", "batch")),
    dict(schedule={"plan": [4]}, rate=0.2, seed=3),
])
def test_fault_plan_fires_as_the_reference(kw):
    rng = np.random.default_rng(0)
    sites = rng.choice(list(fault.FAULT_SITES), size=200)
    plans = (fault.FaultPlan(**kw), jfault.FaultPlan(**kw))
    for site in sites:
        assert plans[0].fires(site) == plans[1].fires(site)
    assert plans[0].fired == plans[1].fired
    assert plans[0].calls == plans[1].calls
    assert plans[0].sites == plans[1].sites
    assert sum(map(len, plans[0].fired.values())) > 0


def test_check_and_mangle_count_health_as_the_reference():
    sched = {"plan": [1], "fingerprint": [0, 2]}
    words = np.array([5, 6, 7], np.uint32)
    got = []
    for mod, g in ((fault, guard), (jfault, jguard)):
        with g.scoped_health() as h, mod.inject(mod.FaultPlan(
                schedule=sched)):
            raised = []
            for _ in range(3):
                try:
                    mod.check("plan")
                    raised.append(None)
                except mod.InjectedFault as e:
                    raised.append((e.site, e.index))
            mangled = [np.asarray(mod.mangle("fingerprint", words)).tolist()
                       for _ in range(3)]
            got.append((raised, mangled, h.snapshot()))
    assert got[0] == got[1]
    assert got[0][0] == [None, ("plan", 1), None]
    assert got[0][1] == [[0, 0, 0], [5, 6, 7], [0, 0, 0]]
    assert got[0][2] == {"fault.plan": 1, "fault.fingerprint": 2}
    assert fault.active() is None


def test_kill_site_is_never_drawn_by_rate():
    plan = fault.FaultPlan(rate=1.0)
    assert fault.KILL_SITE not in plan.sites
    with fault.inject(plan):
        fault.check(fault.KILL_SITE)       # would SIGKILL if it fired
    assert fault.KILL_SITE not in plan.fired


# ---------------------------------------------------------------------------
# dispatch: retry, quarantine, cooldown
# ---------------------------------------------------------------------------

def _dispatch_script(g, primary, monkeypatch):
    """Run one scripted sequence of dispatches; returns what each served
    and the health after each."""
    monkeypatch.setenv("REPRO_GUARD_FALLBACK", "1")
    monkeypatch.setenv("REPRO_GUARD_COOLDOWN", "3")
    # per call: how many times the primary fails before it succeeds
    fails = [0, 1, 2, 0, 0, 0, 0, 2, 0, 0]
    keys = [("a",), ("a",), ("a",), ("a",), ("b",), ("a",), ("a",), ("b",),
            ("b",), ("a",)]
    out = []
    with g.scoped_health() as h:
        for n_fail, key in zip(fails, keys):
            left = [n_fail]

            def call(one):
                if one == primary and left[0] > 0:
                    left[0] -= 1
                    raise RuntimeError("flaky")
                return one

            served = g.dispatch("gemm", primary,
                                g.FALLBACK_CHAINS["gemm"][primary], call,
                                key=key)
            out.append(("primary" if served == primary else served,
                        h.snapshot()))
    return out


def test_dispatch_matches_reference_with_the_chain_on(monkeypatch):
    got = _dispatch_script(guard, "kernel", monkeypatch)
    want = _dispatch_script(jguard, "pallas", monkeypatch)
    assert got == want
    served = [s for s, _ in got]
    # a one-shot recovers on the primary; a second failure quarantines
    # its key for 3 calls of that key, then the primary serves it again
    assert served == ["primary", "primary", "ref", "ref", "primary", "ref",
                      "ref", "ref", "ref", "primary"]
    assert got[-1][1] == {"retry.ok.gemm": 1, "fallback.error.gemm": 5,
                          "quarantine.enter.gemm": 2,
                          "quarantine.skip.gemm": 4,
                          "fallback.served.gemm": 6,
                          "fallback.served.gemm.ref": 6}


def test_dispatch_default_is_off_in_the_port(monkeypatch):
    monkeypatch.delenv("REPRO_GUARD_FALLBACK", raising=False)
    assert not guard.fallback_enabled() and jguard.fallback_enabled()
    assert guard.fallback_cooldown() == jguard.fallback_cooldown() == 32

    def call(one):
        raise RuntimeError(f"{one} failed")

    with guard.scoped_health() as h:
        with pytest.raises(RuntimeError, match="kernel failed"):
            guard.dispatch("search", "kernel", ("ref",), call)
        assert h.snapshot() == {}


def test_the_card_has_no_fallback_chain(monkeypatch):
    """On the card a kernel that fails raises: its chain is empty, so with
    ``REPRO_GUARD_FALLBACK=1`` dispatch retries it, quarantines it and
    raises for the cooldown's calls, then tries it again, and never
    serves the plain version. The CPU keeps the reference's chain."""
    for site in ("search", "gemm"):
        assert guard.fallback_chain(site, "kernel", torch.device("cpu")) \
            == guard.FALLBACK_CHAINS[site]["kernel"] == ("ref",)
        assert guard.fallback_chain(site, "kernel",
                                    torch.device("cuda", 0)) == ()
        assert guard.fallback_chain(site, "ref", "cuda") == ()
    monkeypatch.setenv("REPRO_GUARD_FALLBACK", "1")
    monkeypatch.setenv("REPRO_GUARD_COOLDOWN", "2")
    tried = []

    def call(one):
        tried.append(one)
        raise RuntimeError(f"{one} failed")

    chain = guard.fallback_chain("gemm", "kernel", torch.device("cuda", 0))
    with guard.scoped_health() as h:
        for _ in range(4):
            with pytest.raises(RuntimeError):
                guard.dispatch("gemm", "kernel", chain, call)
        assert tried == ["kernel"] * 4
        assert h.snapshot() == {"fallback.error.gemm": 4,
                                "quarantine.enter.gemm": 2,
                                "quarantine.skip.gemm": 2}


def test_ladder_level_two_keeps_the_kernel_on_the_card():
    """Level 2 forces the plain versions on the CPU only: on the card the
    engine keeps its impl."""
    eng = spconv_serve.ServeEngine(
        minkunet.MinkUNet(CFG, device="cpu",
                          generator=torch.Generator().manual_seed(0)),
        device="cpu", max_batch=1)
    assert eng._impl_now() == "kernel"
    eng.level = 2
    assert eng._impl_now() == "ref"
    eng.device = torch.device("cuda", 0)
    assert eng._impl_now() == "kernel"


def _layer(seed=0):
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, 10, (150, 3)), axis=0)[:96]
    n = coords.shape[0]
    c = torch.from_numpy(coords.astype(np.int32))
    b = torch.zeros(n, dtype=torch.int32)
    v = torch.ones(n, dtype=torch.bool)
    kmap, _ = oct_ops.build_kmap(c, b, v, max_blocks=n, impl="ref")
    tiles = sg_ops.build_tap_tiles(kmap, bm=32)
    f = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((27, 8, 16)).astype(
        np.float32))
    return c, b, v, kmap, tiles, f, w


@pytest.mark.parametrize("site", ["gemm", "search"])
def test_persistent_fault_never_serves_the_plain_version(site, monkeypatch):
    """With the chain off (the default) a persistent injected fault raises
    on the first try; with it on the plain version serves the call,
    bit-equal on the CPU to the clean result."""
    c, b, v, kmap, tiles, f, w = _layer()

    def run():
        if site == "gemm":
            return sg_ops.apply_tiles(f, w, tiles, n_out=f.shape[0])
        return oct_ops.build_kmap(c, b, v, max_blocks=c.shape[0])[0]

    clean = run()
    monkeypatch.delenv("REPRO_GUARD_FALLBACK", raising=False)
    with guard.scoped_health() as h, fault.inject(
            fault.FaultPlan(rate=1.0, sites=(site,))):
        with pytest.raises(fault.InjectedFault):
            run()
        assert h.snapshot() == {f"fault.{site}": 1}
    monkeypatch.setenv("REPRO_GUARD_FALLBACK", "1")
    with guard.scoped_health() as h, fault.inject(
            fault.FaultPlan(schedule={site: [0, 1]})):
        out = run()
        assert h.snapshot() == {
            f"fault.{site}": 2, f"fallback.error.{site}": 2,
            f"quarantine.enter.{site}": 1, f"fallback.served.{site}": 1,
            f"fallback.served.{site}.ref": 1}
    assert torch.equal(out, clean)


def test_with_replan_counts_overflow_and_recovery_as_the_reference():
    from repro.core import validate as jvalidate
    got = []
    for g, exc in ((guard, planlib.CapacityOverflow),
                   (jguard, jvalidate.CapacityOverflow)):
        def build(cap, exc=exc):
            if cap < 40:
                raise exc("block_table", "overflow", needed=30,
                          capacity=cap)
            return cap
        with g.scoped_health() as h:
            out = g.with_replan(build, 8, key=("replan-test", 8))
            got.append((out, h.snapshot(), dict(g._CAPACITY_HINTS)))
    assert got[0] == got[1]
    assert got[0][:2] == (60, {"replan.overflow": 2, "replan.recovered": 1})


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------

def _clouds():
    rng = np.random.default_rng(3)
    n = 40
    lin = rng.choice(20 ** 3, size=n, replace=False)
    c = np.stack([lin % 20, (lin // 20) % 20, lin // 400], -1).astype(
        np.int32)
    b = np.zeros(n, np.int32)
    v = np.ones(n, bool)
    f = rng.standard_normal((n, 4)).astype(np.float32)
    nan = c.astype(np.float32)
    nan[2] = np.nan
    frac = c.astype(np.float32)
    frac[5] += 0.5
    oog = c.copy()
    oog[1, 0] = 5000
    dup = c.copy()
    dup[7] = dup[3]
    nanf = f.copy()
    nanf[4, 1] = np.inf
    big = np.stack([np.arange(100) % 10, np.arange(100) // 10,
                    np.zeros(100)], -1).astype(np.int32)
    return {"clean": (c, b, v, f), "nan_coords": (nan, b, v, f),
            "fractional": (frac, b, v, f), "out_of_grid": (oog, b, v, f),
            "duplicate": (dup, b, v, f), "nan_feats": (c, b, v, nanf),
            "oversize": (big, np.zeros(100, np.int32), np.ones(100, bool),
                         np.zeros((100, 4), np.float32)),
            "empty": (c, b, np.zeros(n, bool), f)}


def _outcome(out):
    if isinstance(out, (admission.Rejection, jadmission.Rejection)):
        return ("rejection", out.reason, out.kind, out.shed)
    return ("request", out.bucket, out.n_valid,
            tuple(np.asarray(a).tobytes() for a in (
                out.coords, out.batch, out.valid, out.feats)))


@pytest.mark.parametrize("mode", ["strict", "repair"])
def test_admission_outcomes_match_reference(mode, monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_VALIDATE", mode)
    assert admission.serve_policy() == (
        admission.validate.STRICT if mode == "strict"
        else admission.validate.REPAIR)
    got = []
    for adm, g in ((admission, guard), (jadmission, jguard)):
        with g.scoped_health() as h:
            q = adm.AdmissionQueue(capacity=16, buckets=(48, 64),
                                   clock=lambda: 0.0)
            outs = {k: _outcome(q.submit(k, *cl))
                    for k, cl in _clouds().items()}
            got.append((outs, h.snapshot(), q.depth))
    assert got[0] == got[1]
    outs = got[0][0]
    assert outs["clean"][0] == "request" and outs["clean"][1] == 48
    if mode == "strict":
        assert outs["nan_coords"][1:3] == (admission.REJECT_INVALID, "dtype")
        assert outs["oversize"][1:3] == (admission.REJECT_OVERSIZE,
                                         "oversize")
        assert outs["duplicate"][1:3] == (admission.REJECT_INVALID,
                                          "duplicate")
    else:
        assert outs["duplicate"][0] == outs["out_of_grid"][0] == "request"


def test_admission_queue_mechanics_match_reference():
    got = []
    c, b, v, f = _clouds()["clean"]
    for adm, flt, g in ((admission, fault, guard),
                        (jadmission, jfault, jguard)):
        now = [0.0]
        with g.scoped_health() as h, flt.inject(flt.FaultPlan(
                schedule={"admit": [0, 4, 5]})):
            q = adm.AdmissionQueue(capacity=4, buckets=(48,),
                                   clock=lambda: now[0])
            outs = [_outcome(q.submit("a", c, b, v, f, deadline_s=10.0)),
                    _outcome(q.submit("b", c, b, v, f, deadline_s=0.5)),
                    _outcome(q.submit("c", c, b, v, f)),
                    _outcome(q.submit("victim", c, b, v, f)),
                    _outcome(q.submit("d", c, b, v, f)),
                    _outcome(q.submit("e", c, b, v, f))]
            depth = q.depth
            now[0] = 1.0
            taken, shed = q.take(2, est_service_s=lambda bucket: 0.1)
            outs.append(([r.rid for r in taken],
                         [(r.rid, r.reason) for r in shed]))
            req = taken[0]
            outs.append(_outcome(q.restore(req)))
            now[0] = 20.0
            outs.append(_outcome(q.restore(req)))
            outs.append([(r.rid, r.reason) for r in q.shed_all()])
            got.append((outs, depth, h.snapshot(), len(q)))
    assert got[0] == got[1]
    outs, depth, health, left = got[0]
    assert outs[3][1] == admission.ISOLATED_FAULT
    assert outs[4][0] == "request"
    assert outs[5][1] == admission.SHED_QUEUE_FULL and depth == 4
    assert outs[6] == (["a", "c"], [("b", admission.SHED_DEADLINE)])
    assert outs[7][0] == "request"
    assert outs[8][1] == admission.SHED_RESTART
    assert outs[9] == [("d", admission.SHED_OVERLOAD),
                       ("a", admission.SHED_OVERLOAD)] and left == 0
    assert health["admit.retry"] == 2 and health["admit.restored"] == 1


# ---------------------------------------------------------------------------
# The serving engine: the reference's replay mix, the ladder
# ---------------------------------------------------------------------------

def _replay(engine_factory, mod, g, subs, plan):
    with g.scoped_health() as h:
        eng = engine_factory()
        with mod.inject(plan):
            for rid, (c, b, v, f), dl in subs:
                eng.submit(rid, c, b, v, f, deadline_s=dl)
            eng.drain()
        return eng, h.snapshot()


def _ledger(eng, health):
    s = eng.stats()
    return {k: s[k] for k in ("completed", "shed", "rejected", "isolated",
                              "degraded")}, \
        {k: health.get(f"serve.{k}", 0) for k in (
            "completed", "shed", "rejected", "isolated", "degraded")}


def test_serve_replay_matches_reference(monkeypatch):
    """The reference gate's mix through both engines with the fallback
    chain on (the reference's semantics), clean and faulted."""
    monkeypatch.setenv("REPRO_GUARD_FALLBACK", "1")
    subs, clean_rids, victim = serve_replay._request_mix(2, 2)
    schedule = serve_replay._fault_schedule(len(subs) - 1)
    jparams = _jparams()
    model = _model(jparams)

    def port():
        return spconv_serve.ServeEngine(
            model, device="cpu", max_batch=8, verify_cache=True,
            queue=admission.AdmissionQueue(capacity=64,
                                           buckets=serve_replay.BUCKETS))

    def ref():
        return jserve.ServeEngine(
            jparams, JCFG, impl="ref", max_batch=8, verify_cache=True,
            queue=jadmission.AdmissionQueue(capacity=64,
                                            buckets=serve_replay.BUCKETS))

    runs = {}
    for name, mk in (("clean", lambda m: None),
                     ("faulted", lambda m: m.FaultPlan(schedule=schedule))):
        planlib.reset_mapsearch_counter()
        jplan.reset_mapsearch_counter()
        pe, ph = _replay(port, fault, guard, subs, mk(fault))
        je, jh = _replay(ref, jfault, jguard, subs, mk(jfault))
        assert ph == jh, name
        pres = {r.rid: r for r in pe.results}
        jres = {r.rid: r for r in je.results}
        assert {k: (r.status, r.reason, r.degraded)
                for k, r in pres.items()} == \
            {k: (r.status, r.reason, r.degraded) for k, r in jres.items()}
        for rid, r in pres.items():
            if r.status == "completed":
                want = jres[rid].logits
                scale = max(1.0, float(np.abs(want).max()))
                assert float(np.abs(r.logits - want).max()) <= 1e-4 * scale
        got, want = _ledger(pe, ph)
        assert got == want, name
        if name == "clean":
            assert planlib.mapsearch_call_count() == \
                jplan.mapsearch_call_count() == 5 * (2 + 1)
        runs[name] = pres
    clean, faulted = runs["clean"], runs["faulted"]
    for rid in clean_rids:
        assert faulted[rid].status == "completed"
        assert faulted[rid].digest == clean[rid].digest
    assert faulted[victim].reason == admission.ISOLATED_FAULT


def test_engine_retry_recovers_one_shot_faults_with_the_chain_off(
        monkeypatch):
    """The port's default: no fallback, so the engine's retry of the plan
    build and of the forward recovers each one-shot fault, bit-equal."""
    monkeypatch.delenv("REPRO_GUARD_FALLBACK", raising=False)
    subs, clean_rids, _ = serve_replay._request_mix(2, 1)
    subs = [s for s in subs if s[0] in clean_rids]
    model = _model(_jparams())

    def port():
        return spconv_serve.ServeEngine(
            model, device="cpu", max_batch=1,
            queue=admission.AdmissionQueue(buckets=serve_replay.BUCKETS))

    clean, _ = _replay(port, fault, guard, subs, None)
    # a search fault on the first request, a gemm fault on the second's
    # first layer (5 layers a forward), a batch fault on the first tick
    plan = fault.FaultPlan(schedule={"search": [1], "gemm": [5],
                                     "batch": [0]})
    faulted, h = _replay(port, fault, guard, subs, plan)
    assert {r.rid: r.digest for r in faulted.results} == \
        {r.rid: r.digest for r in clean.results}
    # one entry a bucket class: the two requests fall in two buckets
    assert h == {"admit.ok": 2, "serve.completed": 2, "fault.search": 1,
                 "serve.build_retry": 1, "fault.gemm": 1,
                 "serve.exec_retry": 1, "fault.batch": 1,
                 "serve.batch_retry": 1, "serve.compile": 2}


def test_ladder_climbs_sheds_and_recovers_as_the_reference():
    subs, _, _ = serve_replay._request_mix(4, 1)
    fresh = [s for s in subs if s[0].startswith("clean-")]
    jparams = _jparams()
    model = _model(jparams)
    sequence = [fresh[0], fresh[1], fresh[2], fresh[0], fresh[3], fresh[0]]
    got = []
    for mod, g, eng in (
            # impl="ref" as the reference's engine: level 2 then keeps
            # the entry's key, and the compile counts agree
            (fault, guard, spconv_serve.ServeEngine(
                model, device="cpu", impl="ref", max_batch=1,
                recover_after=2, queue=admission.AdmissionQueue(
                    buckets=serve_replay.BUCKETS))),
            (jfault, jguard, jserve.ServeEngine(
                jparams, JCFG, impl="ref", max_batch=1, recover_after=2,
                queue=jadmission.AdmissionQueue(
                    buckets=serve_replay.BUCKETS)))):
        trace = []
        with g.scoped_health() as h:
            for i, (rid, cl, dl) in enumerate(sequence):
                plan = None if i == 0 else mod.FaultPlan(rate=1.0,
                                                         sites=("plan",))
                with mod.inject(plan):
                    eng.submit(f"{rid}-{i}", *cl, deadline_s=dl)
                    (res,) = eng.step()
                trace.append((res.status, res.reason, res.degraded,
                              eng.level))
            for _ in range(6):
                eng.step()
                trace.append(eng.level)
            health = h.snapshot()
        got.append((trace, health))
    assert got[0] == got[1]
    trace, health = got[0]
    assert [t[-1] if isinstance(t, tuple) else t for t in trace] == \
        [0, 1, 2, 2, 3, 3, 2, 2, 1, 1, 0, 0]
    assert trace[3][:3] == ("completed", None, True)
    assert trace[5][:2] == ("shed", admission.SHED_OVERLOAD)
    assert health["serve.degrade.exit"] == 3
    assert health["admit.shed.overload"] == 1


def test_training_demo_survives_one_shot_faults(monkeypatch):
    """The chaos train gate (``benchmarks/chaos.py``): one fault at each
    training site. With the chain on, both packages count the same
    health; with the port's default (off) the runner's checkpoint replay
    recovers, and the final state is bit-equal to the fault-free run."""
    from repro.launch.train import run_spconv_demo as jrun_demo
    from repro_torch.launch.train import run_spconv_demo
    schedule = {"search": [1], "gemm": [3], "plan": [2],
                "fingerprint": [1], "checkpoint": [1]}
    kw = dict(steps=2, voxels=91)
    clean = run_spconv_demo(device="cpu", **kw)["state_digest"]
    monkeypatch.setenv("REPRO_GUARD_FALLBACK", "1")
    with guard.scoped_health(), jguard.scoped_health():
        got = run_spconv_demo(device="cpu", faults=fault.FaultPlan(
            schedule=schedule), **kw)
        want = jrun_demo(impl="ref", faults=jfault.FaultPlan(
            schedule=schedule), **kw)
    assert got["health"] == want["health"]
    assert got["state_digest"] == clean
    # chain off: every fault in a step costs the runner a replay of it
    # (three land in step 0), so it gets the retries to cover them
    monkeypatch.delenv("REPRO_GUARD_FALLBACK")
    with guard.scoped_health():
        off = run_spconv_demo(device="cpu", faults=fault.FaultPlan(
            schedule=schedule), max_retries_per_step=3, **kw)
    assert off["state_digest"] == clean and off["recoveries"] == 3
    assert not any(k.startswith("fallback.") for k in off["health"])
    assert {f"fault.{s}" for s in fault.TRAIN_FAULT_SITES} <= \
        set(off["health"])
