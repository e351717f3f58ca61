"""The benchmark's core: the loop, the clock, the output check and the
result line. It knows no configuration, traffic or metric by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics; the
files of a cell are found by name under ``bench/``:

* ``bench/workloads/<cell>.json``: its configuration, its traffic
  generator and that generator's ``params``, the ``loop`` (requests
  outstanding, warm-up requests), the ``check`` (requests compared,
  limits), ``chips`` and ``why``;
* ``bench/configs/<config>.json``: the model as it is run (its ``family``,
  widths, padding bucket, precision) and how traffic may relabel it;
* ``bench/drivers/<family>.py``: ``Driver``, which builds the program's
  model from the benchmark's weights and drives the program's entry;
* ``bench/reference/<family>.py``: the plain reference (``weight_spec``,
  ``reference``, ``gaps``, ``geometry``, ``layers``, ``searches``);
* ``bench/traffic/<generator>.py``: ``Stream``, the seeded requests;
* ``bench/metrics/<metric>.py``: ``read(ctx)``, one metric's reader, and
  its ``UNIT``.

A run sets up (weights from the seed, the driver, the traffic, the warm-up
requests), measures a closed loop for ``--seconds``, then checks a seeded
sample of the window's answers against the reference and prints one JSON
line. A rate is over every request that completed in the window and the
window's whole length, from its start to the last completion; a latency
is each request's own, from the hand-over of its host arrays to its host
outputs.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from bench import trace as tracelib
from bench import weights as weightlib
from bench import workcount

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules the process must not hold once the window closes
BANNED = ("jax", "jaxlib", "flax", "repro")


def _load(root: Path, kind: str, name: str):
    path = root / "bench" / kind / f"{name}.py"
    mod_name = f"bench_{kind}_{name}".replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    chips: int
    workload: dict
    config: dict
    driver: object
    reference: object
    traffic: object
    end_to_end: list     # metric names, in BENCHMARK.json's order
    per_layer: list
    metrics: dict        # metric name -> reader module


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    wl = json.loads((root / "bench" / "workloads" / f"{name}.json")
                    .read_text())
    cfg = json.loads((root / "bench" / "configs" / f"{wl['config']}.json")
                     .read_text())
    cfg["name"] = wl["config"]

    # a metric's ``workloads`` names the cells that report it; without
    # one, an end-to-end metric is every cell's and a per-layer metric is
    # every cell's that reports the end-to-end metric it moves
    def reports(m, default: bool) -> bool:
        return name in m["workloads"] if "workloads" in m else default

    e2e = [m["name"] for m in bench["end_to_end"] if reports(m, True)]
    per = [m["name"] for m in bench["per_layer"]
           if reports(m, m["moves"] in e2e)]
    return Cell(name, entries[0]["chips"], wl, cfg,
                _load(root, "drivers", cfg["family"]),
                _load(root, "reference", cfg["family"]),
                _load(root, "traffic", wl["generator"]),
                e2e, per, {m: _load(root, "metrics", m) for m in e2e + per})


class Record(NamedTuple):
    rid: str
    scans: int
    parts: tuple
    latency_s: float | None    # None: failed
    done_at: float


class Run(NamedTuple):
    setup_s: float
    window_s: float
    records: list
    sample: list          # [(request, outputs)]
    counters: dict        # deltas over the window
    spans: list
    trace: object         # trace.Trace or None
    memory_peak_bytes: int
    weights: dict
    bases: list
    t_closed: float       # perf_counter at the window's last completion


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _closed_loop(driver, stream, first: int, outstanding: int, rec, *,
                 until=None, count=None, keep=None):
    """Keep ``outstanding`` requests in the driver from request ``first``
    on, until the clock passes ``until`` or ``count`` requests were sent;
    then drain, with spans in ``rec``. Returns the records and the next
    request index."""
    inflight, records, i = {}, [], first

    def more():
        if count is not None:
            return i - first < count
        return time.perf_counter() < until

    while True:
        while len(inflight) < outstanding and more():
            with rec.span("client"):
                req = stream.request(i)
            t0 = time.perf_counter()
            with rec.span("submit"):
                ok = driver.submit(req)
            if ok:
                inflight[req["rid"]] = (req, t0)
            else:
                records.append(Record(req["rid"], req["scans"], req["parts"],
                                      None, time.perf_counter()))
            i += 1
        if not inflight:
            return records, i
        with rec.span("step"):
            done = driver.step()
        t1 = time.perf_counter()
        for rid, out in done:
            req, t0 = inflight.pop(rid)
            records.append(Record(rid, req["scans"], req["parts"],
                                  t1 - t0 if out is not None else None, t1))
            if keep is not None and out is not None:
                keep(req, out)


class Reservoir:
    """A seeded uniform sample of ``k`` of the answers offered."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = random.Random(seed)

    def __call__(self, req, out) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append((req, out))
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = (req, out)


def device_for(cell: Cell, allow_cpu: bool) -> torch.device:
    """The card, or an error naming what is missing."""
    if allow_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < cell.chips:
        raise SystemExit(f"the cell needs {cell.chips} cards, "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def run_cell(cell: Cell, seed: int, seconds: float, *, trace: bool,
             device: torch.device, t0: float) -> Run:
    """Set up, warm up, measure; the program's state is freed on return."""
    if cell.config["precision"] != "float32":
        raise ValueError(f"precision {cell.config['precision']!r}")
    # float32 as stated: no TF32 in matrix products or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = cell.config["model"]
    marks = [("imports", time.perf_counter())]
    w = weightlib.make(cell.reference.weight_spec(model), seed, device)
    marks.append(("weights", time.perf_counter()))
    driver = cell.driver.Driver(cell.config, w, device)
    marks.append(("program", time.perf_counter()))
    stream = cell.traffic.Stream(cell.workload["params"], cell.config, seed)
    marks.append(("traffic", time.perf_counter()))
    loop = cell.workload["loop"]
    _, nxt = _closed_loop(driver, stream, 0, loop["outstanding"],
                          tracelib.Recorder(), count=loop["warm_requests"])
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    print("set-up seconds: " + ", ".join(
        f"{name} {t - prev:.2f}" for (name, t), prev in
        zip(marks, [t0] + [t for _, t in marks])), file=sys.stderr)
    sample = Reservoir(cell.workload["check"]["sample"], seed)
    rec = tracelib.Recorder()
    _sync(device)
    c0 = driver.counters()
    prof = tracelib.start() if trace else None
    spans = driver.spans(rec) if trace else None
    t_start = time.perf_counter()
    with spans if spans is not None else contextlib.nullcontext():
        with rec.span(tracelib.WINDOW):
            records, _ = _closed_loop(driver, stream, nxt,
                                      loop["outstanding"], rec,
                                      until=t_start + seconds, keep=sample)
            _sync(device)
    t_end = max([r.done_at for r in records] + [t_start])
    summary = None
    if prof is not None:
        prof.stop()
        summary = tracelib.summarize(prof, rec)
        del prof
    c1 = driver.counters()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    driver.close()
    del driver
    gc.collect()
    return Run(t_start - t0, t_end - t_start, records, sample.items,
               {k: c1[k] - c0[k] for k in c0}, rec.spans, summary, peak,
               w, stream.bases, t_end)


def judge(cell: Cell, run: Run, device, *, precision: str = "float32"):
    """``(correct, numbers, limits)``: the comparison's numbers, each the
    worst over the sampled answers, and whether each keeps its limit (a
    reference ``precision`` other than float32 is the control, computed in
    the program's place and judged the same way). An answer that never
    came is as wrong as one that says the wrong thing."""
    unanswered = sum(r.latency_s is None for r in run.records)
    numbers = {"unanswered": unanswered,
               **_worst_gaps(cell, run, device, precision)}
    limits = {"unanswered": 0, **cell.workload["check"]["limits"]}
    correct = bool(run.sample) and set(numbers) == set(limits) and all(
        numbers[k] <= limits[k] for k in limits)
    return correct, numbers, limits


def _worst_gaps(cell: Cell, run: Run, device, precision: str) -> dict:
    worst: dict = {}
    model = cell.config["model"]
    for req, out in run.sample:
        ref = cell.reference.reference(run.weights, model, req,
                                       device=device)
        if precision != "float32":
            out = cell.reference.reference(run.weights, model, req,
                                           device=device,
                                           precision=precision)
        for k, v in cell.reference.gaps(out, ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
        del ref
    return worst


class Context:
    """What a metric reader reads (``bench/metrics/<metric>.py``)."""

    def __init__(self, cell: Cell, run: Run, device):
        self.cell, self.run, self.device = cell, run, device
        self.completed = [r for r in run.records if r.latency_s is not None]
        self.scans = sum(r.scans for r in self.completed)
        self._work = None

    def work(self) -> list:
        """``(layers, searches)`` of each completed request, from the
        reference's kernel maps of its base sweeps."""
        if self._work is None:
            per_base = {}
            model = self.cell.config["model"]
            self._work = []
            for r in self.completed:
                for b, _, _ in r.parts:
                    if b not in per_base:
                        per_base[b] = workcount.sweep_work(
                            self.cell.reference, model, self.run.bases[b],
                            self.device)
                self._work.append(workcount.request_work(
                    [per_base[b] for b, _, _ in r.parts]))
        return self._work


def _bins(run: Run, width: float) -> list:
    """Scans completed in each ``width`` seconds of the window."""
    t0 = run.t_closed - run.window_s
    out = [0] * max(1, int(run.window_s // width) + 1)
    for r in run.records:
        if r.latency_s is not None:
            out[min(int((r.done_at - t0) // width), len(out) - 1)] += r.scans
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def banned(modules) -> list:
    """The names among ``modules`` whose top-level name is banned, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in modules if m.split(".")[0] in BANNED)


def main(argv, *, t0: float, root: Path = ROOT,
         allow_cpu: bool = False) -> int:
    args = parse(argv)
    cell = load_cell(args.workload, root)
    device = device_for(cell, allow_cpu)
    run = run_cell(cell, args.seed, args.seconds, trace=bool(args.trace),
                   device=device, t0=t0)
    ctx = Context(cell, run, device)
    correct, numbers, limits = judge(cell, run, device)
    names = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for name in names:
        value = cell.metrics[name].read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.metrics[name].UNIT}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    held = banned(list(sys.modules))
    if held:
        print(f"the process holds {', '.join(held)}: the benchmark runs "
              f"the port alone", file=sys.stderr)
        return 3
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    line = {"correct": correct, "attempted": len(run.records),
            "failed": len(run.records) - len(ctx.completed),
            "metrics": metrics, "device": dev}
    if run.trace is not None:
        line["breakdown"] = tracelib.breakdown(run.trace)
    line["checks"] = checks
    sys.stderr.flush()
    print(f"seconds: set-up {run.setup_s:.2f}, window {run.window_s:.2f}, "
          f"then {time.perf_counter() - run.t_closed:.2f} to read the trace "
          f"and check; scans a 5 s bin: {_bins(run, 5.0)}", file=sys.stderr)
    print(f"compared {len(run.sample)} answers of {len(ctx.completed)}",
          file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
