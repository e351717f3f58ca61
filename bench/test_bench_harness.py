"""The harness on the CPU: the layout found by name, the shape
of ``BENCHMARK.json``, whole runs of small cells, and runs whose timed
path is broken underneath, which must come out not correct."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness, testing

ROOT = testing.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return testing.tiny_layout(tmp_path_factory.mktemp("layout"))


def test_benchmark_json_keeps_its_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == \
            c["reduced"]
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert NAME.match(w["name"]) and 0 < len(w["why"]) <= 200
        wl = json.loads((ROOT / "bench" / "workloads" /
                         f"{w['name']}.json").read_text())
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        mod = harness._load(ROOT, "metrics", m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        mod = harness._load(ROOT, "metrics", m["name"])
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_real_cell_loads_by_name():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.end_to_end[-1] == "setup_s" and cell.per_layer
        assert "setup_s" in cell.metrics


def test_new_files_are_found_by_name_with_no_edit(layout, tmp_path):
    """A configuration, a cell and a metric added as files (and entries
    in BENCHMARK.json) run, and every file already there is unchanged."""
    import shutil
    root = tmp_path
    shutil.copytree(layout, root, dirs_exist_ok=True)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "bench/configs/mk-tiny.json").read_text())
    cfg["model"]["classes"] = 7
    (root / "bench/configs/mk-seven.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "bench/workloads/mk-tiny.fresh.json")
                    .read_text())
    wl["config"] = "mk-seven"
    (root / "bench/workloads/mk-seven.fresh.json").write_text(
        json.dumps(wl))
    (root / "bench/metrics/requests_done.py").write_text(
        'UNIT = "requests"\nSOURCE = "host_clock"\nLAYER = "client"\n'
        'MOVES = "scans_per_s"\n\n\ndef read(ctx):\n'
        '    return len(ctx.completed)\n')
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "mk-seven.fresh", "config": "mk-seven",
                           "traffic": "fresh", "chips": 1, "why": "seven"})
    b["per_layer"].append({"name": "requests_done", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "client", "moves": "scans_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell("mk-seven.fresh", root)
    assert "requests_done" in cell.per_layer
    assert cell.config["model"]["classes"] == 7
    line = testing.run(root, "mk-seven.fresh", trace=1)
    assert line["correct"] is True
    assert line["metrics"]["requests_done"]["value"] == \
        line["attempted"] - line["failed"] > 0
    assert all(p.read_bytes() == data for p, data in before.items())


def _subprocess_modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_imports_neither_jax_nor_the_jax_package():
    """Every module a run imports: the harness, each real cell's driver,
    reference, traffic and metrics, the port they drive."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench import harness, control\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "for w in b['workloads']:\n"
        "    harness.load_cell(w['name'])\n"
        "import repro_torch.launch.spconv_serve\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'repro'))))\n")
    assert _subprocess_modules(code) == []


def test_the_reference_imports_nothing_of_the_port():
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import bench.reference.sparse, bench.reference.minkunet\n"
        "import bench.workcount\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('repro_torch', 'repro', 'jax'))))\n")
    assert _subprocess_modules(code) == []
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            assert not [n for n in names if n.split(".")[0] in
                        ("repro_torch", "repro", "jax")], path


def test_banned_modules_compare_whole_top_level_names():
    assert harness.banned(["reprox", "repro_torch", "repro_torch.core",
                           "jaxtyping", "bench"]) == []
    assert harness.banned(["repro.core", "jax", "flax.linen", "torch"]) \
        == ["flax.linen", "jax", "repro.core"]


@pytest.mark.parametrize("cell", ["mk-tiny.fresh", "mk-tiny.revisit"])
def test_a_clean_small_run_is_correct(layout, cell):
    line = testing.run(layout, cell)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"scans_per_s", "latency_p50_ms",
                                    "latency_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"
    for v in line["checks"].values():
        assert v["value"] <= v["limit"]


def test_a_traced_small_run_reports_its_layers(layout):
    line = testing.run(layout, "mk-tiny.revisit", trace=1)
    assert line["correct"] is True
    assert line["metrics"]["map_searches_per_scan"]["value"] == 0.0
    assert "window_s" in line["device"] and "breakdown" in line


def test_a_run_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        harness.main(["--workload", "minkunet-semkitti.fresh", "--seed", "1",
                      "--seconds", "1"], t0=0.0)
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_a_run_needs_the_program_beside_it(tmp_path):
    """A checkout of BENCHMARK.json and bench/ alone fails, printing no
    result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "minkunet-semkitti.fresh", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path,
        capture_output=True, text=True, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_reservoir_is_seeded_and_uniform_in_size():
    a, b = harness.Reservoir(3, 9), harness.Reservoir(3, 9)
    for i in range(50):
        a({"i": i}, None)
        b({"i": i}, None)
    assert [r["i"] for r, _ in a.items] == [r["i"] for r, _ in b.items]
    assert len(a.items) == 3 and a.n == 50
    assert len({r["i"] for r, _ in a.items}) == 3
    assert np.all(np.array([r["i"] for r, _ in a.items]) < 50)
