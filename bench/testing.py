"""A small copy of the benchmark's layout for the CPU tests.

:func:`tiny_layout` copies ``BENCHMARK.json`` and ``bench/`` into a
directory and adds, beside the real cells, ``mk-tiny.*``: the same
workloads on a small preset (MinkUNet at the port's SMALL widths) and
small scenes (16 rings, 128 azimuth steps, 20 x 20 x 40 cm voxels), with
every answer of the window compared.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SENSOR = {"rings": 16, "az_steps": 128, "max_range": 60.0,
          "voxel": [0.2, 0.2, 0.4], "origin": [-64.0, -64.0, -4.0]}
SMALL_MODELS = {
    "minkunet-semkitti": ("mk-tiny", {"enc": [32, 64, 128, 256],
                                      "dec": [128, 96, 96, 96],
                                      "blocks": 1, "classes": 20},
                          {"bucket": 4096, "max_batch": 4}),
}
CELLS = {"mk-tiny.fresh": "minkunet-semkitti.fresh",
         "mk-tiny.revisit": "minkunet-semkitti.revisit"}


def small_config(name: str) -> dict:
    """The configuration ``name`` at its small preset."""
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                     .read_text())
    _, model, top = SMALL_MODELS[name]
    cfg["model"].update(model)
    cfg.update(top)
    cfg["name"] = SMALL_MODELS[name][0]
    return cfg


def small_params(cell: str) -> dict:
    """The traffic parameters of real cell ``cell`` on small scenes."""
    wl = json.loads((ROOT / "bench" / "workloads" / f"{cell}.json")
                    .read_text())
    params = dict(wl["params"], sensor=SENSOR, feature_rows=65536)
    params["bases"] = min(params["bases"], 4)
    return params


def tiny_layout(dest: Path) -> Path:
    """``dest`` holding the benchmark's layout and the tiny cells."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for name in SMALL_MODELS:
        cfg = small_config(name)
        (dest / "bench" / "configs" / f"{cfg.pop('name')}.json").write_text(
            json.dumps(cfg))
    for tiny, real in CELLS.items():
        wl = json.loads((ROOT / "bench" / "workloads" / f"{real}.json")
                        .read_text())
        wl["config"] = SMALL_MODELS[wl["config"]][0]
        wl["params"] = small_params(real)
        wl["loop"] = {"outstanding": min(wl["loop"]["outstanding"], 4),
                      "warm_requests": 4}
        wl["check"]["sample"] = 1 << 10
        (dest / "bench" / "workloads" / f"{tiny}.json").write_text(
            json.dumps(wl))
        bench["workloads"].append({"name": tiny, "config": wl["config"],
                                   "traffic": wl["traffic"], "chips": 1,
                                   "why": f"{real} at a small size"})
        for m in bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def _python(root: Path, lines: list) -> str:
    """Run ``lines`` in a fresh interpreter with two intra-op threads
    (tests run beside each other); its standard output."""
    code = "\n".join([
        "import sys, time",
        "t0 = time.perf_counter()",
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]",
        "import torch",
        "torch.set_num_threads(2)",
        "from pathlib import Path",
        *lines])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def control(root: Path, cell: str, seed: int, seconds: float) -> dict:
    """The program's and the control's readings of one seed
    (``bench/control.py``) of ``cell`` of the layout at ``root``."""
    out = _python(root, [
        "import json",
        "from bench import control, harness",
        f"c = harness.load_cell({cell!r}, Path({str(root)!r}))",
        f"r = control.readings(harness, c, {seed}, {seconds}, "
        "torch.device('cpu'))",
        "print(json.dumps(r))"])
    return json.loads(out.strip().splitlines()[-1])


def run(root: Path, cell: str, *, seconds: float = 0.5, trace: int = 0,
        seed: int = 4_000_000_007, patch: str = "") -> dict:
    """One run of ``cell`` of the layout at ``root`` on the CPU, in a
    fresh interpreter (``patch``, Python run before the harness, may break
    the program underneath); its result line."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    out = _python(root, [
        patch, "from bench import harness",
        f"sys.exit(harness.main({argv!r}, t0=t0, root=Path({str(root)!r}),"
        " allow_cpu=True))"])
    return json.loads(out.strip().splitlines()[-1])
