"""Each cell on the card, as the benchmark runs it, for a few seconds:
``python -m pytest -m gpu bench/test_bench_gpu.py`` on a machine with a
card (skipped without one)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench import testing


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["minkunet-semkitti.fresh",
                                  "minkunet-semkitti.revisit"])
def test_a_short_run_of_each_cell_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2305843009213693951", "--seconds", "2", "--trace", "1"],
        cwd=testing.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["busy_s"] > 0
