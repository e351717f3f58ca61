"""Run one cell of the benchmark once, on the card, and print its result.

    python3 bench/run.py --workload minkunet-semkitti.fresh --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout. The program's kernels build into
``build/`` of the checkout at the first run and load from there after.
The last line of standard output is the result as JSON; the compared
numbers and their limits are the last lines of standard error.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    build = ROOT / "build"
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    return harness.main(sys.argv[1:], t0=T0)


if __name__ == "__main__":
    sys.exit(main())
