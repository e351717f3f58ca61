"""The readings that set a cell's limits: the program's numbers and the
control's, seed by seed, in one process.

    python3 bench/control.py --workload minkunet-semkitti.fresh \\
        --seeds 11,12,13 --seconds 3

For each seed, a run of the cell (set-up from that seed, a short window at
the cell's own load) gives the program's numbers, as a benchmark run
does; the control is the reference computed in TF32 (operands rounded to
10 mantissa bits, float32 sums; ``bench/reference/sparse.py``) in the
program's place, on the same sampled requests. Both are judged by the
harness's own ``judge``, the expression that decides a benchmark run's
``correct``. A limit goes between the largest program reading and the
smallest control reading. One JSON line a seed, then one with both
extremes and whether every program run was correct and every control
run was not; the exit code is 1 where either fails. The benchmark's own
runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(harness, cell, seed: int, seconds: float, device) -> dict:
    run = harness.run_cell(cell, seed, seconds, trace=False, device=device,
                           t0=time.perf_counter())
    ok, program, limits = harness.judge(cell, run, device)
    ctl_ok, control, _ = harness.judge(cell, run, device, precision="tf32")
    return {"seed": seed, "compared": len(run.sample), "limits": limits,
            "program": program, "program_correct": ok,
            "control": control, "control_correct": ctl_ok}


def main(argv=None, *, root: Path = ROOT, allow_cpu: bool = False) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    cell = harness.load_cell(args.workload, root)
    device = harness.device_for(cell, allow_cpu)
    hi, lo, sound = {}, {}, True
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(harness, cell, seed, args.seconds, device)
        print(json.dumps(r), flush=True)
        sound &= r["program_correct"] and not r["control_correct"]
        for k, v in r["program"].items():
            hi[k] = max(hi.get(k, 0.0), v)
        for k, v in r["control"].items():
            lo[k] = min(lo.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "program_max": hi,
                      "control_min": lo, "sound": sound}), flush=True)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
