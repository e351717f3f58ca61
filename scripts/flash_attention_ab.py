#!/usr/bin/env python3
"""Kernel 5's float32 route (flash attention) of this checkout against
another version of its source, on one GPU, at the float32 copies of every
attention shape of ``chip_smoke.FLASH_SHAPES`` (D 64, 80, 128 and 256,
causal, windowed, MQA and ragged Sq < Skv).

    mkdir -p build/ab
    git archive <commit> src/repro_torch/csrc/flash_attention.cu \
        src/repro_torch/csrc/tf32x3.cuh | tar -x -C build/ab
    python3 scripts/flash_attention_ab.py --other build/ab/src/repro_torch/csrc/flash_attention.cu

(a source that includes ``tf32x3.cuh`` finds the copy beside it). Both
sources are built with the port's nvcc flags and called through
their C launch function ``flash_attention_launch`` (``is_bf16`` 0), whose
interface both forms share. At each shape (the inputs of phase
``flash_attention``: seeded ``torch.randn`` in float32) both forms are
held to the plain version at ``chip_smoke.TOL_FLASH["float32"]`` (2e-5 abs
+ 2e-5 rel), then timed other, this, this, other (``octent_ab.ab_times``),
with one float32 ``scaled_dot_product_attention`` call of the same
function timed beside them (``chip_smoke.sdpa_call``). Prints the card's
name and power limit, then one JSON line a shape: each form's ms, their
share of the 3xTF32 bound (``chip_smoke._flash_bound``), SDPA's ms and each
form's error; then the ratios this / other.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: calls a timing, as phase flash_attention times kernel 5
ITERS = 10


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True,
                    help="the other flash_attention.cu")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from octent_ab import ab_times, build_launch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ref import attention_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_dir().mkdir(parents=True, exist_ok=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    fns = {"this": build_launch(build.CSRC / build.SOURCES["flash_attention"],
                                build.build_dir() / "ab_k5_this.so",
                                "flash_attention_launch", argtypes),
           "other": build_launch(args.other.resolve(),
                                 build.build_dir() / "ab_k5_other.so",
                                 "flash_attention_launch", argtypes)}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rel, tol = cs.TOL_FLASH["float32"]
    ratios = {}
    for name, b, hq, hkv, sq, skv, d, causal, window, _ in cs.FLASH_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
        k = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
        v = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
        want = attention_ref(q, k, v, causal=causal, window=window)
        out = torch.empty_like(q)
        call_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, hq, hkv, sq, skv, d, int(causal),
                     window, d ** -0.5, 0, stream)
        calls, err = {}, {}
        for form, fn in fns.items():
            calls[form] = (lambda fn=fn: cs.check(fn(*call_args) == 0,
                                                  "launch failed"))
            out.fill_(float("nan"))
            calls[form]()
            torch.cuda.synchronize()
            diff = (out - want).abs()
            err[form] = diff.max().item()
            worst = (diff - rel * want.abs()).max().item()
            cs.check(worst <= tol, f"{form} differs from the plain version "
                     f"at {name}: |k-p| > {rel} |p| + {tol} (excess {worst})")
        del want
        ms = ab_times(calls, ITERS)
        library, lib_call = cs.sdpa_call(q, k, v, causal, window)
        bound = cs._flash_bound(b, hq, hkv, sq, skv, d, causal, window, 4)
        mean = {form: float(np.mean(t)) for form, t in ms.items()}
        ratios[name] = mean["this"] / mean["other"]
        print(json.dumps({
            "shape": name, "dims": [b, hq, hkv, sq, skv, d],
            "causal": causal, "window": window, "max_abs_err": err,
            "tolerance": f"{rel} * |plain| + {tol}", "ms": ms,
            "mean_ms": mean, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "bound_ms_f32_cores": bound["bound_ms_f32_cores"],
            "share_of_bound": {form: bound["bound_ms"] / t
                               for form, t in mean.items()},
            "library_ms": cs.time_ms(library, ITERS),
            "library_call": lib_call,
            "this_over_other": ratios[name]}), flush=True)
        del q, k, v, out, library
        torch.cuda.empty_cache()
    print(json.dumps({"this_over_other": ratios,
                      "slowest_ratio": max(ratios.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
