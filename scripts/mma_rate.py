#!/usr/bin/env python3
"""The rate of the float32-exact tensor-core step that kernels 2-5 run on
one GPU: ``mma.sync.m16n8k8`` in TF32 (``tf32x3::mma`` of
``src/repro_torch/csrc/tf32x3.cuh``) issued back to back on independent
accumulators, with no loads, at 128 and 256 threads a CTA and 1, 2 and 4
CTAs an SM. A 3xTF32 product costs three of them, so a third of the best
rate here is the most any of those kernels can reach, beside the 495 / 3
TFLOP/s of the card's published TF32 peak.

    python3 scripts/mma_rate.py

Prints the card's name and power limit, one JSON line a configuration
(TF32 TFLOP/s, m16n8k8 products a second an SM), then the best, and the
SM clock that ``nvidia-smi`` read after the run.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the loop's trips: about 20-40 ms a launch
ITERS = 4096

SOURCE = r"""
#include <cuda_runtime.h>
#include "tf32x3.cuh"
template <int N>
__global__ void __launch_bounds__(256) mma_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  float d[N][4];
  for (int j = 0; j < N; ++j)
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  b[0] = __float_as_uint(1e-3f * threadIdx.x);
  b[1] = __float_as_uint(2e-3f);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < N; ++j) tf32x3::mma(d[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < N; ++j)
    for (int e = 0; e < 4; ++e) s += d[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(void* out, int blocks, int threads, int iters,
                               int n_acc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_acc == 8)
    mma_rate<8><<<blocks, threads, 0, st>>>((float*)out, iters);
  else
    mma_rate<16><<<blocks, threads, 0, st>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_rate.cu", out_dir / "mma_rate.so"
    src.write_text(SOURCE)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    fn = ctypes.CDLL(str(lib)).mma_rate_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [p, i, i, i, i, p], i
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    best = 0.0
    for threads in (128, 256):
        for per_sm in (1, 2, 4):
            for n_acc in (8, 16):
                blocks = sms * per_sm
                ms = cs.time_ms(lambda: cs.check(
                    fn(out.data_ptr(), blocks, threads, ITERS, n_acc,
                       stream) == 0, "launch failed"), 5)
                n = blocks * threads // 32 * ITERS * n_acc
                tflops = n * 2048 / ms / 1e9
                best = max(best, tflops)
                print(json.dumps({
                    "threads": threads, "ctas_per_sm": per_sm,
                    "accumulators": n_acc, "ms": ms, "tf32_tflops": tflops,
                    "mma_per_s_per_sm": n / sms / (ms * 1e-3)}), flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"best_tf32_tflops": best,
                      "best_3xtf32_tflops": best / 3,
                      "published_tf32_tflops": 495.0,
                      "sm_clock_after": clocks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
