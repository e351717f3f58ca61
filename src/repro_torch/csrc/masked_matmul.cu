// Block-masked dense matmul (SPAC tile skipping), for Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `masked_matmul` in
//   src/repro/kernels/masked_matmul/kernel.py (body `_kernel`): C = A @ B
//   where each (bm x bk) tile of A whose block-mask entry is 0 counts as
//   zero, and is neither loaded nor multiplied.
//
// What bounds it on the H100: operations. A live (bm x bk) tile costs
// 2 * bm * bk * N float32 FLOPs on the CUDA cores (67 TFLOP/s; no TF32 and
// no tensor cores in this version) against 4 * bm * bk bytes of A; B and C
// move once. At the sparsity of post-ReLU activations the live tiles still
// carry far more FLOPs than bytes.
//
// Design:
//  * One CTA per 128 x 128 tile of C, summed over K in 32-wide steps through
//    shared memory with 8 x 8 values per thread in registers, and stored
//    once (the register-tile step of tile128.cuh). The TPU carried the sum
//    in VMEM across a sequential k grid; here the k loop runs inside the
//    CTA.
//  * Before each K step the CTA reads the mask entries that step covers
//    (one entry when bm and bk are multiples of 128 and 32) and skips the
//    step, loads and FMAs both, when all are 0. When a step straddles live
//    and dead entries (small bm or bk), the elements of dead tiles are
//    loaded as zeros, which is the plain version's contract: a caller's
//    mask that kills a nonzero tile zeroes it.
//  * Ragged edges in M, N and K are masked, so any tile grid works.
#include <cuda_runtime.h>

#include "tile128.cuh"

namespace {

using tile128::kKC;
using tile128::kMT;
using tile128::kNT;
using tile128::kThreads;

__global__ void __launch_bounds__(kThreads) masked_matmul_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ mask, float* __restrict__ c, int m, int n, int k,
    int bm, int bk) {
  __shared__ tile128::Stage s;

  const int row0 = blockIdx.x * kMT;
  const int col0 = blockIdx.y * kNT;
  const int tid = threadIdx.x;
  const int n_kb = k / bk;
  const int mr0 = row0 / bm, mr1 = (min(row0 + kMT, m) - 1) / bm;

  tile128::Acc acc;
  tile128::zero(acc);

  for (int k0 = 0; k0 < k; k0 += kKC) {
    // the mask entries this step covers: skip it when all are dead
    const int mc0 = k0 / bk, mc1 = (min(k0 + kKC, k) - 1) / bk;
    const int n_cols = mc1 - mc0 + 1;
    const int n_entries = (mr1 - mr0 + 1) * n_cols;
    int live = 0;
    for (int e = tid; e < n_entries; e += kThreads) {
      const int er = e / n_cols;
      live |= mask[(long long)(mr0 + er) * n_kb + mc0 + e - er * n_cols];
    }
    if (!__syncthreads_or(live)) continue;
    const bool uniform = n_entries == 1;

    for (int idx = tid; idx < kMT * kKC; idx += kThreads) {
      const int r = idx / kKC, kk = idx - r * kKC;
      const int row = row0 + r, kc = k0 + kk;
      float v = 0.f;
      if (row < m && kc < k &&
          (uniform || mask[(long long)(row / bm) * n_kb + kc / bk] != 0))
        v = __ldg(a + (long long)row * k + kc);
      s.a[kk][r] = v;
    }
    for (int idx = tid; idx < kKC * kNT; idx += kThreads) {
      const int kk = idx / kNT, cc = idx - kk * kNT;
      const int kc = k0 + kk, col = col0 + cc;
      s.b[kk][cc] = (kc < k && col < n) ? __ldg(b + (long long)kc * n + col)
                                        : 0.f;
    }
    __syncthreads();
    tile128::fma_step(s, acc, tid & 15, tid >> 4);
    __syncthreads();
  }
  tile128::store_acc(acc, c + (long long)row0 * n + col0, n, m - row0,
                     n - col0, tid & 15, tid >> 4);
}

}  // namespace

// c (m, n) f32 = a (m, k) @ b (k, n) with the (bm x bk) tiles of a whose
// mask ((m/bm, k/bk) int32) entry is 0 taken as zero. Every pointer is a
// device pointer; bm must divide m and bk divide k. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int masked_matmul_launch(const void* a, const void* b,
                                    const void* mask, void* c, int m, int n,
                                    int k, int bm, int bk, void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((m + kMT - 1) / kMT, (n + kNT - 1) / kNT);
    masked_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (const int*)mask, (float*)c, m, n,
        k, bm, bk);
  }
  return (int)cudaGetLastError();
}
