// Block-masked dense matmul (SPAC tile skipping), for Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `masked_matmul` in
//   src/repro/kernels/masked_matmul/kernel.py (body `_kernel`): C = A @ B
//   where each (bm x bk) tile of A whose block-mask entry is 0 counts as
//   zero, and is neither loaded nor multiplied.
//
// What bounds it on the H100: at the served shapes (M = 65,536 rows, K and
// N 128-512, most of A's tiles dead) bytes: C is written whole, zeros
// included, and the live tiles of A are read once. Where most tiles are
// live the float32-exact product does: 2 * bm * bk * N FLOPs per live
// tile at the 3xTF32 tensor-core rate (495 / 3 TFLOP/s).
//
// Design:
//  * One CTA of 8 warps per 128 x 128 tile of C; the TPU carried the sum in
//    VMEM across a sequential k grid, here the k loop runs inside the CTA.
//  * The CTA first lists the 32-wide K steps that its mask rows keep live,
//    once, into shared memory (in windows of 256 steps), and loops over that
//    list only: a dead step costs neither loads nor products.
//  * A (128 x 32, K-contiguous rows) and B (32 x 128) of each live step are
//    staged with 16-byte cp.async into a 3-stage ring; the loads of step
//    i + 2 are issued before the products of step i, so two steps are in
//    flight while the tensor cores run.
//  * Each warp owns a 64 x 32 block of C (2 x 4 warps) and runs the 3xTF32
//    step of tf32x3.cuh: 4 x 4 m16n8k8 fragments, 3 products each.
//  * When a step straddles live and dead mask entries (bm not a multiple of
//    128 or bk not a multiple of 32), each 16-byte chunk of A is loaded
//    only if its own tile is live and zero-filled otherwise, which is the
//    plain version's contract: a caller's mask that kills a nonzero tile
//    zeroes it. Ragged edges in M, N and K zero-fill; rows that are not
//    16-byte aligned (K or bk not a multiple of 4, N not a multiple of 4)
//    fall back to 4-byte copies.
//  * Two CTAs fit on an SM (106 KB of ring each, at most 128 registers a
//    thread), so one CTA's loads and stores overlap the other's products.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kMT = 128;        // rows of C per CTA
constexpr int kNT = 128;        // columns of C per CTA
constexpr int kKC = 32;         // depth of one staged step
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kWin = kThreads;  // K steps listed per window
constexpr int kLda = kKC + 4;   // 36: A fragment reads hit 32 banks
constexpr int kLdb = kNT + 8;   // 136: B fragment reads hit 32 banks
constexpr int kStageA = kMT * kLda;
constexpr int kStageB = kKC * kLdb;
using tf32x3::cp_async16;
using tf32x3::cp_async4;

constexpr size_t kSmem =
    sizeof(float) * kStages * (kStageA + kStageB) + sizeof(uint32_t) * kWin;

struct Args {
  const float* a;
  const float* b;
  const int* mask;
  float* c;
  int m, n, k, bm, bk, n_kb;
  int uniform;  // one mask entry covers every 128 x 32 step of a CTA
  int a_vec;    // A's chunks may be copied 16 bytes at a time
  int b_vec;    // B's chunks likewise
};

// Stage the live K step `step` of the CTA at rows row0 and columns col0.
__device__ __forceinline__ void load_step(const Args& p, float* sa, float* sb,
                                          int step, int row0, int col0,
                                          int tid) {
  const int k0 = step * kKC;
  {  // A: one row per thread pair, 4 chunks of 4 floats each
    const int r = tid >> 1, row = row0 + r;
    float* dst = sa + r * kLda;
    const long long row_off = (long long)row * p.k;
    const int mrow = (row / p.bm) * p.n_kb;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = ((tid & 1) * 4 + q) * 4, kc = k0 + kk;
      if (p.a_vec) {
        bool ok = row < p.m && kc < p.k;
        if (ok && !p.uniform) ok = p.mask[mrow + kc / p.bk] != 0;
        cp_async16(dst + kk, ok ? p.a + row_off + kc : p.a, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = row < p.m && kc + e < p.k;
          if (ok && !p.uniform) ok = p.mask[mrow + (kc + e) / p.bk] != 0;
          cp_async4(dst + kk + e, ok ? p.a + row_off + kc + e : p.a,
                    ok ? 4 : 0);
        }
      }
    }
  }
  tf32x3::stage_b<kKC, kNT, kLdb, kThreads>(sb, p.b, p.n, k0, col0, p.k,
                                           p.n, p.b_vec, tid);
}

__global__ void __launch_bounds__(kThreads, 2)
    masked_matmul_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_b = s_a + kStages * kStageA;
  uint32_t* s_list = reinterpret_cast<uint32_t*>(s_b + kStages * kStageB);
  __shared__ int s_warp[kThreads / 32];

  const int row0 = blockIdx.x * kMT, col0 = blockIdx.y * kNT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // 64-row half, 32-column quarter
  const int mr0 = row0 / p.bm, mr1 = (min(row0 + kMT, p.m) - 1) / p.bm;
  const int n_steps = (p.k + kKC - 1) / kKC;

  tf32x3::WarpAcc acc;
  tf32x3::zero(acc);

  for (int w0 = 0; w0 < n_steps; w0 += kWin) {
    // the live steps of this window, in K order
    const int step = w0 + tid;
    bool live = false;
    if (step < n_steps) {
      const int k0 = step * kKC;
      const int mc0 = k0 / p.bk, mc1 = (min(k0 + kKC, p.k) - 1) / p.bk;
      for (int r = mr0; r <= mr1 && !live; ++r)
        for (int cc = mc0; cc <= mc1 && !live; ++cc)
          live = p.mask[(long long)r * p.n_kb + cc] != 0;
    }
    const int n_live = tf32x3::append_live<kThreads>(live, step, s_list, 0,
                                                    s_warp);

    tf32x3::ring<kStages>(
        n_live,
        [&](int i, int s) {
          load_step(p, s_a + s * kStageA, s_b + s * kStageB, s_list[i],
                    row0, col0, tid);
        },
        [&](int s) {
          tf32x3::warp_tile<kKC, kLda, kLdb>(
              s_a + s * kStageA + wm * 64 * kLda, s_b + s * kStageB + wn * 32,
              acc, lane);
        });
    // drained: the next window rewrites the list and the ring
  }

  tf32x3::store_tile(acc, p.c, p.n, row0 + wm * 64, col0 + wn * 32, p.m,
                     p.n, (p.n & 1) == 0, lane);
}

}  // namespace

// c (m, n) f32 = a (m, k) @ b (k, n) with the (bm x bk) tiles of a whose
// mask ((m/bm, k/bk) int32) entry is 0 taken as zero. Every pointer is a
// device pointer; bm must divide m and bk divide k, and c must be 8-byte
// aligned. Returns the CUDA error code of the launch (0 on success).
extern "C" int masked_matmul_launch(const void* a, const void* b,
                                    const void* mask, void* c, int m, int n,
                                    int k, int bm, int bk, void* stream) {
  if (m > 0 && n > 0) {
    Args p;
    p.a = (const float*)a;
    p.b = (const float*)b;
    p.mask = (const int*)mask;
    p.c = (float*)c;
    p.m = m;
    p.n = n;
    p.k = k;
    p.bm = bm;
    p.bk = bk;
    p.n_kb = bk > 0 ? k / bk : 0;
    p.uniform = bm % kMT == 0 && bk % kKC == 0;
    p.a_vec = k % 4 == 0 && (p.uniform || bk % 4 == 0) &&
              (reinterpret_cast<uintptr_t>(a) & 15) == 0;
    p.b_vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
    cudaError_t err = cudaFuncSetAttribute(
        masked_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((m + kMT - 1) / kMT, (n + kNT - 1) / kNT);
    masked_matmul_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the kernel, in bytes: the ring and the list of
// live K steps.
extern "C" int masked_matmul_smem() { return (int)kSmem; }
