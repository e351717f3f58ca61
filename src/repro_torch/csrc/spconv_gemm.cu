// Materialized tiled GEMM of the SpConv baseline, for Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `spconv_gemm` in
//   src/repro/kernels/spconv_gemm/kernel.py (body `_kernel`): every bm-row
//   tile of a pre-gathered lhs times the weights of the tile's tap, zeros
//   for a dead tile. The gather before it and the scatter-add after it are
//   plain PyTorch (ops.apply_kmap), as they were XLA in the reference.
//
// What bounds it on the H100: bytes on most layers. The output is the
// whole (M_pad, Cout_pad) partial-product array, dead tiles included, and
// M_pad is the worst-case slot budget of the tile layout (2.2 M slots for a
// 65,536-row bucket), while the live tiles are a few thousand. Writing
// that array (4.6 GB at Cout 512) is the floor. The FLOPs, 2 * Cin *
// Cout_pad per slot of a live tile, on the CUDA cores at float32 (67
// TFLOP/s; no TF32, no tensor cores here) take over only on wide layers at
// the finest resolution.
//
// Design:
//  * One CTA per (tile, 128-column slab), so a layer launches thousands of
//    CTAs (17,382 tiles x Cout_pad/128 at the 65,536-row bucket): unlike
//    the output-stationary kernel there is no run to walk, and no two CTAs
//    write the same element.
//  * A dead tile (tile_nz == 0) loads nothing and stores zeros with
//    16-byte stores: that is the reference's contract (`_skip`).
//  * A live tile is summed over Cin in 32-wide steps through shared memory
//    (lhs rows k-major, the tap's weight slice), 128 rows at a time with
//    8 x 8 values per thread in registers, then stored once (the
//    register-tile step of namespace tile128 below). The ragged Cin edge is
//    masked, so the Cin = 4 stem runs unpadded; rows past bm (bm < 128) are
//    masked too.
#include <cuda_runtime.h>

#include <cstdint>

// The 128 x 128 register-tile step: a CTA of 256 threads holds a 128 x 128
// float32 tile of the output in registers, 8 x 8 values per thread: rows
// ty*4 .. +4 and 64 + ty*4 .. +4, columns tx*4 .. +4 and 64 + tx*4 .. +4
// (tx = tid & 15, ty = tid >> 4). The kernel stages one 32-deep step of its
// operands into `Stage`, then calls `fma_step`; `store_acc` writes the tile
// once at the end.
namespace tile128 {

constexpr int kMT = 128;     // rows of the register tile
constexpr int kNT = 128;     // columns of the register tile
constexpr int kKC = 32;      // depth of one staged step
constexpr int kThreads = 256;

// One staged step: lhs rows k-major (padded against bank conflicts), and
// the matching rows of the right-hand side.
struct Stage {
  __align__(16) float a[kKC][kMT + 4];
  __align__(16) float b[kKC][kNT];
};

using Acc = float[8][8];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc += a^T-slab x b-slab over the kKC staged rows.
__device__ __forceinline__ void fma_step(const Stage& s, Acc& acc, int tx,
                                         int ty) {
#pragma unroll
  for (int kk = 0; kk < kKC; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&s.a[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s.b[kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Write the tile to c (row stride ld), keeping rows < rows and columns
// < cols of it; 16-byte stores where the row and c allow them.
__device__ __forceinline__ void store_acc(const Acc& acc,
                                          float* __restrict__ c,
                                          long long ld, int rows, int cols,
                                          int tx, int ty) {
  const bool vec = (ld & 3) == 0 &&
                   (reinterpret_cast<std::uintptr_t>(c) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (r >= rows) continue;
    float* o = c + r * ld;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 64 + tx * 4, j0 = h * 4;
      if (vec && col + 4 <= cols) {
        *reinterpret_cast<float4*>(o + col) = make_float4(
            acc[i][j0], acc[i][j0 + 1], acc[i][j0 + 2], acc[i][j0 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < cols) o[col + j] = acc[i][j0 + j];
      }
    }
  }
}

}  // namespace tile128

namespace {

using tile128::kKC;
using tile128::kMT;
using tile128::kNT;
using tile128::kThreads;

__global__ void __launch_bounds__(kThreads) spconv_gemm_kernel(
    const float* __restrict__ lhs, int c_in, const float* __restrict__ w,
    int c_out_pad, int bm, const int* __restrict__ tile_tap,
    const int* __restrict__ tile_nz, float* __restrict__ out) {
  __shared__ tile128::Stage s;

  const long long t = blockIdx.x;
  const int col0 = blockIdx.y * kNT;
  const int tid = threadIdx.x;
  const long long row0 = t * bm;

  if (tile_nz[t] == 0) {       // dead tile: zeros, nothing loaded
    for (int idx = tid; idx < bm * (kNT / 4); idx += kThreads) {
      const int r = idx / (kNT / 4), c4 = idx - r * (kNT / 4);
      *reinterpret_cast<float4*>(out + (row0 + r) * c_out_pad + col0 +
                                 4 * c4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const float* wt = w + (long long)tile_tap[t] * c_in * c_out_pad + col0;

  for (int m0 = 0; m0 < bm; m0 += kMT) {
    tile128::Acc acc;
    tile128::zero(acc);
    for (int c0 = 0; c0 < c_in; c0 += kKC) {
      for (int idx = tid; idx < kMT * kKC; idx += kThreads) {
        const int r = idx / kKC, kk = idx - r * kKC;
        const int c = c0 + kk;
        s.a[kk][r] = (m0 + r < bm && c < c_in)
                         ? __ldg(lhs + (row0 + m0 + r) * c_in + c) : 0.f;
      }
      for (int idx = tid; idx < kKC * (kNT / 4); idx += kThreads) {
        const int kk = idx / (kNT / 4), c4 = idx - kk * (kNT / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + kk < c_in)
          v = __ldg(reinterpret_cast<const float4*>(
              wt + (long long)(c0 + kk) * c_out_pad + 4 * c4));
        *reinterpret_cast<float4*>(&s.b[kk][4 * c4]) = v;
      }
      __syncthreads();
      tile128::fma_step(s, acc, tid & 15, tid >> 4);
      __syncthreads();
    }
    tile128::store_acc(acc, out + (row0 + m0) * c_out_pad + col0, c_out_pad,
                       bm - m0, kNT, tid & 15, tid >> 4);
  }
}

}  // namespace

// out (n_tiles*bm, c_out_pad) f32: tile t's rows are lhs's rows times
// w[tile_tap[t]] (K, c_in, c_out_pad), or zeros where tile_nz[t] == 0. Every
// pointer is a device pointer; c_out_pad must be a multiple of 128. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int spconv_gemm_launch(const void* lhs, int c_in, const void* w,
                                  int c_out_pad, int bm, int n_tiles,
                                  const void* tile_tap, const void* tile_nz,
                                  void* out, void* stream) {
  if (n_tiles > 0 && c_out_pad > 0) {
    const dim3 grid(n_tiles, c_out_pad / kNT);
    spconv_gemm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)lhs, c_in, (const float*)w, c_out_pad, bm,
        (const int*)tile_tap, (const int*)tile_nz, (float*)out);
  }
  return (int)cudaGetLastError();
}
