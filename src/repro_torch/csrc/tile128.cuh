// The 128 x 128 register-tile step shared by the materialized GEMM
// (spconv_gemm.cu) and the block-masked matmul (masked_matmul.cu).
//
// A CTA of 256 threads holds a 128 x 128 float32 tile of the output in
// registers, 8 x 8 values per thread: rows ty*4 .. +4 and 64 + ty*4 .. +4,
// columns tx*4 .. +4 and 64 + tx*4 .. +4 (tx = tid & 15, ty = tid >> 4).
// Each kernel stages one 32-deep step of its operands into `Stage` with its
// own gating and loads, then calls `fma_step`; `store_acc` writes the tile
// once at the end.
#pragma once

#include <cstdint>

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
