// The float32-exact tensor-core step shared by the block-masked matmul
// (masked_matmul.cu), the materialized tiled GEMM (spconv_gemm.cu), the
// output-stationary gather-GEMM (spconv_gemm_fused.cu) and the float32
// route of flash attention (flash_attention.cu), plus the cp.async
// helpers and the staged ring that feed it. The first two run the same
// 128 x 128 CTA tile: 8 warps, each a 64 x 32 block (warp_tile below), over
// a kStages ring of 32-deep steps (ring, stage_b, store_tile below).
//
// Plain TF32 rounds each operand to 11 significant bits, which over
// Cin x 27 taps misses 1e-4 x max|out|. The split-precision product
// ("3xTF32") keeps close to float32 accuracy on the tensor cores: each
// operand is split as x = hi + lo with hi = tf32(x) and lo = tf32(x - hi)
// (x - hi is exact in float32), and a*b is accumulated as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, small terms first, into float32
// fragments. The dropped a_lo*b_lo term is below 2^-22 of the product.
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on
// fragments read from padded shared memory. TF32 wgmma takes only K-major
// operands, and both kernels' right-hand sides (masked_matmul's B (K, N),
// a layer's W[tap] (Cin, Cout_pad)) are N-major in device memory; mma.sync
// reads a B fragment from an N-major tile directly, with no transposed copy.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A 16 x 8, row-major: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                        a3 (g + 8, t + 4)
//   B 8 x 8, K x N:      b0 (t, g), b1 (t + 4, g)
//   C 16 x 8:            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                        c3 (g + 8, 2t + 1)
// With an A tile row stride of 4 (mod 32) floats and a B tile row stride of
// 8 (mod 32) floats, every fragment read below touches 32 distinct banks.
#pragma once

#include <cstdint>

namespace tf32x3 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy in the background; with src_bytes < 16 the
// rest is zero-filled (0: nothing is read, the 16 bytes become zeros). Both
// addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte copy for rows that are not 16-byte aligned; src_bytes 0 or 4.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  const float r = x - __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(r));
  hi = h;
  lo = l;
}

// The cheaper split of the materialized GEMM's hot loop: hi is x rounded to
// TF32 (half an ulp added, the 13 low bits cleared), and lo = x - hi is
// passed whole: the tensor core reads only its TF32 bits, so lo is
// truncated, 2^-21 of x against split's 2^-22. Three instructions where
// split's two cvt.rna, each guarding inf and NaN, take seven; inf and NaN
// give NaN through either. Both errors are far below the tensor core's own
// float32 accumulation error over a deep Cin, which sets the kernels' error
// against a float32 matmul.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// split, or split_fast where kExactLo is false
template <bool kExactLo>
__device__ __forceinline__ void split_as(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExactLo)
    split(x, hi, lo);
  else
    split_fast(x, hi, lo);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// The A fragment of rows r0 .. r0 + 16, columns k0 .. k0 + 8 of a row-major
// shared tile with row stride lda floats, split into hi and lo.
template <bool kExactLo = true>
__device__ __forceinline__ void load_a(const float* a, int lda, int r0,
                                       int k0, int lane, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = a + (r0 + (lane >> 2)) * lda + k0 + (lane & 3);
  split_as<kExactLo>(p[0], hi[0], lo[0]);
  split_as<kExactLo>(p[8 * lda], hi[1], lo[1]);
  split_as<kExactLo>(p[4], hi[2], lo[2]);
  split_as<kExactLo>(p[8 * lda + 4], hi[3], lo[3]);
}

// The B fragment of rows k0 .. k0 + 8, columns n0 .. n0 + 8 of a K x N
// shared tile with row stride ldb floats, split into hi and lo.
template <bool kExactLo = true>
__device__ __forceinline__ void load_b(const float* b, int ldb, int k0,
                                       int n0, int lane, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float* p = b + (k0 + (lane & 3)) * ldb + n0 + (lane >> 2);
  split_as<kExactLo>(p[0], hi[0], lo[0]);
  split_as<kExactLo>(p[4 * ldb], hi[1], lo[1]);
}

// The 64 x 32 warp tile: acc[mi][j] is the m16n8 fragment of rows
// mi * 16 .. +16 and columns j * 8 .. +8 of the warp's block.
using WarpAcc = float[4][4][4];

__device__ __forceinline__ void zero(WarpAcc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += a (64 x kKC, row stride kLda) times b (kKC x 32, row stride kLdb),
// both in shared memory, in 3xTF32 (operands split by split, or by
// split_fast where kExactLo is false).
template <int kKC, int kLda, int kLdb, bool kExactLo = true>
__device__ __forceinline__ void warp_tile(const float* a, const float* b,
                                          WarpAcc& acc, int lane) {
#pragma unroll
  for (int ks = 0; ks < kKC; ks += 8) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      load_b<kExactLo>(b, kLdb, ks, j * 8, lane, bh[j], bl[j]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      uint32_t ah[4], al[4];
      load_a<kExactLo>(a, kLda, mi * 16, ks, lane, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma3(acc[mi][j], ah, al, bh[j], bl[j]);
    }
  }
}

// Write the warp's 64 x 32 block, whose first element is row row0, column
// col0 of c (row stride ldc), keeping rows < m and columns < n of c; 8-byte
// stores where vec2 (ldc even and c 8-byte aligned).
__device__ __forceinline__ void store_tile(const WarpAcc& acc, float* c,
                                           long long ldc, int row0, int col0,
                                           int m, int n, bool vec2,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + mi * 16 + g + 8 * h;
      if (row >= m) continue;
      float* o = c + (long long)row * ldc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + j * 8 + 2 * t;
        const float v0 = acc[mi][j][2 * h], v1 = acc[mi][j][2 * h + 1];
        if (vec2 && col + 1 < n) {
          *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
        } else {
          if (col < n) o[col] = v0;
          if (col + 1 < n) o[col + 1] = v1;
        }
      }
    }
}

// Stage rows k0 .. k0 + kKC and columns col0 .. col0 + kNT of a row-major
// right-hand side b (row stride ldb) into dst (row stride kLdb); rows
// >= k and columns >= n are zero-filled. 16-byte copies where vec (n and
// ldb multiples of 4, b 16-byte aligned), else 4-byte ones.
template <int kKC, int kNT, int kLdb, int kThreads>
__device__ __forceinline__ void stage_b(float* dst, const float* b,
                                        long long ldb, int k0, int col0,
                                        int k, int n, bool vec, int tid) {
  static_assert(kNT == 128 && kKC * kNT / 4 % kThreads == 0, "layout");
#pragma unroll
  for (int q = 0; q < kKC * kNT / 4 / kThreads; ++q) {
    const int idx = tid + q * kThreads, kk = idx >> 5, c4 = (idx & 31) * 4;
    const int kr = k0 + kk, col = col0 + c4;
    float* d = dst + kk * kLdb + c4;
    const long long off = (long long)kr * ldb + col;
    if (vec) {
      const bool ok = kr < k && col < n;
      cp_async16(d, ok ? b + off : b, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kr < k && col + e < n;
        cp_async4(d + e, ok ? b + off + e : b, ok ? 4 : 0);
      }
    }
  }
}

// Run n staged steps through a kStages ring of shared-memory stages:
// load(i, s) issues the cp.async copies of step i into stage s, and
// compute(s) consumes stage s. The copies of step i + kStages - 1 are
// issued before the products of step i, so kStages - 1 steps are in flight
// while the tensor cores run. Drains the ring before it returns: the caller
// may rewrite every stage.
template <int kStages, class Load, class Compute>
__device__ __forceinline__ void ring(int n, Load&& load, Compute&& compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    // step i has landed for every thread, and every warp is done with the
    // stage that the next load overwrites
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = i + kStages - 1;
    if (nxt < n) load(nxt, nxt % kStages);
    cp_async_commit();
    compute(i % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Block-wide stream compaction step: every thread offers one item (live or
// not); the live ones are appended to list[base ..] in thread order.
// Returns the number appended. warp_counts holds kThreads / 32 ints of
// shared memory. Contains two __syncthreads().
template <int kThreads>
__device__ __forceinline__ int append_live(bool live, uint32_t item,
                                           uint32_t* list, int base,
                                           int* warp_counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_counts[warp] = __popc(bal);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int c = warp_counts[w];
    off += w < warp ? c : 0;
    total += c;
  }
  if (live) list[base + off + __popc(bal & ((1u << lane) - 1u))] = item;
  __syncthreads();
  return total;
}

}  // namespace tf32x3
