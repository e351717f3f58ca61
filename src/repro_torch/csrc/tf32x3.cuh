// The float32-exact tensor-core step shared by the block-masked matmul
// (masked_matmul.cu) and the output-stationary gather-GEMM
// (spconv_gemm_fused.cu), plus the cp.async helpers that feed it.
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
__device__ __forceinline__ void load_a(const float* a, int lda, int r0,
                                       int k0, int lane, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = a + (r0 + (lane >> 2)) * lda + k0 + (lane & 3);
  split(p[0], hi[0], lo[0]);
  split(p[8 * lda], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * lda + 4], hi[3], lo[3]);
}

// The B fragment of rows k0 .. k0 + 8, columns n0 .. n0 + 8 of a K x N
// shared tile with row stride ldb floats, split into hi and lo.
__device__ __forceinline__ void load_b(const float* b, int ldb, int k0,
                                       int n0, int lane, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float* p = b + (k0 + (lane & 3)) * ldb + n0 + (lane >> 2);
  split(p[0], hi[0], lo[0]);
  split(p[4 * ldb], hi[1], lo[1]);
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
