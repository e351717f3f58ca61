// Flash attention (causal / sliding-window / GQA, online softmax), for
// Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `flash_attention` in
//   src/repro/kernels/flash_attention/kernel.py (body `_kernel`):
//   o = softmax(q k^T * D^-1/2 + mask) v for q (B, Hq, Sq, D) against
//   k, v (B, Hkv, Skv, D), query head h reading KV head h / (Hq / Hkv).
//   The mask keeps k_pos < Skv, k_pos <= q_pos when causal and
//   k_pos > q_pos - window when window > 0, where q_pos = Skv - Sq + i
//   (positions aligned to the end). The sum runs in float32 with a running
//   max m, denominator l and accumulator; the result is acc / max(l, 1e-30)
//   in q's dtype.
//
// What bounds it on the H100: operations. A live (q, k) pair costs 4 * D
// FLOPs (q.k and p.v) against 2 * D bytes of k and v that every query row
// of a head group shares, so at prefill lengths the work is far above the
// card's ridge point, and only the tensor cores (989 TFLOP/s in bf16, one
// `wgmma` per 64-row tile) reach it.
//
// Two routes, chosen by the input type in flash_attention_launch. This is
// a route by type, not a fallback: a bf16 input always takes the first.
//  * bf16: flash_attention_wgmma, both products on the tensor cores.
//  * float32: flash_attention_f32, float32 FMAs on the CUDA cores (67
//    TFLOP/s). It serves the float32 prefill and the float32 check of
//    every shape against the plain version at 2e-5, which a bf16 or TF32
//    tensor-core product could not meet.
//
// Both routes:
//  * One CTA per (q block, query head, batch row), with a loop over KV
//    blocks inside it: the loop takes the place of the TPU's sequential
//    innermost grid dimension, and m, l and the accumulator live in
//    registers instead of VMEM scratch. Heavy causal q blocks (the last
//    ones) are launched first.
//  * The loop visits only the KV blocks inside the causal / window band of
//    the q block (the reference's structural skip): the others are never
//    loaded.
//  * Masked scores are the reference's finite -1e30, never -inf: a block
//    in which a row sees no live key gives exp(0) = 1 there, which the next
//    live block wipes with alpha = exp(-1e30 - m) = 0, where -inf would
//    give exp(-inf + inf) = NaN.
//
// The bf16 route (warp-specialised, FlashAttention-3's form without its
// ping-pong between warpgroups):
//  * A CTA is one producer warpgroup and kNWG consumer warpgroups of 64 q
//    rows each: two (a 128-row q block) at D <= 128, one at D = 256, where
//    the 64 x 256 float32 O accumulator alone takes 128 registers a thread.
//    `setmaxnreg` moves registers from the producer to the consumers.
//  * One thread of the producer loads the q block once, then K and V tiles
//    through a ring of kStages stages by TMA. Each stage has a full barrier
//    for K, one for V (so q k^T starts before V lands) and an empty barrier
//    that every consumer warp arrives on once it is done with the stage;
//    the producer refills a stage only after that.
//  * The tensor maps are rank 3 over (D, S, B * H) with 64-column boxes and
//    the 128-byte swizzle that `wgmma` reads: rows past S within one head,
//    and columns past D (D = 80 loads two boxes, the second zero-filled
//    from column 80), read as zeros instead of the next head's data. Zero
//    columns of q and k add 0 to the scores; O's columns past D are never
//    stored. The host builds the maps with cuTensorMapEncodeTiled, found
//    at run time through cudaGetDriverEntryPoint, so nothing links
//    against libcuda.
//  * S = q k^T: `wgmma` m64nBKVk16 with both operands in shared memory;
//    k as stored (BKV x D, D contiguous) is the K-major B operand.
//  * Online softmax in registers on the accumulator fragment: a row's
//    values lie on 4 lanes of one warp (two shuffles for its max), the
//    scale D^-1/2 * log2(e) is folded into one multiply before exp2, and
//    the per-element mask runs only on blocks that straddle the band's
//    edge or Skv. l stays a per-thread partial sum (alpha is the same on a
//    row's 4 lanes) and is reduced once, at the end.
//  * O += P V: the float32 P fragment of one k16 step, as bf16 pairs, is
//    the register A fragment of the next `wgmma` (m64nDk16), so P never
//    goes through shared memory; v (BKV x D, D contiguous) is the MN-major
//    B operand (transpose bit set). P goes in as two bf16 terms, bf16(P)
//    and bf16(P - bf16(P)), in two `wgmma` passes: one bf16 rounding of P
//    (2^-8 relative) misses the bf16 tolerance, 2^-7 |o| + 2e-3, on rows
//    with few live keys, where o cancels (0.0024 at D = 128, a row of 4
//    keys); the pair is within 2^-16 of P. l is summed from P in float32,
//    which the pair matches to that precision.
//  * Epilogue: O / max(l, 1e-30) in bf16, stored from registers for rows
//    below Sq and columns below D.
//
// The float32 route: one 256-thread CTA per 64-row q block; q, k and v are
// staged in shared memory, each thread owns 4 q rows (4 x BKV / 16 scores
// and 4 x D / 16 accumulator columns), a row's 16 threads are 16 lanes of
// one warp, and the probabilities go through shared memory for p.v. BKV =
// 64 at D <= 80 and 32 at D >= 128 (68,608-141,824 bytes of dynamic shared
// memory). Ragged edges: q rows past Sq are staged as zeros and never
// stored; keys past Skv are masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // -1e30 in the exp2 domain

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kThreads = 256;

template <int D>
struct Tile {
  static constexpr int kBKV = D >= 128 ? 32 : 64;
  static constexpr int kQP = D + 4;       // row pitch of sQ and sK (floats)
  static constexpr int kPP = kBKV + 4;    // row pitch of sP
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kQP + kBKV * kQP + kBKV * D + kBQ * kPP);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int hq, int hkv,
    int sq, int skv, int causal, int window, float scale) {
  constexpr int BKV = Tile<D>::kBKV;
  constexpr int QP = Tile<D>::kQP;
  constexpr int PP = Tile<D>::kPP;
  constexpr int DC = D / 16;     // accumulator columns per thread
  constexpr int JC = BKV / 16;   // key columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [kBQ][QP]
  float* sK = sQ + kBQ * QP;                       // [BKV][QP]
  float* sV = sK + BKV * QP;                       // [BKV][D]
  float* sP = sV + BKV * D;                        // [kBQ][PP]

  const int n_qb = (sq + kBQ - 1) / kBQ;
  const int qb = n_qb - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 4;   // rows rg * 4 .. rg * 4 + 3 of the q block
  const int cg = tid & 15;   // key columns cg + 16 j, output cols cg + 16 dd

  const int row0 = qb * kBQ;
  const int q_lo = row0 + skv - sq;                    // q_pos of row 0
  const int q_hi = min(row0 + kBQ, sq) - 1 + skv - sq; // of the last row

  const float* qp = q + ((long long)(b * hq + h) * sq + row0) * D;
  const float* kp = k + (long long)(b * hkv + hk) * skv * D;
  const float* vp = v + (long long)(b * hkv + hk) * skv * D;
  float* op = o + ((long long)(b * hq + h) * sq + row0) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    sQ[r * QP + c] = row0 + r < sq ? qp[(long long)r * D + c] : 0.f;
  }

  // the KV blocks inside the band of this q block
  int kb_lo = 0, kb_hi = (skv - 1) / BKV;
  if (causal) kb_hi = min(kb_hi, q_hi / BKV);
  if (window > 0) kb_lo = max(0, q_lo - window + 1) / BKV;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DC; ++dd) acc[i][dd] = 0.f;
  }

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * BKV;
    __syncthreads();   // the previous block's sK, sV and sP are consumed
    for (int idx = tid; idx < BKV * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      const bool in = k0 + r < skv;
      const long long off = (long long)(k0 + r) * D + c;
      sK[r * QP + c] = in ? kp[off] : 0.f;
      sV[r * D + c] = in ? vp[off] : 0.f;
    }
    __syncthreads();

    float s[4][JC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JC; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 4) {
      float4 qv[4], kv[JC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (rg * 4 + i) * QP + kk);
#pragma unroll
      for (int j = 0; j < JC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (cg + 16 * j) * QP + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_lo + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        const int k_pos = k0 + cg + 16 * j;
        bool keep = k_pos < skv;
        if (causal) keep = keep && k_pos <= q_pos;
        if (window > 0) keep = keep && k_pos > q_pos - window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(rg * 4 + i) * PP + cg + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (rg * 4 + i) * PP + j);
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) {
        const float* vc = sV + j * D + cg + 16 * dd;
        const float v0 = vc[0], v1 = vc[D], v2 = vc[2 * D], v3 = vc[3 * D];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][dd];
          a = fmaf(pv[i].x, v0, a);
          a = fmaf(pv[i].y, v1, a);
          a = fmaf(pv[i].z, v2, a);
          a = fmaf(pv[i].w, v3, a);
          acc[i][dd] = a;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (row0 + r < sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < DC; ++dd)
        op[(long long)r * D + cg + 16 * dd] = acc[i][dd] / den;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int causal, int window,
               float scale, cudaStream_t stream) {
  const auto kern = flash_attention_f32<D>;
  constexpr size_t bytes = Tile<D>::kBytes;
  // The shared-memory size is a constant of the instantiation: raise the
  // limit once, on the first launch, and keep its result for later ones.
  static const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv,
      sq, skv, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

template <int D>
struct Wg {
  static constexpr int kDP = (D + 63) / 64 * 64;  // D in whole 64-col atoms
  static constexpr int kAtoms = kDP / 64;         // 128-byte swizzle atoms
  static constexpr int kNWG = D == 256 ? 1 : 2;   // consumer warpgroups
  static constexpr int kBQ = 64 * kNWG;
  static constexpr int kBKV = D == 256 ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (kNWG + 1);
  static constexpr int kProducerRegs = kNWG == 2 ? 24 : 56;
  static constexpr int kConsumerRegs = kNWG == 2 ? 240 : 256;
  static constexpr int kQBytes = kBQ * kDP * 2;
  static constexpr int kKVBytes = kBKV * kDP * 2;   // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  // q full; per stage: K full, V full, empty
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (1 + 3 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a rank-3 tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from touching registers that an in-flight wgmma reads
// or writes before wg_wait0 returns.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define WG_R32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64 WG_R32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R128 WG_R64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"
#define WG_F8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d, i) \
  WG_F8(d, i), WG_F8(d, i + 8), WG_F8(d, i + 16), WG_F8(d, i + 24)

// d (64 x N, float32) (+)= a (64 x 16) b^T (16 x N): both bf16 operands in
// shared memory, K-major. scale_d = 0 overwrites d. N = 2 x d's length.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_F32(d, 0)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N) += a (64 x 16, bf16 pairs in registers: the A fragment) b
// (16 x N, bf16 in shared memory, MN-major: transpose bit set).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : WG_F32(d, 0), WG_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_R128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
      : WG_F32(d, 0), WG_F32(d, 32), WG_F32(d, 64), WG_F32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One KV block of the online softmax on the S fragment s (a thread's two
// rows r and r + 8: element i is on row (i % 4) / 2). s holds raw scores
// when sc is the exp2-domain scale, or scaled and masked scores when sc is
// 1. Updates m, l (per-thread partial) and o, and leaves P in s (float32)
// and its bf16 rounding in p, as pairs in the order of the A fragment of
// the P V product.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS], float sc,
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[NO],
                                             uint32_t (&p)[NS / 2]) {
  float mx[2] = {kNegInf2, kNegInf2};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sc);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const int r = (i % 4) / 2;
    s[i] = ex2(fmaf(s[i], sc, -m[r]));
    s[i + 1] = ex2(fmaf(s[i + 1], sc, -m[r]));
    l[r] += s[i] + s[i + 1];
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s[i], s[i + 1]);
    p[i / 2] = *reinterpret_cast<const uint32_t*>(&hi);
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i % 4) / 2];
}

// The bf16 remainder P - bf16(P) of each pair, in place of bf16(P) in p.
template <int NS>
__device__ __forceinline__ void remainder_pairs(const float (&s)[NS],
                                                uint32_t (&p)[NS / 2]) {
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p[i / 2]));
    const __nv_bfloat162 lo =
        __floats2bfloat162_rn(s[i] - hi.x, s[i + 1] - hi.y);
    p[i / 2] = *reinterpret_cast<const uint32_t*>(&lo);
  }
}

template <int D>
__global__ void __launch_bounds__(Wg<D>::kThreads, 1) flash_attention_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    int hq, int hkv, int sq, int skv, int causal, int window, float scale2) {
  using C = Wg<D>;
  constexpr int BQ = C::kBQ, BKV = C::kBKV, DP = C::kDP, ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms need 1024-byte alignment
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = sQ + C::kBarOff;
  const uint32_t q_full = bars;
  // stage s: its K tile, V tile and barriers
  auto tile = [&](int s, int which) {
    return sQ + C::kQBytes + (2 * s + which) * C::kKVBytes;
  };
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * BQ;
  const int q_lo = row0 + skv - sq;                    // q_pos of row 0
  const int q_hi = min(row0 + BQ, sq) - 1 + skv - sq;  // of the last row
  int kb_lo = 0, kb_hi = (skv - 1) / BKV;
  if (causal) kb_hi = min(kb_hi, q_hi / BKV);
  if (window > 0) kb_lo = max(0, q_lo - window + 1) / BKV;
  const int n_kb = kb_hi - kb_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 4 * C::kNWG);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load(sQ + a * BQ * 128, &tq, q_full, 64 * a, row0, b * hq + h);
      const int z = b * hkv + h / (hq / hkv);
      for (int i = 0; i < n_kb; ++i) {
        const int s = i % ST, k0 = (kb_lo + i) * BKV;
        if (i >= ST) mbar_wait(empty(s), (i / ST - 1) & 1);
        mbar_expect_tx(full_k(s), C::kKVBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load(tile(s, 0) + a * BKV * 128, &tk, full_k(s), 64 * a, k0, z);
        mbar_expect_tx(full_v(s), C::kKVBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load(tile(s, 1) + a * BKV * 128, &tv, full_v(s), 64 * a, k0, z);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        C::kConsumerRegs));
    const int w = threadIdx.x / 128 - 1;   // q rows 64 w .. 64 w + 63
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int r = 64 * w + 16 * warp + lane / 4;   // this thread: r, r + 8
    const int qp = row0 + r + skv - sq;             // q_pos of row r
    const int cq = 2 * (lane % 4);   // first column in each 8-column group
    const int wq_lo = row0 + 64 * w + skv - sq, wq_hi = wq_lo + 63;

    float m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};
    float acc[DP / 2], s[BKV / 2];
    uint32_t p[BKV / 4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    // A of q k^T: this warpgroup's 64 rows of each atom of the q block
    const uint64_t dq = desc128(sQ + 64 * w * 128, 16, 1024);
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_kb; ++i) {
      const int st = i % ST, k0 = (kb_lo + i) * BKV;
      const uint32_t ph = (i / ST) & 1;
      mbar_wait(full_k(st), ph);
      const uint64_t dk = desc128(tile(st, 0), 16, 1024);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // 32-byte steps along D
        mma_ss(s, dq + ((kk / 4) * BQ * 128 + (kk % 4) * 32) / 16,
               dk + ((kk / 4) * BKV * 128 + (kk % 4) * 32) / 16, kk > 0);
      wg_commit();
      wg_wait0();
      reg_fence(s);

      // the per-element mask only where the block straddles an edge
      const bool edge = k0 + BKV > skv ||
                        (causal && k0 + BKV - 1 > wq_lo) ||
                        (window > 0 && k0 <= wq_hi - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) {
          const int key = k0 + (j / 4) * 8 + cq + j % 2;
          const int q_pos = qp + 8 * ((j % 4) / 2);
          bool keep = key < skv;
          if (causal) keep = keep && key <= q_pos;
          if (window > 0) keep = keep && key > q_pos - window;
          s[j] = keep ? s[j] * scale2 : kNegInf2;
        }
        softmax_step(s, 1.f, m, l, acc, p);
      } else {
        softmax_step(s, scale2, m, l, acc, p);
      }

      mbar_wait(full_v(st), ph);
      // V: 8-row groups 1024 bytes apart, 64-column atoms BKV * 128 apart.
      // P goes in as two bf16 terms, bf16(P) and the remainder.
      const uint64_t dv = desc128(tile(st, 1), BKV * 128, 1024);
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        if (part == 1) remainder_pairs(s, p);
        wg_fence();
#pragma unroll
        for (int t = 0; t < BKV / 16; ++t)   // 16 keys = 2048 bytes a step
          mma_rs(acc, p + 4 * t, dv + t * 2048 / 16);
        wg_commit();
        wg_wait0();
        reg_fence(acc);
        reg_fence(p);
      }
      if (lane == 0) mbar_arrive(empty(st));
    }

    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      inv[rr] = 1.f / fmaxf(l[rr], 1e-30f);
    }
    __nv_bfloat16* op = o + ((long long)(b * hq + h) * sq + row0) * D;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int col = (i / 4) * 8 + cq, row = r + 8 * ((i % 4) / 2);
      if ((i / 4) * 8 < D && row0 + row < sq)
        *reinterpret_cast<__nv_bfloat162*>(op + (long long)row * D + col) =
            __floats2bfloat162_rn(acc[i] * inv[(i % 4) / 2],
                                  acc[i + 1] * inv[(i % 4) / 2]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The rank-3 map of a contiguous bf16 (heads, s, d) array: boxes of 64
// columns by `rows` rows of one head, 128-byte swizzle, zeros out of bounds.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int s, int heads,
                int rows) {
  const EncodeTiled enc = encoder();
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * s * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc != nullptr &&
         enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int sq, int skv, int causal, int window,
                float scale, cudaStream_t stream) {
  using C = Wg<D>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, D, sq, b * hq, C::kBQ) ||
      !tensor_map(&tk, k, D, skv, b * hkv, C::kBKV) ||
      !tensor_map(&tv, v, D, skv, b * hkv, C::kBKV))
    return (int)cudaErrorInvalidValue;
  const auto kern = flash_attention_wgmma<D>;
  static const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  // heads fastest, q blocks last: the heaviest q blocks of every head first
  const dim3 grid(hq, b, (sq + C::kBQ - 1) / C::kBQ);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, hq, hkv, sq, skv, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <bool kBf16, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal, int window,
           float scale, cudaStream_t st) {
  return kBf16 ? launch_bf16<D>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                                window, scale, st)
               : launch_f32<D>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                               window, scale, st);
}

template <bool kBf16>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int skv, int d, int causal, int window,
             float scale, cudaStream_t st) {
  switch (d) {
    case 64:
      return launch<kBf16, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                               window, scale, st);
    case 80:
      return launch<kBf16, 80>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                               window, scale, st);
    case 128:
      return launch<kBf16, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                                window, scale, st);
    case 256:
      return launch<kBf16, 256>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                                window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// o (b, hq, sq, d) = attention of q (b, hq, sq, d) over k, v
// (b, hkv, skv, d), all contiguous device arrays of one type: bf16 when
// is_bf16 (the tensor-core route; every base 16-byte aligned, as TMA
// needs), else float32 (the CUDA-core route). hq % hkv == 0, sq <= skv,
// d in {64, 80, 128, 256} (checked by the wrapper); scale = d^-1/2.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      int causal, int window, float scale,
                                      int is_bf16, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_d<true>(q, k, v, o, b, hq, hkv, sq, skv, d, causal,
                                  window, scale, st)
                 : launch_d<false>(q, k, v, o, b, hq, hkv, sq, skv, d,
                                   causal, window, scale, st);
}

// Dynamic shared memory of the instantiation for head dim d, in bytes (-1
// for a head dim that has none): what a launch asks for.
extern "C" int flash_attention_smem(int d, int is_bf16) {
  switch (d) {
    case 64:
      return (int)(is_bf16 ? Wg<64>::kSmem : Tile<64>::kBytes);
    case 80:
      return (int)(is_bf16 ? Wg<80>::kSmem : Tile<80>::kBytes);
    case 128:
      return (int)(is_bf16 ? Wg<128>::kSmem : Tile<128>::kBytes);
    case 256:
      return (int)(is_bf16 ? Wg<256>::kSmem : Tile<256>::kBytes);
    default:
      return -1;
  }
}
