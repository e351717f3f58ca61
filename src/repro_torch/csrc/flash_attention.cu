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
// card's ridge point, and only the tensor cores reach it (989 TFLOP/s in
// bf16, one `wgmma` per 64-row tile; 495 / 3 TFLOP/s for float32-exact
// products, three TF32 products each).
//
// Two routes, chosen by the input type in flash_attention_launch. This is
// a route by type, not a fallback: a bf16 input always takes the first.
//  * bf16: flash_attention_wgmma, both products on the tensor cores.
//  * float32: flash_attention_tf32x3, both products on the tensor cores as
//    3xTF32 mma.sync (tf32x3.cuh). It serves the float32 prefill and
//    training gate and the float32 check of every shape against the plain
//    version at 2e-5, which one bf16 or TF32 product could not meet.
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
// The float32 route (3xTF32 on the tensor cores, mma.sync):
//  * Both products are the split-precision step of tf32x3.cuh (m16n8k8,
//    each operand split into two TF32 terms, three products): S = q k^T
//    with q the row-major A operand and k as stored (keys x D, D
//    contiguous) the "col" B operand, b0 = K[n0 + g][k0 + t] and b1 =
//    K[n0 + g][k0 + t + 4]; O += P V with V (keys x D) N-major.
//  * P never leaves registers: the keys of each k8 step of P V are taken
//    in the order 0, 2, 4, 6, 1, 3, 5, 7 (A's k index t is key 2t, t + 4
//    is key 2t + 1; the sum over keys does not care), so the S fragment
//    (c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)) is
//    P's A fragment as it stands, a0 a1 a2 a3 = c0 c2 c1 c3, and V's rows
//    are read in the same order, b0 = V[k0 + 2t][n0 + g], b1 =
//    V[k0 + 2t + 1][n0 + g]. Each thread splits the P values it owns.
//  * Every thread copies the q block once and K and V tiles of kBKV keys
//    (64; 16 at D = 256) through a cp.async ring (tf32x3::ring), 16 bytes
//    a copy, into tiles with a row pitch of D + 4 floats, which keeps every
//    fragment read on 32 distinct banks. Rows past Sq or Skv are
//    zero-filled: q rows past Sq are never stored, keys past Skv masked.
//  * What holds it back is not the tensor cores alone: with two warps a
//    scheduler the fragment loads and splits and the softmax barely
//    overlap the MMAs. So a warp takes two m16 row tiles at D = 64 (each
//    K or V fragment, loaded and split once, feeds both; 4 warps, 128 q
//    rows, two CTAs an SM) and one above (8 warps at D = 80 and 128, 4 at
//    D = 256, whose 16 x 256 O accumulator alone takes 128 registers).
//    Each warp splits the fragments it reads by split_fast (lo passed
//    whole, truncated by the tensor core): splitting each K and V tile
//    once for the CTA into fragment-ordered (hi, lo) tiles, or splitting
//    exactly (split, at the same error), measured slower on an H100
//    (PERF.md).
//  * The online softmax is the bf16 route's, on the float32 S fragment.
//    A warp also skips a KV tile that none of its rows sees (a causal
//    diagonal, a window's edge): such a tile adds exactly nothing, see the
//    note on -1e30 above.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // -1e30 in the exp2 domain

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// float32 route: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

template <int D>
struct F32 {
  static constexpr int kMT = D == 64 ? 2 : 1;   // m16 row tiles a warp
  static constexpr int kWarps = D == 256 ? 4 : 8 / kMT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kMT * kWarps;   // q rows of a CTA
  static constexpr int kBKV = D == 256 ? 16 : 64;   // keys of a tile
  static constexpr int kStages = D == 80 || D == 256 ? 3 : 2;
  static constexpr int kMinBlocks = kMT == 2 ? 2 : 1;   // CTAs an SM
  static constexpr int kPitch = D + 4;   // floats a tile row
  static constexpr int kQTile = kBQ * kPitch;
  static constexpr int kKVTile = kBKV * kPitch;   // one K or V tile
  static constexpr size_t kSmem =
      sizeof(float) * (kQTile + 2 * kStages * kKVTile);
};

// cp.async rows r0 .. r0 + kRows of a row-major (n, D) array into a tile
// of pitch D + 4, 16 bytes a copy; rows past n are zero-filled.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, int tid) {
  constexpr int kChunks = D / 4;
  static_assert(kRows * kChunks % kThreads == 0, "layout");
#pragma unroll
  for (int j = 0; j < kRows * kChunks / kThreads; ++j) {
    const int idx = tid + j * kThreads, r = idx / kChunks;
    const int c = 4 * (idx - r * kChunks);
    const bool ok = r0 + r < n;
    tf32x3::cp_async16(dst + r * (D + 4) + c,
                       ok ? src + (long long)(r0 + r) * D + c : src,
                       ok ? 16 : 0);
  }
}

// B fragment of q k^T: keys n0 .. n0 + 8 of the K tile (keys x D, pitch
// kP) against D columns k0 .. k0 + 8, split into hi and lo.
template <int kP>
__device__ __forceinline__ void load_k(const float* sk, int n0, int k0,
                                       int lane, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float* p = sk + (n0 + (lane >> 2)) * kP + k0 + (lane & 3);
  tf32x3::split_fast(p[0], hi[0], lo[0]);
  tf32x3::split_fast(p[4], hi[1], lo[1]);
}

// B fragment of P V: keys k0 .. k0 + 8 of the V tile (keys x D, pitch kP)
// in the order 0, 2, 4, 6, 1, 3, 5, 7, against columns n0 .. n0 + 8.
template <int kP>
__device__ __forceinline__ void load_v(const float* sv, int k0, int n0,
                                       int lane, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float* p = sv + (k0 + 2 * (lane & 3)) * kP + n0 + (lane >> 2);
  tf32x3::split_fast(p[0], hi[0], lo[0]);
  tf32x3::split_fast(p[kP], hi[1], lo[1]);
}

// One KV block of the online softmax on the float32 S fragments s[j] of
// one m16 tile (elements 0-1 on the thread's row g, 2-3 on row g + 8). s
// holds raw scores when sc is the exp2-domain scale, or scaled and masked
// ones when sc is 1. Updates m, l (per-thread partial) and o, and leaves P
// in s.
template <int NS, int NO>
__device__ __forceinline__ void softmax_f32(float (&s)[NS][4], float sc,
                                            float (&m)[2], float (&l)[2],
                                            float (&o)[NO][4]) {
  float mx[2] = {kNegInf2, kNegInf2};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
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
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], sc, -m[e / 2]));
      l[e / 2] += s[j][e];
    }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
}

template <int D>
__global__ void __launch_bounds__(F32<D>::kThreads, F32<D>::kMinBlocks)
    flash_attention_tf32x3(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int hq, int hkv, int sq, int skv, int causal,
                           int window, float scale2) {
  using C = F32<D>;
  constexpr int BQ = C::kBQ, BKV = C::kBKV, P = C::kPitch, MT = C::kMT;
  constexpr int NS = BKV / 8;   // n8 tiles of S: k8 steps of P V
  constexpr int NO = D / 8;     // n8 tiles of O
  constexpr int KD = D / 8;     // k8 steps of q k^T
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + C::kQTile;   // stage s: K tile 2 s, V tile 2 s + 1

  // heads fastest, q blocks last: the heaviest q blocks of every head first
  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * BQ;
  const int q_lo = row0 + skv - sq;                    // q_pos of row 0
  const int q_hi = min(row0 + BQ, sq) - 1 + skv - sq;  // of the last row
  int kb_lo = 0, kb_hi = (skv - 1) / BKV;
  if (causal) kb_hi = min(kb_hi, q_hi / BKV);
  if (window > 0) kb_lo = max(0, q_lo - window + 1) / BKV;

  const int tid = threadIdx.x, lane = tid % 32;
  const int wr = tid / 32 * 16 * MT;   // the warp's rows: wr .. wr + 16 MT
  const int g = lane / 4, t = lane % 4;
  // q_pos of row wr + 16 mt + g; of row wr + 16 mt + g + 8: + 8
  const int qp = q_lo + wr + g;
  const int wq_lo = q_lo + wr;
  const int wq_hi = min(row0 + wr + 16 * MT, sq) - 1 + skv - sq;
  const bool live = row0 + wr < sq;   // the warp holds a q row

  const long long kvo = (long long)(b * hkv + h / (hq / hkv)) * skv * D;
  // the q block joins the first stage's copies
  stage_rows<D, BQ, C::kThreads>(sQ, q + (long long)(b * hq + h) * sq * D,
                                 row0, sq, tid);

  float m[MT][2], l[MT][2], acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf2;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  int step = 0;

  tf32x3::ring<C::kStages>(
      kb_hi - kb_lo + 1,
      [&](int i, int s) {
        const int k0 = (kb_lo + i) * BKV;
        float* dst = sKV + 2 * s * C::kKVTile;
        stage_rows<D, BKV, C::kThreads>(dst, k + kvo, k0, skv, tid);
        stage_rows<D, BKV, C::kThreads>(dst + C::kKVTile, v + kvo, k0, skv,
                                        tid);
      },
      [&](int s) {
        const int k0 = (kb_lo + step) * BKV;
        ++step;
        // a tile that no row of the warp sees adds nothing
        if (!live || (causal && k0 > wq_hi) ||
            (window > 0 && k0 + BKV - 1 <= wq_lo - window))
          return;
        const float* sK = sKV + 2 * s * C::kKVTile;
        const float* sV = sK + C::kKVTile;

        float sc[MT][NS][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            tf32x3::load_a<false>(sQ, P, wr + 16 * mt, 8 * kk, lane,
                                  ah[mt], al[mt]);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            uint32_t bh[2], bl[2];
            load_k<P>(sK, 8 * j, 8 * kk, lane, bh, bl);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              tf32x3::mma3(sc[mt][j], ah[mt], al[mt], bh, bl);
          }
        }

        // the per-element mask only where the tile straddles an edge
        const bool edge = k0 + BKV > skv ||
                          (causal && k0 + BKV - 1 > wq_lo) ||
                          (window > 0 && k0 <= wq_hi - window);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (edge) {
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = k0 + 8 * j + 2 * t + e % 2;
                const int q_pos = qp + 16 * mt + 8 * (e / 2);
                bool keep = key < skv;
                if (causal) keep = keep && key <= q_pos;
                if (window > 0) keep = keep && key > q_pos - window;
                sc[mt][j][e] = keep ? sc[mt][j][e] * scale2 : kNegInf2;
              }
            softmax_f32(sc[mt], 1.f, m[mt], l[mt], acc[mt]);
          } else {
            softmax_f32(sc[mt], scale2, m[mt], l[mt], acc[mt]);
          }
        }

#pragma unroll
        for (int j = 0; j < NS; ++j) {
          // P's A fragments in the permuted key order: c0 c2 c1 c3
          uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tf32x3::split_fast(sc[mt][j][0], ph[mt][0], pl[mt][0]);
            tf32x3::split_fast(sc[mt][j][2], ph[mt][1], pl[mt][1]);
            tf32x3::split_fast(sc[mt][j][1], ph[mt][2], pl[mt][2]);
            tf32x3::split_fast(sc[mt][j][3], ph[mt][3], pl[mt][3]);
          }
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            uint32_t bh[2], bl[2];
            load_v<P>(sV, 8 * j, 8 * n, lane, bh, bl);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              tf32x3::mma3(acc[mt][n], ph[mt], pl[mt], bh, bl);
          }
        }
      });

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // l is a per-thread partial sum (alpha is the same on a row's 4 lanes)
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      den[r] = fmaxf(lr, 1e-30f);
    }
    const int r0 = row0 + wr + 16 * mt;   // the m16 tile's first q row
    float* og = o + ((long long)(b * hq + h) * sq + r0) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (r0 + row < sq) {
#pragma unroll
        for (int n = 0; n < NO; ++n)
          *reinterpret_cast<float2*>(og + (long long)row * D + 8 * n +
                                     2 * t) =
              make_float2(acc[mt][n][2 * r] / den[r],
                          acc[mt][n][2 * r + 1] / den[r]);
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int causal, int window,
               float scale, cudaStream_t stream) {
  using C = F32<D>;
  const auto kern = flash_attention_tf32x3<D>;
  // The shared-memory size is a constant of the instantiation: raise the
  // limit once, on the first launch, and keep its result for later ones.
  static const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(hq, b, (sq + C::kBQ - 1) / C::kBQ);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, hq, hkv,
      sq, skv, causal, window, scale * kLog2e);
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
// is_bf16 (the wgmma route; every base 16-byte aligned, as TMA needs),
// else float32 (the 3xTF32 route; 16-byte aligned bases for its cp.async
// copies, which the wrapper checks for both types). hq % hkv == 0, sq <= skv,
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
      return (int)(is_bf16 ? Wg<64>::kSmem : F32<64>::kSmem);
    case 80:
      return (int)(is_bf16 ? Wg<80>::kSmem : F32<80>::kSmem);
    case 128:
      return (int)(is_bf16 ? Wg<128>::kSmem : F32<128>::kSmem);
    case 256:
      return (int)(is_bf16 ? Wg<256>::kSmem : F32<256>::kSmem);
    default:
      return -1;
  }
}
