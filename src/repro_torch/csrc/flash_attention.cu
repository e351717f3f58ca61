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
// card's ridge point. This version runs those FLOPs as float32 FMAs on the
// CUDA cores (67 TFLOP/s), not on the tensor cores (989 TFLOP/s in bf16),
// which is the gap a later version closes with wgmma on bf16 tiles.
//
// Design:
//  * One CTA (256 threads) per (64-row q block, query head, batch row), with
//    a loop over KV blocks inside it: the loop takes the place of the TPU's
//    sequential innermost grid dimension, and m, l and the accumulator live
//    in registers instead of VMEM scratch. Heavy causal q blocks (the last
//    ones) are launched first.
//  * The loop visits only the KV blocks inside the causal / window band of
//    the q block (the reference's structural skip): the others are never
//    loaded.
//  * q, k and v (bf16 or float32) are converted to float32 as they are
//    staged in shared memory. Each thread owns 4 q rows: 4 x (BKV / 16)
//    scores and 4 x (D / 16) accumulator columns. A row's 16 threads are
//    16 lanes of one warp, so the row max and sum are warp shuffles; the
//    probabilities go through shared memory for the p.v product.
//  * Masked scores are the reference's finite -1e30, never -inf: a block
//    in which a row sees no live key gives exp(0) = 1 there, which the next
//    live block wipes with alpha = exp(-1e30 - m) = 0, where -inf would
//    give exp(-inf + inf) = NaN.
//  * Ragged edges: q rows past Sq are staged as zeros and never stored;
//    keys past Skv are masked. Blocks: BKV = 64 at D <= 80 and 32 at
//    D >= 128, so the float32 tiles take 68,608-141,824 bytes of dynamic
//    shared memory (three CTAs per SM at D = 64 and 128, two at D = 80,
//    one at D = 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Tile {
  static constexpr int kBKV = D >= 128 ? 32 : 64;
  static constexpr int kQP = D + 4;       // row pitch of sQ and sK (floats)
  static constexpr int kPP = kBKV + 4;    // row pitch of sP
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * kQP + kBKV * kQP + kBKV * D + kBQ * kPP);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int hq, int hkv, int sq,
    int skv, int causal, int window, float scale) {
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

  const T* qp = q + ((long long)(b * hq + h) * sq + row0) * D;
  const T* kp = k + (long long)(b * hkv + hk) * skv * D;
  const T* vp = v + (long long)(b * hkv + hk) * skv * D;
  T* op = o + ((long long)(b * hq + h) * sq + row0) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    sQ[r * QP + c] = row0 + r < sq ? to_f32(qp[(long long)r * D + c]) : 0.f;
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
      sK[r * QP + c] = in ? to_f32(kp[off]) : 0.f;
      sV[r * D + c] = in ? to_f32(vp[off]) : 0.f;
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
        store_as(op + (long long)r * D + cg + 16 * dd, acc[i][dd] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal, int window,
           float scale, cudaStream_t stream) {
  const auto kern = flash_attention_kernel<T, D>;
  constexpr size_t bytes = Tile<D>::kBytes;
  // The shared-memory size is a constant of the instantiation: raise the
  // limit once, on the first launch, and keep its result for later ones.
  static const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, hq, hkv, sq, skv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int skv, int d, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                           scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// o (b, hq, sq, d) = attention of q (b, hq, sq, d) over k, v
// (b, hkv, skv, d), all contiguous device arrays of one type: bf16 when
// is_bf16, else float32. hq % hkv == 0, sq <= skv, d in {64, 80, 128, 256}
// (checked by the wrapper); scale = d^-1/2. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      int causal, int window, float scale,
                                      int is_bf16, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d,
                                           causal, window, scale, st)
                 : launch_d<float>(q, k, v, o, b, hq, hkv, sq, skv, d, causal,
                                   window, scale, st);
}
