// Output-stationary gather-GEMM of every SpConv layer, for Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `spconv_gemm_fused` in
//   src/repro/kernels/spconv_gemm/kernel.py (body `_os_kernel`, row DMAs
//   `_row_dmas`), in both its modes: plain, and with the fused BN/ReLU
//   epilogue that also emits the next layer's per-128-column liveness.
//
// What bounds it on the H100: operations, at serving widths. Each live map
// costs 2 * Cin * Cout float32 FLOPs on the CUDA cores (this first version
// uses no tensor cores, so the 67 TFLOP/s float32 rate is its ceiling),
// while the bytes that must move are the features, the weights and the
// output, each once. Narrow layers (the Cin = 4 stem, Cout padded to 128)
// are bound by bytes instead.
//
// Design:
//  * The tile layout of build_tap_tiles gives each bo-row output block a
//    consecutive run of single-tap tiles (tile_ob is monotone, empty blocks
//    get one all-pad tile). One CTA owns one (output block, 128-column slab)
//    and walks that run in order; this loop replaces the TPU's sequential
//    grid. No two CTAs write the same output element, so no atomics.
//  * A (512 x Cout_pad) float32 block is up to 1 MB, far above the 227 KB
//    of shared memory a block may use, where the TPU held it in VMEM. So
//    each 64-slot chunk of a tile is accumulated in registers over the whole
//    Cin (a 64 x 128 register tile, 4 x 8 values per thread), then
//    read-modify-written into the block in global memory, which this CTA
//    owns exclusively. Within a tile every valid slot targets a distinct
//    row; __syncthreads() between chunks orders one chunk's writes before
//    the next chunk's reads, and the block stays hot in L2.
//  * The rows of a chunk are gathered by gather_idx into shared memory, Cin
//    in 32-wide steps together with the tap's weight slice; slots outside
//    the block (padding) load zeros and are never written back, so they
//    cost no feature bandwidth, and a chunk of padding only is skipped.
//  * Dead tiles (tile_nz == 0) and dead (tile, Cin-block) pairs
//    (tile_bk_nz == 0) are skipped, gather and MACs both. Block liveness is
//    indexed at the plan's bk, which ops.pick_bk keeps a multiple of the
//    32-wide Cin step.
//  * Epilogue mode: when the run ends, relu(y * scale + shift) masked by
//    valid is applied to the finished block in place, one warp per row, and
//    the row's 128-column liveness is a warp ballot over the stored values.
#include <cuda_runtime.h>

namespace {

constexpr int kMT = 64;      // slots per register tile
constexpr int kNT = 128;     // output columns per CTA (one liveness group)
constexpr int kKC = 32;      // Cin step
constexpr int kThreads = 256;

__device__ __forceinline__ void add4(float* p, float a, float b, float c,
                                     float d) {
  float4 v = *reinterpret_cast<float4*>(p);
  v.x += a; v.y += b; v.z += c; v.w += d;
  *reinterpret_cast<float4*>(p) = v;
}

__global__ void __launch_bounds__(kThreads) spconv_gemm_fused_kernel(
    const float* __restrict__ feats, int c_in,
    const float* __restrict__ w, int c_out_pad,
    const int* __restrict__ gather, const int* __restrict__ scatter, int bm,
    const int* __restrict__ tile_tap, const int* __restrict__ tile_nz,
    const int* __restrict__ tile_bk_nz, int n_kb, int bk,
    const int* __restrict__ run_start, int bo,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const int* __restrict__ valid, float* __restrict__ out,
    int* __restrict__ nz, int epilogue) {
  __shared__ __align__(16) float As[kKC][kMT + 4];   // gathered rows, k-major
  __shared__ __align__(16) float Bs[kKC][kNT];       // weight slice
  __shared__ int s_src[kMT];
  __shared__ int s_loc[kMT];

  const int ob = blockIdx.x;
  const int col0 = blockIdx.y * kNT;
  const int tid = threadIdx.x;
  const int tx = tid & 15;         // columns tx*4 .. +4 and 64 + tx*4 .. +4
  const int ty = tid >> 4;         // rows ty*4 .. +4
  const long long row0 = (long long)ob * bo;

  // open the block: zero this CTA's slab of it
  for (int idx = tid; idx < bo * (kNT / 4); idx += kThreads) {
    const int r = idx / (kNT / 4), c4 = idx - r * (kNT / 4);
    *reinterpret_cast<float4*>(out + (row0 + r) * c_out_pad + col0 + 4 * c4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int t_begin = run_start[ob], t_end = run_start[ob + 1];
  for (int t = t_begin; t < t_end; ++t) {
    if (tile_nz[t] == 0) continue;                  // dead tile: uniform skip
    const float* wt = w + (long long)tile_tap[t] * c_in * c_out_pad + col0;
    const int* bk_nz = tile_bk_nz + (long long)t * n_kb;
    for (int m0 = 0; m0 < bm; m0 += kMT) {
      // orders the previous chunk's block writes (and the zeroing) before
      // this chunk's, and frees s_src / s_loc
      __syncthreads();
      int live = 0;
      if (tid < kMT) {
        int src = -1, loc = -1;
        if (m0 + tid < bm) {
          const long long slot = (long long)t * bm + m0 + tid;
          const int l = scatter[slot] - ob * bo;
          if (l >= 0 && l < bo) { loc = l; src = gather[slot]; }
        }
        s_src[tid] = src;
        s_loc[tid] = loc;
        live = loc >= 0;
      }
      // a chunk of padding slots only would add nothing: skip it
      if (!__syncthreads_or(live)) continue;

      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int c0 = 0; c0 < c_in; c0 += kKC) {
        if (bk_nz[c0 / bk] == 0) continue;          // dead Cin block: uniform
        for (int idx = tid; idx < kMT * kKC; idx += kThreads) {
          const int r = idx / kKC, kk = idx - r * kKC;
          const int src = s_src[r], c = c0 + kk;
          As[kk][r] = (src >= 0 && c < c_in)
                          ? __ldg(feats + (long long)src * c_in + c) : 0.f;
        }
        for (int idx = tid; idx < kKC * (kNT / 4); idx += kThreads) {
          const int kk = idx / (kNT / 4), c4 = idx - kk * (kNT / 4);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (c0 + kk < c_in)
            v = __ldg(reinterpret_cast<const float4*>(
                wt + (long long)(c0 + kk) * c_out_pad + 4 * c4));
          *reinterpret_cast<float4*>(&Bs[kk][4 * c4]) = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
          const float4 b1 =
              *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }

      // arrangement: add each slot's row into its row of the block
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int loc = s_loc[ty * 4 + i];
        if (loc < 0) continue;
        float* o = out + (row0 + loc) * c_out_pad + col0;
        add4(o + tx * 4, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        add4(o + 64 + tx * 4, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
  if (!epilogue) return;

  // fused epilogue on the finished block: one warp per row, 4 columns a lane
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  const int n_groups = gridDim.y;
  const float4 sc = *reinterpret_cast<const float4*>(scale + col0 + lane * 4);
  const float4 sh = *reinterpret_cast<const float4*>(shift + col0 + lane * 4);
  for (int r = warp; r < bo; r += kThreads / 32) {
    const long long row = row0 + r;
    float* o = out + row * c_out_pad + col0 + lane * 4;
    float4 v = *reinterpret_cast<float4*>(o);
    if (valid[row]) {
      v.x = fmaxf(v.x * sc.x + sh.x, 0.f);
      v.y = fmaxf(v.y * sc.y + sh.y, 0.f);
      v.z = fmaxf(v.z * sc.z + sh.z, 0.f);
      v.w = fmaxf(v.w * sc.w + sh.w, 0.f);
    } else {
      v = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    *reinterpret_cast<float4*>(o) = v;
    const bool live = v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
    const unsigned any = __ballot_sync(0xffffffffu, live);
    if (lane == 0) nz[row * n_groups + blockIdx.y] = any != 0u;
  }
}

}  // namespace

// out (n_blocks*bo, c_out_pad) f32 = the gather-GEMM-scatter of one layer;
// with epilogue != 0 also relu(out*scale+shift) under valid, and nz
// (n_blocks*bo, c_out_pad/128) int32. run_start (n_blocks+1,) holds the first
// tile of each output block's run. Every pointer is a device pointer (nz,
// scale, shift and valid may be null when epilogue == 0). c_out_pad must be
// a multiple of 128; bk a multiple of 32 unless n_kb == 1. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int spconv_gemm_fused_launch(
    const void* feats, int c_in, const void* w, int c_out_pad,
    const void* gather, const void* scatter, int bm, const void* tile_tap,
    const void* tile_nz, const void* tile_bk_nz, int n_kb, int bk,
    const void* run_start, int n_blocks, int bo, const void* scale,
    const void* shift, const void* valid, void* out, void* nz, int epilogue,
    void* stream) {
  if (n_blocks > 0 && c_out_pad > 0) {
    const dim3 grid(n_blocks, c_out_pad / kNT);
    spconv_gemm_fused_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)feats, c_in, (const float*)w, c_out_pad,
        (const int*)gather, (const int*)scatter, bm, (const int*)tile_tap,
        (const int*)tile_nz, (const int*)tile_bk_nz, n_kb, bk,
        (const int*)run_start, bo, (const float*)scale, (const float*)shift,
        (const int*)valid, (float*)out, (int*)nz, epilogue);
  }
  return (int)cudaGetLastError();
}
