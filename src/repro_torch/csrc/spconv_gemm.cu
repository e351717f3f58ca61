// Materialized tiled GEMM of the SpConv baseline, for Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `spconv_gemm` in
//   src/repro/kernels/spconv_gemm/kernel.py (body `_kernel`): every bm-row
//   tile of a pre-gathered lhs times the weights of the tile's tap, zeros
//   for a dead tile. The gather before it and the scatter-add after it are
//   plain PyTorch (ops.apply_kmap), as they were XLA in the reference.
//
// What bounds it on the H100: bytes on the MinkUNet layers, operations on
// a wide expert product. The output is the whole (M_pad, Cout_pad)
// partial-product array, dead tiles included, and M_pad is the worst-case
// slot budget of the tile layout (2.2 M slots for a 65,536-row bucket),
// while the live tiles are a few thousand: writing that array (4.6 GB at
// Cout 512) is the floor there. On the MoE router's rulebook (Mixtral's
// w_gate: 48 live 128-row tiles, Cin 4,096, Cout 14,336) the products are:
// 0.72 TFLOP at the float32-exact tensor-core rate, 495 / 3 TFLOP/s.
//
// Design:
//  * The 3xTF32 step of tf32x3.cuh (mma.sync m16n8k8, each operand split
//    into two TF32 terms, float32 accuracy) on the 128 x 128 CTA tile that
//    kernel 4 (masked_matmul.cu) also runs: 8 warps, each a 64 x 32 block.
//    W[tap] is N-major (Cin, Cout_pad); mma.sync reads its B fragments from
//    the staged rows directly, with no transposed weight copy. Operands are
//    split by split_fast: the exact split's cvt.rna pair took a sixth of
//    the time at Mixtral's w_gate (12.5 against 10.4 ms on an H100 80GB
//    HBM3 at 700 W), and the error against a float32 matmul stayed where
//    the tensor core's float32 accumulation over Cin puts it (1.76e-4
//    against 1.77e-4 there, of a 5.6e-4 gate).
//  * A live CTA walks Cin in 32-deep steps through the 3-stage cp.async
//    ring of tf32x3.cuh (lhs 128 x 32, W 32 x 128 a stage, 105 KB), so two
//    steps are in flight while the tensor cores run; two CTAs fit on an SM
//    (at most 128 registers a thread). Lhs rows that are not 16-byte
//    aligned (Cin not a multiple of 4) take 4-byte copies; the ragged Cin
//    edge and the rows past bm are zero-filled.
//  * One CTA per (128-row block of a tile, 128-column slab); a tile of bm
//    > 128 rows takes ceil(bm / 128) blocks, one of bm <= 128 a single
//    block with its rows past bm masked. No two CTAs write one element.
//  * Work order, for weight reuse: blockIdx.x runs over the row blocks in
//    layout order and blockIdx.y over the slabs, so the CTAs are issued
//    slab-major, and those resident at once (2 a SM, 264; dead ones retire
//    at once) are the live tiles of a few consecutive slabs. Tiles of one
//    tap lie together in the layout (build_tap_tiles sorts by tap within an
//    output block; the MoE rulebook by expert), so the CTAs that read one
//    (tap, slab) weight panel run together and share it through L2, in
//    step along Cin. At Mixtral's w_gate that reads each expert's panel
//    from DRAM about once, 8 x 112 panels of 2.1 MB = 1.88 GB, and the 48
//    live lhs tiles (100 MB, twice the L2) once per wave of about 5 slabs,
//    about 2 GB: some 3.9 GB, 1.2 ms at 3.35 TB/s, under the 4.4 ms of
//    products. One CTA reading its own panel per tile would move 11.3 GB
//    from L2, as the kernel's first form did.
//  * A dead tile (tile_nz == 0) loads nothing and stores zeros with 16-byte
//    stores: that is the reference's contract (`_skip`), whatever its lhs
//    rows hold.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kMT = 128;        // rows of a CTA's block
constexpr int kNT = 128;        // columns of a slab
constexpr int kKC = 32;         // depth of one staged step
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kLda = kKC + 4;   // 36: A fragment reads hit 32 banks
constexpr int kLdb = kNT + 8;   // 136: B fragment reads hit 32 banks
constexpr int kStageA = kMT * kLda;
constexpr int kStageB = kKC * kLdb;
using tf32x3::cp_async16;
using tf32x3::cp_async4;

constexpr size_t kSmem = sizeof(float) * kStages * (kStageA + kStageB);

struct Args {
  const float* lhs;
  const float* w;
  const int* tile_tap;
  const int* tile_nz;
  float* out;
  int c_in, c_out_pad, bm;
  int row_blocks;  // 128-row blocks a tile
  int a_vec;       // lhs rows may be copied 16 bytes at a time
  int b_vec;       // W rows likewise
};

// Stage Cin step `step` of the block whose first row is lhs row `row0`
// (`rows` of its 128 rows valid) and of the tap's weight panel `wt`.
__device__ __forceinline__ void load_step(const Args& p, float* sa, float* sb,
                                          int step, long long row0, int rows,
                                          const float* wt, int tid) {
  const int k0 = step * kKC;
  {  // lhs: one row per thread pair, 4 chunks of 4 floats each
    const int r = tid >> 1;
    const bool row_ok = r < rows;
    const float* src = p.lhs + (row0 + r) * p.c_in;
    float* dst = sa + r * kLda;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = ((tid & 1) * 4 + q) * 4, kc = k0 + kk;
      if (p.a_vec) {
        const bool ok = row_ok && kc < p.c_in;
        cp_async16(dst + kk, ok ? src + kc : p.lhs, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok && kc + e < p.c_in;
          cp_async4(dst + kk + e, ok ? src + kc + e : p.lhs, ok ? 4 : 0);
        }
      }
    }
  }
  tf32x3::stage_b<kKC, kNT, kLdb, kThreads>(sb, wt, p.c_out_pad, k0, 0,
                                           p.c_in, kNT, p.b_vec, tid);
}

__global__ void __launch_bounds__(kThreads, 2)
    spconv_gemm_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_b = s_a + kStages * kStageA;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // 64-row half, 32-column quarter
  const long long t = blockIdx.x / p.row_blocks;
  const int r0 = (blockIdx.x - t * p.row_blocks) * kMT;
  const int rows = min(kMT, p.bm - r0);
  const long long row0 = t * p.bm + r0;
  const int col0 = blockIdx.y * kNT;
  float* out = p.out + row0 * p.c_out_pad + col0;

  if (p.tile_nz[t] == 0) {  // dead tile: zeros, nothing loaded
    for (int idx = tid; idx < rows * (kNT / 4); idx += kThreads) {
      const int r = idx >> 5, c4 = (idx & 31) * 4;
      *reinterpret_cast<float4*>(out + r * (long long)p.c_out_pad + c4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const float* wt =
      p.w + (long long)p.tile_tap[t] * p.c_in * p.c_out_pad + col0;

  tf32x3::WarpAcc acc;
  tf32x3::zero(acc);
  tf32x3::ring<kStages>(
      (p.c_in + kKC - 1) / kKC,
      [&](int i, int s) {
        load_step(p, s_a + s * kStageA, s_b + s * kStageB, i, row0, rows, wt,
                  tid);
      },
      [&](int s) {
        tf32x3::warp_tile<kKC, kLda, kLdb, false>(
            s_a + s * kStageA + wm * 64 * kLda, s_b + s * kStageB + wn * 32,
            acc, lane);
      });
  // rows as int: the output, M_pad x 128 floats at least, keeps M_pad far
  // below 2^31 on an 80 GB card
  tf32x3::store_tile(acc, p.out + col0, p.c_out_pad, (int)row0 + wm * 64,
                     wn * 32, (int)row0 + rows, kNT, true, lane);
}

}  // namespace

// out (n_tiles*bm, c_out_pad) f32: tile t's rows are lhs's rows times
// w[tile_tap[t]] (K, c_in, c_out_pad), or zeros where tile_nz[t] == 0. Every
// pointer is a device pointer; c_out_pad must be a multiple of 128 and out
// 16-byte aligned. Returns the CUDA error code of the launch (0 on success).
extern "C" int spconv_gemm_launch(const void* lhs, int c_in, const void* w,
                                  int c_out_pad, int bm, int n_tiles,
                                  const void* tile_tap, const void* tile_nz,
                                  void* out, void* stream) {
  if (n_tiles > 0 && c_out_pad > 0) {
    Args p;
    p.lhs = (const float*)lhs;
    p.w = (const float*)w;
    p.tile_tap = (const int*)tile_tap;
    p.tile_nz = (const int*)tile_nz;
    p.out = (float*)out;
    p.c_in = c_in;
    p.c_out_pad = c_out_pad;
    p.bm = bm;
    p.row_blocks = (bm + kMT - 1) / kMT;
    p.a_vec = c_in % 4 == 0 && (reinterpret_cast<uintptr_t>(lhs) & 15) == 0;
    p.b_vec = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    cudaError_t err = cudaFuncSetAttribute(
        spconv_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_tiles * p.row_blocks, c_out_pad / kNT);
    spconv_gemm_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the kernel, in bytes: the ring.
extern "C" int spconv_gemm_smem() { return (int)kSmem; }
