// Output-stationary gather-GEMM of every SpConv layer, for Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `spconv_gemm_fused` in
//   src/repro/kernels/spconv_gemm/kernel.py (body `_os_kernel`, row DMAs
//   `_row_dmas`), in both its modes: plain, and with the fused BN/ReLU
//   epilogue that also emits the next layer's per-128-column liveness.
//
// What bounds it on the H100: operations, at serving widths. Each live map
// costs 2 * Cin * Cout FLOPs, which this kernel runs float32-exact on the
// tensor cores (3xTF32, tf32x3.cuh: 495 / 3 TFLOP/s), while the bytes that
// must move are the features, the weights and the output, each once.
// Narrow layers (the Cin = 4 stem, Cout padded to 128) are bound by bytes.
// In practice the padding of each (output block, tap) group to bm slots,
// the gather latency and the read-modify-write of the output block bound
// it well above either.
//
// Design:
//  * The tile layout of build_tap_tiles gives each bo-row output block a
//    consecutive run of single-tap tiles (tile_ob is monotone, empty blocks
//    get one all-pad tile). A served request pads every resolution to one
//    bucket, so a deep layer has 128 output blocks of which a dozen hold
//    maps, and the tail of the last run is thousands of all-pad tiles. So
//    a one-CTA planning kernel (spconv_split_plan_kernel) first maps the
//    grid onto the live work, on the device: each CTA gets one block and a
//    range of that block's live tiles, from its first live tile to just
//    past its last. When few blocks are live, the busy ones are split over
//    several CTAs in proportion to their live tiles, so that the deep
//    layers still fill the card; the grid size itself is static (blocks
//    plus two CTAs per SM per slab), and the CTAs left over exit.
//  * A CTA that is its block's only one owns the block's 128-column slab
//    exclusively: it zeroes it, read-modify-writes each tile's rows into it
//    (they stay in L2) and runs the epilogue on it. A CTA that shares its
//    block does the same in its own slab of a workspace, and
//    spconv_split_reduce_kernel sums the block's partials in CTA order,
//    then runs the epilogue. No float atomics anywhere: repeated calls give
//    bit-identical outputs.
//  * A CTA first lists its live work items, (tile, Cin step) pairs whose
//    tile is live and whose Cin block is live, into shared memory (in
//    windows of at most 1024 items), each with its tap and whether it opens
//    or closes its tile. Dead tiles and dead (tile, Cin-block) pairs cost
//    nothing further; a tile taller than 128 slots is walked as 128-slot
//    pieces.
//  * Each item's gathered rows (Cin-contiguous, 16-byte cp.async per chunk;
//    at Cin = 4 a row is one chunk) and the tap's weight slice (KC x 128,
//    N-major) go into a 3-stage ring; the loads of item i + 2 are issued
//    before the products of item i. Slots outside the block (padding) are
//    not loaded at all. The gather and scatter indices of a tile's rows are
//    read one item ahead of the tile's first loads.
//  * Within a (block, tap) group the valid slots are a prefix, so each tile
//    is multiplied only up to its last valid slot, in 16-row fragments: a
//    group of 22 maps costs 32 rows, not 128. Each of the 8 warps owns 16
//    columns of the slab and all the tile's fragments.
//  * Cin is walked in steps of KC = 32 (8 below Cin = 32, the stem): the
//    step of pick_bk, so that each step lies in one Cin block of tile_bk_nz.
//  * Epilogue mode: relu(y * scale + shift) masked by valid is applied to
//    the finished block, one warp per row, and the row's 128-column
//    liveness is a warp ballot over the stored values.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;

constexpr int kRows = 128;       // slots of a tile piece in shared memory
constexpr int kNT = 128;         // output columns per CTA (one liveness group)
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMaxItems = 1024;  // work items listed per window
constexpr int kLdb = kNT + 8;    // 136: B fragment reads hit 32 banks
constexpr uint32_t kFirst = 1u << 30, kLast = 1u << 31;

template <int KC>
struct Ring {
  static constexpr int kLda = KC + 4;  // 36 or 12: A reads hit 32 banks
  static constexpr int kStageA = kRows * kLda;
  static constexpr int kStageB = KC * kLdb;
  static constexpr size_t kSmem =
      sizeof(float) * kStages * (kStageA + kStageB) +
      sizeof(int) * kStages * kRows + sizeof(uint32_t) * kMaxItems;
};

struct Params {
  const float* feats;
  const float* w;
  const int* gather;
  const int* scatter;
  const int* tile_tap;
  const int* tile_nz;
  const int* tile_bk_nz;
  const int* work;     // (n_ctas, 4): block, first tile, end tile, splits
  const int* blk;      // (n_blocks, 2): first CTA, CTAs of the block
  const float* scale;
  const float* shift;
  const int* valid;
  float* out;
  float* ws;           // (n_ctas, bo, c_out_pad) partials, or null
  int* nz;
  int c_in, c_out_pad, bm, n_kb, bk, bo, n_out_pad, epilogue;
  int a_vec;           // feature rows may be copied 16 bytes at a time
};

// relu(v * sc + sh) on a valid row, zeros on an invalid one
__device__ __forceinline__ float4 epilogue4(float4 v, float4 sc, float4 sh,
                                            bool valid) {
  if (!valid) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(fmaxf(v.x * sc.x + sh.x, 0.f),
                     fmaxf(v.y * sc.y + sh.y, 0.f),
                     fmaxf(v.z * sc.z + sh.z, 0.f),
                     fmaxf(v.w * sc.w + sh.w, 0.f));
}

// Store the finished values v of output row `row`, columns col .. col + 4
// of slab `slab` (one warp per row, 4 columns a lane): with the epilogue,
// y = relu(v * scale + shift) under valid, and nz[row, slab] = any stored
// value != 0 (a warp ballot).
__device__ __forceinline__ void finish_row(const Params& p, float4 v,
                                           int row, int col, int slab) {
  if (p.epilogue) {
    const float4 sc = *reinterpret_cast<const float4*>(p.scale + col);
    const float4 sh = *reinterpret_cast<const float4*>(p.shift + col);
    v = epilogue4(v, sc, sh, p.valid[row] != 0);
  }
  *reinterpret_cast<float4*>(p.out + (long long)row * p.c_out_pad + col) = v;
  if (p.epilogue) {
    const bool live = v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
    const unsigned any = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0)
      p.nz[(long long)row * (p.c_out_pad / kNT) + slab] = any != 0u;
  }
}

template <int KC>
__global__ void __launch_bounds__(kThreads, 2)
    spconv_gemm_fused_kernel(const Params p) {
  using R = Ring<KC>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_b = s_a + kStages * R::kStageA;
  int* s_loc = reinterpret_cast<int*>(s_b + kStages * R::kStageB);
  uint32_t* s_list = reinterpret_cast<uint32_t*>(s_loc + kStages * kRows);
  __shared__ int s_warp[kThreads / 32];

  const int cta = blockIdx.x, slab = blockIdx.y;
  const int4 wk = reinterpret_cast<const int4*>(p.work)[cta];
  const int ob = wk.x, t_lo = wk.y, t_hi = wk.z;
  if (ob < 0) return;  // a spare CTA: the plan gave it no work
  const bool direct = wk.w == 1;
  const int col0 = slab * kNT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row 0 of this CTA's slab: of the block itself when the CTA is the only
  // one of its block, else of its own partial in the workspace
  float* dst = (direct ? p.out + (long long)ob * p.bo * p.c_out_pad
                       : p.ws + (long long)cta * p.bo * p.c_out_pad) + col0;

  // open the slab
  for (int idx = tid; idx < p.bo * (kNT / 4); idx += kThreads) {
    const int r = idx / (kNT / 4), c4 = idx - r * (kNT / 4);
    *reinterpret_cast<float4*>(dst + (long long)r * p.c_out_pad + 4 * c4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_pieces = (p.bm + kRows - 1) / kRows;  // 128-slot pieces a tile
  const int n_cs = (p.c_in + KC - 1) / KC;          // Cin steps
  const int n_v = (t_hi - t_lo) * n_pieces;
  const int win = max(1, kMaxItems / n_cs);         // pieces per window

  // this thread's row of the ring: row tid / 2, half of its chunks
  const int my_row = tid >> 1;
  int cur_src = 0, cur_loc = -1, pf_src = 0, pf_loc = -1;
  float acc[8][2][4];
  int n_frag = 0, c_slot = 0;

  for (int v0 = 0; v0 < n_v; v0 += win) {
    const int v1 = min(n_v, v0 + win);
    const int n_cand = (v1 - v0) * n_cs;
    // --- the live items of this window, in (piece, Cin step) order
    int n_items = 0;
    for (int base = 0; base < n_cand; base += kThreads) {
      const int idx = base + tid;
      bool live = false;
      uint32_t item = 0;
      if (idx < n_cand) {
        const int vo = idx / n_cs, cs = idx - vo * n_cs;
        const int tile = t_lo + (v0 + vo) / n_pieces;
        if (p.tile_nz[tile] != 0) {
          const int kb = min(cs * KC / p.bk, p.n_kb - 1);
          live = p.tile_bk_nz[(long long)tile * p.n_kb + kb] != 0;
        }
        if (live)
          item = (uint32_t)cs | ((uint32_t)vo << 10) |
                 ((uint32_t)p.tile_tap[tile] << 20);
      }
      n_items += tf32x3::append_live<kThreads>(live, item, s_list, n_items,
                                               s_warp);
    }
    {  // flag the first and last item of each piece
      uint32_t flags[kMaxItems / kThreads];
#pragma unroll
      for (int j = 0; j < kMaxItems / kThreads; ++j) {
        const int i = tid + j * kThreads;
        flags[j] = 0;
        if (i < n_items) {
          const uint32_t vo = (s_list[i] >> 10) & 1023u;
          if (i == 0 || ((s_list[i - 1] >> 10) & 1023u) != vo)
            flags[j] |= kFirst;
          if (i == n_items - 1 || ((s_list[i + 1] >> 10) & 1023u) != vo)
            flags[j] |= kLast;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxItems / kThreads; ++j) {
        const int i = tid + j * kThreads;
        if (i < n_items) s_list[i] |= flags[j];
      }
      __syncthreads();
    }

    // gather / scatter index of this thread's row of the piece of `item`
    auto prefetch = [&](uint32_t item) {
      const int v = v0 + (int)((item >> 10) & 1023u);
      const int tile = t_lo + v / n_pieces;
      const int r = (v % n_pieces) * kRows + my_row;
      pf_loc = -1;
      if (r < p.bm) {
        const long long slot = (long long)tile * p.bm + r;
        const int loc = p.scatter[slot] - ob * p.bo;
        if (loc >= 0 && loc < p.bo) {
          pf_loc = loc;
          pf_src = p.gather[slot];
        }
      }
    };
    int p_tile = 0, c_tile = 0;  // pieces opened by the loads, the products
    auto issue = [&](int q) {
      const uint32_t item = s_list[q];
      const int st = q % kStages;
      if (item & kFirst) {
        cur_src = pf_src;
        cur_loc = pf_loc;
        if ((tid & 1) == 0)
          s_loc[(p_tile % kStages) * kRows + my_row] = cur_loc;
        ++p_tile;
      }
      const int c0 = (int)(item & 1023u) * KC;
      const int tap = (int)((item >> 20) & 1023u);
      if (cur_loc >= 0) {  // rows of padding slots are never loaded
        float* a_dst = s_a + st * R::kStageA + my_row * R::kLda;
        const float* src = p.feats + (long long)cur_src * p.c_in;
#pragma unroll
        for (int q2 = 0; q2 < KC / 8; ++q2) {
          const int kk = ((tid & 1) * (KC / 8) + q2) * 4, c = c0 + kk;
          if (p.a_vec) {
            const bool ok = c < p.c_in;
            cp_async16(a_dst + kk, ok ? src + c : p.feats, ok ? 16 : 0);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ok = c + e < p.c_in;
              cp_async4(a_dst + kk + e, ok ? src + c + e : p.feats,
                        ok ? 4 : 0);
            }
          }
        }
      }
      const float* wt =
          p.w + (long long)tap * p.c_in * p.c_out_pad + col0;
      float* b_dst = s_b + st * R::kStageB;
#pragma unroll
      for (int q2 = 0; q2 < KC / 8; ++q2) {
        const int idx = tid + q2 * kThreads, kk = idx >> 5,
                  c4 = (idx & 31) * 4;
        const bool ok = c0 + kk < p.c_in;
        cp_async16(b_dst + kk * kLdb + c4,
                   ok ? wt + (long long)(c0 + kk) * p.c_out_pad + c4 : p.w,
                   ok ? 16 : 0);
      }
      if (q + 1 < n_items && (s_list[q + 1] & kFirst))
        prefetch(s_list[q + 1]);
    };

    if (n_items > 0) prefetch(s_list[0]);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_items) issue(s);
      tf32x3::cp_async_commit();
    }
    for (int i = 0; i < n_items; ++i) {
      // item i has landed for every thread, and every warp is done with the
      // stage (and the piece's s_loc slot) that the next loads overwrite
      tf32x3::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (i + kStages - 1 < n_items) issue(i + kStages - 1);
      tf32x3::cp_async_commit();

      const uint32_t item = s_list[i];
      if (item & kFirst) {
        c_slot = (c_tile % kStages) * kRows;
        ++c_tile;
        // rows up to the last valid slot, in 16-row fragments
        int last = 0;
#pragma unroll
        for (int q = 0; q < kRows / 32; ++q)
          if (s_loc[c_slot + lane * (kRows / 32) + q] >= 0)
            last = lane * (kRows / 32) + q + 1;
        n_frag = (__reduce_max_sync(0xffffffffu, last) + 15) >> 4;
#pragma unroll
        for (int mi = 0; mi < 8; ++mi)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
      }
      const float* a = s_a + (i % kStages) * R::kStageA;
      const float* b = s_b + (i % kStages) * R::kStageB + warp * 16;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 8) {
        uint32_t bh[2][2], bl[2][2];
        tf32x3::load_b(b, kLdb, ks, 0, lane, bh[0], bl[0]);
        tf32x3::load_b(b, kLdb, ks, 8, lane, bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < 8; ++mi) {
          if (mi < n_frag) {
            uint32_t ah[4], al[4];
            tf32x3::load_a(a, R::kLda, mi * 16, ks, lane, ah, al);
            tf32x3::mma3(acc[mi][0], ah, al, bh[0], bl[0]);
            tf32x3::mma3(acc[mi][1], ah, al, bh[1], bl[1]);
          }
        }
      }
      if (item & kLast) {
        // add each valid slot's row into its row of the block; within a
        // piece every valid slot targets a distinct row, and the
        // __syncthreads() of every item orders one piece's adds before the
        // next piece's
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int mi = 0; mi < 8; ++mi) {
          if (mi >= n_frag) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int loc = s_loc[c_slot + mi * 16 + g + 8 * h];
            if (loc < 0) continue;
            float* o = dst + (long long)loc * p.c_out_pad + warp * 16 + 2 * t;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float2* q = reinterpret_cast<float2*>(o + j * 8);
              float2 v = *q;
              v.x += acc[mi][j][2 * h];
              v.y += acc[mi][j][2 * h + 1];
              *q = v;
            }
          }
        }
      }
    }
    // drained: the next window rewrites the list, the ring and s_loc
    tf32x3::cp_async_wait<0>();
    __syncthreads();
  }
  if (direct && p.epilogue) {
    __syncthreads();  // every add (or the zeroing) of the block is stored
    for (int r = warp; r < p.bo; r += kThreads / 32) {
      const float* x = dst + (long long)r * p.c_out_pad + lane * 4;
      finish_row(p, *reinterpret_cast<const float4*>(x),
                 ob * p.bo + r, col0 + lane * 4, slab);
    }
  }
}

// The rows of the blocks that several CTAs shared: out = their partials
// summed in CTA order, then the epilogue. One warp per row, 32 rows of one
// slab per CTA; rows of blocks that one CTA finished are skipped.
__global__ void __launch_bounds__(kThreads)
    spconv_split_reduce_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = blockIdx.y, col = slab * kNT + lane * 4;
  const int r_end = min((int)blockIdx.x * 32 + 32, p.n_out_pad);
  for (int row = blockIdx.x * 32 + warp; row < r_end; row += kThreads / 32) {
    const int b = row / p.bo;
    const int first = p.blk[2 * b], n = p.blk[2 * b + 1];
    if (n == 1) continue;
    const float* x =
        p.ws + ((long long)first * p.bo + row - b * p.bo) * p.c_out_pad + col;
    const long long plane = (long long)p.bo * p.c_out_pad;
    float4 v = *reinterpret_cast<const float4*>(x);
    for (int s = 1; s < n; ++s) {
      const float4 u = *reinterpret_cast<const float4*>(x + s * plane);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    finish_row(p, v, row, col, slab);
  }
}

// Inclusive sum of v over the 1024 threads of a CTA; *total gets the sum of
// all. s_w holds 32 ints of shared memory. Three __syncthreads().
__device__ __forceinline__ int cta_scan(int v, int* s_w, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_w[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = s_w[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    s_w[lane] = w;
  }
  __syncthreads();
  const int res = v + (warp > 0 ? s_w[warp - 1] : 0);
  *total = s_w[31];
  __syncthreads();
  return res;
}

// First index i in [0, n) with a[i] > x (n if none); a is nondecreasing.
__device__ __forceinline__ int upper_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

constexpr int kPlanThreads = 1024;

// The work plan of one fused launch, in one CTA: which output block each
// of the n_ctas CTAs serves and which tiles of the block's run it walks.
// The math is split_plan_ref's (kernels/spconv_gemm/kernel.py):
//  * run[b] = first tile of block b (tile_ob is monotone); csum[t] = live
//    tiles (tile_nz != 0) before tile t; nlive[b] = the block's live tiles.
//  * When fewer than busy_min blocks hold a live tile and there are spare
//    CTAs (n_ctas > n_blocks), block b gets min(max_splits,
//    max(1, ceil(nlive[b] / q))) CTAs with q = ceil(L / spare) live tiles a
//    CTA (L = all live tiles); else one CTA each. Blocks take consecutive
//    CTAs in block order; CTAs left over get block -1.
//  * CTA j of the n of block b takes the block's live tiles of rank
//    [nlive * j / n, nlive * (j + 1) / n), as the tile range from the first
//    of them to just past the last (empty: an empty range).
// scratch holds (n_tiles + 1) + (n_blocks + 1) + n_blocks ints.
__global__ void __launch_bounds__(kPlanThreads) spconv_split_plan_kernel(
    const int* __restrict__ tile_ob, const int* __restrict__ tile_nz,
    int n_tiles, int n_blocks, int n_ctas, int max_splits, int busy_min,
    int* __restrict__ scratch, int* __restrict__ work,
    int* __restrict__ blk) {
  __shared__ int s_w[32];
  __shared__ int s_busy;
  const int tid = threadIdx.x;
  int* csum = scratch;               // n_tiles + 1
  int* run = csum + n_tiles + 1;     // n_blocks + 1
  int* end = run + n_blocks + 1;     // n_blocks: inclusive CTA prefix
  if (tid == 0) {
    csum[0] = 0;
    s_busy = 0;
  }
  int carry = 0, total;
  for (int base = 0; base < n_tiles; base += kPlanThreads) {
    const int t = base + tid;
    const int inc = cta_scan(t < n_tiles && tile_nz[t] != 0, s_w, &total);
    if (t < n_tiles) csum[t + 1] = carry + inc;
    carry += total;
  }
  for (int b = tid; b <= n_blocks; b += kPlanThreads) {
    int lo = 0, hi = n_tiles;  // first tile with tile_ob >= b
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tile_ob[mid] < b) lo = mid + 1; else hi = mid;
    }
    run[b] = lo;
  }
  __syncthreads();
  int busy = 0;
  for (int b = tid; b < n_blocks; b += kPlanThreads)
    busy += csum[run[b + 1]] > csum[run[b]];
  if (busy) atomicAdd(&s_busy, busy);
  __syncthreads();
  const int spare = n_ctas - n_blocks;
  const int n_live = csum[n_tiles];
  const bool split = spare > 0 && s_busy < busy_min;
  const int q = split ? max(1, (n_live + spare - 1) / spare) : 1;
  carry = 0;
  for (int base = 0; base < n_blocks; base += kPlanThreads) {
    const int b = base + tid;
    int n = 0;
    if (b < n_blocks) {
      const int nl = csum[run[b + 1]] - csum[run[b]];
      n = split ? min(max_splits, max(1, (nl + q - 1) / q)) : 1;
    }
    const int inc = cta_scan(n, s_w, &total);
    if (b < n_blocks) {
      end[b] = carry + inc;
      blk[2 * b] = carry + inc - n;
      blk[2 * b + 1] = n;
    }
    carry += total;
  }
  __syncthreads();
  for (int c = tid; c < n_ctas; c += kPlanThreads) {
    const int b = upper_bound(end, n_blocks, c);
    int4 wk = make_int4(-1, 0, 0, 0);
    if (b < n_blocks) {
      const int first = blk[2 * b], n = blk[2 * b + 1], j = c - first;
      const int lb = csum[run[b]], nl = csum[run[b + 1]] - lb;
      const int r0 = lb + (int)((long long)nl * j / n);
      const int r1 = lb + (int)((long long)nl * (j + 1) / n);
      // tile of live rank r: the first t with csum[t + 1] > r
      const int t0 = upper_bound(csum + 1, n_tiles, r0);
      const int t1 = r1 > r0 ? upper_bound(csum + 1, n_tiles, r1 - 1) + 1
                             : t0;
      wk = make_int4(b, t0, t1, n);
    }
    reinterpret_cast<int4*>(work)[c] = wk;
  }
}

template <int KC>
int launch_fused(const Params& p, int n_ctas, cudaStream_t stream) {
  const size_t smem = Ring<KC>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      spconv_gemm_fused_kernel<KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_ctas, p.c_out_pad / kNT);
  spconv_gemm_fused_kernel<KC><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The work plan of one fused launch (spconv_split_plan_kernel): work
// (n_ctas, 4) and blk (n_blocks, 2) int32; scratch as the kernel says.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int spconv_split_plan_launch(const void* tile_ob,
                                        const void* tile_nz, int n_tiles,
                                        int n_blocks, int n_ctas,
                                        int max_splits, int busy_min,
                                        void* scratch, void* work, void* blk,
                                        void* stream) {
  if (n_blocks > 0 && n_ctas > 0)
    spconv_split_plan_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(
        (const int*)tile_ob, (const int*)tile_nz, n_tiles, n_blocks, n_ctas,
        max_splits, busy_min, (int*)scratch, (int*)work, (int*)blk);
  return (int)cudaGetLastError();
}

// out (n_blocks*bo, c_out_pad) f32 = the gather-GEMM-scatter of one layer;
// with epilogue != 0 also relu(out*scale+shift) under valid, and nz
// (n_blocks*bo, c_out_pad/128) int32. work (n_ctas, 4) and blk
// (n_blocks, 2) are the plan of spconv_split_plan_launch; with ws non-null,
// a (n_ctas, bo, c_out_pad) f32 workspace, a second kernel sums the
// partials of the blocks that several CTAs shared. Every pointer is a
// device pointer (nz, scale, shift and valid may be null when
// epilogue == 0). c_out_pad must be a multiple of 128; bk a multiple of 32
// unless n_kb == 1; w 16-byte aligned; the taps and ceil(c_in / 32) at
// most 1024. Returns the CUDA error code of the launches (0 on success).
extern "C" int spconv_gemm_fused_launch(
    const void* feats, int c_in, const void* w, int c_out_pad,
    const void* gather, const void* scatter, int bm, const void* tile_tap,
    const void* tile_nz, const void* tile_bk_nz, int n_kb, int bk,
    const void* work, const void* blk, int n_ctas, int n_blocks, int bo,
    const void* scale, const void* shift, const void* valid, void* out,
    void* ws, void* nz, int epilogue, void* stream) {
  if (n_blocks <= 0 || c_out_pad <= 0) return (int)cudaGetLastError();
  Params p;
  p.feats = (const float*)feats;
  p.w = (const float*)w;
  p.gather = (const int*)gather;
  p.scatter = (const int*)scatter;
  p.tile_tap = (const int*)tile_tap;
  p.tile_nz = (const int*)tile_nz;
  p.tile_bk_nz = (const int*)tile_bk_nz;
  p.work = (const int*)work;
  p.blk = (const int*)blk;
  p.scale = (const float*)scale;
  p.shift = (const float*)shift;
  p.valid = (const int*)valid;
  p.out = (float*)out;
  p.ws = (float*)ws;
  p.nz = (int*)nz;
  p.c_in = c_in;
  p.c_out_pad = c_out_pad;
  p.bm = bm;
  p.n_kb = n_kb;
  p.bk = bk;
  p.bo = bo;
  p.n_out_pad = n_blocks * bo;
  p.epilogue = epilogue;
  p.a_vec = c_in % 4 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = c_in < 32 ? launch_fused<8>(p, n_ctas, s)
                           : launch_fused<32>(p, n_ctas, s);
  if (rc != 0 || ws == nullptr) return rc;
  const dim3 grid((p.n_out_pad + 31) / 32, c_out_pad / kNT);
  spconv_split_reduce_kernel<<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the fused kernel at Cin step kc (8 or 32), in
// bytes: the ring, the pieces' row targets and the work list.
extern "C" int spconv_gemm_fused_smem(int kc) {
  return kc == 8 ? (int)Ring<8>::kSmem : (int)Ring<32>::kSmem;
}
