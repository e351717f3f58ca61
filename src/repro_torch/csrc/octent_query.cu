// OCTENT map-search query (paper Fig. 5(c) lines 7-13) for Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `octent_query` in
//   src/repro/kernels/octent/kernel.py (body `_octent_kernel`, `_lower_bound`).
//
// What bounds it on the H100: the bytes that must cross device memory are
// the coordinate stream in, the search tables read once, and the (N, K)
// int32 kmap out (27 * 4 B per row), most of the bytes at serving sizes.
// What held the first form back was the work per query: one thread per
// (voxel, offset) ran a lower bound over the directory `ublocks` (12 probes
// at 2,902 blocks), then one over the whole compacted table `tkey` (17
// probes at 65,536 entries), after a 64-bit division for its (row, offset).
//
// Design: the banked table of the paper (Fig. 6(a)) keeps a block's voxels
// contiguous in `tkey` (key = rank*4096 + bank*512 + row), and a 3x3x3
// neighbourhood reaches only the 27 blocks around a voxel's own. So the
// searches that every query repeated are done once per block, by an index
// pass, and a query keeps only a search inside one block's segment.
//  * `octent_index_kernel` (one pass over the table and the blocks) writes
//    seg[r] = lower_bound(tkey, r*4096) for every rank r <= nb =
//    min(n_blocks, max_blocks), each table row's rank (rowrank), and for
//    every block the ranks of its 26 neighbours (nbr, -1 where no block
//    is), each found once by a lower bound over `ublocks` whose first
//    levels run in shared memory (512 pivots).
//  * `octent_query_kernel`, one thread per (voxel, offset) as before, so
//    the kmap is written coalesced, and invalid rows and out-of-grid
//    queries are answered before the index is ready: a query's block is
//    the voxel's own or one of its 26 neighbours, whose rank is one load;
//    then a lower bound over that block's segment only (about 13 entries
//    at res 0, at most 4,096).
//  * Queries that leave the 3x3x3 block neighbourhood (offsets other than
//    Subm3's), voxels whose own block lies outside the grid, and every
//    query of a scene with more blocks than `max_blocks` (its overflowed
//    voxels are not in the table) run the directory search per query.
//  * The query kernel is the index pass's programmatic dependent: its
//    prologue (loads, the Morton ladder) overlaps the index pass, and
//    `griddepcontrol.wait` guards the first read of the index. It is
//    instantiated for Subm3's 27 offsets, so that a thread finds its (row,
//    offset) with a multiply and a shift, and for any count.
//  * Row-list mode (a streaming frame's dirty rows): the table and the
//    coordinate arrays stay the table's own N rows, and a -1-padded list
//    `rows` (Q,) names the rows to search. The thread of (q, offset) takes
//    row rows[q], reads that row's rank on the near path and writes
//    out[rows[q] * K + offset] into a copy of the previous kmap, so the
//    scatter is part of the query; a -1 entry writes nothing. The index
//    pass still reads the whole table and its scratch is sized by N.
// A first redesign staged each CTA's neighbour segments in shared memory
// (runs of 128 table rows, a shared-memory hash of neighbour blocks); it
// was slower than the first form at every resolution but res 0: its
// phases ran one after another behind barriers and each warp walked its
// voxels in turn (PERF.md §6).
// The Morton ladder is the reference's, on signed int, so the result is bit
// for bit the plain version's (octent/ref.py), the first slot of a run of
// duplicate keys included. The batch tag is shifted as unsigned so that an
// overflow wraps as the reference's int32 arithmetic does.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockBits = 4;
constexpr int kBlockSize = 1 << kBlockBits;
constexpr int kTableBits = 12;
constexpr int kTableSize = 1 << kTableBits;
constexpr int kBankRows = 512;
constexpr int kThreads = 256;
constexpr int kIndexThreads = 256;
constexpr int kIndexBlocks = 528;  // 4 a streaming multiprocessor
constexpr int kPiv = 512;          // directory pivots per index CTA
constexpr int kNear = 27;          // the 3x3x3 blocks around a block
constexpr int kOwn = 13;           // the block itself among them

__device__ __forceinline__ int part1by2(int v, int bits) {
  v &= (1 << bits) - 1;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// the inverse of part1by2: every third bit of v, from bit 0, packed
__device__ __forceinline__ int compact1by2(int v, int bits) {
  v &= 0x09249249;
  v = (v | (v >> 2)) & 0x030C30C3;
  v = (v | (v >> 4)) & 0x0300F00F;
  v = (v | (v >> 8)) & 0x030000FF;
  v = (v | (v >> 16)) & 0x000003FF;
  return v & ((1 << bits) - 1);
}

__device__ __forceinline__ int interleave(int x, int y, int z, int bits) {
  return part1by2(x, bits) | (part1by2(y, bits) << 1) |
         (part1by2(z, bits) << 2);
}

__device__ __forceinline__ int block_key(int bx, int by, int bz, unsigned b,
                                         int grid_bits) {
  return interleave(bx, by, bz, grid_bits) | (int)(b << (3 * grid_bits));
}

// part1by2(v, 4) in two steps: bits 0-3 of v to bits 0, 3, 6 and 9
__device__ __forceinline__ int spread4(int v) {
  v &= kBlockSize - 1;
  v = (v | (v << 4)) & 0x0C3;
  return (v | (v << 2)) & 0x249;
}

// the banked-table address (bank*512 + row) of a coordinate inside its block
__device__ __forceinline__ int local_addr(int x, int y, int z) {
  const int phi = spread4(x) | (spread4(y) << 1) | (spread4(z) << 2);
  return (phi & 7) * kBankRows + (phi >> 3);
}

__device__ __forceinline__ bool in_grid(int x, int y, int z, int limit) {
  return (unsigned)x < (unsigned)limit && (unsigned)y < (unsigned)limit &&
         (unsigned)z < (unsigned)limit;
}

// first position in a[0, n) whose value is not less than key
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the rank of block key in ublocks[0, nb), -1 if it is not there
__device__ __forceinline__ int block_rank(const int* __restrict__ ublocks,
                                          int nb, int key) {
  const int r = lower_bound(ublocks, nb, key);
  return r < nb && __ldg(ublocks + r) == key ? r : -1;
}

// kmap entry of the query at local address `local` of the block of rank r:
// a lower bound over that block's segment of the table, whose keys share
// the rank, so their low 12 bits order it
__device__ __forceinline__ int segment_lookup(const int* __restrict__ tkey,
                                              const int* __restrict__ tval,
                                              const int* seg, int r,
                                              int local) {
  const int end = __ldcg(seg + r + 1);
  int lo = __ldcg(seg + r), hi = end;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((__ldg(tkey + mid) & (kTableSize - 1)) < local) lo = mid + 1;
    else hi = mid;
  }
  return lo < end && (__ldg(tkey + lo) & (kTableSize - 1)) == local
             ? __ldg(tval + lo) : -1;
}

// seg[r] = lower_bound(tkey, r * 4096) for r in [0, nb]: position p writes
// every rank in (rank(p - 1), rank(p)], ranks clamped to nb, with
// rank(n_t) = nb; rowrank[tval[p]] = rank(p) for the live positions; and
// nbr[r * 27 + d] = the rank of the block at offset d (dz * 9 + dy * 3 + dx,
// each in 0..2 for -1..1) from block r, -1 where there is none.
__global__ void __launch_bounds__(kIndexThreads) octent_index_kernel(
    const int* __restrict__ tkey, const int* __restrict__ tval, int n_t,
    const int* __restrict__ ublocks, int max_blocks,
    const int* __restrict__ n_blocks_ptr, int grid_bits,
    int* __restrict__ seg, int* __restrict__ rowrank,
    int* __restrict__ nbr) {
  // the query kernel may start its prologue now
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ int s_piv[kPiv];
  const int nb = min(__ldg(n_blocks_ptr), max_blocks);
  const int stride = max(1, (nb + kPiv - 1) / kPiv);
  const int n_piv = (nb + stride - 1) / stride;
  for (int i = threadIdx.x; i < n_piv; i += kIndexThreads)
    s_piv[i] = __ldg(ublocks + i * stride);
  const int gid = blockIdx.x * kIndexThreads + threadIdx.x;
  const int step = gridDim.x * kIndexThreads;
  for (int p = gid; p <= n_t; p += step) {
    const int rk = p < n_t ? min(__ldg(tkey + p) >> kTableBits, nb) : nb;
    const int prev = p > 0 ? min(__ldg(tkey + p - 1) >> kTableBits, nb) : -1;
    for (int r = prev + 1; r <= rk; ++r) seg[r] = p;
    if (rk < nb) rowrank[__ldg(tval + p)] = rk;
  }
  __syncthreads();
  const int side = 1 << grid_bits;
  for (int e = gid; e < nb * kNear; e += step) {
    const int r = e / kNear, d = e - r * kNear;
    int rank = r;
    if (d != kOwn) {
      const int key = __ldg(ublocks + r);
      const int x = compact1by2(key, grid_bits) + d % 3 - 1;
      const int y = compact1by2(key >> 1, grid_bits) + d / 3 % 3 - 1;
      const int z = compact1by2(key >> 2, grid_bits) + d / 9 - 1;
      rank = -1;
      if (in_grid(x, y, z, side)) {
        const int nkey = block_key(x, y, z, (unsigned)key >> (3 * grid_bits),
                                   grid_bits);
        // the pivots bracket the rank to at most `stride` entries
        int lo = 0, hi = n_piv;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_piv[mid] < nkey) lo = mid + 1; else hi = mid;
        }
        const int i = lo;
        lo = i > 0 ? (i - 1) * stride + 1 : 0;
        hi = i < n_piv ? i * stride : nb;
        const int q = lo + lower_bound(ublocks + lo, hi - lo, nkey);
        if (q < nb && __ldg(ublocks + q) == nkey) rank = q;
      }
    }
    nbr[e] = rank;
  }
}

// K > 0 fixes the offset count at compile time (Subm3's 27), so that the
// thread's (row, offset) comes from a multiply and a shift; K = 0 takes k.
// rows == nullptr searches every row i < n into out[i * k + t]; otherwise
// thread (q, t) searches row rows[q] of the n, for q < n_rows.
template <int K>
__global__ void __launch_bounds__(kThreads) octent_query_kernel(
    const int* __restrict__ coords, const int* __restrict__ batch,
    const unsigned char* __restrict__ valid, int n,
    const int* __restrict__ offsets, int k_any,
    const int* __restrict__ ublocks, int max_blocks,
    const int* __restrict__ n_blocks_ptr,
    const int* __restrict__ tkey, const int* __restrict__ tval,
    const int* seg, const int* rowrank, const int* nbr, int grid_bits,
    const int* __restrict__ rows, int n_rows, int* __restrict__ out) {
  const int k = K > 0 ? K : k_any;
  extern __shared__ int s_off[];          // (k, 3)
  for (int i = threadIdx.x; i < 3 * k; i += kThreads) s_off[i] = offsets[i];
  __syncthreads();

  // n * k and n_rows * k < 2^31 (the wrapper checks both): 32-bit index
  // arithmetic
  const unsigned gid = blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (unsigned)((rows ? n_rows : n) * k)) return;
  const int j = (int)(gid / (unsigned)k);
  const int t = (int)(gid - (unsigned)j * k);
  const int i = rows ? __ldg(rows + j) : j;
  // a -1 pad writes nothing (and a row outside the table is dropped)
  if ((unsigned)i >= (unsigned)n) return;
  const unsigned o = (unsigned)i * k + t;
  const int limit = (1 << grid_bits) * kBlockSize;

  // the prologue, before the index is ready: the query, its banked-table
  // address and which of the 27 blocks around the voxel's own it lies in
  bool pending = false, near = false;
  int qx = 0, qy = 0, qz = 0, local = 0, d = 0;
  unsigned b = 0;
  if (valid[i]) {
    const int x = __ldg(coords + 3 * i), y = __ldg(coords + 3 * i + 1),
              z = __ldg(coords + 3 * i + 2);
    qx = x + s_off[3 * t];
    qy = y + s_off[3 * t + 1];
    qz = z + s_off[3 * t + 2];
    // an out-of-grid query misses whatever it would hit after clipping
    pending = in_grid(qx, qy, qz, limit);
    if (pending) {
      local = local_addr(qx, qy, qz);
      b = (unsigned)__ldg(batch + i);
      const int dx = (qx >> kBlockBits) - (x >> kBlockBits) + 1;
      const int dy = (qy >> kBlockBits) - (y >> kBlockBits) + 1;
      const int dz = (qz >> kBlockBits) - (z >> kBlockBits) + 1;
      near = (unsigned)dx <= 2u && (unsigned)dy <= 2u && (unsigned)dz <= 2u &&
             in_grid(x, y, z, limit);
      d = dz * 9 + dy * 3 + dx;
    }
  }
  // invalid rows and out-of-grid queries are answered without the index
  if (!pending) {
    out[o] = -1;
    return;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the index is written

  const int nb_true = __ldg(n_blocks_ptr);
  const int nb = min(nb_true, max_blocks);
  int r;
  if (near && nb_true <= max_blocks) {
    r = __ldcg(rowrank + i);
    if (d != kOwn) r = __ldcg(nbr + r * kNear + d);
  } else {
    r = block_rank(ublocks, nb,
                   block_key(qx >> kBlockBits, qy >> kBlockBits,
                             qz >> kBlockBits, b, grid_bits));
  }
  out[o] = r >= 0 ? segment_lookup(tkey, tval, seg, r, local) : -1;
}

}  // namespace

// Dynamic shared memory of the query kernel for k offsets.
extern "C" int octent_query_smem(int k) { return (int)(3 * k * sizeof(int)); }

// int32 scratch a launch needs: seg (max_blocks + 1), rowrank (n) and nbr
// (27 * max_blocks).
extern "C" int octent_query_scratch(int n, int max_blocks) {
  return max_blocks + 1 + n + kNear * max_blocks;
}

// Resolve all k offset queries of n voxels into out (n, k) int32, -1 = miss.
// Every pointer is a device pointer; n_blocks_ptr points at one int32 (the
// true occupied-block count, clamped to max_blocks here); scratch holds
// octent_query_scratch(n, max_blocks) int32. With rows != nullptr only the
// rows listed in rows (n_rows int32, -1 padded) are searched, each into its
// own row of out, which keeps every other entry. Launches the index pass,
// then the query kernel as its programmatic dependent. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int octent_query_launch(
    const void* coords, const void* batch, const void* valid, int n,
    const void* offsets, int k, const void* ublocks, int max_blocks,
    const void* n_blocks_ptr, const void* tkey, const void* tval, int n_t,
    int grid_bits, void* scratch, const void* rows, int n_rows, void* out,
    void* stream) {
  const long long total = (long long)(rows ? n_rows : n) * k;
  if (total <= 0) return (int)cudaGetLastError();
  if (total >= (1LL << 31) || (long long)n * k >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* seg = (int*)scratch;
  int* rowrank = seg + max_blocks + 1;
  int* nbr = rowrank + n;
  octent_index_kernel<<<kIndexBlocks, kIndexThreads, 0, s>>>(
      (const int*)tkey, (const int*)tval, n_t, (const int*)ublocks,
      max_blocks, (const int*)n_blocks_ptr, grid_bits, seg, rowrank, nbr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)octent_query_smem(k);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, k == 27 ? octent_query_kernel<27> : octent_query_kernel<0>,
      (const int*)coords, (const int*)batch,
      (const unsigned char*)valid, n, (const int*)offsets, k,
      (const int*)ublocks, max_blocks, (const int*)n_blocks_ptr,
      (const int*)tkey, (const int*)tval, (const int*)seg,
      (const int*)rowrank, (const int*)nbr, grid_bits, (const int*)rows,
      n_rows, (int*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
