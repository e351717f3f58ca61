// OCTENT map-search query (paper Fig. 5(c) lines 7-13) for Hopper, sm_90a.
//
// Replaces: the Pallas TPU kernel `octent_query` in
//   src/repro/kernels/octent/kernel.py (body `_octent_kernel`, `_lower_bound`).
//
// What bounds it on the H100: bytes. Per (voxel, offset) query the kernel
// does integer shifts and masks plus two binary searches; the work that must
// cross device memory is the coordinate stream in, the search tables read
// once, and the (N, K) int32 kmap out (27 * 4 B per voxel). The tables
// (sorted block directory `ublocks`, compacted banked table `tkey`/`tval`)
// are a few hundred KB at serving sizes, so after the first probes they stay
// resident in the 50 MB L2 and the binary-search probes are L2/L1 hits.
//
// Design: one thread per (voxel, offset), laid out so that consecutive
// threads write consecutive kmap entries (row-major (N, K)), so the only
// large stream, the kmap, is written fully coalesced. The K offsets sit in
// shared memory. The Morton ladder is the reference's, on signed int, so the
// result is bit-identical to the plain version (octent/ref.py). The TPU's
// fixed-step searches exist only because its grid has no data-dependent trip
// counts; here a plain lower bound over the live prefix gives the same
// positions. The batch tag is shifted as unsigned so that an overflow wraps
// as the reference's int32 arithmetic does.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockBits = 4;
constexpr int kBlockSize = 1 << kBlockBits;
constexpr int kTableSize = 4096;
constexpr int kBankRows = 512;
constexpr int kThreads = 256;

__device__ __forceinline__ int part1by2(int v, int bits) {
  v &= (1 << bits) - 1;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ int interleave(int x, int y, int z, int bits) {
  return part1by2(x, bits) | (part1by2(y, bits) << 1) |
         (part1by2(z, bits) << 2);
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

__global__ void __launch_bounds__(kThreads) octent_query_kernel(
    const int* __restrict__ coords, const int* __restrict__ batch,
    const unsigned char* __restrict__ valid, int n,
    const int* __restrict__ offsets, int k,
    const int* __restrict__ ublocks, int max_blocks,
    const int* __restrict__ n_blocks_ptr,
    const int* __restrict__ tkey, const int* __restrict__ tval, int n_t,
    int grid_bits, int* __restrict__ out) {
  extern __shared__ int s_off[];          // (k, 3)
  for (int i = threadIdx.x; i < 3 * k; i += blockDim.x) s_off[i] = offsets[i];
  __syncthreads();

  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n * k) return;
  const int i = (int)(gid / k);
  const int t = (int)(gid - (long long)i * k);

  int result = -1;
  if (valid[i]) {
    const int x = coords[3 * i + 0] + s_off[3 * t + 0];
    const int y = coords[3 * i + 1] + s_off[3 * t + 1];
    const int z = coords[3 * i + 2] + s_off[3 * t + 2];
    const int limit = (1 << grid_bits) * kBlockSize;
    // an out-of-grid query misses whatever it would hit after clipping
    if (x >= 0 && x < limit && y >= 0 && y < limit && z >= 0 && z < limit) {
      const int bkey =
          interleave(x >> kBlockBits, y >> kBlockBits, z >> kBlockBits,
                     grid_bits) |
          (int)((unsigned)batch[i] << (3 * grid_bits));
      const int phi = interleave(x & (kBlockSize - 1), y & (kBlockSize - 1),
                                 z & (kBlockSize - 1), kBlockBits);
      const int nb = min(*n_blocks_ptr, max_blocks);
      // stage 1: block key -> rank in the sorted directory
      const int rank = lower_bound(ublocks, nb, bkey);
      if (rank < nb && __ldg(ublocks + rank) == bkey) {
        // stage 2: (rank, bank, row) -> voxel in the compacted banked table
        const int key2 = rank * kTableSize + (phi & 7) * kBankRows + (phi >> 3);
        int pos = lower_bound(tkey, n_t, key2);
        if (pos > n_t - 1) pos = n_t - 1;
        if (__ldg(tkey + pos) == key2) result = __ldg(tval + pos);
      }
    }
  }
  out[gid] = result;
}

}  // namespace

// Resolve all k offset queries of n voxels into out (n, k) int32, -1 = miss.
// Every pointer is a device pointer; n_blocks_ptr points at one int32 (the
// true occupied-block count, clamped to max_blocks here). Returns the CUDA
// error code of the launch (0 on success).
extern "C" int octent_query_launch(
    const void* coords, const void* batch, const void* valid, int n,
    const void* offsets, int k, const void* ublocks, int max_blocks,
    const void* n_blocks_ptr, const void* tkey, const void* tval, int n_t,
    int grid_bits, void* out, void* stream) {
  const long long total = (long long)n * k;
  if (total > 0) {
    const int grid = (int)((total + kThreads - 1) / kThreads);
    octent_query_kernel<<<grid, kThreads, 3 * k * sizeof(int),
                          (cudaStream_t)stream>>>(
        (const int*)coords, (const int*)batch, (const unsigned char*)valid, n,
        (const int*)offsets, k, (const int*)ublocks, max_blocks,
        (const int*)n_blocks_ptr, (const int*)tkey, (const int*)tval, n_t,
        grid_bits, (int*)out);
  }
  return (int)cudaGetLastError();
}
