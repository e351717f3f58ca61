// Fixed-order segment sum, for Hopper, sm_90a.
//
// Replaces: the reference's scatter-add `.at[flat].add` at
//   src/repro/models/second.py:116 (SECOND's BEV grid), and the other
//   float scatters that src/repro_torch/core/segment.py serves: the
//   `.at[].add` of the materialized backend's scatter and the `lax.scan`
//   of per-tap scatters of the input-stationary Gconv3. The reference
//   adds each destination row's sources in ascending source order; XLA's
//   scatter on the TPU does so in one op. There was no Pallas kernel: the
//   port needs one because `index_add` on the card adds a row's sources in
//   no fixed order, and the plain version (one launch a column of a
//   count-sorted layout) lets the host pace a row of thousands of sources.
//
// What it computes: for every row r and channel c, acc = 0.0f, then
//   acc += vals[src[i], c] for i from starts[r] to starts[r + 1] - 1, in
//   that order, then out[r, c] = acc. Each add is `__fadd_rn`, so nothing
//   contracts or reorders, and the result is bit-equal to the plain
//   version's float32 `add_` loop. An empty row is written as zero.
//
// What bounds it on the H100: bytes: the kept rows of vals read once, out
// written once and the index (src, starts) read once, at 3.35 TB/s: at
// SECOND-large's `to_bev` 47,497 rows of 128 float32 read and the 65,536
// x 128 BEV grid written, about 0.02 ms. And the widest row's chain of
// dependent adds: `to_bev` piles 14,532 clipped voxels onto one corner
// cell, whose 128 channels (one warp, 32 float4) each take 14,532 adds in
// order. The adds are cheap; the chain is paced by its loads' round trips
// and by that one warp's instructions, about a dozen a source.
//
// Design:
//  * No split of a row across threads and no atomics: a row belongs to one
//    group of threads, one thread a float4 of channels (a float where the
//    channels are not a multiple of 4 or a pointer is not 16-byte
//    aligned); threads of a group take vectors group-width apart when the
//    row is wider than the group. A group is the smallest power of two at
//    least as wide as the row, at most a CTA; a CTA holds several groups
//    when rows are narrow, and the groups stride over the rows.
//  * Software-pipelined batches: while a thread adds one batch of its
//    row's sources (32 floats: 8 float4 or 32 float) in order, the next
//    batch's values are loading into registers from L2, where a prefetch
//    issued one batch earlier put them, and the indices of the batch after
//    that are loading too. So a chain waits for about one L2 round trip a
//    batch, not one device-memory round trip a source. The pipeline is
//    written out (values loaded in one iteration are added in the next):
//    left to itself, the compiler interleaves each load with the adds
//    that use it, and the chain waits several round trips a batch.
//  * Once the loads wait no longer, a long row is paced by its one warp's
//    instructions, so the batches that lie wholly inside the row take a
//    fast step: two batches an iteration in two register buffers that
//    swap roles (no copies), no bound checks and no selects. The last few
//    batches take the general step, which has no branch either: a slot
//    past the row's end re-reads the row's last source and adds +0.0 in
//    its place (a select). Adding +0.0 changes no sum: x + 0.0 == x for
//    every x but -0.0, and the sum never holds -0.0, since it starts at
//    +0.0 and a rounded-to-nearest sum is -0.0 only when both terms are.
//  * The output is stored with an evict-first hint, so that a large grid
//    written at once (the BEV grid is 33.5 MB) does not push the sources
//    out of L2.
//  * Threads of a group read one source row together: neighbouring
//    channels, neighbouring addresses. No shared memory and no barrier:
//    the groups of a CTA are independent, so one wide row holds back only
//    its own group.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

// Bring the 128 bytes at p into L2 without waiting for them.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float vkeep(float v, bool keep) {
  return keep ? v : 0.0f;
}

__device__ __forceinline__ float4 vkeep(float4 v, bool keep) {
  return make_float4(keep ? v.x : 0.0f, keep ? v.y : 0.0f,
                     keep ? v.z : 0.0f, keep ? v.w : 0.0f);
}

template <typename T>
__device__ __forceinline__ T vzero();

template <>
__device__ __forceinline__ float vzero<float>() {
  return 0.0f;
}

template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One batch of a row's inside, with no bound check: load the next batch's
// values (indices n1) into `load`, prefetch the batch after it (n2) into
// L2, move the indices one batch on (the newest from `src_next`), and add
// this batch's values `add` in order.
template <typename T, int kBatch>
__device__ __forceinline__ void fast_step(const T* __restrict__ vals,
                                          const long long* src_next, int cv,
                                          int q, T (&add)[kBatch],
                                          T (&load)[kBatch],
                                          int (&n1)[kBatch],
                                          int (&n2)[kBatch], T& acc) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    load[j] = __ldg(vals + (unsigned)(n1[j] * cv + q));
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    prefetch_l2(vals + (unsigned)(n2[j] * cv + q));
    n1[j] = n2[j];
    n2[j] = (int)__ldg(src_next + j);
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) acc = vadd(acc, add[j]);
}

// T: float4 or float; cv: vectors of T a row (c / 4 or c)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ vals,
                       const long long* __restrict__ src,
                       const long long* __restrict__ starts,
                       T* __restrict__ out, long long n_rows, int cv,
                       int group_log2) {
  constexpr int kBatch = 32 * sizeof(float) / sizeof(T);
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const long long slots = kThreads >> group_log2;
  const long long stride = (long long)gridDim.x * slots;
  for (long long r = blockIdx.x * slots + (threadIdx.x >> group_log2);
       r < n_rows; r += stride) {
    const long long beg = starts[r], end = starts[r + 1];
    for (int q = lane; q < cv; q += group) {
      T acc = vzero<T>();
      if (beg < end) {
        const long long last = end - 1;
        // v: this batch's values; n1, n2: the next two batches' indices
        T v[kBatch];
        int n1[kBatch], n2[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          n1[j] = (int)__ldg(src + min(beg + j, last));
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          v[j] = __ldg(vals + (unsigned)(n1[j] * cv + q));
        if (beg + kBatch < end) {
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            n1[j] = (int)__ldg(src + min(beg + kBatch + j, last));
            n2[j] = (int)__ldg(src + min(beg + 2 * kBatch + j, last));
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
            prefetch_l2(vals + (unsigned)(n1[j] * cv + q));
        }
        T w[kBatch];
        long long i = beg;
        // the fast step reads indices up to i + 5 * kBatch - 1
        for (; i + 5 * kBatch <= end; i += 2 * kBatch) {
          fast_step(vals, src + i + 3 * kBatch, cv, q, v, w, n1, n2, acc);
          fast_step(vals, src + i + 4 * kBatch, cv, q, w, v, n1, n2, acc);
        }
        for (; i < end; i += kBatch) {
          const bool more = i + kBatch < end;
          if (more) {
#pragma unroll
            for (int j = 0; j < kBatch; ++j)
              w[j] = __ldg(vals + (unsigned)(n1[j] * cv + q));
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
              prefetch_l2(vals + (unsigned)(n2[j] * cv + q));
              n1[j] = n2[j];
              n2[j] = (int)__ldg(src + min(i + 3 * kBatch + j, last));
            }
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
            acc = vadd(acc, vkeep(v[j], i + j < end));
          if (more) {
#pragma unroll
            for (int j = 0; j < kBatch; ++j) v[j] = w[j];
          }
        }
      }
      __stcs(out + r * cv + q, acc);
    }
  }
}

template <typename T>
void launch(const void* vals, const void* src, const void* starts, void* out,
            long long n_rows, int cv, cudaStream_t stream) {
  int group_log2 = 0;
  while ((1 << group_log2) < cv && (1 << group_log2) < kThreads)
    ++group_log2;
  const long long slots = kThreads >> group_log2;
  const long long blocks = (n_rows + slots - 1) / slots;
  const unsigned grid =
      (unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20));
  segment_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const long long*>(src),
      static_cast<const long long*>(starts), static_cast<T*>(out), n_rows,
      cv, group_log2);
}

}  // namespace

// vals (n, c) float32; src (n,) int64, the sources sorted stably by their
// destination row (row r's are src[starts[r]] .. src[starts[r + 1] - 1],
// ascending; only the first starts[n_rows] are read); starts (n_rows + 1,)
// int64; out (n_rows, c) float32. vals holds fewer than 2^31 floats, so a
// source's offset into it is a 32-bit int.
// Returns the CUDA error of the launch (0 when there is nothing to do).
extern "C" int segment_sum_launch(const void* vals, const void* src,
                                  const void* starts, void* out,
                                  long long n_rows, int c, void* stream) {
  if (n_rows <= 0 || c <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool vec = c % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(vals) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (vec)
    launch<float4>(vals, src, starts, out, n_rows, c / 4, st);
  else
    launch<float>(vals, src, starts, out, n_rows, c, st);
  return (int)cudaGetLastError();
}
