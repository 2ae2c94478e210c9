// Block decode helpers shared by the segment kernels
// (segment_intersect.cu, scored_intersect.cu): the gap-plane read of one
// lane, the CTA-wide inclusive scan that turns gaps into docids, the
// CTA-wide minimum, and the search of a row's block firsts for the one
// block that can hold a docid.  One CTA is 128 threads, one per lane.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t gap_of(const int64_t* __restrict__ pay,
                                           int64_t pw, int32_t woff,
                                           int32_t bw, int lane) {
  int64_t word;
  int shift;
  uint32_t mask;
  if (bw == 1) {
    word = lane >> 2; shift = 8 * (lane & 3); mask = 0xFFu;
  } else if (bw == 2) {
    word = lane >> 1; shift = 16 * (lane & 1); mask = 0xFFFFu;
  } else {
    word = lane; shift = 0; mask = 0xFFFFFFFFu;
  }
  const int64_t idx = (int64_t)woff + word;
  if (idx < 0 || idx >= pw) return 0u;
  return (uint32_t)(((uint64_t)pay[idx]) >> shift) & mask;
}

// Inclusive scan of one value per thread over the 128-thread CTA.
__device__ __forceinline__ uint32_t block_scan(uint32_t v,
                                               uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  uint32_t add = 0;
  for (int w = 0; w < warp; ++w) add += warp_sums[w];
  __syncthreads();
  return v + add;
}

__device__ __forceinline__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = min(min(red[0], red[1]), min(red[2], red[3]));
  __syncthreads();
  return v;
}

// The one block of an ascending row that can hold `x`: the last block
// whose first docid is <= x, capped at the last block with a real lane
// (the row holds `nbv` real docids in `nbb` blocks).  -1 when none can.
__device__ __forceinline__ int find_block(const int64_t* __restrict__ bf,
                                          int64_t nbb, int64_t nbv,
                                          uint32_t x) {
  if (nbv <= 0 || nbb <= 0) return -1;
  int64_t lo = 0, hi = nbb;  // first block whose first docid > x
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((uint32_t)bf[mid] <= x) lo = mid + 1; else hi = mid;
  }
  int64_t jj = lo - 1;
  const int64_t jmax = (nbv - 1) / kSeg;
  if (jj > jmax) jj = jmax;
  return (int)jj;
}

}  // namespace
