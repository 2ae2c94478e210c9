// Fused gap-decode + membership + impact sum over block-compressed scored
// docid lists, with the block-max WAND skip (the exhaustive scored
// conjunction of the lifecycle engine).
//
// Replaces the Pallas TPU kernel `scored_intersect_batched`
// (`_scored_kernel_batched`, one grid step per (query, segment) row) in
// src/repro/kernels/segment_intersect.py.  The TPU kernel walks the two
// lists with two pointers, one decoded block pair at a time, and zeroes an
// a-block at flush time when its bound `a_bmax + rest <= th` — after it
// has already decoded and matched it.  Here the mapping is the one of
// segment_intersect.cu:
//
//   * one CTA of 128 threads per (row, a-block), one thread per lane;
//   * the skip comes FIRST: a pad a-block, or one whose bound
//     `a_bmax + rest[r]` is <= `th[r]`, writes 128 zeros and returns
//     without reading a payload word, a score word or anything of b;
//   * a live a-block is decoded in registers (byte/halfword/word gap
//     load, block-wide scan, plus `firsts`), and its lane's impact is the
//     byte `lane & 3` of score word `lane >> 2`;
//   * each lane binary-searches its row's `b.firsts` for the one b-block
//     that can hold its docid; the CTA visits the distinct b-blocks its
//     lanes need in ascending order, decoding each into shared memory
//     together with its 32 score words, and each lane that needs the
//     block binary-searches it and reads b's impact at the found lane.
//
// A lane's output is `a_imp + b_imp` when its docid is valid, occurs in
// b's real lanes (lanes past `b.ns` are INVALID, as in the oracle
// `scored_intersect_batched_ref`, whose searchsorted finds the first
// occurrence) and `b_imp > 0`; 0 otherwise — the oracle, bit for bit.
//
// Bound on an H100: memory.  A live a-block reads its block entry, 32*bw
// payload words, 32 score words and writes 512 bytes; a skipped block
// reads 16 bytes and writes 512.  b is read only in the blocks some live
// a-lane can match.  Words are int64 holding uint32 values (twice the
// reference's bytes), as in segment_intersect.cu.
#include "segment_decode.cuh"

namespace {

constexpr int kScoreWords = kSeg / 4;

__device__ __forceinline__ int impact_of(uint32_t word, int lane) {
  return (int)((word >> (8 * (lane & 3))) & 0xFFu);
}

__global__ void __launch_bounds__(kSeg) scored_intersect_kernel(
    const int64_t* __restrict__ a_firsts, const int32_t* __restrict__ a_bws,
    const int32_t* __restrict__ a_woffs, const int64_t* __restrict__ a_pay,
    const int32_t* __restrict__ a_ns, const int64_t* __restrict__ a_sw,
    const int32_t* __restrict__ a_bmax, int64_t nba, int64_t pwa,
    const int64_t* __restrict__ b_firsts, const int32_t* __restrict__ b_bws,
    const int32_t* __restrict__ b_woffs, const int64_t* __restrict__ b_pay,
    const int32_t* __restrict__ b_ns, const int64_t* __restrict__ b_sw,
    int64_t nbb, int64_t pwb, const int32_t* __restrict__ rest,
    const int32_t* __restrict__ th, int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kSeg / 32];
  __shared__ int red[kSeg / 32];
  __shared__ uint32_t bvals[kSeg];
  __shared__ uint32_t bsw[kScoreWords];

  const int64_t r = blockIdx.y;
  const int64_t ia = blockIdx.x;
  const int lane = threadIdx.x;
  int32_t* o = out + (r * nba + ia) * kSeg;
  const int64_t na = a_ns[r];
  const int64_t ablk = r * nba + ia;
  // the WAND bound in int32 arithmetic, wrapping like the reference's
  const int32_t bound = (int32_t)((uint32_t)a_bmax[ablk] + (uint32_t)rest[r]);
  if (ia * kSeg >= na || bound <= th[r]) {  // uniform over the CTA
    o[lane] = 0;
    return;
  }
  const uint32_t g = gap_of(a_pay + r * pwa, pwa, a_woffs[ablk],
                            a_bws[ablk], lane);
  const uint32_t x = (uint32_t)a_firsts[ablk] + block_scan(g, warp_sums);
  const bool va = (ia * kSeg + lane) < na && x != kInvalid;
  const int a_imp = impact_of(
      (uint32_t)a_sw[(r * nba + ia) * kScoreWords + (lane >> 2)], lane);

  const int64_t nbv = b_ns[r];
  const int j = va ? find_block(b_firsts + r * nbb, nbb, nbv, x) : -1;

  int val = 0;
  int cur = block_min(j >= 0 ? j : INT_MAX, red);
  while (cur != INT_MAX) {  // uniform: every thread sees the same cur
    const int64_t bblk = r * nbb + cur;
    const uint32_t bg = gap_of(b_pay + r * pwb, pwb, b_woffs[bblk],
                               b_bws[bblk], lane);
    const uint32_t v = (uint32_t)b_firsts[bblk] + block_scan(bg, warp_sums);
    bvals[lane] = ((int64_t)cur * kSeg + lane < nbv) ? v : kInvalid;
    if (lane < kScoreWords)
      bsw[lane] = (uint32_t)b_sw[bblk * kScoreWords + lane];
    __syncthreads();
    if (j == cur) {
      int lo = 0, hi = kSeg;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bvals[mid] < x) lo = mid + 1; else hi = mid;
      }
      if (lo > kSeg - 1) lo = kSeg - 1;
      if (bvals[lo] == x) {
        const int b_imp = impact_of(bsw[lo >> 2], lo);
        if (b_imp > 0) val = a_imp + b_imp;
      }
    }
    __syncthreads();
    cur = block_min(j > cur ? j : INT_MAX, red);
  }
  o[lane] = val;
}

}  // namespace

extern "C" int scored_intersect_launch(
    const int64_t* a_firsts, const int32_t* a_bws, const int32_t* a_woffs,
    const int64_t* a_pay, const int32_t* a_ns, const int64_t* a_sw,
    const int32_t* a_bmax, int64_t nba, int64_t pwa,
    const int64_t* b_firsts, const int32_t* b_bws, const int32_t* b_woffs,
    const int64_t* b_pay, const int32_t* b_ns, const int64_t* b_sw,
    int64_t nbb, int64_t pwb, const int32_t* rest, const int32_t* th,
    int32_t* out, int64_t rows, cudaStream_t stream) {
  if (rows <= 0 || nba <= 0) return 0;
  if (rows > 65535 || nba > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nba, (unsigned)rows);
  scored_intersect_kernel<<<grid, kSeg, 0, stream>>>(
      a_firsts, a_bws, a_woffs, a_pay, a_ns, a_sw, a_bmax, nba, pwa,
      b_firsts, b_bws, b_woffs, b_pay, b_ns, b_sw, nbb, pwb, rest, th, out);
  return (int)cudaGetLastError();
}
