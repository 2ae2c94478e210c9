// Fused gap-decode + membership + impact sum over block-compressed scored
// docid lists, with the block-max WAND skip (the exhaustive scored
// conjunction of the lifecycle engine).
//
// Replaces the Pallas TPU kernel `scored_intersect_batched`
// (`_scored_kernel_batched`, one grid step per (query, segment) row) in
// src/repro/kernels/segment_intersect.py.  The TPU kernel walks the two
// lists with two pointers, one decoded block pair at a time, and zeroes an
// a-block at flush time when its bound `a_bmax + rest <= th`, after it
// has already decoded and matched it.  Here the walk is
// `frozen_walk<true>` (segment_decode.cuh), the one of
// segment_intersect.cu plus the score planes:
//
//   * the skip comes FIRST: a pad a-block, or one whose bound
//     `a_bmax + rest[r]` is <= `th[r]`, writes zeros without reading a
//     payload word, a score word or anything of b;
//   * lane i's four a-impacts are exactly score word i of the block, and
//     a decoded b-block comes with its lane's score word the same way, so
//     each side's impacts cost one load a lane.
//
// A lane's output is `a_imp + b_imp` when its docid is valid, occurs in
// b's real lanes (lanes past `b.ns` are INVALID, as in the oracle
// `scored_intersect_batched_ref`, whose searchsorted finds the first
// occurrence) and `b_imp > 0`; 0 otherwise: the oracle, bit for bit.
//
// Bound on an H100: memory.  A live a-block reads its block entry, 32*bw
// payload words, 32 score words and writes 512 bytes; a skipped block
// reads 20 bytes and writes 512.  b is read only in the blocks some live
// a-lane can match.  Words are int64 holding uint32 values (twice the
// reference's bytes), as in segment_intersect.cu.
#include "segment_decode.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) scored_intersect_kernel(
    SegLists a, SegLists b, const int32_t* __restrict__ rest,
    const int32_t* __restrict__ th, int32_t* __restrict__ out,
    int64_t rows, int strip, int64_t parts) {
  frozen_walk<true>(a, b, rest, th, out, rows, strip, parts);
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
  const SegLists a{a_firsts, a_bws, a_woffs, a_pay, a_ns, a_sw, a_bmax,
                   nba, pwa};
  const SegLists b{b_firsts, b_bws, b_woffs, b_pay, b_ns, b_sw, nullptr,
                   nbb, pwb};
  const Plan p = plan_for(scored_intersect_kernel, rows, nba);
  scored_intersect_kernel<<<p.grid, kThreads, 0, stream>>>(
      a, b, rest, th, out, rows, p.strip, p.parts);
  return (int)cudaGetLastError();
}
