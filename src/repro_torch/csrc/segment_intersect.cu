// Fused gap-decode + membership over block-compressed docid lists (the
// frozen-segment conjunction of the lifecycle engine).
//
// Replaces two Pallas TPU kernels in src/repro/kernels/segment_intersect.py:
// `segment_intersect_mask_batched` (`_kernel_batched`, one grid step per
// (query, segment) row) and `segment_intersect_mask` (`_kernel`, one
// pair of PackedLists; launched here as one row).  Both walked the two
// lists with two pointers, decoding one 128-docid block at a time into
// VMEM and testing 128 x 128 equality tiles: a serial walk that suits one
// TPU core.  Here warps of a persistent grid take strips of a-blocks and
// run `frozen_walk<false>` (segment_decode.cuh): a warp decodes a block
// (four docids a lane), finds the b-blocks its docids can match with one
// 32-way search of b's block firsts, and visits them in order with their
// loads in flight; pad blocks are written by 16-byte stores.
//
// The output is `hit && lane < ns[r] && docid != INVALID`: the
// searchsorted oracle over both fully decoded lists
// (`segment_intersect_mask_batched_ref`), bit for bit.
//
// Bound on an H100: memory.  Each real a-block reads its 16-byte block
// entry and 32*bw words of payload; the int32 mask (512 bytes a block,
// pad blocks included) is most of the bytes at the path's shapes; b is
// read only in the blocks some valid a-lane can match, plus the firsts
// of its window.  Words are int64 holding uint32 values, so the payload
// moves twice the reference's bytes; narrowing it is a later change.
#include "segment_decode.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) segment_intersect_kernel(
    SegLists a, SegLists b, int32_t* __restrict__ out, int64_t rows,
    int strip, int64_t parts) {
  frozen_walk<false>(a, b, nullptr, nullptr, out, rows, strip, parts);
}

}  // namespace

extern "C" int segment_intersect_launch(
    const int64_t* a_firsts, const int32_t* a_bws, const int32_t* a_woffs,
    const int64_t* a_pay, const int32_t* a_ns, int64_t nba, int64_t pwa,
    const int64_t* b_firsts, const int32_t* b_bws, const int32_t* b_woffs,
    const int64_t* b_pay, const int32_t* b_ns, int64_t nbb, int64_t pwb,
    int32_t* out, int64_t rows, cudaStream_t stream) {
  if (rows <= 0 || nba <= 0) return 0;
  if (rows > 65535 || nba > INT_MAX) return (int)cudaErrorInvalidValue;
  const SegLists a{a_firsts, a_bws, a_woffs, a_pay, a_ns, nullptr, nullptr,
                   nba, pwa};
  const SegLists b{b_firsts, b_bws, b_woffs, b_pay, b_ns, nullptr, nullptr,
                   nbb, pwb};
  const Plan p = plan_for(segment_intersect_kernel, rows, nba);
  segment_intersect_kernel<<<p.grid, kThreads, 0, stream>>>(
      a, b, out, rows, p.strip, p.parts);
  return (int)cudaGetLastError();
}
