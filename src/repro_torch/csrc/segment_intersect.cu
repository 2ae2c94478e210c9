// Fused gap-decode + membership over block-compressed docid lists (the
// frozen-segment conjunction of the lifecycle engine).
//
// Replaces two Pallas TPU kernels in src/repro/kernels/segment_intersect.py:
// `segment_intersect_mask_batched` (`_kernel_batched`, one grid step per
// (query, segment) row) and `segment_intersect_mask` (`_kernel`, one
// pair of PackedLists).  Both walked the two lists with two pointers,
// decoding one 128-docid block at a time into VMEM and testing 128 x 128
// equality tiles — a serial walk that suits one TPU core.  Hopper runs
// thousands of blocks at once, so the walk is turned inside out:
//
//   * one CTA of 128 threads per (row, a-block), one thread per lane;
//   * the a-block is decoded in registers: a byte, halfword or word
//     load by the block's width `bws`, a block-wide inclusive scan of
//     the gaps (wrapping mod 2**32 like the reference's uint32 cumsum),
//     plus `firsts`; lanes at or past the row's count `ns` are INVALID;
//   * each lane binary-searches its row's ascending `b.firsts` for the
//     one b-block that can hold its docid;
//   * the CTA visits the distinct b-blocks its lanes need, in ascending
//     order (at most 128): the block is decoded into shared memory the
//     same way and each lane that needs it binary-searches it.
//
// The output is `hit && lane < ns[r] && docid != INVALID` — the
// searchsorted oracle over both fully decoded lists
// (`segment_intersect_mask_batched_ref`), bit for bit.  Pad rows (ns=0)
// and pad a-blocks write zeros without touching b.
//
// Bound on an H100: memory.  Each real a-block reads its 16-byte block
// entry and 32*bw words of payload and writes 512 bytes of mask; b is
// read only in the blocks some a-lane can match, plus log2(NB) firsts per
// lane (cached).  Words are int64 holding uint32 values, so the payload
// moves twice the reference's bytes; narrowing it is a later change.
#include "segment_decode.cuh"

namespace {

__global__ void __launch_bounds__(kSeg) segment_intersect_kernel(
    const int64_t* __restrict__ a_firsts, const int32_t* __restrict__ a_bws,
    const int32_t* __restrict__ a_woffs, const int64_t* __restrict__ a_pay,
    const int32_t* __restrict__ a_ns, int64_t nba, int64_t pwa,
    const int64_t* __restrict__ b_firsts, const int32_t* __restrict__ b_bws,
    const int32_t* __restrict__ b_woffs, const int64_t* __restrict__ b_pay,
    const int32_t* __restrict__ b_ns, int64_t nbb, int64_t pwb,
    int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kSeg / 32];
  __shared__ int red[kSeg / 32];
  __shared__ uint32_t bvals[kSeg];

  const int64_t r = blockIdx.y;
  const int64_t ia = blockIdx.x;
  const int lane = threadIdx.x;
  int32_t* o = out + (r * nba + ia) * kSeg;
  const int64_t na = a_ns[r];
  if (ia * kSeg >= na) {  // pad block of a: uniform over the CTA
    o[lane] = 0;
    return;
  }
  const int64_t ablk = r * nba + ia;
  const uint32_t g = gap_of(a_pay + r * pwa, pwa, a_woffs[ablk],
                            a_bws[ablk], lane);
  const uint32_t x = (uint32_t)a_firsts[ablk] + block_scan(g, warp_sums);
  const bool va = (ia * kSeg + lane) < na && x != kInvalid;

  const int64_t nbv = b_ns[r];
  const int j = va ? find_block(b_firsts + r * nbb, nbb, nbv, x) : -1;

  int hit = 0;
  int cur = block_min(j >= 0 ? j : INT_MAX, red);
  while (cur != INT_MAX) {  // uniform: every thread sees the same cur
    const int64_t bblk = r * nbb + cur;
    const uint32_t bg = gap_of(b_pay + r * pwb, pwb, b_woffs[bblk],
                               b_bws[bblk], lane);
    const uint32_t v = (uint32_t)b_firsts[bblk] + block_scan(bg, warp_sums);
    bvals[lane] = ((int64_t)cur * kSeg + lane < nbv) ? v : kInvalid;
    __syncthreads();
    if (j == cur) {
      int lo = 0, hi = kSeg;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bvals[mid] < x) lo = mid + 1; else hi = mid;
      }
      if (lo > kSeg - 1) lo = kSeg - 1;
      hit = bvals[lo] == x;
    }
    __syncthreads();
    cur = block_min(j > cur ? j : INT_MAX, red);
  }
  o[lane] = hit;
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
  const dim3 grid((unsigned)nba, (unsigned)rows);
  segment_intersect_kernel<<<grid, kSeg, 0, stream>>>(
      a_firsts, a_bws, a_woffs, a_pay, a_ns, nba, pwa, b_firsts, b_bws,
      b_woffs, b_pay, b_ns, nbb, pwb, out);
  return (int)cudaGetLastError();
}
