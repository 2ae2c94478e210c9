// Sorted-set membership mask (the active engine's conjunctive step).
//
// Replaces the Pallas TPU kernel `intersect_mask` in
// src/repro/kernels/postings_intersect.py (`_kernel`), which walked both
// lists with two pointers over TA x TB equality tiles in VMEM — a
// sequential grid that suits one TPU core.  Hopper runs blocks in
// parallel and in no order, so here every element of `a` is one thread
// that binary-searches its row of `b`:
//
//     pos = lower_bound(b_row, x);  pos = min(pos, nb - 1)
//     out = (b_row[pos] == x) && (x != INVALID)
//
// which is exactly the searchsorted oracle (`intersect_mask_ref`), so the
// mask is bit-identical for any ascending INVALID-padded input.  Rows
// are independent lists of equal width (leading batch axis).
//
// Bound on an H100: memory.  `a` is read once, coalesced; the search
// touches log2(nb) words of `b`, whose top levels stay in L1/L2, and the
// int32 mask is written once — about 12 bytes per lane of `a` plus one
// pass over `b`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kInvalid = 0xFFFFFFFFLL;

__global__ void intersect_mask_kernel(const int64_t* __restrict__ a,
                                      const int64_t* __restrict__ b,
                                      int32_t* __restrict__ out,
                                      int64_t rows, int64_t na,
                                      int64_t nb) {
  const int64_t total = rows * na;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t row = i / na;
    const int64_t x = a[i];
    const int64_t* br = b + row * nb;
    int64_t lo = 0, hi = nb;  // lower_bound in [0, nb)
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (br[mid] < x) lo = mid + 1; else hi = mid;
    }
    if (lo > nb - 1) lo = nb - 1;
    out[i] = (br[lo] == x && x != kInvalid) ? 1 : 0;
  }
}

}  // namespace

extern "C" int intersect_mask_launch(const int64_t* a, const int64_t* b,
                                     int32_t* out, int64_t rows,
                                     int64_t na, int64_t nb,
                                     cudaStream_t stream) {
  const int64_t total = rows * na;
  if (total <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  intersect_mask_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      a, b, out, rows, na, nb);
  return (int)cudaGetLastError();
}
