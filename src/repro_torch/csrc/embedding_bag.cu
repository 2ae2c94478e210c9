// CSR embedding bag (the recsys serving hot path).
//
// Replaces the Pallas TPU kernel `embedding_bag` in
// src/repro/kernels/embedding_bag.py (`_kernel`), which ran one grid
// step per bag and streamed the bag's rows HBM->VMEM with double-
// buffered row DMAs into an fp32 scratch sum.  The oracle is
// `embedding_bag_ref` in src/repro/kernels/ref.py; this kernel computes
// the Pallas kernel's contract:
//
//     out[b] = sum (or mean; an empty bag divides by 1) over
//              j in [offsets[b], offsets[b+1]) of table[clip(idx[j])]
//
// with rows widened to fp32 and summed in fp32 in bag order, an fp32
// output, and indices clipped into [0, R-1] (the oracle's mode="clip";
// the TPU kernel would read out of range).  A bag's sum starts from its
// first row, so a bag of one row is bit-identical to table[idx].float().
// Offsets are clamped into [0, N] so a malformed CSR cannot read past
// the indices.
//
// Design: a 1-D grid-stride loop over bags.  TPB lanes (a power of two
// up to 32, the least that covers D) serve one bag, so a warp serves
// 32 / TPB bags: at the recsys widths (D = 1, 10, 16, 18, 128) a CTA
// per bag would leave most lanes idle.  Lane l of a bag owns columns
// l, l + TPB, ... (up to kCols per pass), so a row is read by
// neighbouring lanes at neighbouring addresses; loads are scalar (4 or
// 2 bytes), since rows of D = 10 or 18 fp32 are not 16-byte aligned.
// Row addresses are int64: DLRM-MLPerf's table has 187,767,808 rows of
// 128, and row * D passes 2**31.
//
// Bound on an H100: memory.  Each bag reads its rows (random rows of a
// table far larger than the 50 MB L2), its indices and offsets, and
// writes B * D fp32 (DCN-v2 serve_bulk: 6.8M single-row bags of 16
// fp32, about 0.9 GB, 0.27 ms at 3.35 TB/s).  The kernel is bound by
// the latency of its dependent index -> row loads; vector loads for
// aligned widths and more bags in flight per warp are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;           // columns per lane per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int TPB>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const T* __restrict__ table, const int32_t* __restrict__ indices,
    const int32_t* __restrict__ offsets, float* __restrict__ out,
    int64_t n, int64_t B, int64_t R, int D, int mean) {
  constexpr int kBagsPerCta = kThreads / TPB;
  const int lane = threadIdx.x % TPB;
  const int64_t stride = (int64_t)gridDim.x * kBagsPerCta;
  for (int64_t b = (int64_t)blockIdx.x * kBagsPerCta + threadIdx.x / TPB;
       b < B; b += stride) {
    int64_t lo = offsets[b];
    int64_t hi = offsets[b + 1];
    lo = lo < 0 ? 0 : (lo > n ? n : lo);
    hi = hi < lo ? lo : (hi > n ? n : hi);
    const float cnt = (float)(hi - lo > 1 ? hi - lo : 1);
    float* ob = out + b * D;
    for (int c0 = 0; c0 < D; c0 += TPB * kCols) {
      float acc[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
      for (int64_t j = lo; j < hi; ++j) {
        int64_t row = indices[j];
        row = row < 0 ? 0 : (row >= R ? R - 1 : row);
        const T* src = table + row * D;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int c = c0 + k * TPB + lane;
          if (c < D) {
            const float x = to_f32(src[c]);
            acc[k] = j == lo ? x : acc[k] + x;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = c0 + k * TPB + lane;
        // the mean divides as the oracle does, by max(count, 1) (an
        // IEEE division: x / 1 is x)
        if (c < D) ob[c] = mean ? acc[k] / cnt : acc[k];
      }
    }
  }
}

template <typename T, int TPB>
int launch_tpb(const void* table, const int32_t* indices,
               const int32_t* offsets, float* out, int64_t n, int64_t B,
               int64_t R, int64_t D, int64_t mean, cudaStream_t stream) {
  constexpr int64_t kBagsPerCta = kThreads / TPB;
  int64_t grid = (B + kBagsPerCta - 1) / kBagsPerCta;
  if (grid > (1 << 20)) grid = 1 << 20;      // the loop strides the rest
  embedding_bag_kernel<T, TPB><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(table), indices, offsets, out, n, B, R, (int)D,
      (int)mean);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* table, const int32_t* indices,
           const int32_t* offsets, float* out, int64_t n, int64_t B,
           int64_t R, int64_t D, int64_t mean, cudaStream_t stream) {
  if (D <= 1)
    return launch_tpb<T, 1>(table, indices, offsets, out, n, B, R, D, mean,
                            stream);
  if (D <= 2)
    return launch_tpb<T, 2>(table, indices, offsets, out, n, B, R, D, mean,
                            stream);
  if (D <= 4)
    return launch_tpb<T, 4>(table, indices, offsets, out, n, B, R, D, mean,
                            stream);
  if (D <= 8)
    return launch_tpb<T, 8>(table, indices, offsets, out, n, B, R, D, mean,
                            stream);
  if (D <= 16)
    return launch_tpb<T, 16>(table, indices, offsets, out, n, B, R, D,
                             mean, stream);
  return launch_tpb<T, 32>(table, indices, offsets, out, n, B, R, D, mean,
                           stream);
}

}  // namespace

// table: [R, D] fp32 or bf16 (table_bf16); indices int32[n]; offsets
// int32[B + 1]; out fp32 [B, D]; mean: 0 = sum, 1 = mean.  Returns the
// launch's cudaError_t.
extern "C" int embedding_bag_launch(const void* table, int64_t table_bf16,
                                    const int32_t* indices, int64_t n,
                                    const int32_t* offsets, int64_t B,
                                    int64_t R, int64_t D, int64_t mean,
                                    float* out, cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  if (R <= 0 || D > (1 << 30)) return (int)cudaErrorInvalidValue;
  if (table_bf16)
    return launch<__nv_bfloat16>(table, indices, offsets, out, n, B, R, D,
                                 mean, stream);
  return launch<float>(table, indices, offsets, out, n, B, R, D, mean,
                       stream);
}
