// Fused scatter-append of one ingest batch (paper §3.2 hot path).
//
// Replaces the Pallas TPU kernel `bulk_append` in
// src/repro/kernels/bulk_append.py (`_kernel` / `_scatter_stream`), which
// streamed (address, value) tiles through VMEM and issued one predicated
// single-slot DMA per element.  Here one launch walks the four streams
// with a grid-stride loop; lane i applies
//
//     heap[post_addr[i]] = post_val[i]    (skip unless 0 <= addr < H)
//     heap[ptr_addr[i]]  = ptr_val[i]     (skip unless 0 <= addr < H)
//     tail[term_idx[i]]  = term_tail[i]   (skip unless 0 <= idx  < V)
//     freq[term_idx[i]]  = term_freq[i]
//
// The bulk allocator makes every live address unique within a batch
// (skip lanes carry distinct out-of-range addresses), so no two lanes
// write one slot and no atomics are needed.  uint32 values travel as
// int64 holding the value, like every pointer and posting of the port.
//
// Bound on an H100: memory.  The streams are read once, coalesced
// (52 bytes per lane); each landed write is a scattered 8-byte store
// that costs a 32-byte sector.  At a 4096-tweet batch (about 287k
// lanes, about 45k of them landing) the whole launch moves ~16 MB, a
// few microseconds at 3.35 TB/s, so it is bound by launch latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bulk_append_kernel(
    int64_t* __restrict__ heap, int64_t heap_cap,
    int64_t* __restrict__ tail, int32_t* __restrict__ freq, int64_t vocab,
    const int64_t* __restrict__ post_addr,
    const int64_t* __restrict__ post_val,
    const int64_t* __restrict__ ptr_addr,
    const int64_t* __restrict__ ptr_val,
    const int64_t* __restrict__ term_idx,
    const int64_t* __restrict__ term_tail,
    const int32_t* __restrict__ term_freq, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t pa = post_addr[i];
    if (pa >= 0 && pa < heap_cap) heap[pa] = post_val[i];
    const int64_t qa = ptr_addr[i];
    if (qa >= 0 && qa < heap_cap) heap[qa] = ptr_val[i];
    const int64_t t = term_idx[i];
    if (t >= 0 && t < vocab) {
      tail[t] = term_tail[i];
      freq[t] = term_freq[i];
    }
  }
}

}  // namespace

extern "C" int bulk_append_launch(
    int64_t* heap, int64_t heap_cap, int64_t* tail, int32_t* freq,
    int64_t vocab, const int64_t* post_addr, const int64_t* post_val,
    const int64_t* ptr_addr, const int64_t* ptr_val,
    const int64_t* term_idx, const int64_t* term_tail,
    const int32_t* term_freq, int64_t n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond that
  bulk_append_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      heap, heap_cap, tail, freq, vocab, post_addr, post_val, ptr_addr,
      ptr_val, term_idx, term_tail, term_freq, n);
  return (int)cudaGetLastError();
}
