// Fused scatter-append of one ingest batch (paper §3.2 hot path).
//
// Replaces the Pallas TPU kernel `bulk_append` in
// src/repro/kernels/bulk_append.py (`_kernel` / `_scatter_stream`), which
// streamed (address, value) tiles through VMEM and issued one predicated
// single-slot DMA per element.  Lane i of the seven streams applies
//
//     heap[post_addr[i]] = post_val[i]    (skip unless 0 <= addr < H)
//     heap[ptr_addr[i]]  = ptr_val[i]     (skip unless 0 <= addr < H)
//     tail[term_idx[i]]  = term_tail[i]   (skip unless 0 <= idx  < V)
//     freq[term_idx[i]]  = term_freq[i]
//
// uint32 values travel as int64 holding the value, like every pointer and
// posting of the port; freq and term_freq are int32.
//
// No atomics.  The bulk allocator (core/slicepool.py) makes every live
// address unique within a batch: postings and previous-pointers take
// disjoint heap slots (a pointer is slot 0 of a fresh slice in a pool
// above 0, a posting any other slot), a term writes its head once, and
// every skip lane carries a distinct out-of-range address.  So no two
// lanes write one word, the writes commute, and plain stores give the
// same heap, tail and freq in any order.
//
// Bound on an H100: memory, counted as the batch needs it.  Every lane's
// three addresses must be read (24 bytes a lane); a value is read, and
// written, only where its lane lands (8 bytes a posting or pointer, 12 a
// term).  At phase 2's 4096-tweet batch (286,720 lanes, 45,043 postings,
// 1,778 pointers and 19,417 terms landing; 84% of the lanes are pads of
// the 70-slot tweets, sorted last by the plan) that is 6,881,280 +
// 2 x 607,572 = 8,096,424 bytes, 0.0024 ms at 3.35 TB/s; charging all
// seven streams to every lane (15,517,012 bytes) counts value bytes the
// call never needs.
//
// The design (launch numbers from kernels/bulk_append.launch_plan):
// * A warp owns tiles of 64 consecutive lanes; thread t holds lanes
//   2t and 2t + 1 of its tile, so each address stream is read by
//   16-byte loads (two lanes a load) that coalesce across the warp.  A
//   thread issues its three address loads before any value load or
//   store, so they are in flight together: one dependent trip for the
//   addresses, one for the values.  (Four lanes a thread, six loads in
//   flight, measured slower on the card: half the warps to hide the
//   latency with, twice the instructions a warp; PERF.md §6.)
// * Consecutive tiles go to consecutive CTAs, warp by warp, so the
//   plan's landing prefix (about the first sixth of the lanes) and its
//   scattered tail/freq stores spread over every SM instead of piling
//   onto the SMs of the first CTAs.
// * A stream whose base is not aligned to two lanes (a view at an odd
//   element), and a pair that runs past n, is read one lane at a time;
//   a lane past n reads the skip address -1.  The alignment bits come
//   from the wrapper and are checked here, so a view never faults.
// * The seven streams are read once: `__ldcs` (cache-streaming, evict
//   first) keeps them from pushing `tail`/`freq` out of the L2, which
//   the next batch's plan gathers.  Stores stay plain.
// * One warp vote a stream: a warp none of whose lanes land in a stream
//   loads none of its values (the whole pad tail, and most warps of the
//   pointer and term streams).  Landing lanes load their values (both
//   lanes of a pair in one load when both land) and store.
// * One wave: the grid is at most kCtasPerSm CTAs an SM (the register
//   budget below), and warps walk any further tiles grid-stride.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per CTA (kernels/bulk_append.py)
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;          // lanes a warp tile: two a thread
constexpr int kCtasPerSm = 5;      // the register budget: 51 a thread
constexpr unsigned kFull = 0xffffffffu;

// bits of `aligned`: the stream may be read two lanes a load
enum : int64_t {
  kPostAddr = 1, kPostVal = 2, kPtrAddr = 4, kPtrVal = 8,
  kTermIdx = 16, kTermTail = 32, kTermFreq = 64, kAllStreams = 127
};

struct Streams {
  const long long* post_addr;
  const long long* post_val;
  const long long* ptr_addr;
  const long long* ptr_val;
  const long long* term_idx;
  const long long* term_tail;
  const int* term_freq;
};

// Lanes i, i + 1 of an address stream, evict-first; a lane at or past n
// reads -1 (a skip).
__device__ __forceinline__ void load_addrs(const long long* s, int64_t i,
                                           int64_t n, bool vec,
                                           long long (&out)[2]) {
  if (vec && i + 1 < n) {
    const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(s + i));
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = i < n ? __ldcs(s + i) : -1;
    out[1] = i + 1 < n ? __ldcs(s + i + 1) : -1;
  }
}

// The values of the landing lanes among i, i + 1 (`w`), evict-first.
template <typename T, typename T2>
__device__ __forceinline__ void load_vals(const T* s, int64_t i, bool vec,
                                          const bool (&w)[2], T (&out)[2]) {
  if (vec && w[0] && w[1]) {
    const T2 v = __ldcs(reinterpret_cast<const T2*>(s + i));
    out[0] = v.x;
    out[1] = v.y;
  } else {
    if (w[0]) out[0] = __ldcs(s + i);
    if (w[1]) out[1] = __ldcs(s + i + 1);
  }
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm) bulk_append_kernel(
    long long* __restrict__ heap, int64_t heap_cap,
    long long* __restrict__ tail, int* __restrict__ freq, int64_t vocab,
    Streams s, int64_t n, int64_t aligned) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  // w is the same for every thread of a warp: the votes see whole warps
  for (int64_t w = (int64_t)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       w < tiles; w += warps) {
    const int64_t i = w * kTile + 2 * (threadIdx.x & 31);
    long long pa[2], qa[2], ta[2];
    load_addrs(s.post_addr, i, n, aligned & kPostAddr, pa);
    load_addrs(s.ptr_addr, i, n, aligned & kPtrAddr, qa);
    load_addrs(s.term_idx, i, n, aligned & kTermIdx, ta);
    bool lp[2], lq[2], lt[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      lp[k] = pa[k] >= 0 && pa[k] < heap_cap;
      lq[k] = qa[k] >= 0 && qa[k] < heap_cap;
      lt[k] = ta[k] >= 0 && ta[k] < vocab;
    }
    const bool any_p = __any_sync(kFull, lp[0] || lp[1]);
    const bool any_q = __any_sync(kFull, lq[0] || lq[1]);
    const bool any_t = __any_sync(kFull, lt[0] || lt[1]);
    long long pv[2] = {}, qv[2] = {}, tv[2] = {};
    int fv[2] = {};
    if (any_p)
      load_vals<long long, longlong2>(s.post_val, i, aligned & kPostVal, lp,
                                      pv);
    if (any_q)
      load_vals<long long, longlong2>(s.ptr_val, i, aligned & kPtrVal, lq,
                                      qv);
    if (any_t) {
      load_vals<long long, longlong2>(s.term_tail, i, aligned & kTermTail,
                                      lt, tv);
      load_vals<int, int2>(s.term_freq, i, aligned & kTermFreq, lt, fv);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (lp[k]) heap[pa[k]] = pv[k];
      if (lq[k]) heap[qa[k]] = qv[k];
      if (lt[k]) {
        tail[ta[k]] = tv[k];
        freq[ta[k]] = fv[k];
      }
    }
  }
}

}  // namespace

extern "C" int bulk_append_launch(
    int64_t* heap, int64_t heap_cap, int64_t* tail, int32_t* freq,
    int64_t vocab, const int64_t* post_addr, const int64_t* post_val,
    const int64_t* ptr_addr, const int64_t* ptr_val,
    const int64_t* term_idx, const int64_t* term_tail,
    const int32_t* term_freq, int64_t n, int64_t tile, int64_t grid,
    int64_t aligned, cudaStream_t stream) {
  if (n <= 0) return 0;
  const Streams s{reinterpret_cast<const long long*>(post_addr),
                  reinterpret_cast<const long long*>(post_val),
                  reinterpret_cast<const long long*>(ptr_addr),
                  reinterpret_cast<const long long*>(ptr_val),
                  reinterpret_cast<const long long*>(term_idx),
                  reinterpret_cast<const long long*>(term_tail),
                  term_freq};
  // the plan's numbers, checked: a bit that claims a pair load on a
  // stream whose base is not aligned to two lanes would fault
  const void* base[7] = {post_addr, post_val, ptr_addr, ptr_val,
                         term_idx, term_tail, term_freq};
  const uintptr_t pair_bytes[7] = {16, 16, 16, 16, 16, 16, 8};
  if (tile != kTile || aligned < 0 || aligned > kAllStreams || grid < 1 ||
      grid > (1 << 30))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 7; ++k)
    if ((aligned >> k & 1) &&
        reinterpret_cast<uintptr_t>(base[k]) % pair_bytes[k] != 0)
      return (int)cudaErrorInvalidValue;
  bulk_append_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      reinterpret_cast<long long*>(heap), heap_cap,
      reinterpret_cast<long long*>(tail), freq, vocab, s, n, aligned);
  return (int)cudaGetLastError();
}
