// Gradient of the CSR embedding bag with respect to the table.
//
// Replaces no Pallas kernel: the reference's table gradient is XLA's
// transpose of `jnp.take(table, ids, mode="clip")` (a scatter-add,
// src/repro/models/recsys.py:49-56), and the Pallas `embedding_bag`
// (src/repro/kernels/embedding_bag.py) has no backward.  The port's
// forward (csrc/embedding_bag.cu) writes a fresh tensor outside autograd,
// so training through it needs this kernel (kernels/ops.py wraps the two
// in a torch.autograd.Function).  Its plain version is
// `embedding_bag_backward_ref` in kernels/ref.py:
//
//     d_table[r] = sum over positions j inside a bag b with
//                  clip(idx[j], 0, R-1) == r of grad_out[b]
//                  (divided by max(len_b, 1) in mean mode)
//
// summed in fp32 and cast once to the table's dtype; rows no position
// reaches are zero, positions outside [offsets[0], offsets[B]) add
// nothing.  The offsets must be non-decreasing (every CSR the models
// build is).
//
// The order of addition, fixed and bit for bit the same from run to run
// (no atomics).  The wrapper's plan (kernels/embedding_bag.py) sorts the
// positions stably by their clipped row (rows of positions outside every
// bag become R and sort last), so each row's contributions form one run
// of the sorted array, in position order.  The sorted array is cut into
// chunks of kChunk entries.  Each row sums its entries inside a chunk in
// position order from 0.0f (its piece of that chunk), then left-folds
// its pieces in chunk order from the first one.  A row with one
// contribution is 0.0f + g, the plain version's bits; a run inside one
// chunk is the plain version's in-order sum; longer runs differ from it
// only in association.  `in_order_backward`
// (launch/time_embedding_bag_backward.py) states this order in plain
// torch, and the card checks hold the kernel bit-equal to it.
//
// A row window (the block [row_lo, row_hi) of a table sharded by rows,
// kernels/ops.py): the sort keys give the window's rows the keys
// row - row_lo and every other position the key R (the window's rows), so
// these kernels see the window as their table and write its [R, D] block.
// To keep each row's order that of the whole table's call, the chunks
// keep the whole sort's boundaries: the phase (`below`, a device int32:
// the count of in-bag positions whose row lies below the window, mod
// kChunk) shifts them, chunk c covering sorted entries [c * kChunk -
// phase, (c + 1) * kChunk - phase).  The windows' blocks then concatenate
// to the whole table's gradient bit for bit.  Without a window `below`
// is null.
//
// Bound on an H100: memory.  The call must write the dense d_table (R x D
// of the table's dtype: 2.16 GB at DCN-v2's 33,762,816 x 16 fp32 table,
// 0.645 ms at 3.35 TB/s) and read grad_out, the indices and the offsets
// once.  The rest is latency and random access: a row's entries are
// gathered from grad_out by their bags, and a hot row (DCN-v2's fields of
// 3 to 1,460 ids take ~45 to ~21,845 contributions a row) folds hundreds
// of chunk pieces in order.  The design writes every byte of d_table
// once, in five launches on the caller's stream:
//
// 0. `keys`, before the plan's sort (torch.sort, in the wrapper): each
//    position's sort key and bag, 2,048 positions a CTA staged in shared
//    memory so that every access is coalesced.  A bag is searched from
//    its place in an even split of the positions (bag_near: one or two
//    loads when the bags' lengths are even, and no hot spot where every
//    thread would start at the middle of the offsets).  Also the count
//    of positions below a window, and the touched-row bitmap cleared.
// 1. `gather`, after the sort: each sorted entry's bag (its position less
//    offsets[0] when every bag is one position, else kernel 0's), so a
//    chunk reads its bags beside its keys; and each touched row's bit.
// 2. `rows`, kCtasPerSm CTAs an SM for the whole call; each warp takes
//    its share of
//    - the chunks: it loads a chunk's 32 keys and bags at once and deals
//      the chunk's runs to its lane groups, which sum each in order (8
//      entries' grad_out rows in flight) and write a run that lies in the
//      chunk to its row, cast once to the table's dtype.  The first run,
//      if it began in an earlier chunk, is the chunk's `head` piece; the
//      last, if it began here and goes on, its `tail` piece (fp32), and
//      that run is listed for (3) with its end (32 probes of the keys a
//      round), as short (at most kShort heads to add) or long;
//    - then the 32-row blocks of d_table: every row whose bit is clear
//      is zeroed in 16-byte stores.
//    The chunks go first: their gathers are random reads, and reads
//    issued under a saturated stream of stores wait so long that the
//    stores end up waiting for them (on an H100, chunks and zeros run
//    side by side took longer than the two in turn).
// 3. `fold`: each listed run's row: its first chunk's tail piece, then
//    the following chunks' heads in chunk order.  A short run is one
//    group's, 8 heads in flight; a long one the whole warp's: its heads
//    are prefetched into L2 at once, its lane groups load 32 / V heads
//    each a batch (64 heads of a 16-wide row), the next batch in flight,
//    and stage them in shared memory, from which one group adds them in
//    order.
// Every row is written by exactly one of (2)'s chunks, (2)'s zeros and
// (3), and the bytes of a 16-byte segment that two rows share are split
// between them element by element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kCtasPerSm = 4;    // resident CTAs of kernel 2 an SM
constexpr int kChunk = 32;       // sorted entries per chunk (BWD_CHUNK)
constexpr int kPos = 8;          // positions a thread of kernel 0
constexpr int kAhead = 8;        // a run's entries in flight in its group
constexpr int kShort = 16;       // heads a group folds; longer runs: a warp
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const float* grad_out;
  const int32_t* offsets;
  const int32_t* key;      // sorted clipped rows; R = outside every bag
  const int64_t* perm;     // positions in sorted order
  const int32_t* below;    // null, or the chunks' shift (see the header)
  const int32_t* uneven;   // nonzero: some bag is not one position
  int32_t* bag_of;         // [N]: each in-bag position's bag
  int32_t* sbag;           // [N]: each sorted entry's bag
  uint32_t* touched;       // [words]: bit r % 32 of word r / 32: row r has
                           // an entry
  float* head;             // [n_chunks, D]
  float* tail;             // [n_chunks, D]
  int32_t* runs;           // [n_chunks, 3]: (row, first, end) of each run
                           // across chunks: short ones from the front,
                           // long ones from the back
  int32_t* n_runs;         // [2]: short and long runs listed
  void* d_table;
  int64_t N, R, D, n_chunks;
  int mean, lanes, esize;
  int seg_shift;           // log2 of the 16-byte segments a row, or -1
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* y) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
  } else {
    p[0] = y[0];
  }
}

// fp32 -> bf16, round to nearest even (torch's cast); NaN stays NaN.
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// One row's V columns to d_table, cast once to the table's dtype.
template <int V, bool BF16>
__device__ __forceinline__ void store_row(void* d_table, int64_t off,
                                          const float* y) {
  if constexpr (!BF16) {
    store_f32<V>(reinterpret_cast<float*>(d_table) + off, y);
  } else {
    unsigned short* p = reinterpret_cast<unsigned short*>(d_table) + off;
    if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(bf16_bits(y[0]) | (bf16_bits(y[1]) << 16),
                     bf16_bits(y[2]) | (bf16_bits(y[3]) << 16));
    } else if constexpr (V == 2) {
      *reinterpret_cast<uint32_t*>(p) =
          bf16_bits(y[0]) | (bf16_bits(y[1]) << 16);
    } else {
      p[0] = (unsigned short)bf16_bits(y[0]);
    }
  }
}

// First b in [lo, hi) with offsets[b + 1] > j (hi if none).
__device__ __forceinline__ int64_t bag_search(const int32_t* off, int64_t lo,
                                              int64_t hi, int64_t j) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(off + mid + 1) > j) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// The same answer searched outward from `guess` (a galloping search):
// one or two loads when the bags' lengths are even, and no hot spot where
// every thread starts a search at the middle of the offsets.
__device__ __forceinline__ int64_t bag_near(const int32_t* off, int64_t B,
                                            int64_t guess, int64_t j) {
  const int64_t g = guess < 0 ? 0 : (guess > B - 1 ? B - 1 : guess);
  int64_t lo, hi;                       // the answer lies in [lo, hi]
  if (g < B - 1 && __ldg(off + g + 1) <= j) {
    lo = g + 1;
    for (int64_t step = 1;; step *= 2) {
      const int64_t p = g + step;
      if (p >= B - 1) { hi = B - 1; break; }
      if (__ldg(off + p + 1) > j) { hi = p; break; }
      lo = p + 1;
    }
  } else {
    hi = g;
    for (int64_t step = 1;; step *= 2) {
      const int64_t p = g - step;
      if (p < 0) { lo = 0; break; }
      if (__ldg(off + p + 1) <= j) { lo = p + 1; break; }
      hi = p;
    }
  }
  return bag_search(off, lo, hi, j);
}

__device__ __forceinline__ int64_t phase_of(const Args& a) {
  return a.below ? (int64_t)__ldg(a.below) % kChunk : 0;
}

// Sorted entries [s, e) of chunk c (empty past the end).
__device__ __forceinline__ void chunk_span(const Args& a, int64_t ph,
                                           int64_t c, int64_t* s,
                                           int64_t* e) {
  const int64_t lo = c * kChunk - ph, hi = lo + kChunk;
  *s = lo < 0 ? 0 : lo;
  *e = hi < a.N ? hi : a.N;
}

// One entry's fp32 contribution to V columns from `col`: grad_out's row
// of bag b, divided by max(len_b, 1) in mean mode.
template <int V>
__device__ __forceinline__ void contribution(const Args& a, int32_t b,
                                             int64_t col, float* x) {
  load_vec<V>(a.grad_out + (int64_t)b * a.D + col, x);
  if (a.mean) {
    const int32_t n = __ldg(a.offsets + b + 1) - __ldg(a.offsets + b);
    const float cnt = (float)(n > 1 ? n : 1);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = x[i] / cnt;
  }
}

// Kernel 0, before the plan's sort, kKeys positions a CTA (staged in
// shared memory, so every load and store of the arrays is coalesced) and
// kPos consecutive ones a thread: each one's sort key (its clipped row
// less row_lo; row_hi - row_lo, the window's rows, outside every bag or
// the window) and bag, and the count of in-bag positions whose row lies
// below the window (`counts[0]`, zeroed before; `counts[1]` is set if
// some in-bag position j's bag is not j - offsets[0]).  The first in-bag
// position's bag is searched from its place in an even split of the
// positions (bag_near), and the next kPos offsets, loaded at once, give
// the others' (a search again past them: empty bags).  The CTAs also
// clear the touched-row bitmap.
constexpr int kKeys = kThreads * kPos;
__global__ void __launch_bounds__(kThreads)
bag_bwd_keys(const int32_t* __restrict__ indices,
             const int32_t* __restrict__ offsets, int64_t N, int64_t B,
             int64_t R, int64_t row_lo, int64_t row_hi,
             int32_t* __restrict__ key, int32_t* __restrict__ bag_of,
             int32_t* __restrict__ counts, uint32_t* __restrict__ touched,
             int64_t words) {
  __shared__ int32_t ids[kKeys];          // the ids, then the bags
  __shared__ int32_t keys[kKeys];
  for (int64_t w = blockIdx.x * (int64_t)kThreads + threadIdx.x; w < words;
       w += (int64_t)gridDim.x * kThreads)
    touched[w] = 0u;
  const int64_t base = blockIdx.x * (int64_t)kKeys;
  if (base >= N) return;
  const int n = (int)(N - base < kKeys ? N - base : kKeys);
  for (int i = threadIdx.x; i < n; i += kThreads)
    ids[i] = __ldg(indices + base + i);
  __syncthreads();
  const int64_t o0 = __ldg(offsets), oB = __ldg(offsets + B);
  const int64_t lo = o0 < 0 ? 0 : (o0 > N ? N : o0);
  const int64_t hi = oB < lo ? lo : (oB > N ? N : oB);
  const int i0 = threadIdx.x * kPos;
  const int64_t j0 = base + i0;
  int n_below = 0;
  for (int i = i0; i < i0 + kPos && i < n; ++i) {
    const int64_t j = base + i;
    const bool inside = j >= o0 && j < oB;
    const int64_t r = ids[i] < 0 ? 0 : (ids[i] > R - 1 ? R - 1 : ids[i]);
    n_below += inside && r < row_lo;
    const bool in = inside && r >= row_lo && r < row_hi;
    keys[i] = (int32_t)(in ? r - row_lo : row_hi - row_lo);
  }
  const int64_t jf = j0 > lo ? j0 : lo;
  const int64_t jend = base + n < hi ? base + n : hi;
  const int64_t je = j0 + kPos < jend ? j0 + kPos : jend;
  bool uneven = false;
  if (jf < je) {
    const int64_t b0 = bag_near(offsets, B, (jf - o0) * B / (oB - o0), jf);
    int32_t next[kPos];                 // offsets[b0 + 1 + i]
#pragma unroll
    for (int i = 0; i < kPos; ++i)
      next[i] = b0 + 1 + i < B ? __ldg(offsets + b0 + 1 + i) : INT32_MAX;
    for (int64_t j = jf; j < je; ++j) {
      int c = 0;                        // next[i] <= j for i < c
#pragma unroll
      for (int i = 0; i < kPos; ++i) c += next[i] <= j;
      int64_t b = c < kPos ? b0 + c
                           : bag_search(offsets, b0 + kPos, B - 1, j);
      b = b < B - 1 ? b : B - 1;
      ids[j - base] = (int32_t)b;
      uneven |= b != j - o0;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    key[base + i] = keys[i];
    bag_of[base + i] = ids[i];   // an id, not a bag, outside every bag
  }
  n_below = __reduce_add_sync(kAll, n_below);
  const unsigned any_uneven = __ballot_sync(kAll, uneven);
  if ((threadIdx.x & 31) == 0) {
    if (n_below) atomicAdd(counts, n_below);
    if (any_uneven) atomicOr(counts + 1, 1);
  }
}

// Kernel 1, after the sort: each sorted entry's bag (position less
// offsets[0] when every bag is one position, else a gather from kernel
// 0's), so a chunk reads its bags beside its keys; and each touched row's
// bit (one atomicOr a run); the run lists emptied.
__global__ void __launch_bounds__(kThreads)
bag_bwd_gather(const Args a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) a.n_runs[0] = a.n_runs[1] = 0;
  const int64_t T = (int64_t)gridDim.x * blockDim.x;
  const bool uneven = __ldg(a.uneven) != 0;
  const int64_t o0 = __ldg(a.offsets);
  for (int64_t k0 = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; k0 < a.N;
       k0 += 4 * T) {
    int32_t r[4], prev[4];
    int64_t p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t k = k0 + u * T;
      r[u] = k < a.N ? __ldg(a.key + k) : INT32_MAX;
      prev[u] = k > 0 && k < a.N ? __ldg(a.key + k - 1) : -1;
      p[u] = k < a.N ? __ldg(a.perm + k) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r[u] >= a.R) continue;         // outside entries (they sort last)
      a.sbag[k0 + u * T] = uneven ? __ldg(a.bag_of + p[u])
                                  : (int32_t)(p[u] - o0);
      if (prev[u] != r[u])
        atomicOr(a.touched + (r[u] >> 5), 1u << (r[u] & 31));
    }
  }
}

// Zero the rows with no entry, 32-row blocks w, w + nw, ... (a block's
// bytes are a multiple of 64): each lane loads the touched word of one of
// the warp's next 32 blocks, and the warp stores its blocks' 16-byte
// segments in turn.
__device__ void zero_rows(const Args& a, int lane, int64_t w, int64_t nw) {
  const int64_t blocks = (a.R + 31) / 32;
  const int rb = (int)a.D * a.esize;                 // bytes a row
  const int64_t bb = 32 * (int64_t)rb;               // bytes a block
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  unsigned char* table = reinterpret_cast<unsigned char*>(a.d_table);
  for (int64_t b0 = w; b0 < blocks; b0 += 32 * nw) {
    const int64_t mine = b0 + (int64_t)lane * nw;
    const uint32_t word = mine < blocks ? __ldg(a.touched + mine) : 0u;
    for (int i = 0; i < 32; ++i) {
      const int64_t b = b0 + (int64_t)i * nw;
      if (b >= blocks) break;
      const uint32_t m = __shfl_sync(kAll, word, i);
      const int rows = (int)(a.R - b * 32 < 32 ? a.R - b * 32 : 32);
      const int bytes = rows * rb;
      unsigned char* base = table + b * bb;
      if (m == 0 && bytes % 16 == 0) {
        for (int q = lane; q * 16 < bytes; q += 32)
          *reinterpret_cast<uint4*>(base + q * 16) = z;
      } else if (a.seg_shift >= 0) {   // 2**seg_shift segments a row
        for (int q = lane; q * 16 < bytes; q += 32)
          if (!((m >> (q >> a.seg_shift)) & 1u))
            *reinterpret_cast<uint4*>(base + q * 16) = z;
      } else {
        for (int q = lane; q * 16 < bytes; q += 32) {
          const int b0q = q * 16, b1q = b0q + 16 < bytes ? b0q + 16 : bytes;
          const int rlo = b0q / rb, rhi = (b1q - 1) / rb;
          const uint32_t span = (rhi - rlo == 31 ? ~0u
                                 : ((1u << (rhi - rlo + 1)) - 1u)) << rlo;
          if (!(m & span) && b1q - b0q == 16) {
            *reinterpret_cast<uint4*>(base + b0q) = z;
          } else {
            for (int e = b0q; e < b1q; e += a.esize) {
              if ((m >> (e / rb)) & 1u) continue;
              if (a.esize == 4) *reinterpret_cast<uint32_t*>(base + e) = 0u;
              else *reinterpret_cast<unsigned short*>(base + e) = 0;
            }
          }
        }
      }
    }
  }
}

// Chunk c (see the header), one warp: every run inside the chunk summed
// and written, the first run's head piece if it began in an earlier
// chunk, the last run's tail piece if it began here and goes on (and that
// run listed for kernel 3).  `bags` and `keys` are the warp's 32 + 32
// ints of shared memory; the runs are dealt to the lane groups in turn.
template <int V, bool BF16>
__device__ void chunk_job(const Args& a, int64_t ph, int64_t c, int lane,
                          int32_t* bags, int32_t* keys) {
  int64_t s, e;
  chunk_span(a, ph, c, &s, &e);
  const int len = s < e ? (int)(e - s) : 0;
  const int32_t k = lane < len ? __ldg(a.key + s + lane) : INT32_MAX;
  const int32_t bag = lane < len ? __ldg(a.sbag + s + lane) : 0;
  const bool in = k < a.R;
  const unsigned inm = __ballot_sync(kAll, in);
  if (inm == 0) return;
  int32_t edge = -1;
  if (lane == 0 && s > 0) edge = __ldg(a.key + s - 1);
  if (lane == 1 && e < a.N) edge = __ldg(a.key + e);
  const int32_t prev = __shfl_sync(kAll, edge, 0);
  const int32_t next = __shfl_sync(kAll, edge, 1);
  const int32_t up = __shfl_up_sync(kAll, k, 1);
  const int32_t down = __shfl_down_sync(kAll, k, 1);
  const unsigned starts = __ballot_sync(kAll, in && (lane == 0 || up != k));
  const unsigned ends = __ballot_sync(kAll, in && (lane == 31 || down != k));
  const int nin = __popc(inm);            // in-window entries: lanes [0, nin)
  const bool cont_prev = prev == __shfl_sync(kAll, k, 0);
  const bool cont_next = nin == len && next == __shfl_sync(kAll, k, nin - 1);
  bags[lane] = in ? bag : 0;
  keys[lane] = k;
  __syncwarp();
  const int groups = 32 / a.lanes, g = lane / a.lanes, gl = lane % a.lanes;
  if (g < groups) {
    unsigned sm = starts, em = ends;
    for (int i = 0; i < g; ++i) { sm &= sm - 1; em &= em - 1; }
    while (sm) {
      const int ja = __ffs(sm) - 1, jb = __ffs(em);     // lanes [ja, jb)
      const int32_t row = keys[ja];
      const bool head = ja == 0 && cont_prev;
      const bool tail = !head && jb == nin && cont_next;
      for (int64_t col = (int64_t)gl * V; col < a.D;
           col += (int64_t)a.lanes * V) {
        float acc[V];
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = 0.0f;
        for (int j = ja; j < jb; j += kAhead) {
          float x[kAhead][V];
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
            if (j + u < jb) contribution<V>(a, bags[j + u], col, x[u]);
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            if (j + u < jb) {
#pragma unroll
              for (int q = 0; q < V; ++q) acc[q] += x[u][q];
            }
          }
        }
        if (head) store_f32<V>(a.head + c * a.D + col, acc);
        else if (tail) store_f32<V>(a.tail + c * a.D + col, acc);
        else store_row<V, BF16>(a.d_table, (int64_t)row * a.D + col, acc);
      }
      for (int i = 0; i < groups; ++i) { sm &= sm - 1; em &= em - 1; }
    }
  }
  __syncwarp();
  // the last run begins here and goes on: list it for kernel 3 with its
  // end, the first entry past e with a larger key (32 probes a round)
  const int ja = 31 - __clz(starts);
  if (cont_next && !(ja == 0 && cont_prev)) {
    const int32_t row = keys[ja];
    int64_t lo = e, stride = 32;        // the end lies in (lo, N]; stride
                                        // stays a power of 32
    for (;;) {
      const int64_t p = lo + (int64_t)(lane + 1) * stride;
      const unsigned past =
          __ballot_sync(kAll, p >= a.N || __ldg(a.key + p) > row);
      if (past) {
        const int f = __ffs(past) - 1;  // the end lies in (lo + f * stride,
        lo += (int64_t)f * stride;      //  lo + (f + 1) * stride]
        if (stride == 1) break;
        stride /= 32;
      } else {
        lo += 32 * stride;
        if (stride < (int64_t)1 << 25) stride *= 32;
      }
    }
    const int64_t b = lo + 1 < a.N ? lo + 1 : a.N;
    if (lane == 0) {
      const int64_t n = (b - 1 + ph) / kChunk - c;
      const int64_t i = n <= kShort ? atomicAdd(a.n_runs, 1)
          : a.n_chunks - 1 - atomicAdd(a.n_runs + 1, 1);
      a.runs[3 * i] = row;
      a.runs[3 * i + 1] = (int32_t)(s + ja);
      a.runs[3 * i + 2] = (int32_t)b;
    }
  }
  __syncwarp();
}

// Kernel 2, kCtasPerSm CTAs an SM for the whole call: every warp takes
// its share of the chunks (chunk_job), then of the untouched rows
// (zero_rows).  The chunks' gathers go first, while the memory is free of
// the zero stores: reads issued under a saturated write stream wait far
// longer, and the stores then wait for them.
template <int V, bool BF16>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bag_bwd_rows(const Args a) {
  __shared__ int32_t stash[kWarps][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t nw = (int64_t)gridDim.x * kWarps;
  const int64_t ph = phase_of(a);
  for (int64_t c = w; c < a.n_chunks; c += nw)
    chunk_job<V, BF16>(a, ph, c, lane, stash[warp], stash[warp] + 32);
  zero_rows(a, lane, w, nw);
}

// A run across chunks [lo, hi) of `row`, V columns from `col`: the tail
// piece of its first chunk plus the head pieces of the following chunks,
// in chunk order, loads 8 heads ahead; one group.
template <int V, bool BF16>
__device__ void fold_short(const Args& a, int64_t ph, int64_t row,
                           int64_t lo, int64_t hi, int64_t col) {
  const int64_t c0 = (lo + ph) / kChunk, c1 = (hi - 1 + ph) / kChunk;
  float acc[V];
  load_vec<V>(a.tail + c0 * a.D + col, acc);
  for (int64_t c = c0 + 1; c <= c1; c += 8) {
    float h[8][V];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c + u <= c1) load_vec<V>(a.head + (c + u) * a.D + col, h[u]);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c + u <= c1) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += h[u][i];
      }
    }
  }
  store_row<V, BF16>(a.d_table, row * a.D + col, acc);
}

// Heads base + u * groups + g (u < F) up to c1, V columns from `col`.
template <int V, int F>
__device__ __forceinline__ void load_heads(const Args& a, int64_t base,
                                           int64_t c1, int groups, int g,
                                           bool cv, int64_t col,
                                           float (*x)[V]) {
#pragma unroll
  for (int u = 0; u < F; ++u) {
    const int64_t c = base + (int64_t)u * groups + g;
    if (cv && c <= c1) {
      load_vec<V>(a.head + c * a.D + col, x[u]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[u][i] = 0.0f;
    }
  }
}

// The same for a long run, by the whole warp: its heads are prefetched
// into L2 at once; lane group g loads heads base + u * groups + g of each
// batch of kF * groups, stages them in `stage` (this warp's 1,024 floats)
// in chunk order while the next batch is in flight, and group 0 adds
// them in order from there, 8 loads ahead.
template <int V, bool BF16>
__device__ void fold_long(const Args& a, int64_t ph, int64_t row, int64_t lo,
                          int64_t hi, int lane, float* stage) {
  constexpr int kF = 32 / V;
  const int groups = 32 / a.lanes, g = lane / a.lanes, gl = lane % a.lanes;
  const int64_t c0 = (lo + ph) / kChunk, c1 = (hi - 1 + ph) / kChunk;
  const int64_t K = (int64_t)kF * groups;
  const int W = a.lanes * V;                     // floats of a head slice
  const char* p0 = reinterpret_cast<const char*>(a.head + (c0 + 1) * a.D);
  const int64_t span = (c1 - c0) * a.D * 4;
  for (int64_t off = (int64_t)lane * 128; off < span; off += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p0 + off));
  for (int64_t col0 = 0; col0 < a.D; col0 += W) {
    const int64_t col = col0 + (int64_t)gl * V;
    const bool cv = g < groups && col < a.D;
    float acc[V], h[kF][V], hn[kF][V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    if (cv) load_vec<V>(a.tail + c0 * a.D + col, acc);
    load_heads<V, kF>(a, c0 + 1, c1, groups, g, cv, col, h);
    for (int64_t base = c0 + 1; base <= c1; base += K) {
      if (base + K <= c1)
        load_heads<V, kF>(a, base + K, c1, groups, g, cv, col, hn);
      if (cv) {
#pragma unroll
        for (int u = 0; u < kF; ++u) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            stage[(u * groups + g) * W + gl * V + i] = h[u][i];
        }
      }
      __syncwarp();
      if (g == 0 && cv) {
        const int n = (int)(c1 - base + 1 < K ? c1 - base + 1 : K);
        int j = 0;
        for (; j + 8 <= n; j += 8) {
          float x[8][V];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
#pragma unroll
            for (int i = 0; i < V; ++i)
              x[q][i] = stage[(j + q) * W + gl * V + i];
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] += x[q][i];
          }
        }
        for (; j < n; ++j) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += stage[j * W + gl * V + i];
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kF; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) h[u][i] = hn[u][i];
      }
    }
    if (g == 0 && cv) store_row<V, BF16>(a.d_table, row * a.D + col, acc);
  }
}

// Kernel 3: the runs across chunks that kernel 2 listed, short ones a
// group each, long ones a warp each.
template <int V, bool BF16>
__global__ void __launch_bounds__(kThreads)
bag_bwd_fold(const Args a) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / a.lanes, g = lane / a.lanes, gl = lane % a.lanes;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t ph = phase_of(a);
  const int64_t n_short = __ldg(a.n_runs), n_long = __ldg(a.n_runs + 1);
  if (g < groups) {
    for (int64_t i = warp * groups + g; i < n_short; i += nwarps * groups) {
      const int32_t* r = a.runs + 3 * i;
      for (int64_t col = (int64_t)gl * V; col < a.D;
           col += (int64_t)a.lanes * V)
        fold_short<V, BF16>(a, ph, __ldg(r), __ldg(r + 1), __ldg(r + 2), col);
    }
  }
  __shared__ float stage[kWarps][1024];
  __syncwarp();
  for (int64_t i = warp; i < n_long; i += nwarps) {
    const int32_t* r = a.runs + 3 * (a.n_chunks - 1 - i);
    fold_long<V, BF16>(a, ph, __ldg(r), __ldg(r + 1), __ldg(r + 2), lane,
                       stage[threadIdx.x >> 5]);
  }
}

template <int V, bool BF16>
cudaError_t run(const Args& a, int64_t sms, cudaStream_t stream) {
  bag_bwd_rows<V, BF16><<<(unsigned)(sms * kCtasPerSm), kThreads, 0,
                          stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_chunks == 0) return err;
  int64_t fgrid = (a.n_chunks + kThreads - 1) / kThreads;
  if (fgrid > sms * 4) fgrid = sms * 4;
  bag_bwd_fold<V, BF16><<<(unsigned)fgrid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Before the plan's sort: the sort keys, the bags by position and (a
// window) the count below it; see bag_bwd_keys.
extern "C" int embedding_bag_backward_keys(
    const int32_t* indices, const int32_t* offsets, int64_t N, int64_t B,
    int64_t R, int64_t row_lo, int64_t row_hi, int32_t* key,
    int32_t* bag_of, int32_t* counts, uint32_t* touched, int64_t words,
    cudaStream_t stream) {
  if (N < 0 || B < 0 || N > 2147483647 || R < 1 || R > 2147483646 ||
      row_lo < 0 || row_lo > row_hi || row_hi > R ||
      words != (row_hi - row_lo + 31) / 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, 8, stream);
  if (err != cudaSuccess) return (int)err;
  int64_t grid = (N + kKeys - 1) / kKeys;
  const int64_t clear = (words + 16 * kThreads - 1) / (16 * kThreads);
  if (grid < clear) grid = clear;
  if (grid < 1) grid = 1;
  bag_bwd_keys<<<(unsigned)grid, kThreads, 0, stream>>>(
      indices, offsets, N, B, R, row_lo, row_hi, key, bag_of, counts,
      touched, words);
  return (int)cudaGetLastError();
}

extern "C" int embedding_bag_backward_launch(
    const float* grad_out, int64_t B, int64_t D, const int32_t* offsets,
    const int32_t* key, const int64_t* perm, const int32_t* below,
    const int32_t* uneven, int64_t N, int64_t R, int64_t mean,
    int64_t out_bf16, int64_t vec, int64_t lanes, int64_t sms,
    int32_t* bag_of, int32_t* sbag, uint32_t* touched, float* head,
    float* tail, int32_t* runs, int32_t* n_runs, void* d_table,
    cudaStream_t stream) {
  if (R <= 0 || D <= 0) return 0;
  const int64_t esize = out_bf16 ? 2 : 4;
  const int64_t n_chunks =
      N > 0 ? (N + kChunk - 1) / kChunk + (below ? 1 : 0) : 0;
  if (B < 0 || N < 0 || N > 2147483647 || R > 2147483646 ||
      D * esize > (1 << 20) || (vec != 1 && vec != 2 && vec != 4) ||
      D % vec != 0 ||
      reinterpret_cast<uintptr_t>(grad_out) % (4 * vec) != 0 ||
      reinterpret_cast<uintptr_t>(d_table) % 16 != 0 ||
      lanes != ((D + vec - 1) / vec < 32 ? (D + vec - 1) / vec : 32) ||
      sms < 1 || sms > 4096)
    return (int)cudaErrorInvalidValue;
  int seg_shift = -1;
  if ((D * esize) % 16 == 0)
    for (int sh = 0; sh < 31 && seg_shift < 0; ++sh)
      if ((int64_t)16 << sh == D * esize) seg_shift = sh;
  const Args a{grad_out, offsets, key, perm, below, uneven, bag_of, sbag,
               touched, head, tail, runs, n_runs, d_table, N, R, D, n_chunks,
               (int)mean, (int)lanes, (int)esize, seg_shift};
  // 1: the bags by sorted entry and the touched bits (cleared by kernel 0)
  cudaError_t err = cudaSuccess;
  if (N > 0) {
    const int64_t ggrid = (N + kThreads - 1) / kThreads;
    bag_bwd_gather<<<(unsigned)(ggrid < sms * 16 ? ggrid : sms * 16),
                     kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // 2 and 3
  if (out_bf16) {
    if (vec == 4) return (int)run<4, true>(a, sms, stream);
    if (vec == 2) return (int)run<2, true>(a, sms, stream);
    return (int)run<1, true>(a, sms, stream);
  }
  if (vec == 4) return (int)run<4, false>(a, sms, stream);
  if (vec == 2) return (int)run<2, false>(a, sms, stream);
  return (int)run<1, false>(a, sms, stream);
}
