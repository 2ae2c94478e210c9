// The frozen-segment walk shared by segment_intersect.cu (membership) and
// scored_intersect.cu (membership + impact sum + the block-max skip): one
// templated device function, `frozen_walk<Scored>`, that both kernels run.
//
// Lists are block-gap-compressed (128 docids a block; a block's gaps are
// bw = 1, 2 or 4 bytes each, packed little-endian into int64 words that
// hold uint32 values).  A warp owns one a-block at a time; lane i owns
// its docids 4i .. 4i+3 and reads exactly the payload words that hold
// their four gaps (one word at bw 1, two at bw 2, four at bw 4), sums
// them in registers and finishes the block's inclusive scan with five
// `__shfl_up_sync` steps (uint32, wrapping mod 2**32 as the reference's
// cumsum does).  No CTA barrier is ever taken: every step is warp-wide.
//
// Work items.  A dense row (b has at most two blocks per live a-block)
// is cut into strips of `kStrip` consecutive a-blocks; a sparse row gives
// each live a-block an item of its own, or four items (a quarter of its
// lanes each) when b has more than `kSplitRatio` blocks a live a-block,
// and shares its pad blocks among the remaining items.  A call with
// fewer strips than the grid has warps takes single a-blocks instead
// (`plan_for`).  Items are row-minor and handed out in rounds over the
// warps of a grid sized to the card, so every row's first items (the
// sparse rows' whole work) start in the first round, and no CTA exists
// only to write a pad block.  An item's a-block entries are read in one
// round and their payload lines prefetched into the L2.
//
// Per live a-block:
//   * when every valid docid lies in the range of the b-block the warp
//     decoded last ([its first docid, the next block's)), that block is
//     the one run and nothing else is read;
//   * else the smallest and largest valid docids bound the b-blocks it
//     can touch; their positions in b's ascending `firsts` come from one
//     probe of the 32 entries where the warp's previous a-block of the
//     item ended (issued with the a-block's payload loads; it also reads
//     those blocks' entries), else from a 32-way search (each lane
//     probes one of 32 evenly spaced entries, a ballot narrows the
//     range);
//   * the window's block entries are staged in shared memory (from the
//     probe, or in one round, the few blocks of a narrow window then
//     prefetched into the L2), and each docid finds its b-block there;
//     a window wider than a block stages one entry in 128 and each docid
//     finishes in device memory.  A docid's block is the last one whose
//     first docid is <= x, capped at the last block with a real lane,
//     none when x is below b's first;
//   * the distinct b-blocks the docids need form runs of consecutive
//     positions; the warp visits them in ascending order with the next
//     `kRing - 1` runs' payload words on their way into a per-warp ring
//     in shared memory (`cp.async`), decodes each block with the warp
//     decode above, and keeps the last decoded block for the next run or
//     a-block that needs it;
//   * a run of at most `kBallotMax` docids is matched by broadcasting
//     each docid and one ballot over the decoded block; a longer run
//     searches the block staged in shared memory (first position >= x,
//     clamped to 127) for a lane's four docids at once.
// Lanes at or past `ns[r]`, and docids equal to INVALID, give 0; lanes of
// b past `b.ns` are INVALID; an out-of-range payload word reads 0.  A pad
// a-block (first lane at or past `ns[r]`) and, scored, a skipped one
// (`a_bmax + rest <= th` in wrapping int32, tested before any payload,
// score or b read) write zeros.  Each lane stores its four results with
// one 16-byte store.  For ascending lists (what `pack_docids` makes) the
// results are the plain versions', bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;                  // docids per block
constexpr int kWarps = 4;                  // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kStrip = 4;                  // a-blocks per dense-row item
constexpr int kBallotMax = 2;              // longest run matched by ballot
constexpr int kRing = 4;                   // b-blocks in the payload ring
constexpr int kPrefetchWindow = 8;         // windows prefetched to the L2
constexpr int kSplit = 4;                  // items per very sparse a-block
constexpr int kSplitRatio = 16;            // b-blocks a live a-block
constexpr int kScoreWords = kSeg / 4;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One side's stacked lists, rows of `nb` block entries and `pw` words.
struct SegLists {
  const int64_t* firsts;
  const int32_t* bws;
  const int32_t* woffs;
  const int64_t* pay;
  const int32_t* ns;
  const int64_t* sw;     // scored: 32 score words per block
  const int32_t* bmax;   // scored: per-block max impact
  int64_t nb, pw;
};

// Per-warp scratch in shared memory.
template <bool Scored>
struct alignas(16) WarpSmem {
  int64_t ring[kRing][kSeg];   // b payload words, lane l's at 4l .. 4l+3
  uint32_t ring_sw[Scored ? kRing : 1][kScoreWords];  // its score words
  uint32_t ent_f[kSeg + 4];    // staged block entries of the window
  int ent_bw[kSeg + 4];
  int ent_wo[kSeg + 4];
  uint32_t bv[kSeg];           // a decoded b-block, for searched runs
  uint32_t bsw[kScoreWords];   // its score words
  int run_j[kSeg];             // each run's b-block
  int run_p[kSeg + 4];         // each run's first position, then 128
  uint32_t run_f[kSeg];        // each run's block entry
  int run_bw[kSeg];
  int run_wo[kSeg];
};

__device__ __forceinline__ int64_t word_at(const int64_t* row, int64_t pw,
                                           int64_t i) {
  return (i >= 0 && i < pw) ? __ldg(row + i) : 0;
}

__device__ __forceinline__ void pair_at(const int64_t* row, int64_t pw,
                                        int64_t i, int64_t& w0,
                                        int64_t& w1) {
  if (i >= 0 && i + 1 < pw &&
      (reinterpret_cast<uintptr_t>(row + i) & 15) == 0) {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(row + i));
    w0 = v.x;
    w1 = v.y;
  } else {
    w0 = word_at(row, pw, i);
    w1 = word_at(row, pw, i + 1);
  }
}

// The payload words that hold lane `lane`'s four gaps (docids 4 lane ..
// 4 lane + 3) of a block at word `woff`; any width but 1 or 2 reads
// whole words, as the reference does.
__device__ __forceinline__ void load_words(const int64_t* row, int64_t pw,
                                           int32_t woff, int32_t bw,
                                           int lane, int64_t (&w)[4]) {
  const int64_t base = (int64_t)woff;
  w[1] = w[2] = w[3] = 0;
  if (bw == 1) {
    w[0] = word_at(row, pw, base + lane);
  } else if (bw == 2) {
    pair_at(row, pw, base + 2 * lane, w[0], w[1]);
  } else {
    pair_at(row, pw, base + 4 * lane, w[0], w[1]);
    pair_at(row, pw, base + 4 * lane + 2, w[2], w[3]);
  }
}

// Lane `lane`'s four docids: `first` plus the block's inclusive scan of
// its gaps (uint32, wrapping).
__device__ __forceinline__ void decode4(uint32_t first, int32_t bw,
                                        const int64_t (&w)[4], int lane,
                                        uint32_t (&x)[4]) {
  uint32_t g[4];
  if (bw == 1) {
    const uint32_t v = (uint32_t)w[0];
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] = (v >> (8 * k)) & 0xFFu;
  } else if (bw == 2) {
    const uint32_t v0 = (uint32_t)w[0], v1 = (uint32_t)w[1];
    g[0] = v0 & 0xFFFFu;
    g[1] = v0 >> 16;
    g[2] = v1 & 0xFFFFu;
    g[3] = v1 >> 16;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] = (uint32_t)w[k];
  }
  const uint32_t s0 = g[0], s1 = s0 + g[1], s2 = s1 + g[2], s3 = s2 + g[3];
  uint32_t inc = s3;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += t;
  }
  const uint32_t base = first + (inc - s3);
  x[0] = base + s0;
  x[1] = base + s1;
  x[2] = base + s2;
  x[3] = base + s3;
}

template <typename T>
__device__ __forceinline__ T sel4(const T (&v)[4], int e) {
  return e == 0 ? v[0] : e == 1 ? v[1] : e == 2 ? v[2] : v[3];
}

// One round of the 32-way search for U(x) = #{i : f[i] <= x} over an
// ascending row, U known to lie in [lo, lo + len]: lane l probes the
// last entry of the l-th of 32 equal steps.  Rounds on len <= 32 are
// left to `search_last`.
__device__ __forceinline__ void search_round(const int64_t* f, uint32_t x,
                                             int lane, int64_t& lo,
                                             int64_t& len) {
  if (len <= 32) return;
  const int64_t step = (len + 31) >> 5;
  const int64_t idx = lo + (int64_t)(lane + 1) * step - 1;
  const bool le = idx < lo + len && (uint32_t)__ldg(f + idx) <= x;
  const int64_t c = __popc(__ballot_sync(kFull, le));
  const int64_t hi = min(lo + (c + 1) * step - 1, lo + len);
  lo += c * step;
  len = hi - lo;
}

__device__ __forceinline__ int64_t search_last(const int64_t* f, uint32_t x,
                                               int lane, int64_t lo,
                                               int64_t len) {
  const bool le = lane < len && (uint32_t)__ldg(f + lo + lane) <= x;
  return lo + __popc(__ballot_sync(kFull, le));
}

// U(x0) and U(x1) over the row's `n` firsts.  With a hint h > 0 (where
// the warp's previous a-block of this row ended, so h <= U(x0)), or when
// the row is short, one probe of the 32 entries from h - 1 settles a key
// whose U lies inside it; the others take the full 32-way search.
__device__ __forceinline__ void upper2(const int64_t* f, int64_t n,
                                       uint32_t x0, uint32_t x1, int64_t h,
                                       int lane, int64_t& u0, int64_t& u1) {
  int64_t lo0 = 0, len0 = n, lo1 = 0, len1 = n;
  if (h > 0 || n <= 31) {
    const int64_t i = h - 1 + lane;
    const uint32_t fv =
        i < 0 ? 0u : (i < n ? (uint32_t)__ldg(f + i) : kInvalid);
    const int c0 = __popc(__ballot_sync(kFull, fv <= x0));
    const int c1 = __popc(__ballot_sync(kFull, fv <= x1));
    if (c0 >= 1 && c0 < 32) { lo0 = h - 1 + c0; len0 = 0; }
    if (c1 >= 1 && c1 < 32) { lo1 = h - 1 + c1; len1 = 0; }
  }
  while (len0 > 32 || len1 > 32) {
    search_round(f, x0, lane, lo0, len0);
    search_round(f, x1, lane, lo1, len1);
  }
  u0 = len0 > 0 ? search_last(f, x0, lane, lo0, len0) : lo0;
  u1 = len1 > 0 ? search_last(f, x1, lane, lo1, len1) : lo1;
}

// #{i < 128 : s[i] <= x} over an ascending staged window (sentinels
// INVALID, above every valid docid), for a lane's four docids at once.
__device__ __forceinline__ void count_le128x4(const uint32_t* s,
                                              const uint32_t (&x)[4],
                                              int (&c)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = 0;
#pragma unroll
  for (int step = 64; step >= 1; step >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] += s[c[k] + step - 1] <= x[k] ? step : 0;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] += c[k] == kSeg - 1 && s[kSeg - 1] <= x[k];
}

// min(first position with s[i] >= x, 127) over an ascending block, for
// a lane's four docids at once (their seven steps interleaved).
__device__ __forceinline__ void lower127x4(const uint32_t* s,
                                           const uint32_t (&x)[4],
                                           int (&c)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = 0;
#pragma unroll
  for (int step = 64; step >= 1; step >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] += s[c[k] + step - 1] < x[k] ? step : 0;
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;     // 0: zero-fill, nothing read
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The words of one block that hold lane `lane`'s gaps: their first index
// and count (any width but 1 or 2 reads four whole words).
__device__ __forceinline__ int lane_words(int32_t woff, int32_t bw, int lane,
                                          int64_t& first) {
  const int n = bw == 1 ? 1 : bw == 2 ? 2 : 4;
  first = (int64_t)woff + (int64_t)n * lane;
  return n;
}

// Start copying run q's payload words (and, scored, its lane's score
// word) into ring slot q % kRing; one commit group per run, empty when
// the run reuses the block decoded before it.
template <bool Scored>
__device__ __forceinline__ void fetch_run(const SegLists& B, int64_t r,
                                          WarpSmem<Scored>& sm, int q,
                                          bool need, int lane) {
  if (need) {
    const int slot = q % kRing;
    const int64_t* row = B.pay + r * B.pw;
    int64_t i0;
    const int n = lane_words(sm.run_wo[q], sm.run_bw[q], lane, i0);
    for (int k = 0; k < n; ++k) {
      const int64_t i = i0 + k;
      const bool ok = i >= 0 && i < B.pw;
      cp_async(&sm.ring[slot][4 * lane + k], ok ? row + i : row, 8, ok);
    }
    if (Scored)
      cp_async(&sm.ring_sw[slot][lane],
               B.sw + (r * B.nb + sm.run_j[q]) * kScoreWords + lane, 4, true);
  }
  cp_commit();
}

// The a-blocks [b, e) of item (row r, part s), and the quarter of lanes
// [l0, l1) whose docids it owns.  `live` a-blocks hold a real lane.  A
// row is sparse when b's blocks outnumber twice its live a-blocks and
// there are parts to spare: part s < live (times `kSplit` when b has
// more than `kSplitRatio` blocks a live a-block, so each docid needs a
// block of its own) is one a-block, or one quarter of one, and the later
// parts share the pad blocks; a dense row is cut into strips.
__device__ __forceinline__ void item_blocks(uint32_t s, uint32_t nba,
                                            uint32_t parts, uint32_t strip,
                                            int64_t na,
                                            int64_t nbv, uint32_t& b,
                                            uint32_t& e, int& l0, int& l1) {
  const uint32_t live = (uint32_t)min((max(na, (int64_t)0) + kSeg - 1) >> 7,
                                      (int64_t)nba);
  const int64_t bblocks = (max(nbv, (int64_t)0) + kSeg - 1) >> 7;
  const uint32_t g = bblocks > kSplitRatio * (int64_t)live &&
                             2 * kSplit * (int64_t)live <= parts
                         ? kSplit : 1;
  l0 = 0;
  l1 = 32;
  if (bblocks > 2 * (int64_t)live && 2 * (int64_t)live * g <= parts) {
    const uint32_t used = live * g;
    if (s < used) {
      b = s / g;
      e = b + 1;
      l0 = (int)(s % g) * (32 / kSplit) * (kSplit / g);
      l1 = g == 1 ? 32 : l0 + 32 / kSplit;
    } else {
      const uint32_t per = (nba - live + (parts - used) - 1) / (parts - used);
      b = (uint32_t)min((uint64_t)live + (uint64_t)(s - used) * per,
                        (uint64_t)nba);
      e = min(b + per, nba);
    }
  } else {
    b = (uint32_t)min((uint64_t)s * strip, (uint64_t)nba);
    e = min(b + strip, nba);
  }
}

template <bool Scored>
__device__ __forceinline__ void frozen_walk(SegLists A, SegLists B,
                                            const int32_t* __restrict__ rest,
                                            const int32_t* __restrict__ th,
                                            int32_t* __restrict__ out,
                                            int64_t rows, int strip,
                                            int64_t parts) {
  __shared__ WarpSmem<Scored> smem[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpSmem<Scored>& sm = smem[warp];
  const int64_t nba = A.nb, nbb = B.nb;
  const int64_t nw = (int64_t)gridDim.x * kWarps;

  // the last decoded b-block (row, index) and its lane values
  int64_t k_row = -1;
  int k_j = -1, s_j = -1;           // s_j: the block staged in sm.bv
  uint32_t kv[4] = {kInvalid, kInvalid, kInvalid, kInvalid};
  uint32_t ksw = 0;
  // the docids that map to the kept block: [k_lo, k_hi) (k_hi 2**32
  // when it is the row's capped last block)
  uint32_t k_lo = 0;
  uint64_t k_hi = 0;

  // Round k hands item t = k nw + (gw + k) mod nw to warp gw: items are
  // row-minor (item t is part t / rows of row t mod rows) and a warp's
  // row changes from round to round even when nw is a multiple of the
  // row count.  t only grows, by nw + 1 (or 1 where (gw + k) mod nw
  // wraps), so its row and part advance by additions.
  const uint32_t nw32 = (uint32_t)nw, rows32 = (uint32_t)rows;
  const uint32_t gw = blockIdx.x * kWarps + warp;
  const uint32_t step_q = (nw32 + 1) / rows32, step_r = (nw32 + 1) % rows32;
  uint32_t m = gw, r32 = gw % rows32, part = gw / rows32;
  for (;; ) {
    if (part >= parts) break;          // t >= items, now and later
    const int64_t r = r32;
    // a small call's (single a-block) item entry, read beside the counts
    // it depends on; a strip's entries wait for the counts, so that pad
    // strips read nothing
    const uint64_t spec_b = strip == 1 ? (uint64_t)part : ~0ull;
    uint32_t pa_f = 0;
    int32_t pa_bw = 1, pa_wo = 0, pa_max = 0;
    if (lane == 0 && spec_b < (uint64_t)nba) {
      const int64_t ablk = r * nba + (int64_t)spec_b + lane;
      pa_f = (uint32_t)A.firsts[ablk];
      pa_bw = A.bws[ablk];
      pa_wo = A.woffs[ablk];
      if (Scored) pa_max = A.bmax[ablk];
    }
    const int64_t na = A.ns[r];
    const int64_t nbv = B.ns[r];
    uint32_t ib32, ie32;
    int l0, l1;
    item_blocks(part, (uint32_t)nba, (uint32_t)parts, (uint32_t)strip, na,
                nbv, ib32, ie32, l0, l1);
    {                                  // the next round's item
      const bool wrap = m + 1 == nw32;
      m = wrap ? 0 : m + 1;
      r32 += wrap ? 1 : step_r;
      part += wrap ? 0 : step_q;
      if (r32 >= rows32) { r32 -= rows32; ++part; }
    }
    const bool own = lane >= l0 && lane < l1;
    const int64_t ib = ib32, ie = ie32;
    const int32_t rest_r = Scored ? rest[r] : 0;
    const int32_t th_r = Scored ? th[r] : 0;
    const int64_t* bf = B.firsts + r * nbb;
    const int64_t jmax = (nbv - 1) / kSeg;
    // the item's live a-blocks' entries, lane i holding block ib + i,
    // and their payload and score lines on their way to the L2
    const int64_t nlive = max(min(ie, (na + kSeg - 1) / kSeg) - ib,
                              (int64_t)0);
    if (lane < nlive) {
      const int64_t ablk = r * nba + ib + lane;
      if ((uint64_t)ib != spec_b) {    // a sparse row's item: read again
        pa_f = (uint32_t)A.firsts[ablk];
        pa_bw = A.bws[ablk];
        pa_wo = A.woffs[ablk];
        if (Scored) pa_max = A.bmax[ablk];
      }
      int64_t i0;
      const int n = lane_words(pa_wo, pa_bw, 0, i0);
      const int64_t lo = max(i0, (int64_t)0);
      const int64_t hi = min(i0 + 32 * n, A.pw);
      for (int64_t i = lo; i < hi; i += 16) prefetch_l2(A.pay + r * A.pw + i);
      if (Scored) {
        prefetch_l2(A.sw + ablk * kScoreWords);
        prefetch_l2(A.sw + ablk * kScoreWords + 16);
      }
    }
    int64_t hint = 0;                  // U of the previous a-block's max
    for (int64_t ia = ib; ia < ie; ++ia) {
      const int64_t ablk = r * nba + ia;
      int4* o = reinterpret_cast<int4*>(out + ablk * kSeg) + lane;
      bool live = ia * kSeg < na;
      const int src = (int)(ia - ib) & 31;
      if (Scored && live) {
        // the WAND bound in int32 arithmetic, wrapping like the reference
        const int32_t bmax = ia - ib < 32 ? __shfl_sync(kFull, pa_max, src)
                                          : A.bmax[ablk];
        const int32_t bound = (int32_t)((uint32_t)bmax + (uint32_t)rest_r);
        live = bound > th_r;
      }
      if (!live) {                     // uniform over the warp
        if (own) *o = make_int4(0, 0, 0, 0);
        continue;
      }
      // the probe's loads (where the previous a-block ended, or a short
      // row's start) go out with the a-block's payload: they do not
      // depend on its docids
      const int64_t h = hint;
      uint32_t pf = kInvalid;
      int32_t pbw = 0, pwo = 0;
      const bool probe = (h > 0 || nbb <= 31) && nbv > 0;
      if (probe) {
        const int64_t i = h - 1 + lane;
        const bool in = i >= 0 && i < nbb;
        pf = i < 0 ? 0u : (in ? (uint32_t)__ldg(bf + i) : kInvalid);
        if (in) {
          pbw = B.bws[r * nbb + i];
          pwo = B.woffs[r * nbb + i];
        }
      }
      uint32_t a_first = __shfl_sync(kFull, pa_f, src);
      int32_t a_bw = __shfl_sync(kFull, pa_bw, src);
      int32_t a_wo = __shfl_sync(kFull, pa_wo, src);
      if (ia - ib >= 32) {
        a_first = (uint32_t)A.firsts[ablk];
        a_bw = A.bws[ablk];
        a_wo = A.woffs[ablk];
      }
      int64_t w[4];
      load_words(A.pay + r * A.pw, A.pw, a_wo, a_bw, lane, w);
      uint32_t asw = 0;
      if (Scored) asw = (uint32_t)__ldg(A.sw + ablk * kScoreWords + lane);
      uint32_t x[4];
      decode4(a_first, a_bw, w, lane, x);
      bool va[4];
      uint32_t mn = kInvalid, mx = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        va[k] = own && ia * kSeg + 4 * lane + k < na && x[k] != kInvalid;
        if (va[k]) { mn = min(mn, x[k]); mx = max(mx, x[k]); }
      }
      int res[4] = {0, 0, 0, 0};
      const bool any = __any_sync(kFull, va[0] || va[1] || va[2] || va[3]);
      if (any && nbv > 0 && nbb > 0) {
        mn = __reduce_min_sync(kFull, mn);
        mx = __reduce_max_sync(kFull, mx);
        int j[4];
        int nruns;
        int64_t e0 = 0;
        if (k_row == r && mn >= k_lo && (uint64_t)mx < k_hi) {
          // every docid maps to the kept block: one run, nothing to load
#pragma unroll
          for (int k = 0; k < 4; ++k) j[k] = va[k] ? k_j : -1;
          hint = (int64_t)k_j + 1;
          nruns = 1;
          __syncwarp();                // earlier readers of the run lists
          if (lane == 0) {
            sm.run_j[0] = k_j;
            sm.run_p[0] = 0;
            sm.run_p[1] = kSeg;
          }
          __syncwarp();
        } else {
          // U(x) = #{i : b.firsts[i] <= x} of the two ends.  With a hint
          // (h <= U(mn)), or a short row, one probe of the 32 entries from
          // h - 1, which also reads their blocks' entries, settles a key
          // whose U lies inside it.
          int64_t lo0 = 0, len0 = nbb, lo1 = 0, len1 = nbb;
          if (probe) {
            const int c0 = __popc(__ballot_sync(kFull, pf <= mn));
            const int c1 = __popc(__ballot_sync(kFull, pf <= mx));
            if (c0 >= 1 && c0 < 32) { lo0 = h - 1 + c0; len0 = 0; }
            if (c1 >= 1 && c1 < 32) { lo1 = h - 1 + c1; len1 = 0; }
          }
          const bool probed = len0 == 0 && len1 == 0;
          while (len0 > 32 || len1 > 32) {
            search_round(bf, mn, lane, lo0, len0);
            search_round(bf, mx, lane, lo1, len1);
          }
          const int64_t ulo = len0 > 0 ? search_last(bf, mn, lane, lo0, len0)
                                       : lo0;
          const int64_t uhi = len1 > 0 ? search_last(bf, mx, lane, lo1, len1)
                                       : lo1;
          hint = uhi;
          // The blocks a docid can need are e0 = ulo - 1 .. uhi - 1.  When
          // they are at most a block's worth, their entries are staged
          // (from the probe's registers, or in one round of loads) for the
          // per-docid count and the visits; else each docid searches
          // b.firsts in device memory.
          const int64_t wn = uhi - ulo;
          e0 = ulo - 1;
          const bool staged = wn < kSeg;
          int64_t u[4] = {ulo, ulo, ulo, ulo};
          __syncwarp();                  // earlier readers of the staging
          if (probed) {
            const int from = (int)(e0 - (h - 1)) + lane;  // in [0, 31]
            const uint32_t f = __shfl_sync(kFull, pf, from & 31);
            const int32_t bw = __shfl_sync(kFull, pbw, from & 31);
            const int32_t wo = __shfl_sync(kFull, pwo, from & 31);
            const bool in = lane <= wn && e0 + lane >= 0;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int i = lane + 32 * m;
              sm.ent_f[i] = m == 0 && in ? f : kInvalid;
              sm.ent_bw[i] = m == 0 && in ? bw : 0;
              sm.ent_wo[i] = m == 0 && in ? wo : 0;
            }
          } else if (staged) {
            uint32_t ef[4];
            int32_t eb[4], ew[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int i = lane + 32 * m;
              const int64_t blk = e0 + i;
              const bool in = i <= wn && blk >= 0;
              ef[m] = in ? (uint32_t)__ldg(bf + blk) : kInvalid;
              eb[m] = in ? B.bws[r * nbb + blk] : 0;
              ew[m] = in ? B.woffs[r * nbb + blk] : 0;
            }
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int i = lane + 32 * m;
              sm.ent_f[i] = ef[m];
              sm.ent_bw[i] = eb[m];
              sm.ent_wo[i] = ew[m];
            }
          }
          if (lane == 0) sm.ent_f[kSeg] = kInvalid;
          if (staged && wn < kPrefetchWindow && lane <= wn && e0 + lane >= 0) {
            // the few blocks a dense a-block can need: payload (and score)
            // lines on their way to the L2 before the runs are known
            int64_t i0;
            const int n = lane_words(sm.ent_wo[lane], sm.ent_bw[lane], 0, i0);
            const int64_t lo = max(i0, (int64_t)0);
            const int64_t hi = min(i0 + 32 * n, B.pw);
            for (int64_t i = lo; i < hi; i += 16)
              prefetch_l2(B.pay + r * B.pw + i);
            if (Scored)
              prefetch_l2(B.sw + (r * nbb + e0 + lane) * kScoreWords);
          }
          __syncwarp();
          if (staged) {
            if (wn > 0) {
              int c[4];
              count_le128x4(sm.ent_f + 1, x, c);
#pragma unroll
              for (int k = 0; k < 4; ++k) u[k] = ulo + c[k];
            }
          } else {
            // 128 equal parts of the window, part i = [P(i), P(i + 1)) with
            // P(i) = i wn / 128: stage each part's last entry, count the
            // parts a docid passes, then lift inside its part
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int i = lane + 32 * m;
              sm.ent_f[i] =
                  (uint32_t)__ldg(bf + ulo + (((i + 1) * wn) >> 7) - 1);
            }
            __syncwarp();
            int64_t c[4], len[4];
            int64_t longest = 0;
            int pk[4];
            count_le128x4(sm.ent_f, x, pk);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int part_k = pk[k];
              c[k] = (part_k * wn) >> 7;
              len[k] = part_k < kSeg ? (((part_k + 1) * wn) >> 7) - 1 - c[k]
                                     : 0;
              longest = max(longest, len[k]);
            }
            int64_t top = 1;
            while (top * 2 <= longest) top *= 2;
            int64_t add[4] = {0, 0, 0, 0};
            for (int64_t step = top; step >= 1 && longest > 0; step >>= 1) {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (add[k] + step <= len[k] &&
                    (uint32_t)__ldg(bf + ulo + c[k] + add[k] + step - 1) <=
                        x[k])
                  add[k] += step;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) u[k] = ulo + c[k] + add[k];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            j[k] = va[k] ? (int)min(u[k] - 1, jmax) : -1;
          // runs: maximal stretches of positions that need one b-block
          int prev = __shfl_up_sync(kFull, j[3], 1);
          if (lane == 0) prev = INT_MIN;
          bool st[4];
          int cnt = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            st[k] = j[k] >= 0 && j[k] != (k == 0 ? prev : j[k - 1]);
            cnt += st[k];
          }
          int inc = cnt;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(kFull, inc, off);
            if (lane >= off) inc += v;
          }
          nruns = __shfl_sync(kFull, inc, 31);
          int pos = inc - cnt;
          // each run's block and entry (staged, or read here: a block
          // outside the staged range, or a window wider than a block)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (st[k]) {
              const int64_t i = j[k] - e0;
              const int64_t bblk = r * nbb + j[k];
              const bool have = staged && i >= 0 && i <= wn;
              sm.run_j[pos] = j[k];
              sm.run_p[pos] = 4 * lane + k;
              sm.run_f[pos] = have ? sm.ent_f[i] : (uint32_t)B.firsts[bblk];
              sm.run_bw[pos] = have ? sm.ent_bw[i] : B.bws[bblk];
              sm.run_wo[pos] = have ? sm.ent_wo[i] : B.woffs[bblk];
              ++pos;
            }
          if (lane == 31) sm.run_p[nruns] = kSeg;
          __syncwarp();
        }
        // need(q): run q's block is not the one decoded before it
        auto need = [&](int q) {
          return q < nruns &&
                 (q == 0 ? !(k_row == r && k_j == sm.run_j[0])
                         : sm.run_j[q] != sm.run_j[q - 1]);
        };
#pragma unroll
        for (int q = 0; q < kRing - 1; ++q)
          fetch_run<Scored>(B, r, sm, q, need(q), lane);
        for (int s = 0; s < nruns; ++s) {
          fetch_run<Scored>(B, r, sm, s + kRing - 1, need(s + kRing - 1),
                            lane);
          cp_wait<kRing - 1>();        // run s's words have landed
          const int J = sm.run_j[s];
          if (need(s)) {
            const int slot = s % kRing;
            const longlong2* lw =
                reinterpret_cast<const longlong2*>(&sm.ring[slot][4 * lane]);
            const longlong2 w01 = lw[0], w23 = lw[1];
            const int64_t bw_[4] = {w01.x, w01.y, w23.x, w23.y};
            uint32_t v[4];
            decode4(sm.run_f[s], sm.run_bw[s], bw_, lane, v);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              kv[k] = (int64_t)J * kSeg + 4 * lane + k < nbv ? v[k]
                                                             : kInvalid;
            if (Scored) ksw = sm.ring_sw[Scored ? slot : 0][lane];
            k_row = r;
            k_j = J;
            s_j = -1;
            k_lo = sm.run_f[s];
            k_hi = J >= jmax || J + 1 >= nbb ? (1ull << 32)
                                              : (uint32_t)__ldg(bf + J + 1);
          }
          const int p0 = sm.run_p[s], p1 = sm.run_p[s + 1];
          if (p1 - p0 <= kBallotMax) {
            for (int p = p0; p < p1; ++p) {
              const int src_l = p >> 2, e = p & 3;
              const uint32_t xp = __shfl_sync(kFull, sel4(x, e), src_l);
              const int jp = __shfl_sync(kFull, sel4(j, e), src_l);
              if (jp != J) continue;   // uniform: an invalid lane
              const bool eq[4] = {kv[0] == xp, kv[1] == xp, kv[2] == xp,
                                  kv[3] == xp};
              const unsigned m =
                  __ballot_sync(kFull, eq[0] || eq[1] || eq[2] || eq[3]);
              if (m == 0) continue;
              const int hl = __ffs(m) - 1;
              int val = 1;
              if (Scored) {
                const int he = eq[0] ? 0 : eq[1] ? 1 : eq[2] ? 2 : 3;
                const int bimp = __shfl_sync(
                    kFull, (int)((ksw >> (8 * he)) & 0xFFu), hl);
                const int aimp = (int)((asw >> (8 * e)) & 0xFFu);
                val = bimp > 0 ? aimp + bimp : 0;
              }
              if (lane == src_l) {
                if (e == 0) res[0] = val;
                else if (e == 1) res[1] = val;
                else if (e == 2) res[2] = val;
                else res[3] = val;
              }
            }
          } else {
            if (s_j != J) {
              __syncwarp();            // earlier searches of sm.bv
              reinterpret_cast<uint4*>(sm.bv)[lane] =
                  make_uint4(kv[0], kv[1], kv[2], kv[3]);
              if (Scored) sm.bsw[lane] = ksw;
              s_j = J;
              __syncwarp();
            }
            int lo[4];
            lower127x4(sm.bv, x, lo);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (j[k] == J && sm.bv[lo[k]] == x[k]) {
                if (Scored) {
                  const int bimp = (int)((sm.bsw[lo[k] >> 2] >>
                                          (8 * (lo[k] & 3))) & 0xFFu);
                  const int aimp = (int)((asw >> (8 * k)) & 0xFFu);
                  res[k] = bimp > 0 ? aimp + bimp : 0;
                } else {
                  res[k] = 1;
                }
              }
          }
        }
        cp_wait<0>();                  // no copy outlives its run list
      }
      if (own) *o = make_int4(res[0], res[1], res[2], res[3]);
    }
  }
}

// The launch plan: a persistent grid of as many CTAs as the card keeps
// resident (read once per device and kernel), at most one warp per work
// item; dense-row items are strips of kStrip a-blocks, or single
// a-blocks (with parts to spare for quarter splits) when the call has
// fewer strips than the grid has warps.
struct Plan {
  int grid, strip;
  int64_t parts;
};

template <typename Kernel>
__host__ inline Plan plan_for(Kernel kernel, int64_t rows, int64_t nba) {
  static int cached_dev = -1, cached_full = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    cached_full = sms * (per_sm > 0 ? per_sm : 1);
    cached_dev = dev;
  }
  const int64_t warps = (int64_t)cached_full * kWarps;
  Plan p{0, kStrip, (nba + kStrip - 1) / kStrip};
  if (rows * p.parts < warps) {
    p.strip = 1;
    p.parts = rows * nba * kSplit <= warps ? nba * kSplit : nba;
  }
  const int64_t need = (rows * p.parts + kWarps - 1) / kWarps;
  p.grid = (int)(need < cached_full ? need : cached_full);
  return p;
}

}  // namespace
