// Decode attention through a page table (paged-KV serving hot path).
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (`_kernel`), which walked one
// sequence's pages with double-buffered HBM->VMEM DMAs, one grid step
// per (sequence, KV head).  The oracle is `paged_attention_ref` in
// src/repro/kernels/ref.py; this kernel computes what the oracle
// computes:
//
//     out[b, h, g] = softmax_t(q[b, h, g] . K[h, slot(b, t)] * D^-0.5)
//                    . V[h, slot(b, t)]      over t < lengths[b]
//
// where slot(b, t) = page_table[b, t / 64] * 64 + t % 64 (a -1 pad page
// reads page 0, as the oracle's clamp does), and a row with length 0
// gives 0.  The walk covers min(ceil(len / 64), NP) pages: the oracle
// sees only the table's NP pages.
//
// Bound on an H100: memory.  The K and V pages each row walks are read
// once (TinyLlama serving: 32 sequences x 4 KV heads x 2048 tokens x 64
// x 2 bytes x 2 = 67 MB, 0.020 ms at 3.35 TB/s); the arithmetic is 4 G D
// flops per token, far below the card's ridge.
//
// The first port (one CTA of 128 threads per (b, h), pages widened to
// fp32 in shared memory, four barriers per page: 128 CTAs on 132 SMs, 4
// at B = 1) took 7.4x its bound.  This design:
//
// 1. Split-K across CTAs (flash-decoding), one launch.  The grid is
//    (B * Hkv * ceil(G / 8)) units x S splits; split s walks pages
//    [s * pps, (s + 1) * pps) of its row.  The host picks S and pps from
//    B, Hkv, G, NP and the SM count, never from the lengths (that would
//    need a host sync): `split_plan` in kernels/paged_attention.py aims
//    at 4 CTAs per SM with S <= min(NP, 64) and S * pps >= NP.  A split
//    past its row's length writes an empty partial (m = -inf, l = 0,
//    acc = 0).  Each split writes its fp32 partial (m, l, acc[8, D]) to
//    a workspace and takes a ticket on its unit's int32 counter after a
//    __threadfence(); the split that draws the last ticket merges the S
//    partials in split order 0..S-1, not in arrival order, so the output
//    is deterministic, and resets the counter to 0: the wrapper zeroes
//    the counters once, never per call.  With S = 1 the CTA writes the
//    output itself.
// 2. Pages copied asynchronously in their own dtype: a 2-stage ring of K
//    and V chunks (64 tokens; 32 where a 64-token chunk of K and V would
//    pass 36 KB: fp32 with D > 64, bf16 with D > 128) filled by 16-byte
//    cp.async.  The copy of chunk c + 1 is issued before the wait for
//    chunk c, so two chunks are in flight while a CTA waits, and the
//    table entry of the chunk after that is read one chunk ahead.  Rows
//    are padded by 16 bytes, so that the score loads and the transposing
//    V loads of neighbouring tokens fall in distinct banks.
// 3. Scores on the tensor cores for bf16 q and heaps: the (up to) 8 query
//    heads of a unit are the n = 8 side of mma.sync.m16n8k16 (bf16 in,
//    fp32 accumulate; S^T[16 tokens x 8 heads] = K[16 x D] . Q^T).  A
//    bf16 x bf16 product is exact in fp32, so only the order of the sum
//    differs from the oracle.  Any other dtype mix runs the scores in
//    fp32 SIMT with full fp32 products (no TF32).
// 4. P.V keeps fp32 precision.  Rounding P to bf16 would cost about 2e-4
//    at long rows (PAGED_ERR is 1e-4); hi + lo bf16 halves leave 2^-16
//    of P, up to about 3e-5 with |V| of 4.  So for bf16 heaps with D a
//    multiple of 16, P is split into three bf16 parts (hi + mid + lo,
//    exact to about 2^-24, finer than fp32 rounding of the sum) and
//    O^T[D x 8] = V^T . P^T runs as three mma.sync per tile, V^T loaded
//    with ldmatrix.trans; each warp keeps its D-tiles in registers.
//    Otherwise (fp32 heaps, or D % 16 == 8) P.V is fp32 SIMT: a thread
//    owns two output columns of all 8 heads and a slice of the chunk's
//    tokens.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPage = 64;
constexpr int kThreads = 128;
constexpr int kHeads = 8;         // query heads per unit (the mma's n)
constexpr int kStages = 2;        // chunks in the copy ring
constexpr int kMaxSplits = 64;    // the merge stages S x 8 weights
// Scores are kept in base 2 (scaled by D^-0.5 log2 e), so every
// exponential is one exp2f: softmax and merge are unchanged by the base.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Eight consecutive elements (16-byte aligned) widened to fp32.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Two consecutive elements widened to fp32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {   // <= N groups pending
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 tiles from shared memory, transposed (lane i gives the
// row address of row i % 8 of tile i / 8).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Shared-memory plan, in bytes (every region 16-byte aligned).
struct Smem {
  int64_t stage, ring, qs, ss, pt, total;
};

__host__ __device__ inline int64_t align16(int64_t x) {
  return (x + 15) / 16 * 16;
}

// K and V chunk rows are D * es + 16 bytes (padded: the score loads and
// the transposing V loads of neighbouring tokens fall in distinct banks).
__host__ __device__ inline Smem smem_plan(int tok, int D, int es) {
  Smem s;
  s.stage = 2 * (int64_t)tok * (D * es + 16);
  const int tg = kThreads / (D / 2);
  const int64_t red = (int64_t)tg * kHeads * D * 4;   // P.V partial sums
  const int64_t merge = 3 * kMaxSplits * kHeads * 4;  // m, l, weights
  s.ring = kStages * s.stage;
  if (s.ring < red) s.ring = red;
  if (s.ring < merge) s.ring = merge;
  s.qs = align16((int64_t)kHeads * (D + 8) * 4);
  s.ss = align16((int64_t)kHeads * (tok + 4) * 4);
  // p: fp32 [tok][8], or its bf16 hi/mid/lo thirds [3][8][tok + 8]
  s.pt = align16((int64_t)3 * kHeads * (tok + 8) * 2);
  if (s.pt < (int64_t)tok * kHeads * 4) s.pt = (int64_t)tok * kHeads * 4;
  s.total = s.ring + s.qs + s.ss + s.pt + 64 * 4;     // + m, l, alpha, flag
  return s;
}

// Chunk tokens: 64 unless a 64-token chunk of K and V passes 36 KB.
__host__ __device__ inline int chunk_tokens(int D, int es) {
  return (int64_t)kPage * 2 * (D * es + 16) <= 36 * 1024 ? 64 : 32;
}

template <typename QT, typename KT, int TOK>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_heap,
    const KT* __restrict__ v_heap, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lengths, float* __restrict__ out,
    float* __restrict__ ws, int32_t* __restrict__ counters, int Hkv, int G,
    int D, int NP, int64_t slots, int S, int pps, float scale) {
  constexpr bool kMma = sizeof(QT) == 2 && sizeof(KT) == 2;
  constexpr int kCpp = kPage / TOK;        // chunks per page
  constexpr int kPerLane = TOK / 32;       // softmax tokens per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem plan = smem_plan(TOK, D, (int)sizeof(KT));
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + plan.ring);
  float* ss = reinterpret_cast<float*>(smem + plan.ring + plan.qs);
  float* pt = reinterpret_cast<float*>(smem + plan.ring + plan.qs + plan.ss);
  float* m_sh = pt + plan.pt / 4;          // [8]
  float* l_sh = m_sh + kHeads;             // [8]
  float* alpha = l_sh + kHeads;            // [8]
  float* mm = alpha + kHeads;              // [8] merge max
  float* ll = mm + kHeads;                 // [8] merge denominator
  int* flag = reinterpret_cast<int*>(ll + kHeads);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NG = (G + kHeads - 1) / kHeads;
  const int unit = blockIdx.x;             // ((b * Hkv) + h) * NG + hg
  const int split = blockIdx.y;
  const int hg = unit % NG;
  const int bh = unit / NG;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int g0 = hg * kHeads;
  const int Gc = min(kHeads, G - g0);      // live heads of this unit

  // This split's chunks of the row: effective length min(len, NP * 64).
  const int n = lengths[b];
  const int ne = max(0, min(n, NP * kPage));
  const int nc = (ne + TOK - 1) / TOK;
  const int c_lo = split * pps * kCpp;
  const int c_hi = min(c_lo + pps * kCpp, nc);

  // m and l of heads warp and warp + 4, held by every lane of the warp.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[kHeads][2];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) acc[g][0] = acc[g][1] = 0.f;
  // bf16 heaps with D % 16 == 0: P.V on the tensor cores, O^T[D x 8] =
  // V^T . P^T, warp w holding the D-tiles w, w + 4, ... (at most 4).
  const bool pv_mma = kMma && D % 16 == 0;
  float cacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cacc[j][0] = cacc[j][1] = cacc[j][2] = cacc[j][3] = 0.f;
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(pt);   // [3][8][TOK+8]
  constexpr int PB = TOK + 8;

  const int RB = D * (int)sizeof(KT) + 16;        // padded K/V row bytes
  const int CPRow = D * (int)sizeof(KT) / 16;     // 16-byte pieces a row
  const int64_t heap_pages = slots / kPage;
  const KT* kh = k_heap + (int64_t)h * slots * D;
  const KT* vh = v_heap + (int64_t)h * slots * D;
  const int CPR2 = D / 2;                  // column pairs per row
  const int TG = kThreads / CPR2;          // token groups of P.V
  const int ptg = tid / CPR2;              // this thread's token group
  const int pcol = 2 * (tid - ptg * CPR2);

  if (c_lo < c_hi) {
    // A chunk's page id is read one chunk before its copy is issued, so
    // the table's latency stays off the loop's path.
    auto page_of = [&](int c) -> int64_t {
      if (c >= c_hi) return 0;
      int64_t pg = table[(int64_t)b * NP + c / kCpp];
      if (pg < 0) pg = 0;                   // the oracle's clamp
      if (pg >= heap_pages) pg = heap_pages - 1;
      return pg;
    };
    auto issue = [&](int c, int stage, int64_t pg) {
      const int64_t off = (pg * kPage + (c % kCpp) * TOK) * D;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(kh + off);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(vh + off);
      unsigned char* kd = ring + stage * plan.stage;
      unsigned char* vd = kd + (int64_t)TOK * RB;
      for (int p = tid; p < TOK * CPRow; p += kThreads) {
        const int r = p / CPRow, col = (p - r * CPRow) * 16;
        cp_async16(kd + r * RB + col, ksrc + (int64_t)p * 16);
        cp_async16(vd + r * RB + col, vsrc + (int64_t)p * 16);
      }
    };

    for (int i = 0; i < kStages - 1; ++i) {
      if (c_lo + i < c_hi) issue(c_lo + i, i, page_of(c_lo + i));
      cp_async_commit();
    }
    int64_t pg_next = page_of(c_lo + kStages - 1);

    // q of the unit's heads (while the first chunks are in flight):
    // bf16 [8][D + 8] for the mma, else fp32 [8][D]; absent heads are 0.
    const QT* qb = q + ((int64_t)bh * G + g0) * D;
    for (int e = tid; e < kHeads * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      const QT v = g < Gc ? qb[(int64_t)g * D + d] : QT(0.f);
      if constexpr (kMma)
        reinterpret_cast<__nv_bfloat16*>(qs)[g * (D + 8) + d] = v;
      else
        qs[e] = to_f32(v);
    }
    for (int e = tid; e < (int)(plan.pt / 4); e += kThreads) pt[e] = 0.f;

    for (int c = c_lo; c < c_hi; ++c) {
      const int stage = (c - c_lo) % kStages;
      __syncthreads();  // everyone is done with chunk c-1: refill its stage
      const int ahead = c + kStages - 1;
      if (ahead < c_hi) issue(ahead, (ahead - c_lo) % kStages, pg_next);
      pg_next = page_of(ahead + 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();   // chunk c landed (the rest may fly)
      __syncthreads();
      const KT* ks = reinterpret_cast<const KT*>(ring + stage * plan.stage);
      const KT* vs = reinterpret_cast<const KT*>(
          ring + stage * plan.stage + (int64_t)TOK * RB);
      const int RK = RB / (int)sizeof(KT);       // K/V row stride, elements
      const int base = c * TOK;

      // scores -> ss[g][t] (scaled; -inf past the length)
      if constexpr (kMma) {
        const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(ks);
        const __nv_bfloat16* qb16 = reinterpret_cast<const __nv_bfloat16*>(qs);
        const int gid = lane >> 2, tig = lane & 3;
        for (int mt = warp; mt < TOK / 16; mt += kThreads / 32) {
          float cf[4] = {0.f, 0.f, 0.f, 0.f};
          const __nv_bfloat16* r0 = kb + (mt * 16 + gid) * RK;
          const __nv_bfloat16* r1 = r0 + 8 * RK;
          const __nv_bfloat16* qr = qb16 + gid * (D + 8);
          for (int d0 = 0; d0 < D; d0 += 16) {
            const int col = d0 + tig * 2;
            const bool hi = d0 + 8 < D;
            uint32_t a[4], bq[2];
            a[0] = *reinterpret_cast<const uint32_t*>(r0 + col);
            a[1] = *reinterpret_cast<const uint32_t*>(r1 + col);
            a[2] = hi ? *reinterpret_cast<const uint32_t*>(r0 + col + 8) : 0u;
            a[3] = hi ? *reinterpret_cast<const uint32_t*>(r1 + col + 8) : 0u;
            bq[0] = *reinterpret_cast<const uint32_t*>(qr + col);
            bq[1] = hi ? *reinterpret_cast<const uint32_t*>(qr + col + 8) : 0u;
            mma_bf16(cf, a, bq);
          }
          const int t0 = mt * 16 + gid, t1 = t0 + 8;
          const int ga = tig * 2;
          const bool v0 = base + t0 < ne, v1 = base + t1 < ne;
          ss[ga * (TOK + 4) + t0] = v0 ? cf[0] * scale : -INFINITY;
          ss[(ga + 1) * (TOK + 4) + t0] = v0 ? cf[1] * scale : -INFINITY;
          ss[ga * (TOK + 4) + t1] = v1 ? cf[2] * scale : -INFINITY;
          ss[(ga + 1) * (TOK + 4) + t1] = v1 ? cf[3] * scale : -INFINITY;
        }
      } else {
        constexpr int kHpt = kHeads * TOK / kThreads;   // heads a thread
        constexpr int kHs = kThreads / TOK;             // head stride
        const int t = tid % TOK;
        const int hs = tid / TOK;
        const KT* kr = ks + t * RK;
        float s[kHpt];
#pragma unroll
        for (int u = 0; u < kHpt; ++u) s[u] = 0.f;
        for (int d = 0; d < D; d += 8) {
          float kv[8];
          load8(kr + d, kv);
#pragma unroll
          for (int u = 0; u < kHpt; ++u) {
            float qv[8];
            load8(qs + (hs + u * kHs) * D + d, qv);
#pragma unroll
            for (int i = 0; i < 8; ++i) s[u] = fmaf(qv[i], kv[i], s[u]);
          }
        }
        const bool live = base + t < ne;
#pragma unroll
        for (int u = 0; u < kHpt; ++u)
          ss[(hs + u * kHs) * (TOK + 4) + t] = live ? s[u] * scale : -INFINITY;
      }
      __syncthreads();

      // online softmax: warp w takes heads w and w + 4
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int g = warp + 4 * j;
        if (g < Gc) {
          float sv[kPerLane];
          float mx = -INFINITY;
#pragma unroll
          for (int u = 0; u < kPerLane; ++u) {
            sv[u] = ss[g * (TOK + 4) + lane + 32 * u];
            mx = fmaxf(mx, sv[u]);
          }
          const float m_new = fmaxf(m_run[j], warp_max(mx));
          const float a = exp2f(m_run[j] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < kPerLane; ++u) {
            const float p = exp2f(sv[u] - m_new);
            const int t = lane + 32 * u;
            if (pv_mma) {   // p = hi + mid + lo to about 2^-24, in bf16
              const __nv_bfloat16 hi = __float2bfloat16_rn(p);
              const float r = p - __bfloat162float(hi);
              const __nv_bfloat16 mid = __float2bfloat16_rn(r);
              pb[g * PB + t] = hi;
              pb[(kHeads + g) * PB + t] = mid;
              pb[(2 * kHeads + g) * PB + t] =
                  __float2bfloat16_rn(r - __bfloat162float(mid));
            } else {
              pt[t * kHeads + g] = p;
            }
            sum += p;
          }
          l_run[j] = l_run[j] * a + warp_sum(sum);
          m_run[j] = m_new;
          if (lane == 0) alpha[g] = a;
        } else if (lane == 0) {
          alpha[g] = 1.f;
        }
      }
      __syncthreads();

      if (pv_mma) {
        const int gid = lane >> 2, tig = lane & 3;
        const float a0 = alpha[tig * 2], a1 = alpha[tig * 2 + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cacc[j][0] *= a0;
          cacc[j][1] *= a1;
          cacc[j][2] *= a0;
          cacc[j][3] *= a1;
        }
        const int mi = lane >> 3;                 // this lane's ldmatrix tile
        const int lrow = (lane & 7) + (mi >= 2 ? 8 : 0);
        const int lcol = (mi & 1) ? 8 : 0;
#pragma unroll
        for (int kt = 0; kt < TOK / 16; ++kt) {
          const int t0 = kt * 16;
          uint32_t bp[3][2];
#pragma unroll
          for (int h3 = 0; h3 < 3; ++h3) {
            const __nv_bfloat16* pr =
                pb + (h3 * kHeads + gid) * PB + t0 + tig * 2;
            bp[h3][0] = *reinterpret_cast<const uint32_t*>(pr);
            bp[h3][1] = *reinterpret_cast<const uint32_t*>(pr + 8);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int mt = warp + 4 * j;
            if (mt * 16 < D) {
              uint32_t a[4];
              ldmatrix_x4_trans(a, vs + (t0 + lrow) * RK + mt * 16 + lcol);
              mma_bf16(cacc[j], a, bp[0]);
              mma_bf16(cacc[j], a, bp[1]);
              mma_bf16(cacc[j], a, bp[2]);
            }
          }
        }
      } else if (ptg < TG) {
        // acc[g][pcol:pcol+2] = acc * alpha[g] + sum_t p[t, g] V[t, pcol:]
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          const float a = alpha[g];
          acc[g][0] *= a;
          acc[g][1] *= a;
        }
        for (int t = ptg; t < TOK; t += TG) {
          const float2 v = load2(vs + t * RK + pcol);
          const float4* pr = reinterpret_cast<const float4*>(pt + t * kHeads);
          const float4 p0 = pr[0], p1 = pr[1];
          const float p[kHeads] = {p0.x, p0.y, p0.z, p0.w,
                                   p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int g = 0; g < kHeads; ++g) {
            acc[g][0] = fmaf(p[g], v.x, acc[g][0]);
            acc[g][1] = fmaf(p[g], v.y, acc[g][1]);
          }
        }
      }
    }
    cp_async_wait<0>();
  }
  // m, l of each head; the token groups' partial sums into the ring
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_sh[warp + 4 * j] = m_run[j];
      l_sh[warp + 4 * j] = l_run[j];
    }
  }
  __syncthreads();   // the ring is free: no copy is in flight
  float* red = reinterpret_cast<float*>(ring);   // [TG][8][D]
  const int TGr = pv_mma ? 1 : TG;               // partial sums to add
  if (pv_mma) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = (warp + 4 * j) * 16 + gid;
      if (d < D) {
        red[(tig * 2) * D + d] = cacc[j][0];
        red[(tig * 2 + 1) * D + d] = cacc[j][1];
        red[(tig * 2) * D + d + 8] = cacc[j][2];
        red[(tig * 2 + 1) * D + d + 8] = cacc[j][3];
      }
    }
  } else if (ptg < TG) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      red[(ptg * kHeads + g) * D + pcol] = acc[g][0];
      red[(ptg * kHeads + g) * D + pcol + 1] = acc[g][1];
    }
  }
  __syncthreads();

  float* ob = out + ((int64_t)bh * G + g0) * D;
  if (S == 1) {
    for (int e = tid; e < Gc * D; e += kThreads) {
      const int g = e / D;
      float x = 0.f;
      for (int t = 0; t < TGr; ++t) x += red[t * kHeads * D + e];
      const float l = l_sh[g];
      ob[e] = l > 0.f ? x / l : 0.f;
    }
    return;
  }

  // this split's partial: ws[unit][split] = (m[8], l[8], acc[8][D])
  const int64_t wstride = 2 * kHeads + (int64_t)kHeads * D;
  float* wp = ws + ((int64_t)unit * S + split) * wstride;
  if (tid < kHeads) {
    wp[tid] = m_sh[tid];
    wp[kHeads + tid] = l_sh[tid];
  }
  for (int e = tid; e < Gc * D; e += kThreads) {   // an empty split: 0
    float x = 0.f;
    if (c_lo < c_hi)
      for (int t = 0; t < TGr; ++t) x += red[t * kHeads * D + e];
    wp[2 * kHeads + e] = x;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(counters + unit, 1);
    flag[0] = ticket == S - 1;
    __threadfence();
  }
  __syncthreads();
  if (!flag[0]) return;

  // The last split merges the S partials in split order: the S x 8
  // (m, l) pairs are read at once into the free ring, each head's max M
  // and weights exp(m_s - M) (0 for an empty split) computed there, and
  // out = sum_s w_s acc_s / sum_s w_s l_s.
  const float* wu = ws + (int64_t)unit * S * wstride;
  float* m_all = reinterpret_cast<float*>(ring);   // [S][8]
  float* l_all = m_all + kMaxSplits * kHeads;      // [S][8]
  float* w_all = l_all + kMaxSplits * kHeads;      // [S][8]
  for (int i = tid; i < S * kHeads; i += kThreads) {
    const int sp = i / kHeads, g = i - sp * kHeads;
    m_all[i] = __ldcg(wu + sp * wstride + g);
    l_all[i] = __ldcg(wu + sp * wstride + kHeads + g);
  }
  __syncthreads();
  if (tid < kHeads) {
    float M = -INFINITY;
    for (int sp = 0; sp < S; ++sp) M = fmaxf(M, m_all[sp * kHeads + tid]);
    mm[tid] = M;
  }
  __syncthreads();
  for (int i = tid; i < S * kHeads; i += kThreads) {
    const float ms = m_all[i], M = mm[i % kHeads];
    w_all[i] = ms > -INFINITY ? exp2f(ms - M) : 0.f;
  }
  __syncthreads();
  if (tid < kHeads) {
    float L = 0.f;
    for (int sp = 0; sp < S; ++sp)
      L = fmaf(l_all[sp * kHeads + tid], w_all[sp * kHeads + tid], L);
    ll[tid] = L;
  }
  __syncthreads();
  for (int e4 = tid; e4 < Gc * D / 4; e4 += kThreads) {   // 4 lanes of a head
    const int g = 4 * e4 / D;
    const float4* src = reinterpret_cast<const float4*>(wu + 2 * kHeads) + e4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int sp = 0; sp < S; ++sp) {
      const float4 a = __ldcg(src + sp * (wstride / 4));
      const float w = w_all[sp * kHeads + g];
      x.x = fmaf(a.x, w, x.x);
      x.y = fmaf(a.y, w, x.y);
      x.z = fmaf(a.z, w, x.z);
      x.w = fmaf(a.w, w, x.w);
    }
    const float L = ll[g];
    reinterpret_cast<float4*>(ob)[e4] =
        L > 0.f ? make_float4(x.x / L, x.y / L, x.z / L, x.w / L)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) counters[unit] = 0;   // ready for the next launch
}

template <typename QT, typename KT, int TOK>
int launch_tok(const void* q, const void* k, const void* v,
               const int32_t* table, const int32_t* lengths, float* out,
               float* ws, int32_t* counters, int64_t B, int64_t Hkv,
               int64_t G, int64_t D, int64_t NP, int64_t slots, int64_t S,
               int64_t pps, cudaStream_t stream) {
  const size_t smem = (size_t)smem_plan(TOK, (int)D, sizeof(KT)).total;
  auto kernel = paged_attention_kernel<QT, KT, TOK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t units = B * Hkv * ((G + kHeads - 1) / kHeads);
  kernel<<<dim3((unsigned)units, (unsigned)S), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), table, lengths, out, ws, counters,
      (int)Hkv, (int)G, (int)D, (int)NP, slots, (int)S, (int)pps,
      kLog2e / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int32_t* table,
           const int32_t* lengths, float* out, float* ws, int32_t* counters,
           int64_t B, int64_t Hkv, int64_t G, int64_t D, int64_t NP,
           int64_t slots, int64_t S, int64_t pps, cudaStream_t stream) {
  if (chunk_tokens((int)D, sizeof(KT)) == 64)
    return launch_tok<QT, KT, 64>(q, k, v, table, lengths, out, ws,
                                  counters, B, Hkv, G, D, NP, slots, S, pps,
                                  stream);
  return launch_tok<QT, KT, 32>(q, k, v, table, lengths, out, ws, counters,
                                B, Hkv, G, D, NP, slots, S, pps, stream);
}

}  // namespace

// q: [B, Hkv, G, D] (fp32 or bf16, q_bf16); k/v heaps: [Hkv, slots, D]
// (fp32 or bf16, kv_bf16; 16-byte aligned, D a multiple of 8);
// page_table int32[B, NP]; lengths int32[B]; out fp32 [B, Hkv, G, D].
// S splits of pps pages each (S * pps >= NP); with S > 1, ws holds
// B * Hkv * ceil(G / 8) * S * (16 + 8 D) floats and counters
// B * Hkv * ceil(G / 8) int32 zeros (left zero on return).
// Returns the launch's cudaError_t.
extern "C" int paged_attention_launch(
    const void* q, int64_t q_bf16, const void* k_heap, const void* v_heap,
    int64_t kv_bf16, const int32_t* page_table, const int32_t* lengths,
    float* out, float* ws, int32_t* counters, int64_t B, int64_t Hkv,
    int64_t G, int64_t D, int64_t NP, int64_t slots, int64_t S, int64_t pps,
    cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0) return 0;
  if (D < 8 || D > 256 || D % 8 || NP <= 0 || slots < kPage || S < 1 ||
      pps < 1 || S * pps < NP || S > kMaxSplits ||
      (S > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_heap, v_heap, page_table, lengths, out, ws, counters, B, Hkv,
        G, D, NP, slots, S, pps, stream);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k_heap, v_heap, page_table,
                                        lengths, out, ws, counters, B, Hkv,
                                        G, D, NP, slots, S, pps, stream);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k_heap, v_heap, page_table,
                                        lengths, out, ws, counters, B, Hkv,
                                        G, D, NP, slots, S, pps, stream);
  return launch<float, float>(q, k_heap, v_heap, page_table, lengths, out,
                              ws, counters, B, Hkv, G, D, NP, slots, S, pps,
                              stream);
}
