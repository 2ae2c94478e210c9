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
// sees only the table's NP pages (the TPU kernel would read past them
// for a sequence longer than its table).
//
// Design: one CTA of 128 threads per (b, h), as the TPU grid.  Each
// 64-token K page and V page is read from device memory once, in 16-byte
// loads, widened to fp32 into shared memory (K rows padded to D + 4
// floats so the score loop's float4 reads are free of bank conflicts),
// and used by all G query heads of that KV head.  The next page's loads
// are issued into registers before this page's math, so a page's copy
// overlaps the previous page's compute.  A thread computes the scores of
// one token for up to four heads (float4 steps along D), and then four
// output lanes of one head.  Scores, the running max, the denominator
// and the accumulator are fp32 (online softmax; masked positions
// -1e30).  A page of D = 256 in fp32 with its V page and the G
// accumulators is more than the default 48 KB, so the launch opts in to
// more dynamic shared memory when it needs it.
//
// Bound on an H100: memory.  The K/V pages a row walks are read once
// (TinyLlama serving: 32 sequences x 4 KV heads x 2048 tokens x 64 x 2
// bytes x 2 = 67 MB, 0.02 ms at 3.35 TB/s).  With one CTA per (b, h) —
// 128 CTAs on 132 SMs, 4 warps each — the page loop's latency, not the
// memory rate, sets the time; splitting long sequences across CTAs
// (flash-decoding split-K), TMA page copies and tensor-core tiles are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPage = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 4;          // 16-byte chunks per thread per round
constexpr float kNegInf = -1e30f;

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

// One 16-byte chunk of a heap page, widened to fp32 at dst (16B-aligned).
__device__ __forceinline__ void put_chunk(float* dst, uint4 raw, float) {
  *reinterpret_cast<uint4*>(dst) = raw;                  // 4 fp32 values
}
__device__ __forceinline__ void put_chunk(float* dst, uint4 raw,
                                          __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Shared memory, in floats: q [G][D] (pre-scaled), acc [G][D],
// K page [64][D + 4], V page [64][D], p [G][64], m/l/alpha [G] each.
// Every array starts 16-byte aligned (D is a multiple of 8).
__host__ __device__ inline int64_t smem_floats(int64_t G, int64_t D) {
  return 2 * G * D + kPage * (D + 4) + kPage * D + G * kPage + 3 * G;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_heap,
    const KT* __restrict__ v_heap, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lengths, float* __restrict__ out, int Hkv,
    int G, int D, int NP, int64_t slots, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int KS = D + 4;                      // padded K row (no conflicts)
  float* qs = smem;                          // [G][D]
  float* acc = qs + G * D;                   // [G][D]
  float* ks = acc + G * D;                   // [64][KS]
  float* vs = ks + kPage * KS;               // [64][D]
  float* ps = vs + kPage * D;                // [G][64]
  float* m_row = ps + G * kPage;             // [G]
  float* l_row = m_row + G;                  // [G]
  float* alpha = l_row + G;                  // [G]

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GD = G * D;

  const QT* qb = q + (int64_t)bh * GD;
  for (int e = tid; e < GD; e += kThreads) {
    qs[e] = to_f32(qb[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_row[g] = kNegInf;
    l_row[g] = 0.f;
  }

  const int n = lengths[b];
  int n_pages = n > 0 ? (n + kPage - 1) / kPage : 0;
  if (n_pages > NP) n_pages = NP;
  const int64_t heap_pages = slots / kPage;
  const KT* kh = k_heap + (int64_t)h * slots * D;
  const KT* vh = v_heap + (int64_t)h * slots * D;

  // A page is 64 * D contiguous elements: CH chunks of 16 bytes per
  // heap, moved in rounds of kRound chunks per thread.  The chunks of
  // the next round (the next page's first round, when a page is one
  // round) are loaded into registers before this page's math.
  constexpr int EPC = 16 / sizeof(KT);       // elements per chunk
  const int CH = kPage * D / EPC;
  const int CPR = D / EPC;                   // chunks per row
  const int rounds = (CH + kRound * kThreads - 1) / (kRound * kThreads);
  uint4 kreg[kRound], vreg[kRound];

  auto page_ptr = [&](int i) -> int64_t {
    int64_t pg = table[(int64_t)b * NP + i];
    if (pg < 0) pg = 0;                      // the oracle's clamp
    if (pg >= heap_pages) pg = heap_pages - 1;
    return pg * kPage * D;
  };
  auto load = [&](int64_t off, int r) {
    const uint4* kp = reinterpret_cast<const uint4*>(kh + off);
    const uint4* vp = reinterpret_cast<const uint4*>(vh + off);
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int c = (r * kRound + u) * kThreads + tid;
      if (c < CH) {
        kreg[u] = __ldg(kp + c);
        vreg[u] = __ldg(vp + c);
      }
    }
  };
  auto store = [&](int r) {
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int c = (r * kRound + u) * kThreads + tid;
      if (c < CH) {
        const int row = c / CPR;
        const int col = (c - row * CPR) * EPC;
        put_chunk(ks + row * KS + col, kreg[u], KT());
        put_chunk(vs + row * D + col, vreg[u], KT());
      }
    }
  };

  int64_t off = n_pages > 0 ? page_ptr(0) : 0;
  if (n_pages > 0) load(off, 0);
  __syncthreads();

  for (int i = 0; i < n_pages; ++i) {
    for (int r = 0; r < rounds; ++r) {
      store(r);
      if (r + 1 < rounds) {
        load(off, r + 1);
      } else if (i + 1 < n_pages) {
        off = page_ptr(i + 1);
        load(off, 0);
      }
    }
    __syncthreads();

    // scores: thread (j, gs) takes token j of the page for heads gs,
    // gs + 2, ... (up to four at a time), float4 steps along D
    const int base_pos = i * kPage;
    {
      const int j = tid & (kPage - 1);
      const int gs = tid / kPage;            // 0 or 1
      const float* kr = ks + j * KS;
      const bool live = base_pos + j < n;
      for (int g0 = gs; g0 < G; g0 += 8) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < D; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int g = g0 + 2 * u;
            if (g < G) {
              const float4 q4 =
                  *reinterpret_cast<const float4*>(qs + g * D + d);
              s[u] = fmaf(q4.x, k4.x, s[u]);
              s[u] = fmaf(q4.y, k4.y, s[u]);
              s[u] = fmaf(q4.z, k4.z, s[u]);
              s[u] = fmaf(q4.w, k4.w, s[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int g = g0 + 2 * u;
          if (g < G) ps[g * kPage + j] = live ? s[u] : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* pr = ps + g * kPage;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = m_row[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[g] = a;
        l_row[g] = l_row[g] * a + sum;
        m_row[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, 4c:4c+4] = acc * alpha[g] + sum_j p[g, j] * V[j, 4c:4c+4]
    const int D4 = D / 4;
    for (int e = tid; e < G * D4; e += kThreads) {
      const int g = e / D4;
      const int c4 = (e - g * D4) * 4;
      const float* pr = ps + g * kPage;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int j = 0; j < kPage; ++j) {
        const float p = pr[j];
        const float4 v4 = *reinterpret_cast<const float4*>(vs + j * D + c4);
        a.x = fmaf(p, v4.x, a.x);
        a.y = fmaf(p, v4.y, a.y);
        a.z = fmaf(p, v4.z, a.z);
        a.w = fmaf(p, v4.w, a.w);
      }
      float4* dst = reinterpret_cast<float4*>(acc + g * D + c4);
      const float al = alpha[g];
      float4 o = *dst;
      o.x = fmaf(o.x, al, a.x);
      o.y = fmaf(o.y, al, a.y);
      o.z = fmaf(o.z, al, a.z);
      o.w = fmaf(o.w, al, a.w);
      *dst = o;
    }
    __syncthreads();   // the next page overwrites ks / vs / ps
  }

  float* ob = out + (int64_t)bh * GD;
  for (int e = tid; e < GD; e += kThreads)
    ob[e] = acc[e] / fmaxf(l_row[e / D], 1e-30f);
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v,
           const int32_t* table, const int32_t* lengths, float* out,
           int64_t B, int64_t Hkv, int64_t G, int64_t D, int64_t NP,
           int64_t slots, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(G, D) * sizeof(float);
  auto kernel = paged_attention_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)(B * Hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), table, lengths, out, (int)Hkv, (int)G,
      (int)D, (int)NP, slots, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Hkv, G, D] (fp32 or bf16, q_bf16); k/v heaps: [Hkv, slots, D]
// (fp32 or bf16, kv_bf16; 16-byte aligned, D a multiple of 8);
// page_table int32[B, NP]; lengths int32[B];
// out fp32 [B, Hkv, G, D].  Returns the launch's cudaError_t.
extern "C" int paged_attention_launch(
    const void* q, int64_t q_bf16, const void* k_heap, const void* v_heap,
    int64_t kv_bf16, const int32_t* page_table, const int32_t* lengths,
    float* out, int64_t B, int64_t Hkv, int64_t G, int64_t D, int64_t NP,
    int64_t slots, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0) return 0;
  if (D < 8 || D > 256 || D % 8 || NP <= 0 || slots < kPage)
    return (int)cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_heap, v_heap, page_table, lengths, out, B, Hkv, G, D, NP,
        slots, stream);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k_heap, v_heap, page_table,
                                        lengths, out, B, Hkv, G, D, NP,
                                        slots, stream);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k_heap, v_heap, page_table,
                                        lengths, out, B, Hkv, G, D, NP,
                                        slots, stream);
  return launch<float, float>(q, k_heap, v_heap, page_table, lengths, out,
                              B, Hkv, G, D, NP, slots, stream);
}
