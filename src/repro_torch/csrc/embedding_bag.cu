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
// the TPU kernel would read out of range).  Offsets are clamped into
// [0, N] (lo = clip(offsets[b]), hi = max(lo, min(offsets[b+1], N))) so
// a malformed CSR cannot read past the indices.  Row addresses are
// int64: DLRM-MLPerf's table has 187,767,808 rows of 128, and row * D
// passes 2**31.
//
// Summation order: each column of a bag starts from the bag's first row
// and adds the others one at a time in bag order, so a bag of one row is
// bit-identical to table[idx].float(), and every bag is bit-identical to
// a loop over its rows (`in_order_bags` in launch/time_embedding_bag.py
// is that loop in plain torch).
//
// Bound on an H100: memory.  A call reads its rows (random rows of a
// table far larger than the 50 MB L2), its indices and offsets, and
// writes B * D fp32: DCN-v2 serve_bulk is 6.8M single-row bags of 16
// fp32, 0.60 GB counting each distinct row once (0.179 ms at 3.35
// TB/s).  What holds a gather back is the latency of the dependent
// loads offsets -> index -> row, so the design keeps many rows in
// flight and pays that chain once per chunk of bags, not once per bag:
//
// * A warp takes a chunk of `bags_per_chunk` consecutive bags (the
//   launch plan sizes it by rows: about one tile).  Its lanes read the
//   chunk's offsets in coalesced loads.
// * A group of `lanes_per_row` lanes reads one row with vector loads of
//   `vec_bytes` (16 where the row's byte width and the table's base
//   address allow it, else 8, 4 or 2; at most 4 elements, since 8 bf16
//   a lane cost more registers than they saved) and each lane holds
//   kRows rows, so a lane issues its kRows index loads, then its kRows
//   row loads, before it adds or stores anything: a warp has groups x
//   kRows rows in flight.
// * A chunk of single-row bags at consecutive positions (every
//   one-id-per-field lookup) is recognised from its offsets alone and
//   copied: slot u of group g takes row u * groups + g, so a slot's
//   loads and stores are contiguous across the warp.
// * Any other chunk clamps its offsets and keeps each bag's start in
//   the chunk's row sequence (a warp prefix sum of the lengths) and its
//   first index position in shared memory.  Its rows are taken in tiles
//   of groups x kRows: group g holds rows g*kRows .. g*kRows + kRows - 1,
//   consecutive in bag order, and adds them in registers, in order,
//   storing a bag (fp32 vector stores; the mean divides by the count)
//   at its last row.  A bag that runs on from the previous group takes
//   that group's running sum by a shuffle, group after group in order,
//   and from the previous tile the same way; a tile whose groups all
//   start on a bag's first row skips that chain.  Empty bags are written
//   as zeros once per chunk.  (Staging a tile's rows in shared memory
//   and adding them by columns measured slower at the recsys lengths.)
// No atomics and no host sync; the kernel allocates nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps per CTA (kernels/embedding_bag.py)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBags = 128;          // bags per chunk at most
constexpr int kRows = 4;               // rows a lane has in flight
constexpr int kCtasPerSm = 3;          // the register budget: 85 a thread
constexpr unsigned kFull = 0xffffffffu;

// One row load of VB bytes as 32-bit words (a 2-byte load in w[0]).
// The loads are volatile PTX, read-only and not kept in L1 (a row is
// read once): the compiler may not sink one into the fold that uses
// it, so a lane's U loads are all issued before its first add.
template <int VB>
struct Raw {
  uint32_t w[VB >= 4 ? VB / 4 : 1];
};

template <int VB>
__device__ __forceinline__ Raw<VB> load_raw(const void* p) {
  Raw<VB> r;
  if constexpr (VB == 16) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
                 : "l"(p));
  } else if constexpr (VB == 8) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                 : "=r"(r.w[0]), "=r"(r.w[1]) : "l"(p));
  } else if constexpr (VB == 4) {
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
                 : "=r"(r.w[0]) : "l"(p));
  } else {
    unsigned short h;
    asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];"
                 : "=h"(h) : "l"(p));
    r.w[0] = h;
  }
  return r;
}

__device__ __forceinline__ int32_t load_index(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The load's V elements widened to fp32 (bf16 -> fp32 is exact: the
// 16 bits become the high half).
template <typename E, int VB>
__device__ __forceinline__ void widen(const Raw<VB>& r, float* x) {
  if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) x[i] = __uint_as_float(r.w[i]);
  } else if constexpr (VB == 2) {
    x[0] = __uint_as_float(r.w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      x[2 * i] = __uint_as_float(r.w[i] << 16);
      x[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
    }
  }
}

// V fp32 to an address aligned to 4 V bytes (up to 16 at a time).
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* y) {
  if constexpr (V == 1) {
    p[0] = y[0];
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(y[i], y[i + 1], y[i + 2], y[i + 3]);
  }
}

// A float 1 the compiler cannot fold: a single-row mean divides by it at
// run time, as a bag of any length divides by its count.
__device__ __forceinline__ float opaque_one() {
  float one;
  asm("mov.b32 %0, 0x3f800000;" : "=f"(one));
  return one;
}

template <typename E, int VB>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) embedding_bag_kernel(
    const E* __restrict__ table, const int32_t* __restrict__ indices,
    const int32_t* __restrict__ offsets, float* __restrict__ out,
    int64_t n, int64_t B, int64_t R, int D, int mean, int lpr, int K) {
  constexpr int V = VB / (int)sizeof(E);     // elements per load
  constexpr int U = kRows;
  __shared__ int64_t s_start[kWarps][kMaxBags + 1];  // bag k's first row
  __shared__ int32_t s_lo[kWarps][kMaxBags];         // its first position
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int64_t* st = s_start[warp];
  int32_t* sl = s_lo[warp];
  const int G = 32 / lpr;                    // rows side by side
  const int g = lane / lpr, sub = lane % lpr;
  for (int64_t b0 = ((int64_t)blockIdx.x * kWarps + warp) * K; b0 < B;
       b0 += (int64_t)gridDim.x * kWarps * K) {
    const int kc = (int)(B - b0 < K ? B - b0 : K);
    // 1. single-row bags at consecutive positions (every one-id-per-field
    //    lookup): bag k is row lo0 + k, nothing to add, no bag table
    const int64_t lo0 = __ldg(offsets + b0);
    bool unit = true;
    for (int k0 = 0; k0 < kc; k0 += 32) {
      const int k = k0 + lane;
      bool one = true;
      if (k < kc) {
        const int64_t a = __ldg(offsets + b0 + k);
        const int64_t e = __ldg(offsets + b0 + k + 1);
        one = a == lo0 + k && e == a + 1 && a >= 0 && e <= n;
      }
      unit = __all_sync(kFull, one) && unit;
    }
    if (unit) {
      // slot u of group g takes row u * G + g, so the warp's loads and
      // stores of one slot are contiguous
      const float one = opaque_one();
      for (int p0 = 0; p0 < D; p0 += lpr * V) {
        const int col = p0 + sub * V;
        const bool lane_on = g < G && col < D;
        for (int t0 = 0; t0 < kc; t0 += G * U) {
          int32_t j[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int t = t0 + u * G + g;
            j[u] = lane_on && t < kc ? (int32_t)lo0 + t : 0;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) j[u] = load_index(indices + j[u]);
          Raw<VB> raw[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t row = j[u] < 0 ? 0 : (j[u] >= R ? R - 1 : j[u]);
            raw[u] = load_raw<VB>(table + row * D + (lane_on ? col : 0));
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int t = t0 + u * G + g;
            if (lane_on && t < kc) {
              // a bag of one row is the row; the mean divides it by its
              // count at run time, as every bag's mean does
              float y[V];
              widen<E, VB>(raw[u], y);
              if (mean) {
#pragma unroll
                for (int v = 0; v < V; ++v) y[v] = y[v] / one;
              }
              store_vec<V>(out + (b0 + t) * D + col, y);
            }
          }
        }
      }
      continue;
    }

    // 2. any other chunk: clamped bounds and a prefix sum of lengths in
    //    shared memory; `contig` when bag k starts at index position
    //    lo(0) + start(k) (every well-formed CSR)
    long long run = 0;
    int32_t first_lo = 0;
    bool contig = true, empty = false;
    for (int k0 = 0; k0 < kc; k0 += 32) {
      const int k = k0 + lane;
      long long len = 0;
      int32_t lo = 0;
      if (k < kc) {
        int64_t a = __ldg(offsets + b0 + k);
        int64_t e = __ldg(offsets + b0 + k + 1);
        a = a < 0 ? 0 : (a > n ? n : a);
        e = e < a ? a : (e > n ? n : e);
        lo = (int32_t)a;
        len = e - a;
      }
      if (k0 == 0) first_lo = __shfl_sync(kFull, lo, 0);
      long long incl = len;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      const long long start = run + incl - len;
      if (k < kc) {
        st[k] = start;
        sl[k] = lo;
      }
      contig = __all_sync(kFull, k >= kc || lo - start == first_lo) && contig;
      empty = __any_sync(kFull, k < kc && len == 0) || empty;
      run += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) st[kc] = run;
    __syncwarp();
    const int64_t T = run;                   // the chunk's rows
    const int top = kc > 1 ? 1 << (31 - __clz(kc - 1)) : 0;

    // 3. tiles of G x U rows, per pass of lpr x V columns (one pass for
    //    D <= 32 V, every recsys width)
    for (int p0 = 0; p0 < D; p0 += lpr * V) {
      const int col = p0 + sub * V;
      const bool lane_on = g < G && col < D;
      float acc[V], carry[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = carry[v] = 0.f;
      for (int64_t t0 = 0; t0 < T; t0 += (int64_t)G * U) {
        // each slot's bag k (found for the group's first row, then walked
        // on), index position j (an int32: offsets are), and whether it
        // is the bag's first or last row
        const int64_t tg = t0 + (int64_t)g * U;  // the group's first row
        int32_t j[U];
        int kk[U];
        unsigned ok = 0, first = 0, last = 0;
        int k = 0;
        if (lane_on && tg < T) {             // the last bag starting <= tg
          for (int step = top; step; step >>= 1)
            if (k + step < kc && st[k + step] <= tg) k += step;
        }
        int64_t s = st[k], e = st[k + 1];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t t = tg + u;
          const bool valid = lane_on && t < T;
          if (valid && t >= e) {             // the next bag (past empty ones)
            do {
              ++k;
              s = e;
              e = st[k + 1];
            } while (t >= e);
          }
          j[u] = !valid ? 0 : contig ? first_lo + (int32_t)t
                                     : sl[k] + (int32_t)(t - s);
          ok |= (unsigned)valid << u;
          first |= (unsigned)(valid && t == s) << u;
          last |= (unsigned)(valid && t + 1 == e) << u;
          kk[u] = k;
        }
        // every index load, then every row load, before any add (a slot
        // with no row reads position 0 and row 0: T > 0, so both exist)
#pragma unroll
        for (int u = 0; u < U; ++u) j[u] = load_index(indices + j[u]);
        Raw<VB> raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t row = j[u] < 0 ? 0 : (j[u] >= R ? R - 1 : j[u]);
          raw[u] = load_raw<VB>(table + row * D + (lane_on ? col : 0));
        }
        // fold the group's rows in order into acc; store each bag at its
        // last row
        auto fold = [&]() {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!(ok >> u & 1)) continue;
            float x[V];
            widen<E, VB>(raw[u], x);
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = first >> u & 1 ? x[v] : acc[v] + x[v];
            if (last >> u & 1) {
              // the mean divides as the oracle does, by max(count, 1) =
              // count here (an IEEE division: x / 1 is x)
              const float cnt = (float)(st[kk[u] + 1] - st[kk[u]]);
              float y[V];
#pragma unroll
              for (int v = 0; v < V; ++v) y[v] = mean ? acc[v] / cnt : acc[v];
              store_vec<V>(out + (b0 + kk[u]) * D + col, y);
            }
          }
        };
        if (!__any_sync(kFull, (ok & ~first) & 1u)) {
          fold();                            // every group starts a bag
        } else {
          for (int gg = 0; gg < G; ++gg) {   // the carry, group by group
            float cin[V];
#pragma unroll
            for (int v = 0; v < V; ++v)
              cin[v] = gg == 0 ? carry[v] : __shfl_up_sync(kFull, acc[v], lpr);
            if (g == gg) {
#pragma unroll
              for (int v = 0; v < V; ++v) acc[v] = cin[v];
              fold();
            }
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
          carry[v] = __shfl_sync(kFull, acc[v], (G - 1) * lpr + sub);
      }
    }
    // 4. empty bags are zeros
    if (empty) {
      for (int k = 0; k < kc; ++k) {
        if (st[k + 1] == st[k]) {
          float* o = out + (b0 + k) * D;
          for (int i = lane; i < D; i += 32) o[i] = 0.f;
        }
      }
    }
    __syncwarp();                            // before the next chunk's table
  }
}

struct Args {
  const void* table;
  const int32_t* indices;
  const int32_t* offsets;
  float* out;
  int64_t n, B, R, D, mean, lpr, K, grid;
  cudaStream_t stream;
};

template <typename E, int VB>
int launch_vb(const Args& a) {
  if constexpr (VB < (int)sizeof(E) || VB / (int)sizeof(E) > 4) {
    return (int)cudaErrorInvalidValue;
  } else {
    embedding_bag_kernel<E, VB><<<(unsigned)a.grid, kThreads, 0, a.stream>>>(
        static_cast<const E*>(a.table), a.indices, a.offsets, a.out, a.n,
        a.B, a.R, (int)a.D, (int)a.mean, (int)a.lpr, (int)a.K);
    return (int)cudaGetLastError();
  }
}

template <typename E>
int launch(const Args& a, int64_t vec_bytes) {
  switch (vec_bytes) {
    case 16: return launch_vb<E, 16>(a);
    case 8: return launch_vb<E, 8>(a);
    case 4: return launch_vb<E, 4>(a);
    case 2: return launch_vb<E, 2>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// table: [R, D] fp32 or bf16 (table_bf16); indices int32[n]; offsets
// int32[B + 1]; out fp32 [B, D]; mean: 0 = sum, 1 = mean.  The launch
// plan (kernels/embedding_bag.launch_plan): vec_bytes per row load (at
// most 4 elements), lanes_per_row = min(32, ceil(D / elements per load)),
// bags_per_chunk (1 to 128) and the grid (CTAs of 8 warps; the warps
// stride over the chunks).  A plan the table cannot take (a load wider
// than the row or than the base address's alignment) is refused.
// Returns the launch's cudaError_t.
extern "C" int embedding_bag_launch(const void* table, int64_t table_bf16,
                                    const int32_t* indices, int64_t n,
                                    const int32_t* offsets, int64_t B,
                                    int64_t R, int64_t D, int64_t mean,
                                    int64_t vec_bytes, int64_t lanes_per_row,
                                    int64_t bags_per_chunk, int64_t grid,
                                    float* out, cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  const int64_t esize = table_bf16 ? 2 : 4;
  if (R <= 0 || D > (1 << 30) || vec_bytes < esize ||
      vec_bytes > 4 * esize || (D * esize) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(table) % vec_bytes != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t vec = vec_bytes / esize;
  const int64_t want_lpr = (D + vec - 1) / vec < 32 ? (D + vec - 1) / vec : 32;
  if (lanes_per_row != want_lpr || bags_per_chunk < 1 ||
      bags_per_chunk > kMaxBags || grid < 1 || grid > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const Args a{table, indices, offsets, out, n, B, R, D, mean,
               lanes_per_row, bags_per_chunk, grid, stream};
  if (table_bf16) return launch<unsigned short>(a, vec_bytes);
  return launch<float>(a, vec_bytes);
}
