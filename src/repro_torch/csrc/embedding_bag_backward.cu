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
// Deterministic by design, bit for bit from run to run: no atomics.  The
// wrapper's plan (kernels/embedding_bag.py) sorts the positions stably by
// their clipped row (rows of positions outside every bag become R and sort
// last), so each row's contributions form one run of the sorted array,
// in position order.  The launch runs four kernels on the caller's
// stream:
//
// 1. `bag_of`: each position's bag, a binary search of the offsets (the
//    first b with offsets[b+1] > j, as searchsorted(right=True) finds it);
// 2. `zero_fill`: the dense d_table, 16-byte stores;
// 3. `chunks`: the sorted array in chunks of kChunk entries, one chunk a
//    group of `lanes` lanes (each lane `vec` columns of a row, vector
//    loads).  A group walks its chunk in order, summing each run from
//    0.0f; a run that starts and ends in the chunk is written to its row
//    at once, the chunk's first run, if it began earlier, is kept as the
//    chunk's `head` sum, and its last run, if it goes on past the chunk,
//    as its `tail` sum (flag bit 0: this chunk owns the run; bit 1: the
//    chunk lies inside one run that goes on past it);
// 4. `combine`: each owning chunk adds the heads of the chunks after it,
//    in order, up to the chunk where the run ends, and writes the row.
//
// So every row sums its contributions in one fixed order: in position
// order inside a chunk, chunk after chunk.  A row with one contribution
// is 0.0f + g, the plain version's bits; a run inside one chunk is the
// plain version's in-order sum; longer runs differ from it only in
// association (fp32 rounding).
//
// Bound on an H100: memory.  The call must write the dense d_table (R x D
// of the table's dtype: 2.16 GB at DCN-v2's 33,762,816 x 16 fp32 table)
// and read grad_out, the indices and the offsets once.  The zero fill is
// that write; the touched rows are written a second time, and the plan's
// sort and the scratch (bag_of, heads, tails) add about 16 bytes a
// position.  Making it faster (writing each row once, no sort) is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps per CTA of the chunk kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;       // sorted entries per chunk (kernels/embedding_bag.py)
constexpr int kAhead = 8;        // entries (heads) loaded before they are added

__global__ void bag_of_kernel(const int32_t* __restrict__ offsets, int64_t B,
                              int64_t N, int32_t* __restrict__ bag_of) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < N;
       j += (int64_t)gridDim.x * blockDim.x) {
    int64_t lo = 0, hi = B;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if ((int64_t)__ldg(offsets + mid + 1) > j) hi = mid; else lo = mid + 1;
    }
    bag_of[j] = (int32_t)lo;
  }
}

__global__ void zero_fill_kernel(uint4* __restrict__ out, int64_t n16,
                                 unsigned char* __restrict__ tail,
                                 int64_t n_tail) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n16;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = z;
  if (blockIdx.x == 0 && threadIdx.x < n_tail) tail[threadIdx.x] = 0;
}

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

struct Args {
  const float* grad_out;
  const int32_t* offsets;
  const int32_t* key;      // sorted clipped rows; R = outside every bag
  const int32_t* perm;     // positions in sorted order
  const int32_t* bag_of;
  float* head;             // [n_chunks, D]
  float* tail;             // [n_chunks, D]
  unsigned char* flags;    // [n_chunks]
  void* d_table;
  int64_t N, R, D, n_chunks;
  int mean, lanes;
};

// Kernel 3: one chunk per group of `lanes` lanes (see the header).
template <int V, bool BF16>
__global__ void __launch_bounds__(kThreads)
bag_bwd_chunks(const Args a) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / a.lanes;
  const int g = lane / a.lanes, gl = lane % a.lanes;
  if (g >= groups) return;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t c = warp * groups + g; c < a.n_chunks; c += nwarps * groups) {
    const int64_t s = c * kChunk;
    const int64_t e = s + kChunk < a.N ? s + kChunk : a.N;
    const int32_t first = __ldg(a.key + s);
    if (first >= a.R) {                    // only positions outside bags
      if (gl == 0) a.flags[c] = 0;
      continue;
    }
    const bool first_here = s == 0 || __ldg(a.key + s - 1) != first;
    for (int64_t col = (int64_t)gl * V; col < a.D; col += (int64_t)a.lanes * V) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      int32_t run = first;
      bool here = first_here;
      unsigned char flag = 0;
      int64_t j = s;
      bool stop = false;
      while (j < e && !stop) {
        // load up to kAhead entries, then add them in order
        int32_t k[kAhead];
        float x[kAhead][V];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          k[u] = j + u < e ? __ldg(a.key + j + u) : (int32_t)a.R;
          if (k[u] < a.R) {
            const int32_t b = __ldg(a.bag_of + __ldg(a.perm + j + u));
            load_vec<V>(a.grad_out + (int64_t)b * a.D + col, x[u]);
            if (a.mean) {
              const int32_t n = __ldg(a.offsets + b + 1) - __ldg(a.offsets + b);
              const float cnt = (float)(n > 1 ? n : 1);
#pragma unroll
              for (int i = 0; i < V; ++i) x[u][i] = x[u][i] / cnt;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (stop || j + u >= e) continue;
          if (k[u] >= a.R) { stop = true; continue; }
          if (k[u] != run) {                 // `run` ended inside the chunk
            if (here) {
              store_row<V, BF16>(a.d_table, (int64_t)run * a.D + col, acc);
            } else {
              store_f32<V>(a.head + c * a.D + col, acc);
            }
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = 0.0f;
            run = k[u];
            here = true;
          }
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += x[u][i];
        }
        j += kAhead;
      }
      // the chunk's last run: does it go on past the chunk?
      const bool ends = stop || e == a.N || __ldg(a.key + e) != run;
      if (here && ends) {
        store_row<V, BF16>(a.d_table, (int64_t)run * a.D + col, acc);
      } else if (!here) {                    // began before the chunk
        store_f32<V>(a.head + c * a.D + col, acc);
        if (!ends) flag = 2;
      } else {                               // begins here, goes on
        store_f32<V>(a.tail + c * a.D + col, acc);
        flag = 1;
      }
      if (gl == 0 && col == 0) a.flags[c] = flag;
    }
  }
}

// Kernel 4: each owning chunk's run, its tail plus the following heads.
template <int V, bool BF16>
__global__ void __launch_bounds__(kThreads)
bag_bwd_combine(const Args a) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / a.lanes;
  const int g = lane / a.lanes, gl = lane % a.lanes;
  if (g >= groups) return;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t c = warp * groups + g; c < a.n_chunks; c += nwarps * groups) {
    if (!(__ldg(a.flags + c) & 1)) continue;
    const int64_t last = (c + 1) * kChunk - 1;   // < N: the run goes on
    const int32_t row = __ldg(a.key + last);
    for (int64_t col = (int64_t)gl * V; col < a.D; col += (int64_t)a.lanes * V) {
      float acc[V];
      load_vec<V>(a.tail + c * a.D + col, acc);
      int64_t c2 = c + 1;
      bool done = false;
      while (!done) {
        unsigned char f[kAhead];
        float h[kAhead][V];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (c2 + u < a.n_chunks) {
            f[u] = __ldg(a.flags + c2 + u);
            load_vec<V>(a.head + (c2 + u) * a.D + col, h[u]);
          } else {
            f[u] = 0;
#pragma unroll
            for (int i = 0; i < V; ++i) h[u][i] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (done) continue;
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += h[u][i];
          if (!(f[u] & 2)) done = true;
        }
        c2 += kAhead;
      }
      store_row<V, BF16>(a.d_table, (int64_t)row * a.D + col, acc);
    }
  }
}

template <int V, bool BF16>
cudaError_t run(const Args& a, int64_t grid, cudaStream_t stream) {
  bag_bwd_chunks<V, BF16><<<(unsigned)grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bag_bwd_combine<V, BF16><<<(unsigned)grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int embedding_bag_backward_launch(
    const float* grad_out, int64_t B, int64_t D, const int32_t* offsets,
    const int32_t* key, const int32_t* perm, int64_t N, int64_t R,
    int64_t mean, int64_t out_bf16, int64_t vec, int64_t lanes,
    int64_t grid, int32_t* bag_of, float* head, float* tail,
    unsigned char* flags, void* d_table, int64_t sms, cudaStream_t stream) {
  if (R <= 0 || D <= 0) return 0;
  if (B < 0 || N < 0 || R > 2147483646 || D > (1 << 30) || sms < 1 ||
      (vec != 1 && vec != 2 && vec != 4) || D % vec != 0 ||
      reinterpret_cast<uintptr_t>(grad_out) % (4 * vec) != 0 ||
      lanes != ((D + vec - 1) / vec < 32 ? (D + vec - 1) / vec : 32) ||
      grid < 1 || grid > (1 << 30))
    return (int)cudaErrorInvalidValue;
  // 2: the dense zero fill
  const int64_t bytes = R * D * (out_bf16 ? 2 : 4);
  const int64_t n16 = bytes / 16;
  const int64_t fill_grid = sms * 8;
  zero_fill_kernel<<<(unsigned)fill_grid, 256, 0, stream>>>(
      reinterpret_cast<uint4*>(d_table), n16,
      reinterpret_cast<unsigned char*>(d_table) + n16 * 16, bytes - n16 * 16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || N == 0 || B == 0) return (int)err;
  // 1: each position's bag
  int64_t pgrid = (N + 255) / 256;
  if (pgrid > sms * 32) pgrid = sms * 32;
  bag_of_kernel<<<(unsigned)pgrid, 256, 0, stream>>>(offsets, B, N, bag_of);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Args a{grad_out, offsets, key, perm, bag_of, head, tail, flags,
               d_table, N, R, D, (N + kChunk - 1) / kChunk, (int)mean,
               (int)lanes};
  if (out_bf16) {
    if (vec == 4) return (int)run<4, true>(a, grid, stream);
    if (vec == 2) return (int)run<2, true>(a, grid, stream);
    return (int)run<1, true>(a, grid, stream);
  }
  if (vec == 4) return (int)run<4, false>(a, grid, stream);
  if (vec == 2) return (int)run<2, false>(a, grid, stream);
  return (int)run<1, false>(a, grid, stream);
}
