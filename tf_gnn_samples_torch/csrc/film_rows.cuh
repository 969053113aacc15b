// The row walks of K1 (film_fwd.cu) and K2 (film_bwd_dgb.cu), designed
// for Hopper. Each source builds into a library of its own, so the kernels
// have internal linkage.
//
// Both kernels are bound by bytes: a 2D-byte message row per edge and, per
// rank, a gamma|beta(|g) row and an f32 output row, against a few
// operations per element. Their earlier design (film_walk.cuh, still the
// K16 v3 variants) gave each column a thread that walked a 64-edge chunk
// with 2-byte loads, a table row reloaded behind every rank test: about
// one load in flight a thread, 64 bytes a warp instruction, and 2.4-2.9x
// the byte bound at the QM9 batch. Here:
//
// * A lane owns VEC = 8 consecutive columns of one 64-edge chunk (a work
//   item), so a half-warp covers a 128-column row and every message, table
//   and output access is 16 bytes a lane (two f32 float4 stores for 8
//   outputs). A D that is not a multiple of 8, or a pointer or row stride
//   that is not 16-byte aligned, takes the same walk with 2-byte loads and
//   4-byte stores (template parameter V false), masked to the last column.
// * The loads of the next few edges (FWD_AHEAD for K1, DGB_AHEAD for K2)
//   are issued into registers before their sums: each edge's message row
//   and its rank's table rows (by rank, whether or not the rank changed;
//   repeats hit L1), so a lane keeps 6 x 48 bytes (K2: 4 x 64) in flight
//   instead of one 2-byte load. Deeper prefetch costs registers and so
//   warps an SM: at the QM9 batch K1 ran no faster at 8 and slower at 12,
//   K2 slower at 8. Loading a table row only where the rank changed,
//   splitting a chunk's rank runs over two or four lanes, 128-thread blocks
//   and streaming cache hints all ran no faster there either (exploratory
//   runs on the H100).
// * Blocks of THREADS items, the ranks of their chunks staged in shared
//   memory. At the QM9 batch (E 161,792, D 128) that is 632 blocks of two
//   warps, one wave on 132 SMs, so a persistent grid would have no tail to
//   remove. A cp.async or TMA ring in shared memory would stage the same
//   rows the registers hold, for a walk of at most 64 edges.
// * No tensor cores: the kernels form no matrix product. The TPU kernels'
//   windowed one-hot MXU expansion would, at ~1.5 edges a rank, multiply
//   mostly zeros.
//
// Sum order: a lane sums each rank run of its chunk in stream order from
// 0.0f, as the earlier design's thread did, and flushes it as
// film_common.cuh says: the chunk's first and last runs by atomicAdd into
// the caller's zeroed output, the runs between by stores. A row that one
// or two chunks hold therefore equals the earlier design's bit for bit;
// three or more partials meet in atomic order. Ranks are nondecreasing;
// rows in a gap are never written.
#pragma once

#include <cstdint>

#include "film_common.cuh"

namespace {

constexpr int VEC = 8;        // columns a lane owns: 16 bytes of bf16
constexpr int THREADS = 64;   // work items (lanes) a block
constexpr int FWD_AHEAD = 6;  // edges whose loads K1 issues before their sums
constexpr int DGB_AHEAD = 4;  // the same for K2

// 8 bf16 of a row, as raw bits two to a word: one 16-byte load, or
// `valid` 2-byte loads and zeros after them.
template <bool V>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int valid) {
  if (V) return __ldg(reinterpret_cast<const uint4*>(p));
  const auto* q = reinterpret_cast<const unsigned short*>(p);
  unsigned int w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (k < valid) {
      w[k / 2] |= static_cast<unsigned int>(__ldg(q + k)) << (16 * (k % 2));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Value k of load8's result (bf16 to f32 is exact: the bits move up).
__device__ __forceinline__ float bf(const uint4& v, int k) {
  const unsigned int w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
  return __uint_as_float(k % 2 ? (w & 0xffff0000u) : (w << 16));
}

// Writes a run's 8 (or `valid`) sums: by atomicAdd where the run may
// continue in a neighbouring chunk, else by stores.
template <bool V>
__device__ __forceinline__ void flush8(float* dst, const float (&acc)[VEC],
                                       int valid, bool may_span) {
  if (may_span) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (k < valid) atomicAdd(dst + k, acc[k]);
    }
  } else if (V) {
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (k < valid) dst[k] = acc[k];
    }
  }
}

// A lane's work item: columns [c, c + valid) of the chunk whose n edges
// start at edge e0 and whose ranks are at rk (shared memory).
struct Item {
  const int* rk;
  size_t e0;
  int n, c, valid;
};

// Items are numbered chunk-major (chunk * slots + column slot), THREADS a
// block. Stages the ranks of the block's chunks in shared memory and sets
// the lane's item; false for a lane past the last item.
__device__ __forceinline__ bool load_item(const int* __restrict__ ranks,
                                          int num_edges, int dim, int* s_rank,
                                          Item& it) {
  const long long slots = (dim + VEC - 1) / VEC;
  const long long chunks = (num_edges + film::CHUNK - 1) / film::CHUNK;
  const long long item0 = static_cast<long long>(blockIdx.x) * THREADS;
  const long long c_lo = item0 / slots;
  const long long last = (item0 + THREADS - 1) / slots + 1;
  const long long c_hi = last < chunks ? last : chunks;
  const long long e_lo = c_lo * film::CHUNK;
  const long long e_hi = c_hi * film::CHUNK;
  const int n_rk = static_cast<int>((e_hi < num_edges ? e_hi : num_edges) - e_lo);
  for (int i = threadIdx.x; i < n_rk; i += THREADS) {
    s_rank[i] = ranks[e_lo + i];
  }
  __syncthreads();
  const long long item = item0 + threadIdx.x;
  const long long chunk = item / slots;
  if (chunk >= chunks) return false;
  it.e0 = static_cast<size_t>(chunk) * film::CHUNK;
  it.n = min(film::CHUNK, static_cast<int>(num_edges - it.e0));
  it.rk = s_rank + (it.e0 - e_lo);
  it.c = static_cast<int>(item - chunk * slots) * VEC;
  it.valid = min(VEC, dim - it.c);
  return true;
}

// Launch shape: blocks of THREADS items, and shared memory for the ranks
// of the most chunks a block's items reach.
inline dim3 rows_grid(int num_edges, int dim) {
  const long long items =
      static_cast<long long>((num_edges + film::CHUNK - 1) / film::CHUNK) *
      ((dim + VEC - 1) / VEC);
  return dim3(static_cast<unsigned int>((items + THREADS - 1) / THREADS));
}

inline size_t rows_smem(int dim) {
  const int slots = (dim + VEC - 1) / VEC;
  return static_cast<size_t>((THREADS - 1) / slots + 2) * film::CHUNK *
         sizeof(int);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K1: out[r, d] += sum over the chunk's edges of rank r of
// bf16(act(gamma[r, d] * m[e, d] + beta[r, d])).
template <int ACT, bool V>
__global__ void __launch_bounds__(THREADS)
film_fwd_rows_kernel(const __nv_bfloat16* __restrict__ msgs,
                     const __nv_bfloat16* __restrict__ gb,
                     const int* __restrict__ ranks, float* __restrict__ out,
                     int num_edges, int dim) {
  extern __shared__ int s_rank[];
  Item it;
  if (!load_item(ranks, num_edges, dim, s_rank, it)) return;
  const __nv_bfloat16* m_col = msgs + it.e0 * dim + it.c;
  const int first = it.rk[0];
  int cur = first;
  float acc[VEC] = {};
  constexpr int AHEAD = FWD_AHEAD;
#pragma unroll 1
  for (int i0 = 0; i0 < it.n; i0 += AHEAD) {
    int r[AHEAD];
    uint4 mv[AHEAD], gv[AHEAD], bv[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      // Past the chunk's end: the last edge again, loaded but not summed.
      const int i = min(i0 + u, it.n - 1);
      r[u] = it.rk[i];
      const __nv_bfloat16* row = gb + static_cast<size_t>(r[u]) * 2 * dim + it.c;
      mv[u] = load8<V>(m_col + static_cast<size_t>(i) * dim, it.valid);
      gv[u] = load8<V>(row, it.valid);
      bv[u] = load8<V>(row + dim, it.valid);
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (i0 + u >= it.n) break;
      if (r[u] != cur) {
        flush8<V>(out + static_cast<size_t>(cur) * dim + it.c, acc, it.valid,
                  cur == first);
        cur = r[u];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc[k] += film::round_bf16(
            film::act<ACT>(bf(gv[u], k) * bf(mv[u], k) + bf(bv[u], k)));
      }
    }
  }
  flush8<V>(out + static_cast<size_t>(cur) * dim + it.c, acc, it.valid, true);
}

// K2: dgb[r, d] += sum bf16(m[e, d] * dz), dgb[r, D + d] += sum bf16(dz)
// over the chunk's edges of rank r, dz = act'(gamma m + beta) * g, with
// gamma|beta rows of ld_gb and g rows of ld_g elements.
template <int ACT, bool V>
__global__ void __launch_bounds__(THREADS)
film_bwd_dgb_rows_kernel(const __nv_bfloat16* __restrict__ msgs,
                         const __nv_bfloat16* __restrict__ gb,
                         const __nv_bfloat16* __restrict__ g,
                         const int* __restrict__ ranks,
                         float* __restrict__ dgb, int num_edges, int dim,
                         int ld_gb, int ld_g) {
  extern __shared__ int s_rank[];
  Item it;
  if (!load_item(ranks, num_edges, dim, s_rank, it)) return;
  const __nv_bfloat16* m_col = msgs + it.e0 * dim + it.c;
  const int first = it.rk[0];
  int cur = first;
  float acc_g[VEC] = {}, acc_b[VEC] = {};
  constexpr int AHEAD = DGB_AHEAD;
#pragma unroll 1
  for (int i0 = 0; i0 < it.n; i0 += AHEAD) {
    int r[AHEAD];
    uint4 mv[AHEAD], gv[AHEAD], bv[AHEAD], cv[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int i = min(i0 + u, it.n - 1);
      r[u] = it.rk[i];
      const __nv_bfloat16* row = gb + static_cast<size_t>(r[u]) * ld_gb + it.c;
      mv[u] = load8<V>(m_col + static_cast<size_t>(i) * dim, it.valid);
      gv[u] = load8<V>(row, it.valid);
      bv[u] = load8<V>(row + dim, it.valid);
      cv[u] = load8<V>(g + static_cast<size_t>(r[u]) * ld_g + it.c, it.valid);
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (i0 + u >= it.n) break;
      if (r[u] != cur) {
        float* o = dgb + static_cast<size_t>(cur) * 2 * dim + it.c;
        flush8<V>(o, acc_g, it.valid, cur == first);
        flush8<V>(o + dim, acc_b, it.valid, cur == first);
        cur = r[u];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc_g[k] = acc_b[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float m = bf(mv[u], k);
        const float dz =
            film::dact<ACT>(bf(gv[u], k) * m + bf(bv[u], k)) * bf(cv[u], k);
        acc_g[k] += film::round_bf16(m * dz);
        acc_b[k] += film::round_bf16(dz);
      }
    }
  }
  float* o = dgb + static_cast<size_t>(cur) * 2 * dim + it.c;
  flush8<V>(o, acc_g, it.valid, true);
  flush8<V>(o + dim, acc_b, it.valid, true);
}

}  // namespace
