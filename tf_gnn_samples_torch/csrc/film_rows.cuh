// The row walks of K1 (film_fwd.cu), K2 (film_bwd_dgb.cu), K3
// (film_src_bwd.cu) and K4 (film_bwd.cu), designed for Hopper; K12a
// (act_agg.cu), K9 (rgat_src_bwd.cu) and K7a / K13a (wseg_common.cuh)
// build on its pieces. Each source
// builds into a library of its own, so the kernels have internal linkage.
//
// All four are bound by bytes: per edge a 2D-byte message row (K1, K2,
// K4; K4 also writes a 2D-byte cotangent row) or a gathered 6D-byte
// gamma|beta|g row (K3), per rank a table or t row and an f32 output row,
// against a few operations per element. Their earlier design (K1 / K2:
// film_walk.cuh, still the K16 v3 variants; K3 / K4: film_src_bwd_walk.cu
// and film_bwd_walk.cu) gave each column a thread that walked a 64-edge
// chunk with 2-byte loads, a table row reloaded behind every rank test:
// about one load in flight a thread, 64 bytes a warp instruction, and
// 2.2-2.9x the byte bound at the QM9 batch. Here:
//
// * A lane owns VEC = 8 consecutive columns of one 64-edge chunk (a work
//   item), so a half-warp covers a 128-column row and every message, table
//   and output access is 16 bytes a lane (two f32 float4 stores for 8
//   outputs; K4's 8 bf16 cotangents one 16-byte store). A D that is not a
//   multiple of 8, or a pointer or row stride that is not 16-byte aligned,
//   takes the same walk with 2-byte loads and stores and 4-byte f32 stores
//   (template parameter V false), masked to the last column.
// * The loads of the next few edges (FWD_AHEAD for K1, DGB_AHEAD for K2
//   and K4, SRC_AHEAD for K3) are issued into registers before their sums:
//   each edge's message row and its rank's table rows (by rank, whether or
//   not the rank changed; repeats hit L1), so a lane keeps 6 x 48 bytes
//   (K2, K4, K3: 4 x 64) in flight instead of one 2-byte load. Deeper
//   prefetch costs registers and so warps an SM: at the QM9 batch K1 ran
//   no faster at 8 and slower at 12, K2 slower at 8. Loading a table row
//   only where the rank changed, splitting a chunk's rank runs over two or
//   four lanes, 128-thread blocks and streaming cache hints all ran no
//   faster there either (exploratory runs on the H100).
// * K3 reads its per-edge rows through indices (its gather form): edge e's
//   gamma|beta and g rows at its fine rank f_e, and its source group's t
//   row at clip(t_index[s_e]). The block stages f_e and the clipped t row
//   of every edge in shared memory beside the ranks, so a lane's loads of
//   the next edges need no dependent global load first. Without this the
//   caller built an [E, 3D] gamma|beta|gamma*g stream and an [R_src, D]
//   t stream for the kernel: about five times K3's own bytes a layer. An
//   f_e outside [0, RPAD) (the diluted stream's fill key) reads nothing
//   and adds an exact zero term.
// * Blocks of THREADS items, the ranks of their chunks staged in shared
//   memory. At the QM9 batch (E 161,792, D 128) that is 632 blocks of two
//   warps, one wave on 132 SMs, so a persistent grid would have no tail to
//   remove. A cp.async or TMA ring in shared memory would stage the same
//   rows the registers hold, for a walk of at most 64 edges.
// * No tensor cores: the kernels form no matrix product. The TPU kernels'
//   windowed one-hot MXU expansion and reduction would, at ~1.5 edges a
//   rank, multiply mostly zeros.
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
constexpr int DGB_AHEAD = 4;  // the same for K2 and K4
constexpr int SRC_AHEAD = 4;  // the same for K3

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

// Stores 8 (or `valid`) values as bf16, rounded to nearest: one 16-byte
// store, or `valid` 2-byte stores.
template <bool V>
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float (&v)[VEC], int valid) {
  if (V) {
    unsigned int w[VEC / 2];
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned int*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (k < valid) dst[k] = __float2bfloat16_rn(v[k]);
    }
  }
}

// A lane's work item: columns [c, c + valid) of the chunk whose n edges
// start at edge e0 and whose ranks are at rk (shared memory); `off` is the
// chunk's first edge in the block's staged arrays.
struct Item {
  const int* rk;
  size_t e0;
  int n, c, valid, off;
};

// Ints a block stages per array: the edges of the most chunks its items
// reach, for lanes of W columns.
template <int W = VEC>
__host__ __device__ __forceinline__ int rows_cap(int dim) {
  const int slots = (dim + W - 1) / W;
  return ((THREADS - 1) / slots + 2) * film::CHUNK;
}

// Does nothing: load_item's `stage` where a kernel stages the ranks alone.
struct NoStage {
  __device__ void operator()(int, size_t, int) const {}
};

// Items are numbered chunk-major (chunk * slots + column slot), THREADS a
// block, a slot being W columns. Stages the ranks of block `block`'s
// chunks in shared memory, calls stage(i, e, rank) for each of those edges
// (local index i, edge e) to stage more, and sets the lane's item; false
// for a lane past the last item. `block` is the block's index in the
// stream's own grid (K12a walks several streams in one grid).
// The edges of the chunks that the items of block `block` reach: the
// first one (e_lo), and their count (returned).
template <int W = VEC>
__device__ __forceinline__ int block_edges(long long block, int num_edges,
                                           int dim, long long& e_lo) {
  const long long slots = (dim + W - 1) / W;
  const long long chunks = (num_edges + film::CHUNK - 1) / film::CHUNK;
  const long long item0 = block * THREADS;
  const long long last = (item0 + THREADS - 1) / slots + 1;
  const long long c_hi = last < chunks ? last : chunks;
  e_lo = item0 / slots * film::CHUNK;
  const long long e_hi = c_hi * film::CHUNK;
  return static_cast<int>((e_hi < num_edges ? e_hi : num_edges) - e_lo);
}

template <int W = VEC, typename Stage = NoStage>
__device__ __forceinline__ bool load_item_at(long long block,
                                             const int* __restrict__ ranks,
                                             int num_edges, int dim,
                                             int* s_rank, Item& it,
                                             Stage stage = Stage()) {
  const long long slots = (dim + W - 1) / W;
  const long long chunks = (num_edges + film::CHUNK - 1) / film::CHUNK;
  const long long item0 = block * THREADS;
  long long e_lo;
  const int n_rk = block_edges<W>(block, num_edges, dim, e_lo);
  for (int i = threadIdx.x; i < n_rk; i += THREADS) {
    const int r = ranks[e_lo + i];
    s_rank[i] = r;
    stage(i, static_cast<size_t>(e_lo + i), r);
  }
  __syncthreads();
  const long long item = item0 + threadIdx.x;
  const long long chunk = item / slots;
  if (chunk >= chunks) return false;
  it.e0 = static_cast<size_t>(chunk) * film::CHUNK;
  it.n = min(film::CHUNK, static_cast<int>(num_edges - it.e0));
  it.off = static_cast<int>(it.e0 - e_lo);
  it.rk = s_rank + it.off;
  it.c = static_cast<int>(item - chunk * slots) * W;
  it.valid = min(W, dim - it.c);
  return true;
}

// load_item_at for the block's own index in the grid.
template <typename Stage = NoStage>
__device__ __forceinline__ bool load_item(const int* __restrict__ ranks,
                                          int num_edges, int dim, int* s_rank,
                                          Item& it, Stage stage = Stage()) {
  return load_item_at<VEC>(blockIdx.x, ranks, num_edges, dim, s_rank, it,
                           stage);
}

// Launch shape: blocks of THREADS items of W columns, and shared memory
// for `arrays` staged int arrays (the ranks, and K3's fine ranks and t
// rows) of the most chunks a block's items reach.
template <int W = VEC>
inline dim3 rows_grid(int num_edges, int dim) {
  const long long items =
      static_cast<long long>((num_edges + film::CHUNK - 1) / film::CHUNK) *
      ((dim + W - 1) / W);
  return dim3(static_cast<unsigned int>((items + THREADS - 1) / THREADS));
}

template <int W = VEC>
inline size_t rows_smem(int dim, int arrays = 1) {
  return static_cast<size_t>(arrays) * rows_cap<W>(dim) * sizeof(int);
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

// K2 (DMSG false) and K4 (DMSG true): dgb[r, d] += sum bf16(m[e, d] * dz),
// dgb[r, D + d] += sum bf16(dz) over the chunk's edges of rank r, dz =
// act'(gamma m + beta) * g, with gamma|beta rows of ld_gb and g rows of
// ld_g elements; K4 also writes dmsg[e, d] = bf16(gamma * dz).
template <int ACT, bool V, bool DMSG>
__device__ __forceinline__ void bwd_rows(const __nv_bfloat16* __restrict__ msgs,
                                         const __nv_bfloat16* __restrict__ gb,
                                         const __nv_bfloat16* __restrict__ g,
                                         const int* __restrict__ ranks,
                                         __nv_bfloat16* __restrict__ dmsg,
                                         float* __restrict__ dgb,
                                         int num_edges, int dim, int ld_gb,
                                         int ld_g) {
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
      float dm[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float m = bf(mv[u], k), gamma = bf(gv[u], k);
        const float dz = film::dact<ACT>(gamma * m + bf(bv[u], k)) * bf(cv[u], k);
        acc_g[k] += film::round_bf16(m * dz);
        acc_b[k] += film::round_bf16(dz);
        dm[k] = gamma * dz;
      }
      if constexpr (DMSG) {
        store8_bf16<V>(dmsg + (it.e0 + i0 + u) * dim + it.c, dm, it.valid);
      }
    }
  }
  float* o = dgb + static_cast<size_t>(cur) * 2 * dim + it.c;
  flush8<V>(o, acc_g, it.valid, true);
  flush8<V>(o + dim, acc_b, it.valid, true);
}

// K2: d_gamma | d_beta alone.
template <int ACT, bool V>
__global__ void __launch_bounds__(THREADS)
film_bwd_dgb_rows_kernel(const __nv_bfloat16* __restrict__ msgs,
                         const __nv_bfloat16* __restrict__ gb,
                         const __nv_bfloat16* __restrict__ g,
                         const int* __restrict__ ranks,
                         float* __restrict__ dgb, int num_edges, int dim,
                         int ld_gb, int ld_g) {
  bwd_rows<ACT, V, false>(msgs, gb, g, ranks, nullptr, dgb, num_edges, dim,
                          ld_gb, ld_g);
}

// K4: K2 and the per-edge message cotangent. A kernel of its own name, so
// a profile tells the two apart.
template <int ACT, bool V>
__global__ void __launch_bounds__(THREADS)
film_bwd_rows_kernel(const __nv_bfloat16* __restrict__ msgs,
                     const __nv_bfloat16* __restrict__ gb,
                     const __nv_bfloat16* __restrict__ g,
                     const int* __restrict__ ranks,
                     __nv_bfloat16* __restrict__ dmsg, float* __restrict__ dgb,
                     int num_edges, int dim, int ld_gb, int ld_g) {
  bwd_rows<ACT, V, true>(msgs, gb, g, ranks, dmsg, dgb, num_edges, dim,
                         ld_gb, ld_g);
}

// K3: dt[s, d] += sum over the chunk's edges of src rank s of
// bf16(act'(gamma_e t[s] + beta_e) * C_e). GATHER false (the stream form):
// gamma|beta|C is row e of the [E, 3D] stream gcb and t[s] row s of t.
// GATHER true: gamma|beta is row f_e = fine[e] of gb (rows of ld_gb), C =
// bf16(gamma * g[f_e]) (g rows of ld_g), and t[s] is row
// clip(t_index[s], 0, t_rows - 1) of t; an f_e outside [0, rpad) reads
// nothing and adds bf16(act'(0) * 0) = 0.
template <int ACT, bool V, bool GATHER>
__global__ void __launch_bounds__(THREADS)
film_src_bwd_rows_kernel(const __nv_bfloat16* __restrict__ gcb,
                         const __nv_bfloat16* __restrict__ gb,
                         const __nv_bfloat16* __restrict__ g,
                         const int* __restrict__ fine,
                         const __nv_bfloat16* __restrict__ t,
                         const int* __restrict__ t_index,
                         const int* __restrict__ ranks,
                         float* __restrict__ dt, int num_edges, int dim,
                         int ld_gb, int ld_g, int rpad, int t_rows) {
  extern __shared__ int s_rank[];
  int* s_fine = s_rank + rows_cap(dim);
  int* s_trow = s_fine + rows_cap(dim);
  Item it;
  bool live;
  if constexpr (GATHER) {
    live = load_item(ranks, num_edges, dim, s_rank, it,
                     [&](int i, size_t e, int r) {
                       s_fine[i] = fine[e];
                       s_trow[i] = min(max(t_index[r], 0), t_rows - 1);
                     });
  } else {
    live = load_item(ranks, num_edges, dim, s_rank, it);
  }
  if (!live) return;
  const int first = it.rk[0];
  int cur = first;
  float acc[VEC] = {};
  constexpr int AHEAD = SRC_AHEAD;
#pragma unroll 1
  for (int i0 = 0; i0 < it.n; i0 += AHEAD) {
    int r[AHEAD];
    uint4 tv[AHEAD], gv[AHEAD], bv[AHEAD], cv[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int i = min(i0 + u, it.n - 1);
      r[u] = it.rk[i];
      if constexpr (GATHER) {
        const int f = s_fine[it.off + i];
        if (static_cast<unsigned int>(f) < static_cast<unsigned int>(rpad)) {
          const __nv_bfloat16* row = gb + static_cast<size_t>(f) * ld_gb + it.c;
          gv[u] = load8<V>(row, it.valid);
          bv[u] = load8<V>(row + dim, it.valid);
          cv[u] = load8<V>(g + static_cast<size_t>(f) * ld_g + it.c, it.valid);
          tv[u] = load8<V>(t + static_cast<size_t>(s_trow[it.off + i]) * dim + it.c,
                           it.valid);
        } else {
          gv[u] = bv[u] = cv[u] = tv[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        const __nv_bfloat16* row = gcb + (it.e0 + i) * 3 * dim + it.c;
        gv[u] = load8<V>(row, it.valid);
        bv[u] = load8<V>(row + dim, it.valid);
        cv[u] = load8<V>(row + 2 * dim, it.valid);
        tv[u] = load8<V>(t + static_cast<size_t>(r[u]) * dim + it.c, it.valid);
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (i0 + u >= it.n) break;
      if (r[u] != cur) {
        flush8<V>(dt + static_cast<size_t>(cur) * dim + it.c, acc, it.valid,
                  cur == first);
        cur = r[u];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float gamma = bf(gv[u], k);
        // gamma * g is exact in f32 (two 8-bit significands); rounding it
        // once gives the caller's bf16 product bit for bit.
        const float c = GATHER ? film::round_bf16(gamma * bf(cv[u], k))
                               : bf(cv[u], k);
        acc[k] += film::round_bf16(
            film::dact<ACT>(gamma * bf(tv[u], k) + bf(bv[u], k)) * c);
      }
    }
  }
  flush8<V>(dt + static_cast<size_t>(cur) * dim + it.c, acc, it.valid, true);
}

}  // namespace
