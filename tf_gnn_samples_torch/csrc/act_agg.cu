// K12a: fused activate-aggregate, forward, one launch over all of a
// layer's type slices.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_act_agg_kernel`
// (called by `_act_agg_impl`, the forward of `act_ranked_aggregate`):
//   out[r, d] = sum_{e: rank_e = r} bf16(act(float(m[e, d])))
// with m a bf16 [E, D] stream, ranks nondecreasing and gap-free, and out an
// f32 [rows, D] table, zeroed by the caller. The activation runs in f32 and
// every term is rounded to bf16 (the TPU kernel's cast before its one-hot
// MXU dot) before the f32 sum. gelu is the Abramowitz-Stegun erf of
// film_common.cuh, as in the JAX package.
//
// GNN-Edge-MLP1 calls it on each streamed edge type's slice of the
// type-major stream (any number of edges, ranks that start anywhere). The
// rank rows of two types are disjoint, so every slice writes into one
// table. One launch takes up to MAX_SLICES slices: their message and rank
// pointers and edge counts ride in one __grid_constant__ parameter struct
// with each slice's first block, and a block finds its slice there.
//
// Bound on the card: bytes. Each edge costs a 2D-byte message row and a
// 4-byte rank, the table one 4D-byte row per rank of the streams. gelu
// through the erf polynomial counts as 30 f32 operations an element in
// the bound, a third of the byte time, but is some 40 instructions on the
// card with an IEEE division and an expf, so its issue, not the bytes,
// holds a lane that evaluates many of them in a row. Its earlier design
// (act_agg_walk.cu, one launch a slice) gave each column a thread that
// walked a 64-edge chunk with 2-byte loads, one term at a time; three of
// QM9's four streamed slices are 2,048-6,144 edges, 32-96 chunks, well
// under one wave of the card a launch. Here the walk is K1's
// (film_rows.cuh) without the gamma|beta rows, one launch for the layer:
// * a lane owns LW = 2 consecutive columns of one 64-edge chunk of one
//   slice (4-byte loads, a warp on 128 contiguous bytes of a row); with 8
//   columns a lane, as K1 has, each lane evaluated 512 gelus in a row and
//   the layer ran 4.2x its bound on the H100 (PERF.md);
// * it issues AHEAD edges' loads before their sums, and computes all of
//   their terms before it adds any, so their arithmetic overlaps;
// * interior rank runs are stored, only a chunk's first and last runs
//   added by atomicAdd (2-byte loads and 4-byte stores, template parameter
//   V false, for an odd D or a pointer that is not aligned).
// Blocks never span two slices, and a slice's chunks start at its own
// first edge, so every rank run is summed in the order of the per-slice
// launches of the earlier design.
#include <climits>

#include "film_rows.cuh"

namespace {

constexpr int MAX_SLICES = 32;  // slices one launch takes (ACT_AGG_MAX_SLICES)
constexpr int LW = 2;           // columns a lane owns
constexpr int AHEAD = 8;        // edges whose loads a lane issues ahead

// The non-empty slices of one launch; block0[s] is slice s's first block
// of the grid, block0[count] the grid's size.
struct Slices {
  const __nv_bfloat16* msgs[MAX_SLICES];
  const int* ranks[MAX_SLICES];
  int num_edges[MAX_SLICES];
  int block0[MAX_SLICES + 1];
  int count;
};

// LW = 2 bf16 of a row as raw bits: one 4-byte load, or `valid` 2-byte
// loads.
template <bool V>
__device__ __forceinline__ unsigned int load2(const __nv_bfloat16* p,
                                              int valid) {
  if (V) return __ldg(reinterpret_cast<const unsigned int*>(p));
  const auto* q = reinterpret_cast<const unsigned short*>(p);
  unsigned int w = __ldg(q);
  if (valid > 1) w |= static_cast<unsigned int>(__ldg(q + 1)) << 16;
  return w;
}

template <int ACT, bool V>
__global__ void __launch_bounds__(THREADS)
act_agg_rows_kernel(const __grid_constant__ Slices sl, float* __restrict__ out,
                    int dim) {
  extern __shared__ int s_rank[];
  const int b = static_cast<int>(blockIdx.x);
  int s = 0;
  while (s + 1 < sl.count && b >= sl.block0[s + 1]) ++s;
  Item it;
  if (!load_item_at<LW>(b - sl.block0[s], sl.ranks[s], sl.num_edges[s], dim,
                        s_rank, it)) {
    return;
  }
  const __nv_bfloat16* m_col = sl.msgs[s] + it.e0 * dim + it.c;
  float* o = out + it.c;
  const int first = it.rk[0];
  int cur = first;
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 1
  for (int i0 = 0; i0 < it.n; i0 += AHEAD) {
    int r[AHEAD];
    unsigned int mv[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      // Past the chunk's end: the last edge again, loaded but not summed.
      const int i = min(i0 + u, it.n - 1);
      r[u] = it.rk[i];
      mv[u] = load2<V>(m_col + static_cast<size_t>(i) * dim, it.valid);
    }
    // Every term of the AHEAD edges first, with no branch between them.
    float t0[AHEAD], t1[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      t0[u] = film::round_bf16(film::act<ACT>(__uint_as_float(mv[u] << 16)));
      t1[u] = film::round_bf16(
          film::act<ACT>(__uint_as_float(mv[u] & 0xffff0000u)));
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (i0 + u >= it.n) break;
      if (r[u] != cur) {
        film::flush2<V>(o + static_cast<size_t>(cur) * dim, a0, a1, it.valid,
                        cur == first);
        cur = r[u];
        a0 = a1 = 0.0f;
      }
      a0 += t0[u];
      a1 += t1[u];
    }
  }
  film::flush2<V>(o + static_cast<size_t>(cur) * dim, a0, a1, it.valid, true);
}

template <int ACT>
int launch(const Slices& sl, float* o, int dim, bool vec, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(sl.block0[sl.count]));
  const size_t smem = rows_smem<LW>(dim);
  if (vec) {
    act_agg_rows_kernel<ACT, true><<<grid, THREADS, smem, s>>>(sl, o, dim);
  } else {
    act_agg_rows_kernel<ACT, false><<<grid, THREADS, smem, s>>>(sl, o, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// Host arrays of `num_slices` (at most MAX_SLICES) message and rank
// pointers and edge counts; empty slices are skipped, and nothing is
// launched where every slice is empty. One launch otherwise.
extern "C" int act_agg_slices_launch(const void* const* msgs,
                                     const void* const* ranks,
                                     const int* num_edges, int num_slices,
                                     void* out, int dim, int act,
                                     void* stream) {
  if (num_slices < 0 || num_slices > MAX_SLICES || dim <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Slices sl = {};
  long long blocks = 0;
  bool vec = dim % LW == 0 && aligned(out, 8);
  for (int i = 0; i < num_slices; ++i) {
    if (num_edges[i] <= 0) continue;
    const int j = sl.count++;
    sl.msgs[j] = static_cast<const __nv_bfloat16*>(msgs[i]);
    sl.ranks[j] = static_cast<const int*>(ranks[i]);
    sl.num_edges[j] = num_edges[i];
    sl.block0[j] = static_cast<int>(blocks);
    blocks += rows_grid<LW>(num_edges[i], dim).x;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    vec = vec && aligned(msgs[i], 4);
  }
  if (sl.count == 0) return 0;
  sl.block0[sl.count] = static_cast<int>(blocks);
  FILM_DISPATCH_ACT_CALL(act, launch, sl, static_cast<float*>(out), dim, vec,
                         static_cast<cudaStream_t>(stream))
}
