// The sorted-rank walks of K1 (film_fwd.cu) and K2 (film_bwd_dgb.cu),
// templated on the edges a block walks: CHUNK for the shipped kernels,
// 64 * G for their K16 v3 variants (film_fwd_ab.cu, film_dgb_ab.cu), whose
// v2a variant also sums its columns with K1's walk. Each source builds
// into a library of its own, so the kernels have internal linkage.
//
// Ranks are nondecreasing; a gap between two ranks is allowed (its rows
// stay zero). A block's first and last segments may continue in a
// neighbouring block and are added atomically, the others stored
// (film_common.cuh).
#pragma once

#include "film_common.cuh"

namespace {

// K1's column walk: sums column d of the block's n edges (from e0) in
// stream order and calls emit(rank, sum, last) once per rank run, `last`
// for the block's last run.
template <int ACT, typename Emit>
__device__ __forceinline__ void walk_column(
    const __nv_bfloat16* __restrict__ msgs,
    const __nv_bfloat16* __restrict__ gb, const int* s_rank, int n,
    size_t e0, int d, int dim, Emit emit) {
  int cur = s_rank[0];
  const __nv_bfloat16* row = gb + static_cast<size_t>(cur) * 2 * dim;
  float gamma = film::ld(row + d), beta = film::ld(row + dim + d);
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int r = s_rank[i];
    if (r != cur) {
      emit(cur, acc, false);
      cur = r;
      acc = 0.0f;
      row = gb + static_cast<size_t>(cur) * 2 * dim;
      gamma = film::ld(row + d);
      beta = film::ld(row + dim + d);
    }
    const float m = film::ld(msgs + (e0 + i) * dim + d);
    acc += film::round_bf16(film::act<ACT>(gamma * m + beta));
  }
  emit(cur, acc, true);
}

// K1: out[r, d] += sum over the block's edges of rank r of
// bf16(act(gamma[r, d] * m[e, d] + beta[r, d])).
template <int ACT, int EDGES = film::CHUNK>
__global__ void __launch_bounds__(film::MAX_THREADS)
film_fwd_kernel(const __nv_bfloat16* __restrict__ msgs,
                const __nv_bfloat16* __restrict__ gb,
                const int* __restrict__ ranks, float* __restrict__ out,
                int num_edges, int dim) {
  __shared__ int s_rank[EDGES];
  const int n = film::load_chunk_ranks<EDGES>(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * EDGES;
  const int first = s_rank[0];
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    walk_column<ACT>(msgs, gb, s_rank, n, e0, d, dim,
                     [&](int r, float acc, bool last) {
                       film::flush(out + static_cast<size_t>(r) * dim + d,
                                   acc, last || r == first);
                     });
  }
}

// K2: dgb[r, d] += sum bf16(m[e, d] * dz), dgb[r, D + d] += sum bf16(dz)
// over the block's edges of rank r, dz = act'(gamma m + beta) * g.
template <int ACT, int EDGES = film::CHUNK>
__global__ void __launch_bounds__(film::MAX_THREADS)
film_bwd_dgb_kernel(const __nv_bfloat16* __restrict__ msgs,
                    const __nv_bfloat16* __restrict__ gbg,
                    const int* __restrict__ ranks, float* __restrict__ dgb,
                    int num_edges, int dim) {
  __shared__ int s_rank[EDGES];
  const int n = film::load_chunk_ranks<EDGES>(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * EDGES;
  const int first = s_rank[0];
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    int cur = first;
    const __nv_bfloat16* row = gbg + static_cast<size_t>(cur) * 3 * dim;
    float gamma = film::ld(row + d), beta = film::ld(row + dim + d),
          g = film::ld(row + 2 * dim + d);
    float acc_g = 0.0f, acc_b = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        float* o = dgb + static_cast<size_t>(cur) * 2 * dim;
        film::flush(o + d, acc_g, cur == first);
        film::flush(o + dim + d, acc_b, cur == first);
        cur = r;
        acc_g = acc_b = 0.0f;
        row = gbg + static_cast<size_t>(cur) * 3 * dim;
        gamma = film::ld(row + d);
        beta = film::ld(row + dim + d);
        g = film::ld(row + 2 * dim + d);
      }
      const float m = film::ld(msgs + (e0 + i) * dim + d);
      const float dz = film::dact<ACT>(gamma * m + beta) * g;
      acc_g += film::round_bf16(m * dz);
      acc_b += film::round_bf16(dz);
    }
    float* o = dgb + static_cast<size_t>(cur) * 2 * dim;
    atomicAdd(o + d, acc_g);
    atomicAdd(o + dim + d, acc_b);
  }
}

}  // namespace
