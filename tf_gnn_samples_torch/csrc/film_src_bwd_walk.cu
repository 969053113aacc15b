// K3's earlier design (PRs 1-9): the dt half of the fused GNN-FiLM
// backward over the SOURCE-sorted stream, a thread per column walking a
// 64-edge chunk. film_src_bwd.cu (csrc/film_rows.cuh) replaced it on every
// model path; this body stays, unchanged, as the baseline that the
// redesign is held and timed against (tools/earlier_designs.py; launches
// counted under "film_src_bwd_walk", 0 on every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_film_src_bwd_kernel`
// (:493, called by `_film_src_bwd_impl`). With s_e the src rank of edge e:
//   z = gamma_e * t[s_e] + beta_e
//   dt[s, d] = sum_{e: s_e = s} bf16(act'(z) * C_e),   C = gamma * g
// with gamma|beta|C a bf16 [E, 3D] stream, t a bf16 [R_src, D] table of
// the messages in src-rank order and dt an f32 [R_src, D] table, zeroed by
// the caller. Bound on the card: bytes. The t row of the current source
// group is read once per segment and kept in a register; every other load
// is 2 bytes, one in flight a thread.
#include "film_common.cuh"

namespace {

template <int ACT>
__global__ void __launch_bounds__(film::MAX_THREADS)
film_src_bwd_kernel(const __nv_bfloat16* __restrict__ gcb,
                    const __nv_bfloat16* __restrict__ t,
                    const int* __restrict__ ranks, float* __restrict__ dt,
                    int num_edges, int dim) {
  __shared__ int s_rank[film::CHUNK];
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  const int first = s_rank[0];
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    int cur = first;
    float m = film::ld(t + static_cast<size_t>(cur) * dim + d);
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(dt + static_cast<size_t>(cur) * dim + d, acc, cur == first);
        cur = r;
        acc = 0.0f;
        m = film::ld(t + static_cast<size_t>(cur) * dim + d);
      }
      const __nv_bfloat16* row = gcb + (e0 + i) * 3 * dim;
      const float gamma = film::ld(row + d), beta = film::ld(row + dim + d),
                  c = film::ld(row + 2 * dim + d);
      acc += film::round_bf16(film::dact<ACT>(gamma * m + beta) * c);
    }
    atomicAdd(dt + static_cast<size_t>(cur) * dim + d, acc);
  }
}

}  // namespace

extern "C" int film_src_bwd_walk_launch(const void* gcb, const void* t,
                                        const void* ranks, void* dt,
                                        int num_edges, int dim, int act,
                                        void* stream) {
  if (num_edges <= 0) return 0;
  const auto* g = static_cast<const __nv_bfloat16*>(gcb);
  const auto* tt = static_cast<const __nv_bfloat16*>(t);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(dt);
  const dim3 grid = film::grid_for(num_edges), block = film::block_for(dim);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT(act, film_src_bwd_kernel, grid, block, s, g, tt, rk, o,
                    num_edges, dim)
  return static_cast<int>(cudaGetLastError());
}
