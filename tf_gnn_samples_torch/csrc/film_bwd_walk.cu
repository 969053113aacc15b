// K4's earlier design (PRs 4-9): the full backward of the fused GNN-FiLM
// aggregation (K1), a thread per column walking a 64-edge chunk.
// film_bwd.cu (csrc/film_rows.cuh) replaced it on every model path; this
// body stays, unchanged, as the baseline that the redesign is held and
// timed against (tools/earlier_designs.py; launches counted under
// "film_bwd_walk", 0 on every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_film_bwd_kernel`
// (:526, called by `_film_bwd_impl`). In receiver (fine rank) order:
//   z = gamma[r] * m_e + beta[r],  dz = act'(z) * g[r]
//   dmsg[e]    = bf16(gamma[r] * dz)
//   dgb[r, :D] = sum_{e: rank_e = r} bf16(m_e * dz),
//   dgb[r, D:] = sum_{e: rank_e = r} bf16(dz)
// with m a bf16 [E, D] stream, gamma|beta|g a bf16 [RPAD, 3D] table, dmsg a
// bf16 [E, D] stream and dgb an f32 [RPAD, 2D] table, zeroed by the caller.
// Bound on the card: bytes. Each table row is read once per segment and
// kept in registers; every load and store is 2 bytes.
#include "film_common.cuh"

namespace {

template <int ACT>
__global__ void __launch_bounds__(film::MAX_THREADS)
film_bwd_kernel(const __nv_bfloat16* __restrict__ msgs,
                const __nv_bfloat16* __restrict__ gbg,
                const int* __restrict__ ranks,
                __nv_bfloat16* __restrict__ dmsg, float* __restrict__ dgb,
                int num_edges, int dim) {
  __shared__ int s_rank[film::CHUNK];
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
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
      dmsg[(e0 + i) * dim + d] = __float2bfloat16_rn(gamma * dz);
      acc_g += film::round_bf16(m * dz);
      acc_b += film::round_bf16(dz);
    }
    float* o = dgb + static_cast<size_t>(cur) * 2 * dim;
    atomicAdd(o + d, acc_g);
    atomicAdd(o + dim + d, acc_b);
  }
}

}  // namespace

extern "C" int film_bwd_walk_launch(const void* msgs, const void* gbg,
                                    const void* ranks, void* dmsg,
                                    void* dgb, int num_edges, int dim,
                                    int act, void* stream) {
  if (num_edges <= 0) return 0;
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* t = static_cast<const __nv_bfloat16*>(gbg);
  const auto* rk = static_cast<const int*>(ranks);
  auto* dm = static_cast<__nv_bfloat16*>(dmsg);
  auto* o = static_cast<float*>(dgb);
  const dim3 grid = film::grid_for(num_edges), block = film::block_for(dim);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT(act, film_bwd_kernel, grid, block, s, m, t, rk, dm, o,
                    num_edges, dim)
  return static_cast<int>(cudaGetLastError());
}
