// K2: d_gamma | d_beta half of the fused GNN-FiLM backward.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_film_bwd_dgb_kernel`
// (called by `_film_bwd_dgb_impl`). In receiver (fine rank) order:
//   z = gamma[r] * m_e + beta[r],  dz = act'(z) * g[r]
//   dgb[r, :D] = sum_{e: rank_e = r} bf16(m_e * dz),
//   dgb[r, D:] = sum_{e: rank_e = r} bf16(dz)
// with m a bf16 [E, D] stream, gamma|beta|g a bf16 [RPAD, 3D] table and dgb
// an f32 [RPAD, 2D] table, zeroed by the caller.
//
// Bound on the card: bytes (a 2D-byte message row per edge, a 6D-byte
// table row per segment, an 8D-byte output row per rank). The TPU kernel's
// windowed one-hot MXU products become the sorted-rank segment walk of
// film_common.cuh: coalesced row reads, each table row read once per
// segment, atomics only at the chunk seams. The kernel,
// film_bwd_dgb_kernel, is in film_walk.cuh.
#include "film_walk.cuh"

extern "C" int film_bwd_dgb_launch(const void* msgs, const void* gbg,
                                   const void* ranks, void* dgb,
                                   int num_edges, int dim, int act,
                                   void* stream) {
  if (num_edges <= 0) return 0;
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* t = static_cast<const __nv_bfloat16*>(gbg);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(dgb);
  const dim3 grid = film::grid_for(num_edges), block = film::block_for(dim);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT(act, film_bwd_dgb_kernel, grid, block, s, m, t, rk, o,
                    num_edges, dim)
  return static_cast<int>(cudaGetLastError());
}
