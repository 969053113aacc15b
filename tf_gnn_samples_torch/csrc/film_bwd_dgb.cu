// K2: d_gamma | d_beta half of the fused GNN-FiLM backward.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_film_bwd_dgb_kernel`
// (:433, called by `_film_bwd_dgb_impl`). In receiver (fine rank) order:
//   z = gamma[r] * m_e + beta[r],  dz = act'(z) * g[r]
//   dgb[r, :D] = sum_{e: rank_e = r} bf16(m_e * dz),
//   dgb[r, D:] = sum_{e: rank_e = r} bf16(dz)
// with m a bf16 [E, D] stream, gamma|beta a bf16 [RPAD, 2D] table with
// rows of ld_gb elements, g a bf16 [RPAD, D] table with rows of ld_g (two
// tensors, or two views of one gamma|beta|g table), and dgb an f32
// [RPAD, 2D] table, zeroed by the caller.
//
// Bound on the card: bytes (a 2D-byte message row per edge, a 6D-byte
// table row and an 8D-byte output row per rank). The kernel,
// film_bwd_dgb_rows_kernel, is in film_rows.cuh, which says how its design
// meets that bound; a lane holds 16 sums (8 columns of d_gamma and of
// d_beta).
#include "film_rows.cuh"

namespace {

template <int ACT>
int launch(const __nv_bfloat16* m, const __nv_bfloat16* gb,
           const __nv_bfloat16* g, const int* rk, float* o, int num_edges,
           int dim, int ld_gb, int ld_g, cudaStream_t s) {
  const dim3 grid = rows_grid(num_edges, dim);
  const size_t smem = rows_smem(dim);
  if (dim % VEC == 0 && ld_gb % VEC == 0 && ld_g % VEC == 0 &&
      aligned16(m) && aligned16(gb) && aligned16(g) && aligned16(o)) {
    film_bwd_dgb_rows_kernel<ACT, true><<<grid, THREADS, smem, s>>>(
        m, gb, g, rk, o, num_edges, dim, ld_gb, ld_g);
  } else {
    film_bwd_dgb_rows_kernel<ACT, false><<<grid, THREADS, smem, s>>>(
        m, gb, g, rk, o, num_edges, dim, ld_gb, ld_g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int film_bwd_dgb_launch(const void* msgs, const void* gb,
                                   const void* g, const void* ranks,
                                   void* dgb, int num_edges, int dim,
                                   int ld_gb, int ld_g, int act,
                                   void* stream) {
  if (num_edges <= 0) return 0;
  FILM_DISPATCH_ACT_CALL(act, launch, static_cast<const __nv_bfloat16*>(msgs),
                         static_cast<const __nv_bfloat16*>(gb),
                         static_cast<const __nv_bfloat16*>(g),
                         static_cast<const int*>(ranks),
                         static_cast<float*>(dgb), num_edges, dim, ld_gb,
                         ld_g, static_cast<cudaStream_t>(stream))
}
