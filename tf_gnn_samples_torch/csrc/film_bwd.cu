// K4: full backward of the fused GNN-FiLM aggregation (K1): the per-edge
// message cotangent and the d_gamma | d_beta table.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_film_bwd_kernel`
// (:526, called by `_film_bwd_impl`, the VJP of `film_ranked_aggregate`).
// In receiver (fine rank) order:
//   z = gamma[r] * m_e + beta[r],  dz = act'(z) * g[r]
//   dmsg[e]    = bf16(gamma[r] * dz)
//   dgb[r, :D] = sum_{e: rank_e = r} bf16(m_e * dz),
//   dgb[r, D:] = sum_{e: rank_e = r} bf16(dz)
// with m a bf16 [E, D] stream, gamma|beta a bf16 [RPAD, 2D] table with
// rows of ld_gb elements, g a bf16 [RPAD, D] table with rows of ld_g (two
// tensors, or two views of one gamma|beta|g table), dmsg a bf16 [E, D]
// stream and dgb an f32 [RPAD, 2D] table, zeroed by the caller. The
// rounding points are the TPU kernel's: z and dz in f32, dmsg rounded
// once, both summed terms rounded to bf16 before their f32 sum.
//
// Bound on the card: bytes (per edge a 2D-byte message row read and a
// 2D-byte cotangent row written, a 6D-byte table row and an 8D-byte
// output row per rank). It is K2 plus one store per edge: the kernel,
// film_bwd_rows_kernel, runs K2's body (film_rows.cuh, which says how its
// design meets that bound) with the cotangent store switched on, 8 bf16
// values a lane in one 16-byte store.
#include "film_rows.cuh"

namespace {

template <int ACT>
int launch(const __nv_bfloat16* m, const __nv_bfloat16* gb,
           const __nv_bfloat16* g, const int* rk, __nv_bfloat16* dm,
           float* o, int num_edges, int dim, int ld_gb, int ld_g,
           cudaStream_t s) {
  const dim3 grid = rows_grid(num_edges, dim);
  const size_t smem = rows_smem(dim);
  if (dim % VEC == 0 && ld_gb % VEC == 0 && ld_g % VEC == 0 &&
      aligned16(m) && aligned16(gb) && aligned16(g) && aligned16(dm) &&
      aligned16(o)) {
    film_bwd_rows_kernel<ACT, true><<<grid, THREADS, smem, s>>>(
        m, gb, g, rk, dm, o, num_edges, dim, ld_gb, ld_g);
  } else {
    film_bwd_rows_kernel<ACT, false><<<grid, THREADS, smem, s>>>(
        m, gb, g, rk, dm, o, num_edges, dim, ld_gb, ld_g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int film_bwd_launch(const void* msgs, const void* gb,
                               const void* g, const void* ranks, void* dmsg,
                               void* dgb, int num_edges, int dim, int ld_gb,
                               int ld_g, int act, void* stream) {
  if (num_edges <= 0) return 0;
  FILM_DISPATCH_ACT_CALL(act, launch, static_cast<const __nv_bfloat16*>(msgs),
                         static_cast<const __nv_bfloat16*>(gb),
                         static_cast<const __nv_bfloat16*>(g),
                         static_cast<const int*>(ranks),
                         static_cast<__nv_bfloat16*>(dmsg),
                         static_cast<float*>(dgb), num_edges, dim, ld_gb,
                         ld_g, static_cast<cudaStream_t>(stream))
}
