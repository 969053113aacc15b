// K3: dt half of the fused GNN-FiLM backward, over the SOURCE-sorted stream.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_film_src_bwd_kernel`
// (:493, called by `_film_src_bwd_impl`). With s_e the src rank of edge e:
//   z = gamma_e * t[s_e] + beta_e
//   dt[s, d] = sum_{e: s_e = s} bf16(act'(z) * C_e),   C = bf16(gamma * g)
// into an f32 [R_src, D] table dt, zeroed by the caller. Two forms, one
// kernel body (film_src_bwd_rows_kernel in film_rows.cuh):
// * the stream form (the JAX package's inputs): gamma|beta|C a bf16
//   [E, 3D] stream and t a bf16 [R_src, D] table in src-rank order;
// * the gather form (what the fused FiLM backward calls): gamma|beta a
//   bf16 [RPAD, 2D] and g a bf16 [RPAD, D] fine-rank table (rows of ld_gb
//   and ld_g elements), read at each edge's fine rank (`fine`; a key
//   outside [0, RPAD) adds zero), C formed in registers, and t a bf16
//   [t_rows, D] node table read at clip(t_index[s], 0, t_rows - 1).
//
// Bound on the card: bytes (gather form: a 6D-byte fine row per used fine
// rank, two ranks per edge, a 2D-byte t row and a rank per source group
// and a 4D-byte dt row per rank; the stream form reads a 6D-byte row per
// edge instead). film_rows.cuh says how the design meets that bound:
// 16-byte accesses, a lane's loads issued SRC_AHEAD edges before their
// sums, the fine ranks and t rows staged in shared memory, and the
// earlier design's sum order kept. The gather form spares the caller the
// [E, 3D] stream and the t table it would otherwise build for the kernel.
#include "film_rows.cuh"

namespace {

template <int ACT>
int launch(const __nv_bfloat16* gcb, const __nv_bfloat16* gb,
           const __nv_bfloat16* g, const int* fine, const __nv_bfloat16* t,
           const int* t_index, const int* rk, float* o, int num_edges,
           int dim, int ld_gb, int ld_g, int rpad, int t_rows,
           cudaStream_t s) {
  const dim3 grid = rows_grid(num_edges, dim);
  const bool vec = dim % VEC == 0 && aligned16(t) && aligned16(o);
  if (gcb == nullptr) {
    const size_t smem = rows_smem(dim, 3);
    if (vec && ld_gb % VEC == 0 && ld_g % VEC == 0 && aligned16(gb) &&
        aligned16(g)) {
      return film::launch_smem(film_src_bwd_rows_kernel<ACT, true, true>,
                               grid, dim3(THREADS), smem, s, gcb, gb, g, fine,
                               t, t_index, rk, o, num_edges, dim, ld_gb, ld_g,
                               rpad, t_rows);
    }
    return film::launch_smem(film_src_bwd_rows_kernel<ACT, false, true>, grid,
                             dim3(THREADS), smem, s, gcb, gb, g, fine, t,
                             t_index, rk, o, num_edges, dim, ld_gb, ld_g,
                             rpad, t_rows);
  }
  const size_t smem = rows_smem(dim);
  if (vec && aligned16(gcb)) {
    return film::launch_smem(film_src_bwd_rows_kernel<ACT, true, false>, grid,
                             dim3(THREADS), smem, s, gcb, gb, g, fine, t,
                             t_index, rk, o, num_edges, dim, ld_gb, ld_g,
                             rpad, t_rows);
  }
  return film::launch_smem(film_src_bwd_rows_kernel<ACT, false, false>, grid,
                           dim3(THREADS), smem, s, gcb, gb, g, fine, t,
                           t_index, rk, o, num_edges, dim, ld_gb, ld_g, rpad,
                           t_rows);
}

}  // namespace

// The stream form passes gcb and null gb, g, fine and t_index; the gather
// form a null gcb.
extern "C" int film_src_bwd_launch(const void* gcb, const void* gb,
                                   const void* g, const void* fine,
                                   const void* t, const void* t_index,
                                   const void* ranks, void* dt, int num_edges,
                                   int dim, int ld_gb, int ld_g, int rpad,
                                   int t_rows, int act, void* stream) {
  if (num_edges <= 0) return 0;
  FILM_DISPATCH_ACT_CALL(act, launch, static_cast<const __nv_bfloat16*>(gcb),
                         static_cast<const __nv_bfloat16*>(gb),
                         static_cast<const __nv_bfloat16*>(g),
                         static_cast<const int*>(fine),
                         static_cast<const __nv_bfloat16*>(t),
                         static_cast<const int*>(t_index),
                         static_cast<const int*>(ranks),
                         static_cast<float*>(dt), num_edges, dim, ld_gb, ld_g,
                         rpad, t_rows, static_cast<cudaStream_t>(stream))
}
