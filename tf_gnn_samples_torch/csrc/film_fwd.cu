// K1: fused GNN-FiLM modulate-activate-aggregate, forward.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_film_fwd_kernel`
// (:333, called by `_film_fwd_impl`):
//   out[r, d] = sum_{e: rank_e = r} bf16(act(gamma[r, d] * m[e, d] + beta[r, d]))
// with m a bf16 [E, D] stream, gamma|beta a bf16 [RPAD, 2D] table and out an
// f32 [RPAD, D] table, zeroed by the caller.
//
// Bound on the card: bytes (a 2D-byte message row per edge, a 4D-byte
// table row and a 4D-byte output row per rank); the arithmetic is a few
// operations per element. The kernel, film_fwd_rows_kernel, is in
// film_rows.cuh, which says how its design meets that bound: 16-byte
// accesses, a lane's loads issued AHEAD edges before their sums, and the
// earlier design's sum order kept.
#include "film_rows.cuh"

namespace {

template <int ACT>
int launch(const __nv_bfloat16* m, const __nv_bfloat16* t, const int* rk,
           float* o, int num_edges, int dim, cudaStream_t s) {
  const dim3 grid = rows_grid(num_edges, dim);
  const size_t smem = rows_smem(dim);
  if (dim % VEC == 0 && aligned16(m) && aligned16(t) && aligned16(o)) {
    film_fwd_rows_kernel<ACT, true><<<grid, THREADS, smem, s>>>(
        m, t, rk, o, num_edges, dim);
  } else {
    film_fwd_rows_kernel<ACT, false><<<grid, THREADS, smem, s>>>(
        m, t, rk, o, num_edges, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int film_fwd_launch(const void* msgs, const void* gb,
                               const void* ranks, void* out, int num_edges,
                               int dim, int act, void* stream) {
  if (num_edges <= 0) return 0;
  FILM_DISPATCH_ACT_CALL(act, launch, static_cast<const __nv_bfloat16*>(msgs),
                         static_cast<const __nv_bfloat16*>(gb),
                         static_cast<const int*>(ranks),
                         static_cast<float*>(out), num_edges, dim,
                         static_cast<cudaStream_t>(stream))
}
