// K7a: per-head weighted ranked segment-sum with head-major weights.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_wseg_t_kernel`
// (called by `_wseg_t_impl`):
//   out[r, c] = sum_{e: rank_e = r} bf16(m[e, c] * w_t[c / Dh, e])
// with m a bf16 [E, dim_in] stream of which the first D columns are used
// (trailing columns may carry other lanes), w_t the f32 [K, E] attention
// weights of K heads of Dh = D / K columns each, ranks nondecreasing and
// gap-free, and out an f32 [rows, D] table, zeroed by the caller.
//
// Bound on the card: bytes (a 2D-byte message row, 4K bytes of weights
// and a 4-byte rank per edge, a 4D-byte store per used table row; one
// multiply and one add per element). The design, shared with K13a's
// row-major weights, is wseg_common.cuh's.
#include "wseg_common.cuh"

extern "C" int wseg_t_launch(const void* msgs, const void* w_t,
                             const void* ranks, void* out, int num_edges,
                             int dim, int dim_in, int num_heads, void* stream) {
  return wseg::launch_fwd<true>(msgs, w_t, ranks, out, num_edges, dim, dim_in,
                                num_heads, stream);
}
