// K13a: per-head weighted ranked segment-sum with row-major weights.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_wseg_kernel`
// (called by `_wseg_impl`):
//   out[r, c] = sum_{e: rank_e = r} bf16(m[e, c] * w[e, c / Dh])
// with m a bf16 [E, D] stream, w the f32 [E, K] per-head weights of K
// heads of Dh = D / K columns each, read in place (no transposed copy),
// ranks nondecreasing and gap-free, and out an f32 [rows, D] table, zeroed
// by the caller.
//
// Bound on the card: bytes (a 2D-byte message row, 4K bytes of weights
// and a 4-byte rank per edge, a 4D-byte store per used table row; one
// multiply and one add per element). The design, shared with K7a's
// head-major weights, is wseg_common.cuh's: a block stages the weight rows
// of its chunks' edges, which are contiguous in w, in shared memory.
#include "wseg_common.cuh"

extern "C" int wseg_launch(const void* msgs, const void* w, const void* ranks,
                           void* out, int num_edges, int dim, int num_heads,
                           void* stream) {
  return wseg::launch_fwd<false>(msgs, w, ranks, out, num_edges, dim, dim,
                                 num_heads, stream);
}
