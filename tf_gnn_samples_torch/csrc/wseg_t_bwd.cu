// K7b: backward of the per-head weighted ranked segment-sum (K7a).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_wseg_t_bwd_kernel`
// (called by `_wseg_t_bwd_impl`). With g_e = g16[rank_e] the table
// cotangent of edge e's receiver, rounded to bf16 by the caller:
//   dmsg[e, c] = bf16(g_e[c] * w_t[c / Dh, e])
//   dw_t[k, e] = sum_{c in head k} m[e, c] * g_e[c]        (f32)
// with m a bf16 [E, D] stream, w_t the f32 [K, E] weights, g16 a bf16
// [rows, D] table and ranks int32 [E] below rows.
//
// Bound on the card: bytes (per edge a 2D-byte message row read, a
// 2D-byte row written, 8K bytes of weights and their cotangent and a
// 4-byte rank; each used g row read once; two multiplies and an add per
// element). The design, shared with K13b's row-major weights, is
// wseg_common.cuh's: one thread per (edge, head), the [K, E] weights and
// their cotangent staged through shared memory.
#include "wseg_common.cuh"

extern "C" int wseg_t_bwd_launch(const void* msgs, const void* w_t,
                                 const void* g16, const void* ranks, void* dmsg,
                                 void* dw_t, int num_edges, int dim,
                                 int num_heads, void* stream) {
  return wseg::launch_bwd<true>(msgs, w_t, g16, ranks, dmsg, dw_t, num_edges,
                                dim, num_heads, stream);
}
