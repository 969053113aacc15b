// K13b: backward of the per-head weighted ranked segment-sum with
// row-major weights (K13a).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_wseg_bwd_kernel`
// (called by `_wseg_bwd_impl`). With g_e = g16[rank_e] the table
// cotangent of edge e's receiver, rounded to bf16 by the caller:
//   dmsg[e, c] = bf16(g_e[c] * w[e, c / Dh])
//   dw[e, k]   = sum_{c in head k} m[e, c] * g_e[c]        (f32)
// with m a bf16 [E, D] stream, w the f32 [E, K] weights, g16 a bf16
// [rows, D] table and ranks int32 [E] below rows.
//
// Bound on the card: bytes (per edge a 2D-byte message row read, a
// 2D-byte row written, 8K bytes of weights and their cotangent and a
// 4-byte rank; each used g row read once; two multiplies and an add per
// element). The design, shared with K7b's head-major weights, is
// wseg_common.cuh's: one thread per (edge, head), threads head-fastest,
// so the row-major weights and their cotangent are read and written in
// place, coalesced, without shared memory.
#include "wseg_common.cuh"

extern "C" int wseg_bwd_launch(const void* msgs, const void* w,
                               const void* g16, const void* ranks, void* dmsg,
                               void* dw, int num_edges, int dim, int num_heads,
                               void* stream) {
  return wseg::launch_bwd<false>(msgs, w, g16, ranks, dmsg, dw, num_edges, dim,
                                 num_heads, stream);
}
