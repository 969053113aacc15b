// K1: fused GNN-FiLM modulate-activate-aggregate, forward.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_film_fwd_kernel`
// (called by `_film_fwd_impl`):
//   out[r, d] = sum_{e: rank_e = r} bf16(act(gamma[r, d] * m[e, d] + beta[r, d]))
// with m a bf16 [E, D] stream, gamma|beta a bf16 [RPAD, 2D] table and out an
// f32 [RPAD, D] table, zeroed by the caller.
//
// Bound on the card: bytes. Each edge costs a 2D-byte message row plus,
// at every rank change, a 4D-byte gamma|beta row; the arithmetic is a few
// operations per element. The TPU kernel expands the table rows with
// windowed one-hot MXU products; here a block walks CHUNK edges in stream
// order with one thread per column, so message rows and table rows are
// read as contiguous, coalesced rows, each table row once per segment,
// and the only atomics are at the two chunk seams (film_common.cuh). The
// kernel, film_fwd_kernel, is in film_walk.cuh.
#include "film_walk.cuh"

extern "C" int film_fwd_launch(const void* msgs, const void* gb,
                               const void* ranks, void* out, int num_edges,
                               int dim, int act, void* stream) {
  if (num_edges <= 0) return 0;
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* t = static_cast<const __nv_bfloat16*>(gb);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const dim3 grid = film::grid_for(num_edges), block = film::block_for(dim);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT(act, film_fwd_kernel, grid, block, s, m, t, rk, o,
                    num_edges, dim)
  return static_cast<int>(cudaGetLastError());
}
