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
// and the only atomics are at the two chunk seams (film_common.cuh).
#include "film_common.cuh"

namespace {

template <int ACT>
__global__ void __launch_bounds__(film::MAX_THREADS)
film_fwd_kernel(const __nv_bfloat16* __restrict__ msgs,
                const __nv_bfloat16* __restrict__ gb,
                const int* __restrict__ ranks, float* __restrict__ out,
                int num_edges, int dim) {
  __shared__ int s_rank[film::CHUNK];
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  const int first = s_rank[0];
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    int cur = first;
    const __nv_bfloat16* row = gb + static_cast<size_t>(cur) * 2 * dim;
    float gamma = film::ld(row + d), beta = film::ld(row + dim + d);
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(out + static_cast<size_t>(cur) * dim + d, acc, cur == first);
        cur = r;
        acc = 0.0f;
        row = gb + static_cast<size_t>(cur) * 2 * dim;
        gamma = film::ld(row + d);
        beta = film::ld(row + dim + d);
      }
      const float m = film::ld(msgs + (e0 + i) * dim + d);
      acc += film::round_bf16(film::act<ACT>(gamma * m + beta));
    }
    atomicAdd(out + static_cast<size_t>(cur) * dim + d, acc);
  }
}

}  // namespace

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
