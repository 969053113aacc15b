// K12a: fused activate-aggregate, forward.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_act_agg_kernel`
// (called by `_act_agg_impl`, the forward of `act_ranked_aggregate`):
//   out[r, d] = sum_{e: rank_e = r} bf16(act(float(m[e, d])))
// with m a bf16 [E, D] stream, ranks nondecreasing and gap-free, and out an
// f32 [rows, D] table, zeroed by the caller. The activation runs in f32 and
// every term is rounded to bf16 (the TPU kernel's cast before its one-hot
// MXU dot) before the f32 sum. gelu is the Abramowitz-Stegun erf of
// film_common.cuh, as in the JAX package.
//
// The stream may be one edge type's slice of the type-major stream: any
// number of edges, ranks that start anywhere. The rank rows of two types
// are disjoint, so the per-type calls write into one table, which the
// caller zeroes once for all of them.
//
// Bound on the card: bytes. Each edge costs a 2D-byte message row and a
// 4-byte rank, the table one 4D-byte row per rank of the stream. It is K1 (film_fwd.cu) without the gamma |
// beta rows: a block walks CHUNK edges in stream order with one thread per
// column, message rows are read as contiguous, coalesced rows, interior
// segments are stored once and only the chunk's first and last segments use
// atomicAdd. The TPU kernel builds windowed one-hot matrices and
// accumulates into a VMEM-resident table.
#include "film_common.cuh"

namespace {

template <int ACT>
__global__ void __launch_bounds__(film::MAX_THREADS)
act_agg_kernel(const __nv_bfloat16* __restrict__ msgs,
               const int* __restrict__ ranks, float* __restrict__ out,
               int num_edges, int dim) {
  __shared__ int s_rank[film::CHUNK];
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  const int first = s_rank[0];
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    int cur = first;
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(out + static_cast<size_t>(cur) * dim + d, acc, cur == first);
        cur = r;
        acc = 0.0f;
      }
      const float m = film::ld(msgs + (e0 + i) * dim + d);
      acc += film::round_bf16(film::act<ACT>(m));
    }
    atomicAdd(out + static_cast<size_t>(cur) * dim + d, acc);
  }
}

}  // namespace

extern "C" int act_agg_launch(const void* msgs, const void* ranks, void* out,
                              int num_edges, int dim, int act, void* stream) {
  if (num_edges <= 0) return 0;
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const dim3 grid = film::grid_for(num_edges), block = film::block_for(dim);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT(act, act_agg_kernel, grid, block, s, m, rk, o, num_edges,
                    dim)
  return static_cast<int>(cudaGetLastError());
}
