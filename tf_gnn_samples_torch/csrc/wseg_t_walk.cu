// K7a's earlier design: the head-major weighted ranked segment-sum with a
// thread per output column walking a 64-edge chunk with 2-byte loads.
// wseg_common.cuh's row walk (a lane owns 8 columns, 16-byte loads issued
// ahead) replaced it on every model path; this body stays, unchanged, as
// the baseline that the redesign is held and timed against
// (tools/earlier_designs.py; launches counted under "wseg_t_walk", 0 on
// every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_wseg_t_kernel`
// (called by `_wseg_t_impl`):
//   out[r, c] = sum_{e: rank_e = r} bf16(m[e, c] * w_t[c / Dh, e])
// with m a bf16 [E, dim_in] stream of which the first D columns are used,
// w_t the f32 [K, E] attention weights of K heads of Dh = D / K columns
// each, ranks nondecreasing and gap-free, and out an f32 [rows, D] table,
// zeroed by the caller.
//
// Bound on the card: bytes (a 2D-byte message row, 4K bytes of weights
// and a 4-byte rank per edge, a 4D-byte store per table row). A block owns
// CHUNK consecutive edges, stages their K x CHUNK weights in shared memory
// with loads along the edge axis, and each thread walks the chunk for its
// column (film_common.cuh's sorted-rank walk), reading the weight of its
// column's head as a shared-memory broadcast.
#include "film_common.cuh"

namespace {

__global__ void __launch_bounds__(film::MAX_THREADS)
wseg_t_walk_kernel(const __nv_bfloat16* __restrict__ msgs,
                   const float* __restrict__ w_t, const int* __restrict__ ranks,
                   float* __restrict__ out, int num_edges, int dim, int dim_in,
                   int num_heads) {
  extern __shared__ float s_w[];  // [num_heads][CHUNK]
  __shared__ int s_rank[film::CHUNK];
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  for (int idx = threadIdx.x; idx < num_heads * film::CHUNK; idx += blockDim.x) {
    const int k = idx / film::CHUNK, i = idx % film::CHUNK;
    if (i < n) {
      s_w[k * film::CHUNK + i] = w_t[static_cast<size_t>(k) * num_edges + e0 + i];
    }
  }
  __syncthreads();
  const int head_dim = dim / num_heads;
  const int first = s_rank[0];
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    const float* wk = s_w + (d / head_dim) * film::CHUNK;
    int cur = first;
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(out + static_cast<size_t>(cur) * dim + d, acc, cur == first);
        cur = r;
        acc = 0.0f;
      }
      acc += film::round_bf16(film::ld(msgs + (e0 + i) * dim_in + d) * wk[i]);
    }
    atomicAdd(out + static_cast<size_t>(cur) * dim + d, acc);
  }
}

}  // namespace

// dim must be a multiple of num_heads, and num_heads * CHUNK floats must
// fit the 48 KB of static-limit shared memory (the wrapper checks both).
extern "C" int wseg_t_walk_launch(const void* msgs, const void* w_t,
                                  const void* ranks, void* out, int num_edges,
                                  int dim, int dim_in, int num_heads,
                                  void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  const size_t smem = static_cast<size_t>(num_heads) * film::CHUNK * sizeof(float);
  wseg_t_walk_kernel<<<film::grid_for(num_edges), film::block_for(dim), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(msgs), static_cast<const float*>(w_t),
      static_cast<const int*>(ranks), static_cast<float*>(out), num_edges, dim,
      dim_in, num_heads);
  return static_cast<int>(cudaGetLastError());
}
