// K11b: backward of the fused expand-add-activate (K11a).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py
// `_expand_add_act_bwd_kernel` (called by `_expand_add_act_bwd_impl`, the
// VJP of `expand_add_act`):
//   dz          = bf16(act'_from_out(x[e, d]) * dx[e, d])
//   dm[e, d]    = dz
//   dbeta[r, d] = sum_{e: rank_e = r} dz
// with x (the forward's OUTPUT) and dx bf16 [E, D] streams, ranks
// nondecreasing and gap-free, dm a bf16 [E, D] stream and dbeta an f32
// [rows, D] table, zeroed by the caller. The derivative is a function of
// the output (`_ACTS_FROM_OUT`: elu 1 or x + 1, relu, leaky_relu 1 or 0.2,
// linear), so the forward keeps no residual beside x. The product is taken
// in f32 and rounded once; the ROUNDED value is what both the per-edge
// store and the f32 sum see, as in the TPU kernel.
//
// Bound on the card: bytes (per edge two 2D-byte rows read, one written and
// a 4-byte rank; a 4D-byte row per rank written). It is K5a's walk
// (segsum.cu, film_common.cuh) with a second stream and a store per edge: a
// block owns CHUNK consecutive edges, a thread a column, so rows are read
// and written contiguously, interior segments are stored once and only the
// chunk's first and last segments use atomicAdd.
#include "film_common.cuh"

namespace {

// act'(z) as a function of x = act(z).
template <int ACT>
__device__ __forceinline__ float dact_from_out(float x) {
  if (ACT == film::ELU) return x > 0.0f ? 1.0f : x + 1.0f;
  if (ACT == film::RELU) return x > 0.0f ? 1.0f : 0.0f;
  if (ACT == film::LEAKY_RELU) return x > 0.0f ? 1.0f : 0.2f;
  return 1.0f;  // LINEAR
}

template <int ACT>
__global__ void __launch_bounds__(film::MAX_THREADS)
expand_add_act_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ dx,
                          const int* __restrict__ ranks,
                          __nv_bfloat16* __restrict__ dm,
                          float* __restrict__ dbeta, int num_edges, int dim) {
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
        film::flush(dbeta + static_cast<size_t>(cur) * dim + d, acc, cur == first);
        cur = r;
        acc = 0.0f;
      }
      const size_t at = (e0 + i) * dim + d;
      const __nv_bfloat16 dz = __float2bfloat16_rn(
          dact_from_out<ACT>(film::ld(x + at)) * film::ld(dx + at));
      dm[at] = dz;
      acc += __bfloat162float(dz);
    }
    atomicAdd(dbeta + static_cast<size_t>(cur) * dim + d, acc);
  }
}

}  // namespace

extern "C" int expand_add_act_bwd_launch(const void* x, const void* dx,
                                         const void* ranks, void* dm,
                                         void* dbeta, int num_edges, int dim,
                                         int act, void* stream) {
  if (num_edges <= 0) return 0;
  const auto* xs = static_cast<const __nv_bfloat16*>(x);
  const auto* gs = static_cast<const __nv_bfloat16*>(dx);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<__nv_bfloat16*>(dm);
  auto* t = static_cast<float*>(dbeta);
  const dim3 grid = film::grid_for(num_edges), block = film::block_for(dim);
  const auto s = static_cast<cudaStream_t>(stream);
  // Only the activations whose derivative is a function of their output.
  switch (act) {
    case film::LINEAR:
      expand_add_act_bwd_kernel<film::LINEAR><<<grid, block, 0, s>>>(
          xs, gs, rk, o, t, num_edges, dim);
      break;
    case film::RELU:
      expand_add_act_bwd_kernel<film::RELU><<<grid, block, 0, s>>>(
          xs, gs, rk, o, t, num_edges, dim);
      break;
    case film::LEAKY_RELU:
      expand_add_act_bwd_kernel<film::LEAKY_RELU><<<grid, block, 0, s>>>(
          xs, gs, rk, o, t, num_edges, dim);
      break;
    case film::ELU:
      expand_add_act_bwd_kernel<film::ELU><<<grid, block, 0, s>>>(
          xs, gs, rk, o, t, num_edges, dim);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
