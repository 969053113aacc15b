// K5a: ranked segment-sum.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_segsum_kernel`
// (called by `_segsum_table_impl`):
//   out[r, d] = sum_{e: rank_e = r} bf16(m[e, d])
// with m an f32 or bf16 [E, D] stream, ranks nondecreasing and gap-free,
// and out an f32 [rows, D] table, zeroed by the caller. Every term is
// rounded to bf16 (the TPU kernel's cast before its one-hot MXU dot) and
// summed in f32.
//
// Bound on the card: bytes. Each edge costs one message row (4D bytes for
// an f32 stream) and a 4-byte rank, each used table row one 4D-byte
// store; there is one add per element. The TPU kernel builds windowed
// one-hot matrices and accumulates into a VMEM-resident table; here a
// block walks CHUNK edges in stream order with one thread per column (the
// scheme of the FiLM kernels, film_common.cuh), so message rows are read
// as contiguous, coalesced rows, the term is rounded as it is loaded (an
// f32 stream needs no separate cast pass), interior segments are stored
// once and only the chunk's first and last segments use atomicAdd.
#include "film_common.cuh"

namespace {

__device__ __forceinline__ float load_term(const float* p) {
  return film::round_bf16(*p);
}

__device__ __forceinline__ float load_term(const __nv_bfloat16* p) {
  return film::ld(p);  // already a bf16 value
}

template <typename T>
__global__ void __launch_bounds__(film::MAX_THREADS)
segsum_kernel(const T* __restrict__ msgs, const int* __restrict__ ranks,
              float* __restrict__ out, int num_edges, int dim) {
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
      acc += load_term(msgs + (e0 + i) * dim + d);
    }
    atomicAdd(out + static_cast<size_t>(cur) * dim + d, acc);
  }
}

}  // namespace

// in_type: 0 = float32 stream, 1 = bfloat16 stream (SEGSUM_TYPES in
// ops/ranked_segment.py).
extern "C" int segsum_launch(const void* msgs, const void* ranks, void* out,
                             int num_edges, int dim, int in_type,
                             void* stream) {
  if (num_edges <= 0) return 0;
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const dim3 grid = film::grid_for(num_edges), block = film::block_for(dim);
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_type == 0) {
    segsum_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(msgs), rk, o, num_edges, dim);
  } else if (in_type == 1) {
    segsum_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(msgs), rk, o, num_edges, dim);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
