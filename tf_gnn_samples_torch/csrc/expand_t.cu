// K6b: head-major ranked expand.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_expand_t_kernel`
// (called by `_expand_t_impl`):
//   out[k, e] = float(bf16(table_t[k, rank_e]))
// with table_t an f32 [K, rows] table, ranks int32 [E] below rows, and out
// an f32 [K, E] stream. The rounding is the TPU kernel's cast of the table
// slab to bf16 before its one-hot MXU dot, which the dot then reproduces
// exactly in f32, so this kernel equals its plain version bit for bit.
//
// Bound on the card: bytes (each edge writes 4K bytes and reads a 4-byte
// rank; the used table entries are read once), few enough at K = 8 that
// the launch itself shows. One thread per edge reads its rank once and
// walks the K heads: for each head the threads of a warp store
// neighbouring addresses of the [K, E] stream and, the ranks being
// sorted, read neighbouring (often equal) table entries.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
expand_t_kernel(const float* __restrict__ table_t, const int* __restrict__ ranks,
                float* __restrict__ out, int num_edges, int rows,
                int num_heads) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= num_edges) return;
  const int r = ranks[e];
  for (int k = 0; k < num_heads; ++k) {
    const float v = table_t[static_cast<size_t>(k) * rows + r];
    out[static_cast<size_t>(k) * num_edges + e] =
        __bfloat162float(__float2bfloat16_rn(v));
  }
}

}  // namespace

extern "C" int expand_t_launch(const void* table_t, const void* ranks, void* out,
                               int num_edges, int rows, int num_heads,
                               void* stream) {
  if (num_edges <= 0 || num_heads <= 0) return 0;
  const int blocks = (num_edges + THREADS - 1) / THREADS;
  expand_t_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table_t), static_cast<const int*>(ranks),
      static_cast<float*>(out), num_edges, rows, num_heads);
  return static_cast<int>(cudaGetLastError());
}
