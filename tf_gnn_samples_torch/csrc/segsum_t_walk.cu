// K6a's earlier design: the head-major ranked segment-sum with a thread
// per run of 8 edges of one head, the grid's second axis over the heads.
// segsum_t.cu (the ranks staged once for all heads, 16-byte loads, the
// runs' partials joined inside a block) replaced it on every model path;
// this body stays, unchanged, as the baseline that the redesign is held
// and timed against (tools/earlier_designs.py; launches counted under
// "segsum_t_walk", 0 on every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_segsum_t_kernel`
// (called by `_segsum_t_impl`):
//   out[k, r] = sum_{e: rank_e = r} bf16(m_t[k, e])
// with m_t an f32 [K, E] stream (K attention heads), ranks nondecreasing
// and gap-free, and out an f32 [K, rows] table, zeroed by the caller.
//
// Bound on the card: bytes (4 bytes a term, one add). A thread owns RUN
// consecutive edges of one head (blockIdx.y), keeps a running f32 sum
// while the rank is unchanged, stores a segment that lies wholly inside
// its run and adds its first and last segments, which may continue in a
// neighbour's run, with atomicAdd. Each of the K rows of the grid reads
// all E ranks again.
#include "film_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 8;  // consecutive edges per thread

__global__ void __launch_bounds__(THREADS)
segsum_t_walk_kernel(const float* __restrict__ msgs_t,
                     const int* __restrict__ ranks, float* __restrict__ out,
                     int num_edges, int rows) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * RUN;
  if (base >= num_edges) return;
  const int n = min(RUN, static_cast<int>(num_edges - base));
  const float* m = msgs_t + static_cast<size_t>(blockIdx.y) * num_edges + base;
  const int* rk = ranks + base;
  float* o = out + static_cast<size_t>(blockIdx.y) * rows;
  const int first = rk[0];
  int cur = first;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int r = rk[i];
    if (r != cur) {
      film::flush(o + cur, acc, cur == first);
      cur = r;
      acc = 0.0f;
    }
    acc += film::round_bf16(m[i]);
  }
  atomicAdd(o + cur, acc);
}

}  // namespace

extern "C" int segsum_t_walk_launch(const void* msgs_t, const void* ranks,
                                    void* out, int num_edges, int rows,
                                    int num_heads, void* stream) {
  if (num_edges <= 0 || num_heads <= 0) return 0;
  const int per_block = THREADS * RUN;
  const dim3 grid((num_edges + per_block - 1) / per_block, num_heads);
  segsum_t_walk_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msgs_t), static_cast<const int*>(ranks),
      static_cast<float*>(out), num_edges, rows);
  return static_cast<int>(cudaGetLastError());
}
