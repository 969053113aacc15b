// K16, forward half: three alternative designs of K1 (film_fwd.cu), for
// A/B timing against it (tf_gnn_samples_torch/tools/film_fwd_ab.py).
//
// Replaces the variant kernels of tools/film_fwd_ab.py: `_fwd_kernel_v3`
// (called by `_impl_v3`), `_fwd_kernel_v2a` and `_fwd_kernel_v2b` (called
// by `_impl`). All three compute K1's function,
//   out[r, d] = sum_{e: rank_e = r} bf16(act(gamma[r, d] * m[e, d] + beta[r, d]))
// with m a bf16 [E, D] stream, gamma|beta a bf16 [RPAD, 2D] table, ranks
// nondecreasing (gaps allowed, as K1 allows them), and out an f32
// [RPAD, D] table zeroed by the caller. Each term is rounded where K1 rounds it and each row is summed
// in stream order, so a row that lies inside one 64-edge chunk of K1
// equals K1's bit for bit.
//
// Bound on the card: bytes, as K1 (a 2D-byte message row per edge, a
// 4D-byte table row per segment, the f32 output table). Each variant asks
// in Hopper terms the question its TPU variant asked of the MXU:
//
// * v3, group G ("fewer, larger MXU operations per grid step"): K1's
//   kernel (film_walk.cuh) over 64 * G edges per block (G a template
//   parameter). A block rereads fewer gamma|beta rows at segment starts
//   and makes fewer seam atomics, with fewer blocks in flight.
// * v2a, "scratch" ("one write of the output per step instead of chained
//   read-modify-writes"): a block of V2A_EDGES edges and a V2A_COLS column
//   slice keeps its rank window's f32 sums in shared memory (gap-free
//   ranks: n edges touch at most n rows) and writes the window once, in
//   16-byte row stores; only its first and last rank are added
//   atomically. A block whose ranks have a gap (its window could outgrow
//   the buffer or leave rows unwritten) walks and flushes as K1 does.
// * v2b, "stepdot" ("decouple the elementwise pass from the reduction"):
//   an edge-parallel phase computes the bf16 terms with 16-byte loads (8
//   bf16 a thread) into a shared [V2B_EDGES, V2B_COLS] bf16 buffer, then a
//   column-parallel phase sums that buffer by rank runs. D must be a
//   multiple of 8.
#include <cstdint>

#include "film_walk.cuh"

namespace {

constexpr int V2A_EDGES = 128, V2A_COLS = 128;
constexpr int V2B_EDGES = 256, V2B_COLS = 128;

template <int ACT>
__global__ void __launch_bounds__(V2A_COLS)
fwd_v2a_kernel(const __nv_bfloat16* __restrict__ msgs,
               const __nv_bfloat16* __restrict__ gb,
               const int* __restrict__ ranks, float* __restrict__ out,
               int num_edges, int dim) {
  extern __shared__ float4 s_acc4[];  // [V2A_EDGES][V2A_COLS] f32
  float* s_acc = reinterpret_cast<float*>(s_acc4);
  __shared__ int s_rank[V2A_EDGES];
  const int n = film::load_chunk_ranks<V2A_EDGES>(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * V2A_EDGES;
  const int first = s_rank[0];
  const int n_rows = s_rank[n - 1] - first + 1;
  const int c0 = blockIdx.y * V2A_COLS;
  const int width = min(V2A_COLS, dim - c0);
  const int c = threadIdx.x;
  bool gap = false;
  for (int i = threadIdx.x + 1; i < n; i += blockDim.x) {
    gap |= s_rank[i] - s_rank[i - 1] > 1;
  }
  if (__syncthreads_or(gap)) {  // K1's flushes, straight to the output
    if (c < width) {
      walk_column<ACT>(msgs, gb, s_rank, n, e0, c0 + c, dim,
                       [&](int r, float acc, bool last) {
                         film::flush(out + static_cast<size_t>(r) * dim + c0 + c,
                                     acc, last || r == first);
                       });
    }
    return;
  }
  // Gap-free: the window has at most n <= V2A_EDGES rows, each with an
  // edge, so the walk writes every (row, column) of it once: no zeroing.
  if (c < width) {
    walk_column<ACT>(msgs, gb, s_rank, n, e0, c0 + c, dim,
                     [&](int r, float acc, bool) {
                       s_acc[(r - first) * V2A_COLS + c] = acc;
                     });
  }
  __syncthreads();
  // The window's first and last rows may continue in a neighbouring
  // block: atomics. The rows between are stored whole.
  float* o = out + static_cast<size_t>(first) * dim + c0;
  if (dim % 4 == 0) {
    const int w4 = width / 4;
    for (int i = threadIdx.x; i < n_rows * w4; i += blockDim.x) {
      const int row = i / w4, q = i - row * w4;
      const float4 v = s_acc4[row * (V2A_COLS / 4) + q];
      float* dst = o + static_cast<size_t>(row) * dim + 4 * q;
      if (row == 0 || row == n_rows - 1) {
        atomicAdd(dst, v.x);
        atomicAdd(dst + 1, v.y);
        atomicAdd(dst + 2, v.z);
        atomicAdd(dst + 3, v.w);
      } else {
        *reinterpret_cast<float4*>(dst) = v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * width; i += blockDim.x) {
      const int row = i / width, q = i - row * width;
      film::flush(o + static_cast<size_t>(row) * dim + q,
                  s_acc[row * V2A_COLS + q], row == 0 || row == n_rows - 1);
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(V2B_COLS)
fwd_v2b_kernel(const __nv_bfloat16* __restrict__ msgs,
               const __nv_bfloat16* __restrict__ gb,
               const int* __restrict__ ranks, float* __restrict__ out,
               int num_edges, int dim) {
  extern __shared__ uint4 s_terms4[];  // [V2B_EDGES][V2B_COLS] bf16
  const __nv_bfloat16* s_terms =
      reinterpret_cast<const __nv_bfloat16*>(s_terms4);
  __shared__ int s_rank[V2B_EDGES];
  const int n = film::load_chunk_ranks<V2B_EDGES>(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * V2B_EDGES;
  const int c0 = blockIdx.y * V2B_COLS;
  const int width = min(V2B_COLS, dim - c0);
  // Phase 1, edge-parallel: 8 columns of one edge a thread.
  const int w8 = width / 8;
  for (int i = threadIdx.x; i < n * w8; i += blockDim.x) {
    const int e = i / w8, q = i - e * w8;
    const __nv_bfloat16* row = gb + static_cast<size_t>(s_rank[e]) * 2 * dim;
    const uint4 mv = *reinterpret_cast<const uint4*>(
        msgs + (e0 + e) * dim + c0 + 8 * q);
    const uint4 gv = *reinterpret_cast<const uint4*>(row + c0 + 8 * q);
    const uint4 bv = *reinterpret_cast<const uint4*>(row + dim + c0 + 8 * q);
    const auto* m8 = reinterpret_cast<const __nv_bfloat16*>(&mv);
    const auto* g8 = reinterpret_cast<const __nv_bfloat16*>(&gv);
    const auto* b8 = reinterpret_cast<const __nv_bfloat16*>(&bv);
    uint4 tv;
    auto* t8 = reinterpret_cast<__nv_bfloat16*>(&tv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float z = __bfloat162float(g8[k]) * __bfloat162float(m8[k])
                      + __bfloat162float(b8[k]);
      t8[k] = __float2bfloat16_rn(film::act<ACT>(z));
    }
    s_terms4[e * (V2B_COLS / 8) + q] = tv;
  }
  __syncthreads();
  // Phase 2, column-parallel: the buffer's column sums by rank runs.
  const int c = threadIdx.x;
  if (c >= width) return;
  const int first = s_rank[0];
  int cur = first;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int r = s_rank[i];
    if (r != cur) {
      film::flush(out + static_cast<size_t>(cur) * dim + c0 + c, acc,
                  cur == first);
      cur = r;
      acc = 0.0f;
    }
    acc += __bfloat162float(s_terms[i * V2B_COLS + c]);
  }
  atomicAdd(out + static_cast<size_t>(cur) * dim + c0 + c, acc);
}

enum Variant { V3 = 0, V2A = 1, V2B = 2 };

template <int ACT>
int launch(const __nv_bfloat16* m, const __nv_bfloat16* t, const int* rk,
           float* o, int num_edges, int dim, int variant, int group,
           cudaStream_t s) {
  if (variant == V2A) {
    const dim3 grid((num_edges + V2A_EDGES - 1) / V2A_EDGES,
                    (dim + V2A_COLS - 1) / V2A_COLS);
    return film::launch_smem(fwd_v2a_kernel<ACT>, grid, dim3(V2A_COLS),
                             V2A_EDGES * V2A_COLS * sizeof(float), s, m, t,
                             rk, o, num_edges, dim);
  }
  if (variant == V2B) {
    if (dim % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((num_edges + V2B_EDGES - 1) / V2B_EDGES,
                    (dim + V2B_COLS - 1) / V2B_COLS);
    return film::launch_smem(fwd_v2b_kernel<ACT>, grid, dim3(V2B_COLS),
                             V2B_EDGES * V2B_COLS * sizeof(__nv_bfloat16), s,
                             m, t, rk, o, num_edges, dim);
  }
  if (variant != V3) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block = film::block_for(dim);
  switch (group) {
    case 1: film_fwd_kernel<ACT, 64><<<(num_edges + 63) / 64, block, 0, s>>>(m, t, rk, o, num_edges, dim); break;
    case 2: film_fwd_kernel<ACT, 128><<<(num_edges + 127) / 128, block, 0, s>>>(m, t, rk, o, num_edges, dim); break;
    case 4: film_fwd_kernel<ACT, 256><<<(num_edges + 255) / 256, block, 0, s>>>(m, t, rk, o, num_edges, dim); break;
    case 8: film_fwd_kernel<ACT, 512><<<(num_edges + 511) / 512, block, 0, s>>>(m, t, rk, o, num_edges, dim); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 = v3 (with `group` in 1, 2, 4, 8), 1 = v2a, 2 = v2b.
extern "C" int film_fwd_ab_launch(const void* msgs, const void* gb,
                                  const void* ranks, void* out, int num_edges,
                                  int dim, int act, int variant, int group,
                                  void* stream) {
  if (num_edges <= 0) return 0;
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* t = static_cast<const __nv_bfloat16*>(gb);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT_CALL(act, launch, m, t, rk, o, num_edges, dim, variant,
                         group, s)
}
