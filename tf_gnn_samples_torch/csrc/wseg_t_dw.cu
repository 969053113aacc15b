// K8: the weight-cotangent half of the per-head weighted ranked
// segment-sum's backward, alone.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_wseg_t_dw_kernel`
// (called by `_wseg_t_dw_impl`, in the backward of `rgat_fused_pass`). With
// g_e = g16[rank_e] the table cotangent of edge e's receiver, rounded to
// bf16 by the caller:
//   dw_t[k, e] = sum_{c in head k} m[e, c] * g_e[c]        (f32)
// with m a bf16 [E, dim_in] stream of which only the first `dim` columns
// are read (the RGAT gather carries K extra columns), g16 a bf16 [rows,
// dim] table and ranks int32 [E] below rows. The products of two bf16
// values are exact in f32; only the order of the Dh-term f32 sum is this
// kernel's own.
//
// Bound on the card: bytes (per edge 2 * dim bytes of the message row, 4K
// bytes written and a 4-byte rank; each used g row read once; a multiply
// and an add per element). It is K7b (wseg_t_bwd.cu) without the weights
// and without the [E, D] message cotangent: no reduction across edges, so
// no atomics; one thread owns one (edge, head) pair and its Dh contiguous
// columns of the message row and of the receiver's g row (read in 16-byte
// pieces when Dh and dim_in are multiples of 8 and the pointers are
// aligned). Threads are laid out head-fastest, so a warp reads whole
// contiguous rows. The [K, E] output is strided by E across heads: it is
// staged through shared memory and stored along the edge axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float lo_bf16(unsigned x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float hi_bf16(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

// One 32-bit word holds two bf16 columns.
__device__ __forceinline__ void word(unsigned m, unsigned g, float& acc) {
  acc += lo_bf16(m) * lo_bf16(g);
  acc += hi_bf16(m) * hi_bf16(g);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
wseg_t_dw_kernel(const __nv_bfloat16* __restrict__ msgs,
                 const __nv_bfloat16* __restrict__ g16,
                 const int* __restrict__ ranks, float* __restrict__ dw_t,
                 int num_edges, int dim, int dim_in, int num_heads,
                 int block_edges) {
  extern __shared__ float s_dw[];  // [num_heads][block_edges]
  const size_t e0 = static_cast<size_t>(blockIdx.x) * block_edges;
  const int n = min(block_edges, static_cast<int>(num_edges - e0));
  const int i = threadIdx.x / num_heads, k = threadIdx.x % num_heads;
  if (i < n) {
    const int head_dim = dim / num_heads;
    const size_t e = e0 + i;
    const size_t col = static_cast<size_t>(k) * head_dim;
    const __nv_bfloat16* m = msgs + e * dim_in + col;
    const __nv_bfloat16* g = g16 + static_cast<size_t>(ranks[e]) * dim + col;
    float acc = 0.0f;
    if (VEC) {
      for (int j = 0; j < head_dim; j += 8) {
        const uint4 mv = *reinterpret_cast<const uint4*>(m + j);
        const uint4 gv = *reinterpret_cast<const uint4*>(g + j);
        word(mv.x, gv.x, acc);
        word(mv.y, gv.y, acc);
        word(mv.z, gv.z, acc);
        word(mv.w, gv.w, acc);
      }
    } else {
      for (int j = 0; j < head_dim; ++j) {
        acc += __bfloat162float(m[j]) * __bfloat162float(g[j]);
      }
    }
    s_dw[k * block_edges + i] = acc;
  }
  __syncthreads();
  const int cells = num_heads * block_edges;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int kk = idx / block_edges, ii = idx % block_edges;
    if (ii < n) dw_t[static_cast<size_t>(kk) * num_edges + e0 + ii] = s_dw[idx];
  }
}

}  // namespace

// dim must be a multiple of num_heads, at most dim_in, and num_heads at
// most THREADS (the wrapper checks all three).
extern "C" int wseg_t_dw_launch(const void* msgs, const void* g16,
                                const void* ranks, void* dw_t, int num_edges,
                                int dim, int dim_in, int num_heads,
                                void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  if (num_heads <= 0 || num_heads > THREADS || dim % num_heads != 0 ||
      dim > dim_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int block_edges = THREADS / num_heads;
  const int blocks = (num_edges + block_edges - 1) / block_edges;
  const size_t smem = static_cast<size_t>(num_heads) * block_edges * sizeof(float);
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* g = static_cast<const __nv_bfloat16*>(g16);
  const auto* rk = static_cast<const int*>(ranks);
  auto* dw = static_cast<float*>(dw_t);
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte pieces need head slices and rows that start on 16 bytes.
  const bool vec = (dim / num_heads) % 8 == 0 && dim_in % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g16) % 16 == 0;
  if (vec) {
    wseg_t_dw_kernel<true><<<blocks, THREADS, smem, s>>>(
        m, g, rk, dw, num_edges, dim, dim_in, num_heads, block_edges);
  } else {
    wseg_t_dw_kernel<false><<<blocks, THREADS, smem, s>>>(
        m, g, rk, dw, num_edges, dim, dim_in, num_heads, block_edges);
  }
  return static_cast<int>(cudaGetLastError());
}
