// K7b: backward of the per-head weighted ranked segment-sum (K7a).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_wseg_t_bwd_kernel`
// (called by `_wseg_t_bwd_impl`). With g_e = g16[rank_e] the table
// cotangent of edge e's receiver, rounded to bf16 by the caller:
//   dmsg[e, c] = bf16(g_e[c] * w_t[c / Dh, e])
//   dw_t[k, e] = sum_{c in head k} m[e, c] * g_e[c]        (f32)
// with m a bf16 [E, D] stream, w_t the f32 [K, E] weights, g16 a bf16
// [rows, D] table and ranks int32 [E] below rows. The products m * g of
// two bf16 values are exact in f32; only the order of the Dh-term f32 sum
// is this kernel's own.
//
// Bound on the card: bytes (per edge a 2D-byte message row read, a
// 2D-byte row written, 8K bytes of weights and their cotangent and a
// 4-byte rank; each used g row read once; two multiplies and an add per
// element). There is no reduction across edges, so no atomics: one thread
// owns one (edge, head) pair, its Dh contiguous columns of the message
// row and of the receiver's g row (read in 16-byte pieces when Dh is a
// multiple of 8 and the pointers are aligned), and writes the same Dh
// columns of dmsg. Threads are laid out head-fastest, so a warp covers
// whole contiguous rows. The [K, E] weights and their cotangent are
// strided by E across heads: both are staged through shared memory and
// moved with loads and stores that run along the edge axis.
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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// One 32-bit word holds two bf16 columns: accumulates m * g and returns
// the two dmsg columns g * w.
__device__ __forceinline__ unsigned word(unsigned m, unsigned g, float w,
                                         float& acc) {
  const float g0 = lo_bf16(g), g1 = hi_bf16(g);
  acc += lo_bf16(m) * g0;
  acc += hi_bf16(m) * g1;
  return pack_bf16(g0 * w, g1 * w);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
wseg_t_bwd_kernel(const __nv_bfloat16* __restrict__ msgs,
                  const float* __restrict__ w_t,
                  const __nv_bfloat16* __restrict__ g16,
                  const int* __restrict__ ranks,
                  __nv_bfloat16* __restrict__ dmsg, float* __restrict__ dw_t,
                  int num_edges, int dim, int num_heads, int block_edges) {
  extern __shared__ float smem[];
  float* s_w = smem;                              // [num_heads][block_edges]
  float* s_dw = smem + num_heads * block_edges;   // [num_heads][block_edges]
  const size_t e0 = static_cast<size_t>(blockIdx.x) * block_edges;
  const int n = min(block_edges, static_cast<int>(num_edges - e0));
  const int cells = num_heads * block_edges;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int k = idx / block_edges, i = idx % block_edges;
    if (i < n) s_w[idx] = w_t[static_cast<size_t>(k) * num_edges + e0 + i];
  }
  __syncthreads();
  const int i = threadIdx.x / num_heads, k = threadIdx.x % num_heads;
  if (i < n) {
    const int head_dim = dim / num_heads;
    const size_t e = e0 + i;
    const float w = s_w[k * block_edges + i];
    const size_t col = static_cast<size_t>(k) * head_dim;
    const __nv_bfloat16* m = msgs + e * dim + col;
    const __nv_bfloat16* g = g16 + static_cast<size_t>(ranks[e]) * dim + col;
    __nv_bfloat16* dm = dmsg + e * dim + col;
    float acc = 0.0f;
    if (VEC) {
      for (int j = 0; j < head_dim; j += 8) {
        const uint4 mv = *reinterpret_cast<const uint4*>(m + j);
        const uint4 gv = *reinterpret_cast<const uint4*>(g + j);
        uint4 dv;
        dv.x = word(mv.x, gv.x, w, acc);
        dv.y = word(mv.y, gv.y, w, acc);
        dv.z = word(mv.z, gv.z, w, acc);
        dv.w = word(mv.w, gv.w, w, acc);
        *reinterpret_cast<uint4*>(dm + j) = dv;
      }
    } else {
      for (int j = 0; j < head_dim; ++j) {
        const float gj = __bfloat162float(g[j]);
        acc += __bfloat162float(m[j]) * gj;
        dm[j] = __float2bfloat16_rn(gj * w);
      }
    }
    s_dw[k * block_edges + i] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int kk = idx / block_edges, ii = idx % block_edges;
    if (ii < n) dw_t[static_cast<size_t>(kk) * num_edges + e0 + ii] = s_dw[idx];
  }
}

}  // namespace

// dim must be a multiple of num_heads and num_heads at most THREADS (the
// wrapper checks both).
extern "C" int wseg_t_bwd_launch(const void* msgs, const void* w_t,
                                 const void* g16, const void* ranks, void* dmsg,
                                 void* dw_t, int num_edges, int dim,
                                 int num_heads, void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  if (num_heads <= 0 || num_heads > THREADS || dim % num_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int block_edges = THREADS / num_heads;
  const int blocks = (num_edges + block_edges - 1) / block_edges;
  const size_t smem = 2 * static_cast<size_t>(num_heads) * block_edges * sizeof(float);
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* w = static_cast<const float*>(w_t);
  const auto* g = static_cast<const __nv_bfloat16*>(g16);
  const auto* rk = static_cast<const int*>(ranks);
  auto* dm = static_cast<__nv_bfloat16*>(dmsg);
  auto* dw = static_cast<float*>(dw_t);
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte pieces need head slices that start and end on 16 bytes.
  const bool vec = (dim / num_heads) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g16) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dmsg) % 16 == 0;
  if (vec) {
    wseg_t_bwd_kernel<true><<<blocks, THREADS, smem, s>>>(
        m, w, g, rk, dm, dw, num_edges, dim, num_heads, block_edges);
  } else {
    wseg_t_bwd_kernel<false><<<blocks, THREADS, smem, s>>>(
        m, w, g, rk, dm, dw, num_edges, dim, num_heads, block_edges);
  }
  return static_cast<int>(cudaGetLastError());
}
