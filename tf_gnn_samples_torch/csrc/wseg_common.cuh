// Shared device code of the per-head weighted ranked segment-sum and its
// backward, for both layouts of the per-head weights: head-major w_t
// [K, E] (K7a wseg_t.cu, K7b wseg_t_bwd.cu; RGAT's attention weights) and
// row-major w [E, K] (K13a wseg.cu, K13b wseg_bwd.cu). Head k weighs the
// columns k * Dh ... (k + 1) * Dh - 1 of a row, Dh = D / K.
//
// Forward (wseg_kernel):
//   out[r, c] = sum_{e: rank_e = r} bf16(m[e, c] * w(e, c / Dh))
// with m a bf16 [E, dim_in] stream of which the first D columns are used,
// ranks nondecreasing and gap-free and out an f32 [rows, D] table zeroed
// by the caller. The product is taken in f32, rounded to bf16 (the TPU
// kernels' cast before their one-hot MXU dot) and summed in f32. The TPU
// kernels replicate the weights to D lanes with a thin MXU contraction in
// VMEM; here it is the chunked sorted-rank walk of the FiLM kernels
// (film_common.cuh) with another term: a block owns CHUNK consecutive
// edges, stages their K x CHUNK weights in shared memory with coalesced
// loads (along the edge axis of w_t, along the contiguous rows of w), and
// each thread walks the chunk for its column, reading the weight of its
// column's head as a shared-memory broadcast.
//
// Backward (wseg_bwd_kernel): with g_e = g16[rank_e] the table cotangent
// of edge e's receiver, rounded to bf16 by the caller,
//   dmsg[e, c] = bf16(g_e[c] * w(e, c / Dh))
//   dw(e, k)   = sum_{c in head k} m[e, c] * g_e[c]        (f32)
// The products m * g of two bf16 values are exact in f32; only the order
// of the Dh-term f32 sum is this kernel's own. There is no reduction
// across edges, so no atomics: one thread owns one (edge, head) pair, its
// Dh contiguous columns of the message row and of the receiver's g row
// (read in 16-byte pieces when Dh is a multiple of 8 and the pointers are
// aligned), and writes the same Dh columns of dmsg. Threads are laid out
// head-fastest, so a warp covers whole contiguous rows, and a row-major
// weight or its cotangent is read and written in place, coalesced. The
// head-major [K, E] weights and their cotangent are strided by E across
// heads: both are staged through shared memory and moved with loads and
// stores that run along the edge axis.
#pragma once

#include <cstdint>

#include "film_common.cuh"

namespace wseg {

constexpr int BWD_THREADS = 256;

// Weight of head k for the chunk-local edge i of the block starting at e0.
template <bool HEAD_MAJOR>
__device__ __forceinline__ size_t weight_index(size_t e0, int i, int k,
                                               int num_edges, int num_heads) {
  return HEAD_MAJOR ? static_cast<size_t>(k) * num_edges + e0 + i
                    : (e0 + i) * num_heads + k;
}

template <bool HEAD_MAJOR>
__global__ void __launch_bounds__(film::MAX_THREADS)
wseg_kernel(const __nv_bfloat16* __restrict__ msgs,
            const float* __restrict__ w, const int* __restrict__ ranks,
            float* __restrict__ out, int num_edges, int dim, int dim_in,
            int num_heads) {
  extern __shared__ float s_w[];  // [num_heads][CHUNK]
  __shared__ int s_rank[film::CHUNK];
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  for (int idx = threadIdx.x; idx < num_heads * film::CHUNK; idx += blockDim.x) {
    // Consecutive threads take consecutive addresses in either layout.
    const int k = HEAD_MAJOR ? idx / film::CHUNK : idx % num_heads;
    const int i = HEAD_MAJOR ? idx % film::CHUNK : idx / num_heads;
    if (i < n) {
      s_w[k * film::CHUNK + i] =
          w[weight_index<HEAD_MAJOR>(e0, i, k, num_edges, num_heads)];
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

// dim must be a multiple of num_heads, and num_heads * CHUNK floats must
// fit the 48 KB of static-limit shared memory (the wrappers check both).
template <bool HEAD_MAJOR>
inline int launch_fwd(const void* msgs, const void* w, const void* ranks,
                      void* out, int num_edges, int dim, int dim_in,
                      int num_heads, void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  const size_t smem = static_cast<size_t>(num_heads) * film::CHUNK * sizeof(float);
  wseg_kernel<HEAD_MAJOR><<<film::grid_for(num_edges), film::block_for(dim),
                            smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(msgs), static_cast<const float*>(w),
      static_cast<const int*>(ranks), static_cast<float*>(out), num_edges, dim,
      dim_in, num_heads);
  return static_cast<int>(cudaGetLastError());
}

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

template <bool HEAD_MAJOR, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS)
wseg_bwd_kernel(const __nv_bfloat16* __restrict__ msgs,
                const float* __restrict__ w,
                const __nv_bfloat16* __restrict__ g16,
                const int* __restrict__ ranks,
                __nv_bfloat16* __restrict__ dmsg, float* __restrict__ dw,
                int num_edges, int dim, int num_heads, int block_edges) {
  // Head-major only: [num_heads][block_edges] weights, then their
  // cotangents.
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_dw = smem + num_heads * block_edges;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * block_edges;
  const int n = min(block_edges, static_cast<int>(num_edges - e0));
  const int cells = num_heads * block_edges;
  if (HEAD_MAJOR) {
    for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
      const int k = idx / block_edges, i = idx % block_edges;
      if (i < n) s_w[idx] = w[static_cast<size_t>(k) * num_edges + e0 + i];
    }
    __syncthreads();
  }
  const int i = threadIdx.x / num_heads, k = threadIdx.x % num_heads;
  if (i < n) {
    const int head_dim = dim / num_heads;
    const size_t e = e0 + i;
    const float wk = HEAD_MAJOR ? s_w[k * block_edges + i]
                                : w[e * num_heads + k];
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
        dv.x = word(mv.x, gv.x, wk, acc);
        dv.y = word(mv.y, gv.y, wk, acc);
        dv.z = word(mv.z, gv.z, wk, acc);
        dv.w = word(mv.w, gv.w, wk, acc);
        *reinterpret_cast<uint4*>(dm + j) = dv;
      }
    } else {
      for (int j = 0; j < head_dim; ++j) {
        const float gj = __bfloat162float(g[j]);
        acc += __bfloat162float(m[j]) * gj;
        dm[j] = __float2bfloat16_rn(gj * wk);
      }
    }
    if (HEAD_MAJOR) {
      s_dw[k * block_edges + i] = acc;
    } else {
      dw[e * num_heads + k] = acc;
    }
  }
  if (HEAD_MAJOR) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
      const int kk = idx / block_edges, ii = idx % block_edges;
      if (ii < n) dw[static_cast<size_t>(kk) * num_edges + e0 + ii] = s_dw[idx];
    }
  }
}

// dim must be a multiple of num_heads and num_heads at most BWD_THREADS
// (the wrappers check both).
template <bool HEAD_MAJOR>
inline int launch_bwd(const void* msgs, const void* w, const void* g16,
                      const void* ranks, void* dmsg, void* dw, int num_edges,
                      int dim, int num_heads, void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  if (num_heads <= 0 || num_heads > BWD_THREADS || dim % num_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int block_edges = BWD_THREADS / num_heads;
  const int blocks = (num_edges + block_edges - 1) / block_edges;
  const size_t smem = HEAD_MAJOR ? 2 * static_cast<size_t>(num_heads) *
                                       block_edges * sizeof(float)
                                 : 0;
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* wp = static_cast<const float*>(w);
  const auto* g = static_cast<const __nv_bfloat16*>(g16);
  const auto* rk = static_cast<const int*>(ranks);
  auto* dm = static_cast<__nv_bfloat16*>(dmsg);
  auto* dwp = static_cast<float*>(dw);
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte pieces need head slices that start and end on 16 bytes.
  const bool vec = (dim / num_heads) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g16) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dmsg) % 16 == 0;
  if (vec) {
    wseg_bwd_kernel<HEAD_MAJOR, true><<<blocks, BWD_THREADS, smem, s>>>(
        m, wp, g, rk, dm, dwp, num_edges, dim, num_heads, block_edges);
  } else {
    wseg_bwd_kernel<HEAD_MAJOR, false><<<blocks, BWD_THREADS, smem, s>>>(
        m, wp, g, rk, dm, dwp, num_edges, dim, num_heads, block_edges);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wseg
