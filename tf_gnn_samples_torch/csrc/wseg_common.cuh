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
// VMEM. Bound on the card: bytes (a 2D-byte message row, 4K bytes of
// weights and a 4-byte rank an edge, a 4D-byte row of the table), against
// a multiply and an add an element. The walk is K1's (film_rows.cuh), with
// a weight for the gamma|beta rows:
// * a lane owns VEC = 8 consecutive columns of one 64-edge chunk, so every
//   message load is 16 bytes and every store two float4s; a D or a row
//   stride dim_in that is not a multiple of 8, or a pointer that is not
//   16-byte aligned (the fused RGAT branch's [E, D+K] stream at PPI's D
//   320 with 4 heads: 648-byte rows), takes 2-byte loads and 4-byte
//   stores (template parameter V false);
// * the next WSEG_AHEAD = 16 edges' message rows are loaded into
//   registers before their sums (at the QM9 batch 8 edges ran much
//   slower, 12-24 about as fast, 32 slower: exploratory runs on the H100);
// * a run that may continue in a neighbouring chunk is added with two
//   float4 atomicAdds on the 16-byte path (flush_row); with scalar ones
//   the kernel ran markedly slower there;
// * a block stages the ranks and the K weights of every edge of the chunks
//   its items reach in shared memory, loaded along the edge axis of w_t
//   (along the contiguous rows of w); a lane whose 8 columns lie in one
//   head (Dh a multiple of 8) reads one weight an edge, else each column
//   its own head's (a lane may straddle heads, e.g. D 100 with 4 heads).
// Its earlier design (wseg_t_walk.cu, kept as K7a's A/B baseline) gave
// each column a thread with 2-byte loads, one in flight: 2.7x the byte
// bound at the QM9 batch. A lane sums each rank run of its chunk in stream
// order from 0.0f as that thread did, and flushes it as film_common.cuh
// says (the chunk's first and last runs by atomicAdd), so every row that
// one or two chunks hold is equal to the earlier design's bit for bit; a
// row over three or more chunks (the dump rank's run of padded edges)
// meets its partials in atomic order.
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

#include "film_rows.cuh"

namespace wseg {

constexpr int BWD_THREADS = 256;
constexpr int WSEG_AHEAD = 16;  // edges whose message loads a lane issues ahead

// flush8 whose atomics are two float4 atomicAdds (sm_90, global memory)
// on the 16-byte path: four times fewer atomic instructions for the runs
// that may continue in a neighbouring chunk. Each element is added on its
// own, so the sums are flush8's.
template <bool V>
__device__ __forceinline__ void flush_row(float* dst, const float (&acc)[VEC],
                                          int valid, bool may_span) {
  if (V && may_span) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(acc[0], acc[1], acc[2], acc[3]));
    atomicAdd(reinterpret_cast<float4*>(dst) + 1,
              make_float4(acc[4], acc[5], acc[6], acc[7]));
  } else {
    flush8<V>(dst, acc, valid, may_span);
  }
}

// The forward row walk. V: 16-byte message loads and float4 stores (D and
// the row stride dim_in multiples of 8, pointers aligned), else 2-byte
// loads masked to the last column. ONE_HEAD: Dh is a multiple of 8, so a
// lane's 8 columns lie in one head and an edge's weight is one
// shared-memory load; else each column reads its own head's weight.
template <bool HEAD_MAJOR, bool V, bool ONE_HEAD>
__global__ void __launch_bounds__(THREADS)
wseg_kernel(const __nv_bfloat16* __restrict__ msgs,
            const float* __restrict__ w, const int* __restrict__ ranks,
            float* __restrict__ out, int num_edges, int dim, int dim_in,
            int num_heads) {
  extern __shared__ int s_rank[];
  const int cap = rows_cap(dim);
  float* s_w = reinterpret_cast<float*>(s_rank + cap);  // [num_heads][cap]
  Item it;
  bool live;
  if constexpr (HEAD_MAJOR) {
    // Each edge's K weights by the thread that stages its rank:
    // consecutive threads take consecutive edges, along the edge axis.
    live = load_item(ranks, num_edges, dim, s_rank, it,
                     [&](int i, size_t e, int) {
                       for (int k = 0; k < num_heads; ++k) {
                         s_w[k * cap + i] =
                             w[static_cast<size_t>(k) * num_edges + e];
                       }
                     });
  } else {
    // The block's edges' weight rows are contiguous in w: consecutive
    // threads take consecutive weights (load_item's barrier covers them).
    long long e_lo;
    const int n_w = block_edges(blockIdx.x, num_edges, dim, e_lo) * num_heads;
    for (int j = threadIdx.x; j < n_w; j += THREADS) {
      s_w[(j % num_heads) * cap + j / num_heads] = w[e_lo * num_heads + j];
    }
    live = load_item(ranks, num_edges, dim, s_rank, it);
  }
  if (!live) return;
  const int head_dim = dim / num_heads;
  const float* wk[ONE_HEAD ? 1 : VEC];
#pragma unroll
  for (int k = 0; k < (ONE_HEAD ? 1 : VEC); ++k) {
    // Columns past D (masked) read the last head's weight.
    wk[k] = s_w + it.off +
            static_cast<size_t>(min((it.c + k) / head_dim, num_heads - 1)) * cap;
  }
  const __nv_bfloat16* m_col = msgs + it.e0 * dim_in + it.c;
  const int first = it.rk[0];
  int cur = first;
  float acc[VEC] = {};
#pragma unroll 1
  for (int i0 = 0; i0 < it.n; i0 += WSEG_AHEAD) {
    int r[WSEG_AHEAD];
    uint4 mv[WSEG_AHEAD];
#pragma unroll
    for (int u = 0; u < WSEG_AHEAD; ++u) {
      // Past the chunk's end: the last edge again, loaded but not summed.
      const int i = min(i0 + u, it.n - 1);
      r[u] = it.rk[i];
      mv[u] = load8<V>(m_col + static_cast<size_t>(i) * dim_in, it.valid);
    }
#pragma unroll
    for (int u = 0; u < WSEG_AHEAD; ++u) {
      const int i = i0 + u;
      if (i >= it.n) break;
      if (r[u] != cur) {
        flush_row<V>(out + static_cast<size_t>(cur) * dim + it.c, acc,
                     it.valid, cur == first);
        cur = r[u];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc[k] += film::round_bf16(bf(mv[u], k) * wk[ONE_HEAD ? 0 : k][i]);
      }
    }
  }
  flush_row<V>(out + static_cast<size_t>(cur) * dim + it.c, acc, it.valid,
               true);
}

template <bool HEAD_MAJOR, bool V, bool ONE_HEAD>
inline int launch_fwd_as(const void* msgs, const void* w, const void* ranks,
                         void* out, int num_edges, int dim, int dim_in,
                         int num_heads, cudaStream_t stream) {
  return film::launch_smem(
      wseg_kernel<HEAD_MAJOR, V, ONE_HEAD>, rows_grid(num_edges, dim),
      dim3(THREADS), rows_smem(dim, 1 + num_heads), stream,
      static_cast<const __nv_bfloat16*>(msgs), static_cast<const float*>(w),
      static_cast<const int*>(ranks), static_cast<float*>(out), num_edges, dim,
      dim_in, num_heads);
}

// dim must be a multiple of num_heads, and num_heads at most 128 (the
// wrappers check both): the block's ranks and weights, (1 + K) ints and
// floats for each edge of the chunks its items reach, then take at most
// 182 KB of shared memory (D 120, 120 heads), opted in above 48 KB.
template <bool HEAD_MAJOR>
inline int launch_fwd(const void* msgs, const void* w, const void* ranks,
                      void* out, int num_edges, int dim, int dim_in,
                      int num_heads, void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  if (num_heads <= 0 || dim % num_heads != 0 || dim > dim_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = dim % VEC == 0 && dim_in % VEC == 0 && aligned16(msgs) &&
                   aligned16(out);
  const bool one = (dim / num_heads) % VEC == 0;
  if (vec) {
    return one ? launch_fwd_as<HEAD_MAJOR, true, true>(
                     msgs, w, ranks, out, num_edges, dim, dim_in, num_heads, s)
               : launch_fwd_as<HEAD_MAJOR, true, false>(
                     msgs, w, ranks, out, num_edges, dim, dim_in, num_heads, s);
  }
  return one ? launch_fwd_as<HEAD_MAJOR, false, true>(
                   msgs, w, ranks, out, num_edges, dim, dim_in, num_heads, s)
             : launch_fwd_as<HEAD_MAJOR, false, false>(
                   msgs, w, ranks, out, num_edges, dim, dim_in, num_heads, s);
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
