// K11a: fused expand-add-activate, forward.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_expand_add_act_kernel`
// (called by `_expand_add_act_impl`, the forward of `expand_add_act`):
//   x[e, d] = bf16(act(float(m[e, d]) + float(bf16(beta[rank_e, d]))))
// with m a bf16 [E, D] stream, beta an f32 [rows, D] rank table, ranks
// int32 [E] below rows and x a bf16 [E, D] stream. The rounding points are
// the TPU kernel's: the table row is cast to bf16 before its one-hot MXU
// dot (which reproduces it exactly in f32), the add and the activation run
// in f32, and x is rounded once.
//
// Bound on the card: bytes. Each edge reads a 2D-byte message row and a
// 4-byte rank and writes a 2D-byte row; each used table row is read (from
// L2 after its first edge: the ranks are sorted, so consecutive edges read
// the same or the next row). The TPU kernel expands windowed one-hot
// matrices against a VMEM-resident table; here it is K5b's row copy
// (expand.cu) with an add and an activation: a grid-stride loop walks the
// [E, D] output in slots of 8 columns (16 bytes of bf16 in and out, two
// float4 of the table), so loads and stores are contiguous and coalesced
// and the threads of a warp read the same rank; single columns when D is
// not a multiple of 8 or a pointer is not 16-byte aligned.
#include "film_common.cuh"

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM of an H100

struct alignas(16) Bf16x8 {
  __nv_bfloat16 v[8];
};

template <int ACT>
__global__ void __launch_bounds__(THREADS)
expand_add_act_vec_kernel(const Bf16x8* __restrict__ m,
                          const float4* __restrict__ beta,
                          const int* __restrict__ ranks,
                          Bf16x8* __restrict__ x, int num_edges, int width) {
  const long long total = static_cast<long long>(num_edges) * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long e = i / width;
    const int c = static_cast<int>(i - e * width);
    const Bf16x8 mv = m[i];
    const float4* row = beta + (static_cast<long long>(ranks[e]) * width + c) * 2;
    const float4 b0 = row[0], b1 = row[1];
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    Bf16x8 out;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float z = __bfloat162float(mv.v[j]) + film::round_bf16(b[j]);
      out.v[j] = __float2bfloat16_rn(film::act<ACT>(z));
    }
    x[i] = out;
  }
}

template <int ACT>
__global__ void __launch_bounds__(THREADS)
expand_add_act_kernel(const __nv_bfloat16* __restrict__ m,
                      const float* __restrict__ beta,
                      const int* __restrict__ ranks,
                      __nv_bfloat16* __restrict__ x, int num_edges, int dim) {
  const long long total = static_cast<long long>(num_edges) * dim;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long e = i / dim;
    const int c = static_cast<int>(i - e * dim);
    const float z = film::ld(m + i) +
        film::round_bf16(beta[static_cast<long long>(ranks[e]) * dim + c]);
    x[i] = __float2bfloat16_rn(film::act<ACT>(z));
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int expand_add_act_launch(const void* m, const void* beta,
                                     const void* ranks, void* x,
                                     int num_edges, int dim, int act,
                                     void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  const auto* rk = static_cast<const int*>(ranks);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = dim % 8 == 0 && aligned16(m) && aligned16(beta) && aligned16(x);
  const int width = vec ? dim / 8 : dim;
  const long long total = static_cast<long long>(num_edges) * width;
  const long long want = (total + THREADS - 1) / THREADS;
  const dim3 grid(static_cast<unsigned>(want < MAX_BLOCKS ? want : MAX_BLOCKS));
  const dim3 block(THREADS);
  if (vec) {
    FILM_DISPATCH_ACT(act, expand_add_act_vec_kernel, grid, block, s,
                      static_cast<const Bf16x8*>(m),
                      static_cast<const float4*>(beta), rk,
                      static_cast<Bf16x8*>(x), num_edges, width)
  } else {
    FILM_DISPATCH_ACT(act, expand_add_act_kernel, grid, block, s,
                      static_cast<const __nv_bfloat16*>(m),
                      static_cast<const float*>(beta), rk,
                      static_cast<__nv_bfloat16*>(x), num_edges, dim)
  }
  return static_cast<int>(cudaGetLastError());
}
