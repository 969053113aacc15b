// Shared pieces of the fused GNN-FiLM kernels (film_fwd.cu, film_bwd.cu,
// film_bwd_dgb.cu, film_src_bwd.cu, film_fwd_mask.cu, film_rows.cuh,
// film_walk.cuh, the earlier designs film_src_bwd_walk.cu and
// film_bwd_walk.cu, and the K16 variants film_fwd_ab.cu, film_dgb_ab.cu)
// and of the other sorted-rank reductions and activation passes
// (segsum.cu, segsum_t.cu, wseg_common.cuh, rgat_src_bwd.cu,
// expand_add_act.cu, expand_add_act_bwd.cu, act_agg.cu, act_agg_bwd.cu,
// typed_dense_agg.cu, typed_dense_agg_bwd.cu, emlp1_src_bwd.cu,
// masked_segsum.cu, the earlier designs act_agg_walk.cu,
// rgat_src_bwd_walk.cu, wseg_t_walk.cu and segsum_t_walk.cu): the activations of the JAX package's `_ACTS`
// table (tf_gnn_samples_tpu/ops/ranked_segment.py), bf16 rounding, the
// segment flush of the sorted-rank reduction and the launches.
//
// These kernels are segmented reductions over a stream whose ranks are
// nondecreasing and gap-free. A block owns CHUNK consecutive edges, its
// threads span the feature columns (film_rows.cuh: a lane owns 8 columns
// of a chunk; act_agg.cu and rgat_src_bwd.cu: 2), and each thread keeps a
// running f32 sum while the rank is unchanged. At a rank change it flushes
// the sum:
// the chunk's first and last segments may continue in a neighbouring chunk
// and are added with atomicAdd, a segment wholly inside the chunk is
// stored. The output is zeroed by the caller.
//
// Built with -fmad=false: every product and sum is rounded on its own, as
// in the PyTorch plain versions, so each bf16-rounded term matches them
// bit for bit and only the order of the f32 sums differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace film {

constexpr int CHUNK = 64;          // edges per block
constexpr int MAX_THREADS = 128;   // threads per block, across columns

// Activation ids; the order matches ACT_IDS in ops/ranked_segment.py.
enum Act { LINEAR = 0, RELU = 1, LEAKY_RELU = 2, ELU = 3, TANH = 4, GELU = 5 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Abramowitz-Stegun 7.1.26, as the JAX package's _erf_approx (the TPU has
// no erf lowering; the port keeps the same approximation, not erff).
__device__ __forceinline__ float erf_approx(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  const float y = 1.0f - poly * expf(-ax * ax);
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return sign * y;
}

constexpr float kRsqrt2 = 0.70710678118654752f;      // 2 ** -0.5
constexpr float kRsqrt2Pi = 0.39894228040143268f;    // 1 / sqrt(2 pi)

template <int ACT>
__device__ __forceinline__ float act(float z) {
  if (ACT == LINEAR) return z;
  if (ACT == RELU) return fmaxf(z, 0.0f);
  if (ACT == LEAKY_RELU) return z > 0.0f ? z : 0.2f * z;
  if (ACT == ELU) return z > 0.0f ? z : expf(fminf(z, 0.0f)) - 1.0f;
  if (ACT == TANH) return tanhf(z);
  return 0.5f * z * (1.0f + erf_approx(z * kRsqrt2));  // GELU
}

template <int ACT>
__device__ __forceinline__ float dact(float z) {
  if (ACT == LINEAR) return 1.0f;
  if (ACT == RELU) return z > 0.0f ? 1.0f : 0.0f;
  if (ACT == LEAKY_RELU) return z > 0.0f ? 1.0f : 0.2f;
  if (ACT == ELU) return z > 0.0f ? 1.0f : expf(fminf(z, 0.0f));
  if (ACT == TANH) {
    const float t = tanhf(z);
    return 1.0f - t * t;
  }
  return 0.5f * (1.0f + erf_approx(z * kRsqrt2))  // GELU
         + z * expf(-0.5f * z * z) * kRsqrt2Pi;
}

// A segment that may continue in a neighbouring chunk (the chunk's first
// or last rank) is added atomically; one wholly inside the chunk is stored.
__device__ __forceinline__ void flush(float* dst, float v, bool may_span) {
  if (may_span) {
    atomicAdd(dst, v);
  } else {
    *dst = v;
  }
}

// flush for a run's two sums (`valid` of them), one 8-byte store with V2
// (dst 8-byte aligned).
template <bool V2>
__device__ __forceinline__ void flush2(float* dst, float a0, float a1,
                                       int valid, bool may_span) {
  if (may_span) {
    atomicAdd(dst, a0);
    if (valid > 1) atomicAdd(dst + 1, a1);
  } else if (V2) {
    *reinterpret_cast<float2*>(dst) = make_float2(a0, a1);
  } else {
    dst[0] = a0;
    if (valid > 1) dst[1] = a1;
  }
}

// Loads the ranks of block blockIdx.x's EDGES edges (a chunk unless the
// caller walks more) into shared memory; returns the edge count.
template <int EDGES = CHUNK>
__device__ __forceinline__ int load_chunk_ranks(const int* __restrict__ ranks,
                                                int num_edges, int* s_rank) {
  const long e0 = static_cast<long>(blockIdx.x) * EDGES;
  const int n = min(EDGES, static_cast<int>(num_edges - e0));
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_rank[i] = ranks[e0 + i];
  __syncthreads();
  return n;
}

inline dim3 grid_for(int num_edges) { return dim3((num_edges + CHUNK - 1) / CHUNK); }

inline dim3 block_for(int dim) {
  return dim3(dim < MAX_THREADS ? ((dim + 31) / 32) * 32 : MAX_THREADS);
}

// Launches `kernel` with `smem` bytes of dynamic shared memory, first
// raising the kernel's limit where `smem` is over the 48 KB default;
// returns the CUDA error of the launch.
template <typename... Params, typename... Args>
inline int launch_smem(void (*kernel)(Params...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace film

// Launches KERNEL<ACT> for the runtime activation id `act`; returns
// cudaErrorInvalidValue for an unknown id.
#define FILM_DISPATCH_ACT(act, KERNEL, GRID, BLOCK, STREAM, ...)              \
  switch (act) {                                                              \
    case film::LINEAR: KERNEL<film::LINEAR><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__); break;         \
    case film::RELU: KERNEL<film::RELU><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__); break;             \
    case film::LEAKY_RELU: KERNEL<film::LEAKY_RELU><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__); break; \
    case film::ELU: KERNEL<film::ELU><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__); break;               \
    case film::TANH: KERNEL<film::TANH><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__); break;             \
    case film::GELU: KERNEL<film::GELU><<<GRID, BLOCK, 0, STREAM>>>(__VA_ARGS__); break;             \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }

// Returns FN<ACT>(...) for the runtime activation id `act`, or
// cudaErrorInvalidValue for an unknown id.
#define FILM_DISPATCH_ACT_CALL(act, FN, ...)                                  \
  switch (act) {                                                              \
    case film::LINEAR: return FN<film::LINEAR>(__VA_ARGS__);                  \
    case film::RELU: return FN<film::RELU>(__VA_ARGS__);                      \
    case film::LEAKY_RELU: return FN<film::LEAKY_RELU>(__VA_ARGS__);          \
    case film::ELU: return FN<film::ELU>(__VA_ARGS__);                        \
    case film::TANH: return FN<film::TANH>(__VA_ARGS__);                      \
    case film::GELU: return FN<film::GELU>(__VA_ARGS__);                      \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }

// Returns film::launch_smem of KERNEL<ACT> for the runtime activation id
// `act`, or cudaErrorInvalidValue for an unknown id.
#define FILM_DISPATCH_ACT_SMEM(act, KERNEL, GRID, BLOCK, SMEM, STREAM, ...)   \
  switch (act) {                                                              \
    case film::LINEAR: return film::launch_smem(KERNEL<film::LINEAR>, GRID, BLOCK, SMEM, STREAM, __VA_ARGS__);         \
    case film::RELU: return film::launch_smem(KERNEL<film::RELU>, GRID, BLOCK, SMEM, STREAM, __VA_ARGS__);             \
    case film::LEAKY_RELU: return film::launch_smem(KERNEL<film::LEAKY_RELU>, GRID, BLOCK, SMEM, STREAM, __VA_ARGS__); \
    case film::ELU: return film::launch_smem(KERNEL<film::ELU>, GRID, BLOCK, SMEM, STREAM, __VA_ARGS__);               \
    case film::TANH: return film::launch_smem(KERNEL<film::TANH>, GRID, BLOCK, SMEM, STREAM, __VA_ARGS__);             \
    case film::GELU: return film::launch_smem(KERNEL<film::GELU>, GRID, BLOCK, SMEM, STREAM, __VA_ARGS__);             \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }
