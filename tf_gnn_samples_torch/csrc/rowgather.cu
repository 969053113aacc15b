// K16, row gathers: four ways to compute out[i] = table[idx[i]], for A/B
// timing against each other and against torch.index_select
// (tf_gnn_samples_torch/tools/rowgather_prof.py); the function behind K5b
// (expand.cu).
//
// Replaces the kernels of tools/rowgather_prof.py: `_loop_kernel` (called
// by `kernel_loop`), `_loop8_kernel` (`kernel_loop8`), `_take_kernel`
// (`kernel_take`) and `_onehot_kernel` (`kernel_onehot`). The table is
// bf16 or f32 [rows, D], idx int32 [E], out the table's type [E, D].
//
// Bound on the card: bytes (each used table row read once, the indices,
// each output row written once); no arithmetic. The TPU kernels asked how
// to read rows out of a VMEM-resident table; here the table sits in
// device memory behind the 50 MB L2, and each variant asks the Hopper
// question:
//
// * loop: one warp per output row, lanes over the columns, one element a
//   lane a step: the straightforward gather. Indices must lie in
//   [0, rows), as for the TPU kernel.
// * loop8: the same with 8 rows a warp, all 8 rows' loads in flight before
//   their stores: instruction-level parallelism. Indices in [0, rows).
// * take: 16-byte loads and stores (8 bf16 or 4 f32 a lane) over a flat
//   grid-stride walk of the output, indices clamped to [0, rows) (the TPU
//   kernel's mode="clip"): the widest plain gather.
// * onehot: a block of 256 edges stages the `win` table rows
//   [start, start + win) of its block (starts[b], given) in shared memory
//   with one coalesced load, rounded to bf16, and writes each edge's row
//   from there, widened to the table's type: zero where idx - start falls
//   outside [0, win), as the TPU kernel's windowed one-hot product gives.
//   Does staging a locality window on chip beat the row reads that L2
//   already serves?
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM of an H100
constexpr int ONEHOT_EDGES = 256;

// One warp per output row; T is the element (uint16_t for bf16, uint32_t
// for f32): an exact copy.
template <typename T>
__global__ void __launch_bounds__(THREADS)
loop_kernel(const T* __restrict__ table, const int* __restrict__ idx,
            T* __restrict__ out, int num_out, int dim) {
  const int lane = threadIdx.x & 31;
  const long warp = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long warps = (static_cast<long>(gridDim.x) * blockDim.x) >> 5;
  for (long i = warp; i < num_out; i += warps) {
    const T* src = table + static_cast<long>(idx[i]) * dim;
    T* dst = out + i * dim;
    for (int c = lane; c < dim; c += 32) dst[c] = src[c];
  }
}

// One warp per 8 consecutive output rows (num_out a multiple of 8): the
// 8 rows' loads of a column step are issued before their stores.
template <typename T>
__global__ void __launch_bounds__(THREADS)
loop8_kernel(const T* __restrict__ table, const int* __restrict__ idx,
             T* __restrict__ out, int num_out, int dim) {
  const int lane = threadIdx.x & 31;
  const long warp = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long warps = (static_cast<long>(gridDim.x) * blockDim.x) >> 5;
  for (long i0 = warp * 8; i0 < num_out; i0 += warps * 8) {
    const T* src[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) src[k] = table + static_cast<long>(idx[i0 + k]) * dim;
    T* dst = out + i0 * dim;
    for (int c = lane; c < dim; c += 32) {
      T v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = src[k][c];
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k * dim + c] = v[k];
    }
  }
}

// V is uint4 (width = row bytes / 16 slots a row) or the element type.
template <typename V>
__global__ void __launch_bounds__(THREADS)
take_kernel(const V* __restrict__ table, const int* __restrict__ idx,
            V* __restrict__ out, int num_out, int width, int rows) {
  const long long total = static_cast<long long>(num_out) * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long e = i / width;
    const int c = static_cast<int>(i - e * width);
    const int r = min(max(idx[e], 0), rows - 1);
    out[i] = table[static_cast<long long>(r) * width + c];
  }
}

__device__ __forceinline__ float to_bf16_value(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ __nv_bfloat16 to_bf16_value(__nv_bfloat16 x) {
  return x;
}

// One block per 256 edges; dynamic shared memory holds the block's
// [win, D] window of the table, already rounded to bf16.
template <typename T>
__global__ void __launch_bounds__(THREADS)
onehot_kernel(const T* __restrict__ table, const int* __restrict__ idx,
              const int* __restrict__ starts, T* __restrict__ out, int dim,
              int rows, int win) {
  extern __shared__ float4 s_win4[];
  T* s_win = reinterpret_cast<T*>(s_win4);
  __shared__ int s_local[ONEHOT_EDGES];
  const int start = starts[blockIdx.x];
  const long e0 = static_cast<long>(blockIdx.x) * ONEHOT_EDGES;
  for (int i = threadIdx.x; i < win * dim; i += blockDim.x) {
    const int r = start + i / dim;
    s_win[i] = (r >= 0 && r < rows)
                   ? to_bf16_value(table[static_cast<long>(r) * dim + i % dim])
                   : T(0.0f);
  }
  for (int i = threadIdx.x; i < ONEHOT_EDGES; i += blockDim.x) {
    s_local[i] = idx[e0 + i] - start;
  }
  __syncthreads();
  T* dst = out + e0 * dim;
  for (int i = threadIdx.x; i < ONEHOT_EDGES * dim; i += blockDim.x) {
    const int e = i / dim, lr = s_local[e];
    dst[i] = (lr >= 0 && lr < win) ? s_win[lr * dim + (i - e * dim)] : T(0.0f);
  }
}

enum Variant { LOOP = 0, LOOP8 = 1, TAKE = 2, ONEHOT = 3 };

int blocks_for(long long work) {
  const long long want = (work + THREADS - 1) / THREADS;
  return static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
}

template <typename T>
int launch_take(const void* table, const int* idx, void* out, int num_out,
                int dim, int rows, cudaStream_t s) {
  const bool vec = (dim * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int width = static_cast<int>(dim * sizeof(T) / 16);
    take_kernel<uint4><<<blocks_for(static_cast<long long>(num_out) * width), THREADS, 0, s>>>(
        static_cast<const uint4*>(table), idx, static_cast<uint4*>(out),
        num_out, width, rows);
  } else {
    take_kernel<T><<<blocks_for(static_cast<long long>(num_out) * dim), THREADS, 0, s>>>(
        static_cast<const T*>(table), idx, static_cast<T*>(out), num_out,
        dim, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// T: the element as raw bits (loop, loop8, take); F: the element as a
// number (onehot rounds it).
template <typename T, typename F>
int launch(const void* table, const int* idx, const int* starts, void* out,
           int num_out, int dim, int rows, int variant, int win,
           cudaStream_t s) {
  const auto* t = static_cast<const T*>(table);
  auto* o = static_cast<T*>(out);
  switch (variant) {
    case LOOP:
      loop_kernel<T><<<blocks_for(32LL * num_out), THREADS, 0, s>>>(
          t, idx, o, num_out, dim);
      break;
    case LOOP8:
      if (num_out % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
      loop8_kernel<T><<<blocks_for(4LL * num_out), THREADS, 0, s>>>(
          t, idx, o, num_out, dim);
      break;
    case TAKE:
      return launch_take<T>(table, idx, out, num_out, dim, rows, s);
    case ONEHOT: {
      if (num_out % ONEHOT_EDGES != 0 || win <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const size_t smem = static_cast<size_t>(win) * dim * sizeof(F);
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            onehot_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      onehot_kernel<F><<<num_out / ONEHOT_EDGES, THREADS, smem, s>>>(
          static_cast<const F*>(table), idx, starts, static_cast<F*>(out),
          dim, rows, win);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem_bytes: 2 (bf16 table) or 4 (f32 table); variant: 0 = loop,
// 1 = loop8, 2 = take, 3 = onehot (reads starts [E / 256] and win).
extern "C" int rowgather_launch(const void* table, const void* idx,
                                const void* starts, void* out, int num_out,
                                int dim, int rows, int elem_bytes,
                                int variant, int win, void* stream) {
  if (num_out <= 0 || dim <= 0) return 0;
  const auto* ix = static_cast<const int*>(idx);
  const auto* st = static_cast<const int*>(starts);
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return launch<uint16_t, __nv_bfloat16>(table, ix, st, out, num_out, dim,
                                           rows, variant, win, s);
  }
  if (elem_bytes == 4) {
    return launch<uint32_t, float>(table, ix, st, out, num_out, dim, rows,
                                   variant, win, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
