// K5b: ranked expand.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_expand_kernel`
// (called by `_expand_impl`):
//   out[e, d] = float(bf16(table[rank_e, d]))
// with table an f32 [rows, D] table, ranks int32 [E] below rows, and out
// an f32 [E, D] stream. The rounding is the TPU kernel's cast of the table
// to bf16 before its one-hot MXU dot, which the dot then reproduces
// exactly in f32.
//
// Bound on the card: bytes. Each edge writes a 4D-byte row and reads a
// 4-byte rank; each used table row is read (from L2 after its first edge:
// ranks are sorted, so consecutive edges read the same or the next row).
// The TPU kernel expands windowed one-hot matrices against a
// VMEM-resident table; here it is a row copy with rounding. A grid-stride
// loop walks the [E, D] output in 16-byte float4 slots (4-byte slots when
// D is not a multiple of 4), so stores are contiguous and coalesced, and
// the threads of a warp read the same rank.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM of an H100

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

// V is float4 (width = D / 4 slots a row) or float (width = D).
template <typename V>
__global__ void __launch_bounds__(THREADS)
expand_kernel(const V* __restrict__ table, const int* __restrict__ ranks,
              V* __restrict__ out, int num_edges, int width) {
  const long long total = static_cast<long long>(num_edges) * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long e = i / width;
    const int c = static_cast<int>(i - e * width);
    out[i] = round_bf16(table[static_cast<long long>(ranks[e]) * width + c]);
  }
}

}  // namespace

extern "C" int expand_launch(const void* table, const void* ranks, void* out,
                             int num_edges, int dim, void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  const auto* rk = static_cast<const int*>(ranks);
  const auto s = static_cast<cudaStream_t>(stream);
  // float4 slots need 16-byte aligned rows: a width divisible by 4 and
  // aligned base pointers (a view into a larger tensor may not be).
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int width = vec4 ? dim / 4 : dim;
  const long long total = static_cast<long long>(num_edges) * width;
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  if (vec4) {
    expand_kernel<float4><<<blocks, THREADS, 0, s>>>(
        static_cast<const float4*>(table), rk, static_cast<float4*>(out),
        num_edges, width);
  } else {
    expand_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(table), rk, static_cast<float*>(out),
        num_edges, width);
  }
  return static_cast<int>(cudaGetLastError());
}
