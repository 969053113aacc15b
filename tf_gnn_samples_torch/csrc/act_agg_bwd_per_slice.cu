// K12b's earlier design: one launch a stream slice (GNN-Edge-MLP1 made
// one a streamed edge type, 22 a layer on VarMisuse). Unchanged from
// before its redesign as one launch over every slice of a layer
// (act_agg_bwd.cu); no model path calls it: chip_smoke.py and the card
// tests hold the redesign to it bit for bit and time the two in turns
// (tools/earlier_designs.py act_agg_bwd_per_slice).
//
// Backward of the fused activate-aggregate (K12a).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_act_agg_bwd_kernel`
// (called by `_act_agg_bwd_impl`, the VJP of `act_ranked_aggregate`):
//   dmsg[e, d] = bf16(act'(float(m[e, d])) * float(g[rank_e, d]))
// with m a bf16 [E, D] stream, g the bf16 [rows, D] table cotangent, ranks
// int32 [E] below rows and dmsg a bf16 [E, D] stream. act' is recomputed in
// f32 from the bf16 message (no activation residual is kept), the product
// is taken in f32 and rounded once. No reduction, so no atomics.
//
// Bound on the card: bytes. Each edge reads a 2D-byte message row and a
// 4-byte rank and writes a 2D-byte row; each used cotangent row is read
// (from L2 after its first edge: the ranks are sorted). The TPU kernel
// expands the table with windowed one-hot MXU products against a
// VMEM-resident table; here it is K5b's row copy (expand.cu) times the
// recomputed derivative: a grid-stride loop walks the [E, D] output in
// slots of 8 columns (16 bytes of each bf16 operand), so loads and stores
// are contiguous and coalesced and the threads of a warp read the same
// rank; single columns when D is not a multiple of 8 or a pointer is not
// 16-byte aligned.
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
act_agg_bwd_vec_kernel(const Bf16x8* __restrict__ msgs,
                       const Bf16x8* __restrict__ g,
                       const int* __restrict__ ranks,
                       Bf16x8* __restrict__ dmsg, int num_edges, int width) {
  const long long total = static_cast<long long>(num_edges) * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long e = i / width;
    const int c = static_cast<int>(i - e * width);
    const Bf16x8 mv = msgs[i];
    const Bf16x8 gv = g[static_cast<long long>(ranks[e]) * width + c];
    Bf16x8 out;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out.v[j] = __float2bfloat16_rn(
          film::dact<ACT>(__bfloat162float(mv.v[j])) * __bfloat162float(gv.v[j]));
    }
    dmsg[i] = out;
  }
}

template <int ACT>
__global__ void __launch_bounds__(THREADS)
act_agg_bwd_kernel(const __nv_bfloat16* __restrict__ msgs,
                   const __nv_bfloat16* __restrict__ g,
                   const int* __restrict__ ranks,
                   __nv_bfloat16* __restrict__ dmsg, int num_edges, int dim) {
  const long long total = static_cast<long long>(num_edges) * dim;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long e = i / dim;
    const int c = static_cast<int>(i - e * dim);
    dmsg[i] = __float2bfloat16_rn(
        film::dact<ACT>(film::ld(msgs + i)) *
        film::ld(g + static_cast<long long>(ranks[e]) * dim + c));
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int act_agg_bwd_per_slice_launch(const void* msgs, const void* g,
                                            const void* ranks,
                                            void* dmsg, int num_edges,
                                            int dim, int act,
                                            void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  const auto* rk = static_cast<const int*>(ranks);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = dim % 8 == 0 && aligned16(msgs) && aligned16(g) && aligned16(dmsg);
  const int width = vec ? dim / 8 : dim;
  const long long total = static_cast<long long>(num_edges) * width;
  const long long want = (total + THREADS - 1) / THREADS;
  const dim3 grid(static_cast<unsigned>(want < MAX_BLOCKS ? want : MAX_BLOCKS));
  const dim3 block(THREADS);
  if (vec) {
    FILM_DISPATCH_ACT(act, act_agg_bwd_vec_kernel, grid, block, s,
                      static_cast<const Bf16x8*>(msgs),
                      static_cast<const Bf16x8*>(g), rk,
                      static_cast<Bf16x8*>(dmsg), num_edges, width)
  } else {
    FILM_DISPATCH_ACT(act, act_agg_bwd_kernel, grid, block, s,
                      static_cast<const __nv_bfloat16*>(msgs),
                      static_cast<const __nv_bfloat16*>(g), rk,
                      static_cast<__nv_bfloat16*>(dmsg), num_edges, dim)
  }
  return static_cast<int>(cudaGetLastError());
}
