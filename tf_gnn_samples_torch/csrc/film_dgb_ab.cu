// K16, backward half: two alternative designs of K2 (film_bwd_dgb.cu), for
// A/B timing against it (tf_gnn_samples_torch/tools/film_fwd_ab.py).
//
// Replaces the variant kernels of tools/film_fwd_ab.py: `_dgb_kernel_v3`
// (called by `_impl_dgb_v3`) and `_dgb_kernel_v4` (called by
// `_impl_dgb_v4`). Both compute K2's function, in receiver order:
//   z = gamma[r] * m_e + beta[r],  dz = act'(z) * g[r]
//   dgb[r, :D] = sum_{e: rank_e = r} bf16(m_e * dz),
//   dgb[r, D:] = sum_{e: rank_e = r} bf16(dz)
// with m a bf16 [E, D] stream, gamma|beta|g a bf16 [RPAD, 3D] table, ranks
// nondecreasing (gaps allowed, as K2 allows them), and dgb an f32 [RPAD, 2D] table zeroed by
// the caller. Terms are rounded where K2 rounds them and each row is
// summed in stream order, so a row inside one 64-edge chunk of K2 equals
// K2's bit for bit.
//
// Bound on the card: bytes, as K2 (a 2D-byte message row per edge, a
// 6D-byte table row per segment, the f32 [RPAD, 2D] output). Both walk
// 64 * G edges per block (G a template parameter: fewer table rereads
// and seam atomics, fewer blocks in flight), the Hopper form of the TPU
// variants' larger dot-blocks:
//
// * v3 (one accumulate dot over the concatenated [d_gamma | d_beta]): K2's
//   kernel (film_walk.cuh), where one thread keeps a column's d_gamma and
//   d_beta sums and stores both halves of the row in one pass.
// * v4 (two accumulate dots): the d_gamma half and the d_beta half are
//   summed by two separate thread groups of the block, each recomputing
//   dz from the same loads of m and of the table row (the second group's
//   loads hit L1): twice the threads in flight, twice the dz arithmetic.
#include "film_walk.cuh"

namespace {

// Launched with 2 * T threads: threads [0, T) sum the d_gamma half,
// threads [T, 2T) the d_beta half, each over columns d = t, t + T, ...
template <int ACT, int EDGES>
__global__ void __launch_bounds__(2 * film::MAX_THREADS)
dgb_v4_kernel(const __nv_bfloat16* __restrict__ msgs,
              const __nv_bfloat16* __restrict__ gbg,
              const int* __restrict__ ranks, float* __restrict__ dgb,
              int num_edges, int dim) {
  __shared__ int s_rank[EDGES];
  const int n = film::load_chunk_ranks<EDGES>(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * EDGES;
  const int first = s_rank[0];
  const int half = blockDim.x / 2;
  const bool beta_half = threadIdx.x >= half;
  const int out_col = beta_half ? dim : 0;
  for (int d = threadIdx.x - (beta_half ? half : 0); d < dim; d += half) {
    int cur = first;
    const __nv_bfloat16* row = gbg + static_cast<size_t>(cur) * 3 * dim;
    float gamma = film::ld(row + d), beta = film::ld(row + dim + d),
          g = film::ld(row + 2 * dim + d);
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(dgb + static_cast<size_t>(cur) * 2 * dim + out_col + d,
                    acc, cur == first);
        cur = r;
        acc = 0.0f;
        row = gbg + static_cast<size_t>(cur) * 3 * dim;
        gamma = film::ld(row + d);
        beta = film::ld(row + dim + d);
        g = film::ld(row + 2 * dim + d);
      }
      const float m = film::ld(msgs + (e0 + i) * dim + d);
      const float dz = film::dact<ACT>(gamma * m + beta) * g;
      acc += film::round_bf16(beta_half ? dz : m * dz);
    }
    atomicAdd(dgb + static_cast<size_t>(cur) * 2 * dim + out_col + d, acc);
  }
}

enum Variant { V3 = 0, V4 = 1 };

template <int ACT, int EDGES>
void launch_edges(const __nv_bfloat16* m, const __nv_bfloat16* t,
                  const int* rk, float* o, int num_edges, int dim,
                  int variant, cudaStream_t s) {
  const dim3 grid((num_edges + EDGES - 1) / EDGES);
  const dim3 block = film::block_for(dim);
  if (variant == V3) {
    film_bwd_dgb_kernel<ACT, EDGES><<<grid, block, 0, s>>>(
        m, t, rk, o, num_edges, dim);
  } else {
    dgb_v4_kernel<ACT, EDGES><<<grid, dim3(2 * block.x), 0, s>>>(
        m, t, rk, o, num_edges, dim);
  }
}

template <int ACT>
int launch(const __nv_bfloat16* m, const __nv_bfloat16* t, const int* rk,
           float* o, int num_edges, int dim, int variant, int group,
           cudaStream_t s) {
  if (variant != V3 && variant != V4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (group) {
    case 1: launch_edges<ACT, 64>(m, t, rk, o, num_edges, dim, variant, s); break;
    case 2: launch_edges<ACT, 128>(m, t, rk, o, num_edges, dim, variant, s); break;
    case 4: launch_edges<ACT, 256>(m, t, rk, o, num_edges, dim, variant, s); break;
    case 8: launch_edges<ACT, 512>(m, t, rk, o, num_edges, dim, variant, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 = v3, 1 = v4; group in 1, 2, 4, 8 (64 * group edges a block).
extern "C" int film_dgb_ab_launch(const void* msgs, const void* gbg,
                                  const void* ranks, void* dgb, int num_edges,
                                  int dim, int act, int variant, int group,
                                  void* stream) {
  if (num_edges <= 0) return 0;
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* t = static_cast<const __nv_bfloat16*>(gbg);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(dgb);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT_CALL(act, launch, m, t, rk, o, num_edges, dim, variant,
                         group, s)
}
