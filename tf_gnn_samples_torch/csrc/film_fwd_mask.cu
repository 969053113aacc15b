// K15a: fused GNN-FiLM forward (K1) that also writes the packed sign mask
// of every edge.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py
// `_film_fwd_mask_kernel` (called by `_film_fwd_mask_impl`):
//   out[r, d]  = sum_{e: rank_e = r} bf16(act(z[e, d])),
//   z[e, d]    = gamma[r, d] * m[e, d] + beta[r, d]   (r = rank_e)
//   mask[e, g] = sum_{d in group g, z[e, d] > 0} 2^(d mod 16)
// with m a bf16 [E, D] stream, gamma|beta a bf16 [RPAD, 2D] table, out an
// f32 [RPAD, D] table zeroed by the caller and mask f32 [E, lanes]: lane g
// < ceil(D / 16) holds the exact integer of group g's 16 sign bits (the
// JAX package's packed layout, _mask_pack_matrix), lanes past it hold 0.
// z is formed and the table summed exactly as film_fwd.cu does (same
// expression, same block shape, same walk), so both tables agree bit for
// bit.
//
// Bound on the card: bytes, K1's traffic plus the [E, lanes] f32 mask
// store. The TPU kernel packs with a [D, lanes] MXU product of the 0/1
// mask; here each warp spans 32 consecutive columns (blocks are whole
// warps and column passes start on multiples of 32), so one warp vote
// (`__ballot_sync`) gives two lanes' 16 bits for an edge. The block
// collects its CHUNK edges' lanes in shared memory, zero lanes included,
// and stores them as contiguous rows.
#include "film_common.cuh"

namespace {

template <int ACT>
__global__ void __launch_bounds__(film::MAX_THREADS)
film_fwd_mask_kernel(const __nv_bfloat16* __restrict__ msgs,
                     const __nv_bfloat16* __restrict__ gb,
                     const int* __restrict__ ranks, float* __restrict__ out,
                     float* __restrict__ mask, int num_edges, int dim,
                     int lanes) {
  extern __shared__ unsigned s_mask[];  // [CHUNK][lanes]
  __shared__ int s_rank[film::CHUNK];
  for (int idx = threadIdx.x; idx < film::CHUNK * lanes; idx += blockDim.x) {
    s_mask[idx] = 0u;
  }
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);  // syncs
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  const int first = s_rank[0];
  const int groups = (dim + 15) / 16;
  const int lane = threadIdx.x % 32;
  // Every thread of a warp runs the same passes (dim rounded up to a
  // multiple of 32), so all 32 take part in each vote; a column past dim
  // votes 0 and loads and stores nothing.
  const int dim32 = (dim + 31) / 32 * 32;
  for (int d = threadIdx.x; d < dim32; d += blockDim.x) {
    const bool live = d < dim;
    const int g0 = (d - lane) / 16;  // the warp's first group
    int cur = first;
    const __nv_bfloat16* row = gb + static_cast<size_t>(cur) * 2 * dim;
    float gamma = live ? film::ld(row + d) : 0.0f;
    float beta = live ? film::ld(row + dim + d) : 0.0f;
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        if (live) {
          film::flush(out + static_cast<size_t>(cur) * dim + d, acc,
                      cur == first);
        }
        cur = r;
        acc = 0.0f;
        row = gb + static_cast<size_t>(cur) * 2 * dim;
        gamma = live ? film::ld(row + d) : 0.0f;
        beta = live ? film::ld(row + dim + d) : 0.0f;
      }
      float z = 0.0f;
      if (live) {
        const float m = film::ld(msgs + (e0 + i) * dim + d);
        z = gamma * m + beta;
        acc += film::round_bf16(film::act<ACT>(z));
      }
      const unsigned bits = __ballot_sync(0xffffffffu, live && z > 0.0f);
      if (lane == 0 && g0 < groups) s_mask[i * lanes + g0] = bits & 0xffffu;
      if (lane == 16 && g0 + 1 < groups) s_mask[i * lanes + g0 + 1] = bits >> 16;
    }
    if (live) atomicAdd(out + static_cast<size_t>(cur) * dim + d, acc);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * lanes; idx += blockDim.x) {
    mask[e0 * lanes + idx] = static_cast<float>(s_mask[idx]);
  }
}

}  // namespace

// lanes must be at least ceil(dim / 16); CHUNK * lanes words of shared
// memory (8 KB at the 32 lanes of D <= 512) are requested dynamically.
extern "C" int film_fwd_mask_launch(const void* msgs, const void* gb,
                                    const void* ranks, void* out, void* mask,
                                    int num_edges, int dim, int lanes, int act,
                                    void* stream) {
  if (num_edges <= 0) return 0;
  if (dim <= 0 || lanes < (dim + 15) / 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* m = static_cast<const __nv_bfloat16*>(msgs);
  const auto* t = static_cast<const __nv_bfloat16*>(gb);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  auto* mk = static_cast<float*>(mask);
  const dim3 grid = film::grid_for(num_edges), block = film::block_for(dim);
  const size_t smem = static_cast<size_t>(film::CHUNK) * lanes * sizeof(unsigned);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT_SMEM(act, film_fwd_mask_kernel, grid, block, smem, s, m, t,
                         rk, o, mk, num_edges, dim, lanes)
}
