// K15b's earlier design: a thread per column walking a 64-edge chunk with
// 2-byte loads, the chunk's first and last runs added by atomicAdd into a
// table the caller zeroed. masked_segsum.cu (K1's row walk of
// film_rows.cuh, every row written once, no atomics) replaced it; this
// body stays, unchanged, as the baseline that the redesign is held and
// timed against (tools/earlier_designs.py; launches counted under
// "masked_segsum_walk", 0 on every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_masked_segsum_kernel`
// (called by `_masked_segsum_impl`):
//   out[r, d] = sum_{e: rank_e = r} bf16(C[e, d] * factor(bit(e, d)))
// with C a bf16 [E, D] stream, bit(e, d) bit d mod 16 of the exact integer
// in lane d / 16 of the f32 [E, lanes] mask that K15a writes, factor(b) =
// leak + (1 - leak) * b (b itself for relu's leak 0; 0.2 or 1 for
// leaky_relu's 0.2), ranks nondecreasing and gap-free (the src-sorted
// stream) and out an f32 [rows, D] table, zeroed by the caller. The
// product is taken in f32, rounded to bf16 and summed in f32, as the TPU
// kernel does before and after its one-hot MXU dot.
//
// Bound on the card: bytes (a 2D-byte C row, the 4 * lanes-byte mask row
// and a 4-byte rank per edge, a 4D-byte store per used table row; a
// shift, a multiply and an add per element). The TPU kernel unpacks the
// mask with a replicate product and floor arithmetic; here each thread of
// the chunked sorted-rank walk (film_common.cuh) reads its column's lane,
// converts it to an integer and tests its bit.
#include "film_common.cuh"

namespace {

__global__ void __launch_bounds__(film::MAX_THREADS)
masked_segsum_walk_kernel(const float* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ c,
                     const int* __restrict__ ranks, float* __restrict__ out,
                     int num_edges, int dim, int lanes, float leak) {
  __shared__ int s_rank[film::CHUNK];
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  const int first = s_rank[0];
  const float rise = 1.0f - leak;
  for (int d = threadIdx.x; d < dim; d += blockDim.x) {
    const int lane = d / 16, shift = d % 16;
    int cur = first;
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(out + static_cast<size_t>(cur) * dim + d, acc, cur == first);
        cur = r;
        acc = 0.0f;
      }
      const int packed = static_cast<int>(mask[(e0 + i) * lanes + lane]);
      const float bit = static_cast<float>((packed >> shift) & 1);
      const float factor = leak + rise * bit;
      acc += film::round_bf16(film::ld(c + (e0 + i) * dim + d) * factor);
    }
    atomicAdd(out + static_cast<size_t>(cur) * dim + d, acc);
  }
}

}  // namespace

// lanes must be at least ceil(dim / 16) (the wrapper checks it).
extern "C" int masked_segsum_walk_launch(const void* mask, const void* c,
                                    const void* ranks, void* out,
                                    int num_edges, int dim, int lanes,
                                    float leak, void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  if (lanes < (dim + 15) / 16) return static_cast<int>(cudaErrorInvalidValue);
  masked_segsum_walk_kernel<<<film::grid_for(num_edges), film::block_for(dim), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mask), static_cast<const __nv_bfloat16*>(c),
      static_cast<const int*>(ranks), static_cast<float*>(out), num_edges, dim,
      lanes, leak);
  return static_cast<int>(cudaGetLastError());
}
