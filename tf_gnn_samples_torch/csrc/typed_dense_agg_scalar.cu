// K10a's earlier design: the typed dense aggregate's forward with its typed
// products formed by scalar f32 multiply-adds, each (edge, column) pair a
// 128-long dot product reading its weight column from L2. typed_dense_agg.cu
// (the products on the tensor cores) replaced it on every model path; this
// body stays, unchanged, as the baseline that the redesign is held and timed
// against (tools/earlier_designs.py; launches counted under
// "typed_dense_agg_scalar", 0 on every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py
// `_typed_dense_agg_kernel`
// (called by `_typed_dense_agg_impl`, the forward of
// `typed_dense_aggregate`, GNN-Edge-MLP1's `fused1` branch):
//   y_e        = x_e @ w[type_e]                          (f32 sums)
//   out[r, c]  = sum_{e: rank_e = r} bf16(act(y_e[c]))
// with x a bf16 [E, Dh] stream, w bf16 [L, Dh, D], int32 types and
// nondecreasing gap-free int32 ranks [E], and out an f32 [rows, D] table,
// zeroed by the caller. An edge whose type is not in [0, L) adds nothing.
//
// Bound on the card: bytes at QM9's widths (a 2 Dh-byte row and two ints per
// edge, a 4D-byte table row per rank), but this first version computes the
// products with scalar f32 multiplies and adds, so the f32 rate (2 E Dh D
// operations) is what it runs against. The TPU kernel runs the L type-masked
// products of every 256-edge sub-block on the MXU; the mask multiplies by
// exactly 0 or 1, so computing each edge's own type only is the same math up
// to the order of the sums. A block owns CHUNK consecutive edges: their x
// rows are staged in shared memory, every (edge, column) pair's product runs
// over Dh with the weight column read from L2 (coalesced across the warp's
// columns), and the rounded terms are then summed by the sorted-rank segment
// walk of film_common.cuh (interior segments stored, the chunk's first and
// last segments added atomically). Built with -fmad=false.
#include "film_common.cuh"

namespace {

constexpr int THREADS = 128;

template <int ACT>
__global__ void __launch_bounds__(THREADS)
typed_dense_agg_scalar_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ w,
                              const int* __restrict__ types,
                              const int* __restrict__ ranks,
                              float* __restrict__ out, int num_edges, int dh,
                              int dim, int n_types) {
  __shared__ int s_rank[film::CHUNK];
  __shared__ int s_type[film::CHUNK];
  extern __shared__ unsigned short smem_raw[];
  auto* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_x = smem;                        // [CHUNK][dh]
  __nv_bfloat16* s_term = smem + film::CHUNK * dh;  // [CHUNK][dim]
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = types[e0 + i];
    s_type[i] = (t >= 0 && t < n_types) ? t : -1;
  }
  for (int p = threadIdx.x; p < n * dh; p += blockDim.x) {
    s_x[p] = x[e0 * dh + p];
  }
  __syncthreads();

  // Each (edge, column) pair's rounded term.
  for (int p = threadIdx.x; p < n * dim; p += blockDim.x) {
    const int i = p / dim, c = p - i * dim;
    const int t = s_type[i];
    float term = 0.0f;
    if (t >= 0) {
      const __nv_bfloat16* wc = w + static_cast<size_t>(t) * dh * dim + c;
      const __nv_bfloat16* xi = s_x + i * dh;
      float y = 0.0f;
      for (int k = 0; k < dh; ++k) {
        y += film::ld(xi + k) * film::ld(wc + static_cast<size_t>(k) * dim);
      }
      term = film::act<ACT>(y);
    }
    s_term[p] = __float2bfloat16_rn(term);
  }
  __syncthreads();

  // Per-rank f32 sums, a thread per column.
  const int first = s_rank[0];
  for (int c = threadIdx.x; c < dim; c += blockDim.x) {
    int cur = first;
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(out + static_cast<size_t>(cur) * dim + c, acc, cur == first);
        cur = r;
        acc = 0.0f;
      }
      acc += film::ld(s_term + i * dim + c);
    }
    atomicAdd(out + static_cast<size_t>(cur) * dim + c, acc);
  }
}

}  // namespace

// A block stages CHUNK x rows and CHUNK term rows in (dynamic) shared
// memory: CHUNK * (dh + dim) bf16 values, at most 227 KB.
extern "C" int typed_dense_agg_scalar_launch(const void* x, const void* w,
                                             const void* types,
                                             const void* ranks, void* out,
                                             int num_edges, int dh, int dim,
                                             int n_types, int act,
                                             void* stream) {
  if (num_edges <= 0) return 0;
  const size_t smem = static_cast<size_t>(film::CHUNK) * (dh + dim) * 2;
  if (dh <= 0 || dim <= 0 || n_types <= 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* tp = static_cast<const int*>(types);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT_SMEM(act, typed_dense_agg_scalar_kernel,
                         film::grid_for(num_edges), THREADS, smem, s, xp, wp,
                         tp, rk, o, num_edges, dh, dim, n_types)
}
