// K14's earlier design: the source-order half of the GNN-Edge-MLP1 backward
// with both typed products formed by scalar f32 multiply-adds, each (edge,
// column) pair's da a 128-long dot product reading its weight column from
// L2, each column's dx a thread's serial walk over the chunk against wt.
// emlp1_src_bwd.cu (the products on the tensor cores) replaced it on the
// fused_src1 path; this body stays, unchanged, as the baseline that the
// redesign is held and timed against (tools/earlier_designs.py; launches
// counted under "emlp1_src_bwd_scalar", 0 on every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_emlp1_src_bwd_kernel`
// (called by `_emlp1_src_bwd_impl`, in the backward of `emlp1_tm_pass`).
// Over the SOURCE-sorted edge stream, with s = rank_e the src rank of edge
// e and l = col[s] its compact non-self type:
//   m = t[s],  beta | g = gcb[e]                     (bf16 rows)
//   x  = elu(m + beta)                               (f32)
//   y  = bf16(x) @ w[l]                              (f32 sums)
//   da = bf16(act'(y) * g)
//   dx = da @ w[l]^T                                 (f32 sums)
//   out[s, k] = sum_{e: rank_e = s} bf16(elu'(x)[k] * dx[k])
// with elu' taken from the output x (1 where x > 0, else x + 1). t is a
// bf16 [R, D] table, col an int32 [R] column (-1: a self-loop type or a
// slack row), gcb a bf16 [E, 2D] stream, w bf16 [L_eff, D, D] and wt = w^T
// (the wrapper's transposed copy), and out an f32 [R, D] table, zeroed by
// the caller. Edges at or past *e_real (the padded tail of the src-sorted
// stream, whose type decode is garbage) and edges of no non-self type add
// nothing.
//
// Bound on the card: bytes at QM9's widths (a 4D-byte stream row per edge,
// a 2D-byte t row and a 4D-byte output row per source group), but this
// first version computes the two products with scalar f32 multiplies and
// adds, so the f32 rate (4 E D^2 operations) is what it runs against. The
// TPU kernel runs the products of every non-self type, masked by a type
// one-hot, on the MXU; the mask multiplies by exactly 0 or 1, so each
// edge's own type alone is the same math up to the order of the sums. A
// block owns CHUNK consecutive edges in three phases: bf16(x) of each
// (edge, column) pair into shared memory, then da of each pair (the weight
// column read coalesced across the warp), then a thread per column that
// computes dx against wt (again coalesced), recomputes x and sums the
// rounded terms by the sorted-rank segment walk of film_common.cuh.
// Built with -fmad=false.
#include "film_common.cuh"

namespace {

constexpr int THREADS = 128;

template <int ACT>
__global__ void __launch_bounds__(THREADS)
emlp1_src_bwd_scalar_kernel(const __nv_bfloat16* __restrict__ gcb,
                     const __nv_bfloat16* __restrict__ t,
                     const int* __restrict__ col,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ wt,
                     const int* __restrict__ e_real,
                     const int* __restrict__ ranks, float* __restrict__ out,
                     int num_edges, int dim, int l_eff) {
  __shared__ int s_rank[film::CHUNK];
  __shared__ int s_col[film::CHUNK];
  extern __shared__ unsigned short smem_raw[];
  auto* s_x = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [CHUNK][dim]
  __nv_bfloat16* s_da = s_x + film::CHUNK * dim;             // [CHUNK][dim]
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  const int live = *e_real;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = col[s_rank[i]];
    s_col[i] = (static_cast<long>(e0) + i < live && l >= 0 && l < l_eff) ? l : -1;
  }
  // bf16(x) of each (edge, column) pair.
  for (int p = threadIdx.x; p < n * dim; p += blockDim.x) {
    const int i = p / dim, k = p - i * dim;
    const float m = film::ld(t + static_cast<size_t>(s_rank[i]) * dim + k);
    const float beta = film::ld(gcb + (e0 + i) * 2 * dim + k);
    s_x[p] = __float2bfloat16_rn(film::act<film::ELU>(m + beta));
  }
  __syncthreads();

  // da of each (edge, column) pair.
  for (int p = threadIdx.x; p < n * dim; p += blockDim.x) {
    const int i = p / dim, c = p - i * dim;
    const int l = s_col[i];
    float da = 0.0f;
    if (l >= 0) {
      const __nv_bfloat16* wc = w + static_cast<size_t>(l) * dim * dim + c;
      const __nv_bfloat16* xi = s_x + i * dim;
      float y = 0.0f;
      for (int k = 0; k < dim; ++k) {
        y += film::ld(xi + k) * film::ld(wc + static_cast<size_t>(k) * dim);
      }
      da = film::dact<ACT>(y) * film::ld(gcb + (e0 + i) * 2 * dim + dim + c);
    }
    s_da[p] = __float2bfloat16_rn(da);
  }
  __syncthreads();

  // dx, elu'(x) and the per-rank sums, a thread per column.
  const int first = s_rank[0];
  for (int k = threadIdx.x; k < dim; k += blockDim.x) {
    int cur = first;
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(out + static_cast<size_t>(cur) * dim + k, acc, cur == first);
        cur = r;
        acc = 0.0f;
      }
      const int l = s_col[i];
      if (l < 0) continue;
      const __nv_bfloat16* wk = wt + static_cast<size_t>(l) * dim * dim + k;
      const __nv_bfloat16* dai = s_da + i * dim;
      float dx = 0.0f;
      for (int c = 0; c < dim; ++c) {
        dx += film::ld(dai + c) * film::ld(wk + static_cast<size_t>(c) * dim);
      }
      const float m = film::ld(t + static_cast<size_t>(r) * dim + k);
      const float beta = film::ld(gcb + (e0 + i) * 2 * dim + k);
      const float x = film::act<film::ELU>(m + beta);
      const float dm = (x > 0.0f ? 1.0f : x + 1.0f) * dx;
      acc += film::round_bf16(dm);
    }
    atomicAdd(out + static_cast<size_t>(cur) * dim + k, acc);
  }
}

}  // namespace

// A block stages CHUNK rows of bf16(x) and of da in (dynamic) shared memory:
// 2 * CHUNK * dim bf16 values, at most 227 KB.
extern "C" int emlp1_src_bwd_scalar_launch(const void* gcb, const void* t,
                                    const void* col, const void* w,
                                    const void* wt, const void* e_real,
                                    const void* ranks, void* out,
                                    int num_edges, int dim, int l_eff,
                                    int act, void* stream) {
  if (num_edges <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(film::CHUNK) * dim * 2;
  if (dim <= 0 || l_eff <= 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* gp = static_cast<const __nv_bfloat16*>(gcb);
  const auto* tp = static_cast<const __nv_bfloat16*>(t);
  const auto* cp = static_cast<const int*>(col);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* wtp = static_cast<const __nv_bfloat16*>(wt);
  const auto* ep = static_cast<const int*>(e_real);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT_SMEM(act, emlp1_src_bwd_scalar_kernel, film::grid_for(num_edges),
                         THREADS, smem, s, gp, tp, cp, wp, wtp, ep, rk, o,
                         num_edges, dim, l_eff)
}
