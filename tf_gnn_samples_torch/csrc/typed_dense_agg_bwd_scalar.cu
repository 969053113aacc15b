// K10b's earlier design: the typed dense aggregate's backward with its three
// typed products formed by scalar f32 multiply-adds and dW added by one
// atomicAdd per block, type and entry. typed_dense_agg_bwd.cu (the products
// on the tensor cores, dW flushed once per persistent block) replaced it on
// every model path; this body stays, unchanged, as the baseline that the
// redesign is held and timed against (tools/earlier_designs.py; launches
// counted under "typed_dense_agg_bwd_scalar", 0 on every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py
// `_typed_dense_agg_bwd_kernel` (called by `_typed_dense_agg_bwd_impl`, the
// VJP of `typed_dense_aggregate`). Per edge e of type t = type_e:
//   y_e   = x_e @ w[t]                                    (f32, recomputed)
//   dz_e  = bf16(act'(y_e) * g[rank_e])
//   dx_e  = bf16(dz_e @ w[t]^T)                           (f32 sums)
//   dw[t] += x_e^T dz_e                                   (f32)
// with x a bf16 [E, Dh] stream, w bf16 [L, Dh, D] and wt = w^T bf16
// [L, D, Dh] (the wrapper's transposed copy), g the bf16 [rows, D] table
// cotangent, int32 types and ranks [E]; dx bf16 [E, Dh] and dw f32
// [L, Dh, D], zeroed by the caller. An edge whose type is not in [0, L)
// gets dx = 0 and adds nothing to dw.
//
// Bound on the card: bytes at QM9's widths (two 2 Dh-byte rows and two ints
// per edge, a 2D-byte cotangent row per rank), but this first version
// computes the three products with scalar f32 multiplies and adds, so the
// f32 rate (6 E Dh D operations) is what it runs against. A block owns
// BLOCK_EDGES consecutive edges and stages their x rows and dz rows in
// shared memory (dynamic, above 48 KB at Dh = D = 128). dz runs per
// (edge, column) pair with the weight column read coalesced, dx per (edge,
// row) pair against wt, so those loads are coalesced too. The dw reduction
// crosses blocks: the block orders its edges by type (a rank count in
// shared memory), each thread owns (row, column) entries of dw, sums the
// exact products x * dz of one type's edges in f32 and adds each type's
// partial sum to dw with one atomicAdd. So dw sums its terms in another
// order on every run; the TPU kernel instead accumulates a VMEM-resident dw
// over the sequential grid. Built with -fmad=false.
#include "film_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_EDGES = 128;

template <int ACT>
__global__ void __launch_bounds__(THREADS)
typed_dense_agg_bwd_scalar_kernel(const __nv_bfloat16* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ w,
                                  const __nv_bfloat16* __restrict__ wt,
                                  const __nv_bfloat16* __restrict__ g,
                                  const int* __restrict__ types,
                                  const int* __restrict__ ranks,
                                  __nv_bfloat16* __restrict__ dx,
                                  float* __restrict__ dw, int num_edges,
                                  int dh, int dim, int n_types) {
  __shared__ int s_rank[BLOCK_EDGES];
  __shared__ int s_type[BLOCK_EDGES];
  __shared__ int s_order[BLOCK_EDGES];  // the block's edges, by type
  extern __shared__ unsigned short smem_raw[];
  auto* s_x = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [B][dh]
  __nv_bfloat16* s_dz = s_x + BLOCK_EDGES * dh;             // [B][dim]
  const size_t e0 = static_cast<size_t>(blockIdx.x) * BLOCK_EDGES;
  const int n = min(BLOCK_EDGES, static_cast<int>(num_edges - e0));
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = types[e0 + i];
    s_type[i] = (t >= 0 && t < n_types) ? t : -1;
    s_rank[i] = ranks[e0 + i];
  }
  for (int p = threadIdx.x; p < n * dh; p += blockDim.x) {
    s_x[p] = x[e0 * dh + p];
  }
  __syncthreads();

  // Stable order by type: edge i goes after every edge of a lower type and
  // every earlier edge of its own.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = s_type[i];
    int pos = 0;
    for (int j = 0; j < n; ++j) {
      const int u = s_type[j];
      pos += (u < t || (u == t && j < i)) ? 1 : 0;
    }
    s_order[pos] = i;
  }
  // dz of each (edge, column) pair.
  for (int p = threadIdx.x; p < n * dim; p += blockDim.x) {
    const int i = p / dim, c = p - i * dim;
    const int t = s_type[i];
    float dz = 0.0f;
    if (t >= 0) {
      const __nv_bfloat16* wc = w + static_cast<size_t>(t) * dh * dim + c;
      const __nv_bfloat16* xi = s_x + i * dh;
      float y = 0.0f;
      for (int k = 0; k < dh; ++k) {
        y += film::ld(xi + k) * film::ld(wc + static_cast<size_t>(k) * dim);
      }
      dz = film::dact<ACT>(y) *
           film::ld(g + static_cast<size_t>(s_rank[i]) * dim + c);
    }
    s_dz[p] = __float2bfloat16_rn(dz);
  }
  __syncthreads();

  // dx of each (edge, row) pair.
  for (int p = threadIdx.x; p < n * dh; p += blockDim.x) {
    const int i = p / dh, k = p - i * dh;
    const int t = s_type[i];
    float acc = 0.0f;
    if (t >= 0) {
      const __nv_bfloat16* wk = wt + static_cast<size_t>(t) * dim * dh + k;
      const __nv_bfloat16* dzi = s_dz + i * dim;
      for (int c = 0; c < dim; ++c) {
        acc += film::ld(dzi + c) * film::ld(wk + static_cast<size_t>(c) * dh);
      }
    }
    dx[(e0 + i) * dh + k] = __float2bfloat16_rn(acc);
  }

  // dw: per (row, column) entry, one f32 sum per type present in the block.
  for (int p = threadIdx.x; p < dh * dim; p += blockDim.x) {
    const int k = p / dim, c = p - k * dim;
    int cur = -1;
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) {
      const int i = s_order[j];
      const int t = s_type[i];
      if (t != cur) {
        if (cur >= 0) {
          atomicAdd(dw + (static_cast<size_t>(cur) * dh + k) * dim + c, acc);
        }
        cur = t;
        acc = 0.0f;
      }
      acc += film::ld(s_x + i * dh + k) * film::ld(s_dz + i * dim + c);
    }
    if (cur >= 0) {
      atomicAdd(dw + (static_cast<size_t>(cur) * dh + k) * dim + c, acc);
    }
  }
}

}  // namespace

// A block stages BLOCK_EDGES x rows and dz rows in (dynamic) shared memory:
// BLOCK_EDGES * (dh + dim) bf16 values, at most 227 KB.
extern "C" int typed_dense_agg_bwd_scalar_launch(
    const void* x, const void* w, const void* wt, const void* g,
    const void* types, const void* ranks, void* dx, void* dw, int num_edges,
    int dh, int dim, int n_types, int act, void* stream) {
  if (num_edges <= 0) return 0;
  const size_t smem = static_cast<size_t>(BLOCK_EDGES) * (dh + dim) * 2;
  if (dh <= 0 || dim <= 0 || n_types <= 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* wtp = static_cast<const __nv_bfloat16*>(wt);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* tp = static_cast<const int*>(types);
  const auto* rk = static_cast<const int*>(ranks);
  auto* dxp = static_cast<__nv_bfloat16*>(dx);
  auto* dwp = static_cast<float*>(dw);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((num_edges + BLOCK_EDGES - 1) / BLOCK_EDGES);
  FILM_DISPATCH_ACT_SMEM(act, typed_dense_agg_bwd_scalar_kernel, grid,
                         THREADS, smem, s, xp, wp, wtp, gp, tp, rk, dxp, dwp,
                         num_edges, dh, dim, n_types)
}
