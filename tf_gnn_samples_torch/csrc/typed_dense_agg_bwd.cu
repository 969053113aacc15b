// K10b: typed dense aggregate, backward, with its typed products on the
// tensor cores.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py
// `_typed_dense_agg_bwd_kernel` (called by `_typed_dense_agg_bwd_impl`, the
// VJP of `typed_dense_aggregate`). Per edge e of type t = type_e:
//   y_e   = x_e @ w[t]                                    (f32, recomputed)
//   dz_e  = bf16(act'(y_e) * g[rank_e])
//   dx_e  = bf16(dz_e @ w[t]^T)                           (f32 sums)
//   dw[t] += x_e^T dz_e                                   (f32)
// with x a bf16 [E, Dh] stream, w bf16 [L, Dh, D] (L <= 8), g the bf16
// [rows, D] table cotangent, int32 types and ranks [E]; dx bf16 [E, Dh] and
// dw f32 [L, Dh, D], dw zeroed by the caller. An edge whose type is not in
// [0, L) gets dx = 0 and adds nothing to dw.
//
// Bound on the card: bytes (two 2 Dh-byte rows and two ints per edge, a
// 2D-byte cotangent row per rank: 0.029 ms at QM9's widths) over the three
// products (6 E Dh D bf16 operations, 0.016 ms at the tensor cores' rate);
// act' (gelu: some 50 instructions an element) costs about as much again.
// The TPU kernel builds L type-masked products per 256-edge sub-block and
// keeps dw in VMEM over its sequential grid. Here nothing needs the edges
// in rank order: a block (one an SM, 12 warps) owns a contiguous range of
// the stream and first orders it by type in shared memory (a stable
// counting sort by warp ballots, each edge's rank beside it). It then runs
// the range type by type in batches of BM = 48 edges: each batch's x rows
// and cotangent rows g[rank] are copied in (cp.async) while the batch
// before it runs, and so is the next type's W; the three products run on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators): y = x W
// then dz = bf16(act'(y) g) to shared memory, dx = dz W^T (W's own rows
// read by plain ldmatrix, so no transposed copy) and dW += x^T dz (x read
// by ldmatrix.trans), dW's 16 x 8 tiles held in registers over the range
// (11 a warp). So each block adds its range's dW of a type once, with
// float2 atomicAdds (at QM9's batch 132 blocks x 5 types x 8,192 float2
// atomics, 5.4 million, against 103 million scalar ones of the earlier
// body). Wider weights than 12 warps' tiles hold (Dh_p x D_p > 16,896)
// take the dW tiles in panels, recomputing y and dz for each. Widths not
// multiples of 16 are zero-padded in shared memory; rows of Dh or D not
// multiples of 8 (or unaligned) take 2-byte loads.
#include "film_common.cuh"
#include "typed_mma.cuh"

namespace {

constexpr int THREADS = 384;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 48;               // edges a batch
constexpr int M_TILES = BM / 16;
constexpr int TILES_PER_WARP = 11;   // dW accumulator tiles a warp holds
constexpr int PANEL = WARPS * TILES_PER_WARP;
constexpr int MAX_EPB = 2048;        // edges a block orders by type
// Dynamic shared memory a block may take beside its static arrays.
constexpr size_t SMEM_MAX = 232448 - 2048;

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const __nv_bfloat16* g;
  const int* types;
  const int* ranks;
  __nv_bfloat16* dx;
  float* dw;
  int num_edges, dh, dim, n_types;
  int dh_p, d_p;  // Dh and D padded to multiples of 16
  int edges_per_block;
};

// Two [Dh_p][D_p + 8] weight buffers, two batches' [BM][Dh_p + 8] x rows
// and [BM][D_p + 8] cotangent rows, [BM][D_p + 8] dz rows (bf16), and the
// block's edges and ranks in type order (int).
size_t smem_bytes(int dh_p, int d_p, int epb) {
  return 2 * (2 * static_cast<size_t>(dh_p) * (d_p + 8) +
              2 * static_cast<size_t>(BM) * (dh_p + 8) +
              3 * static_cast<size_t>(BM) * (d_p + 8)) +
         8 * static_cast<size_t>(epb);
}

// The next dW tile of a warp's run, row-major over (m-tile, n-tile).
__device__ __forceinline__ void next_tile(int& mt, int& nt, int ntn) {
  if (++nt == ntn) {
    nt = 0;
    ++mt;
  }
}

// y = x W for one (16 rows, NJ x 8 columns) item, then dz = bf16(act'(y)
// g) into s_z (0 for rows past cnt and columns past D).
template <int ACT, int NJ>
__device__ __forceinline__ void dz_item(const __nv_bfloat16* s_x, int ldx,
                                        const __nv_bfloat16* s_w,
                                        const __nv_bfloat16* s_g,
                                        __nv_bfloat16* s_z, int ldw,
                                        int k_steps, int dim, int mt, int col,
                                        int cnt) {
  const int lane = threadIdx.x & 31;
  float acc[NJ][4];
  tmma::zero(acc);
  tmma::tile_kn(acc, s_x + (mt * 16 + (lane & 15)) * ldx, s_w + col, ldw,
                k_steps);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col + j * 8 + 2 * (lane & 3);
      float z0 = 0.0f, z1 = 0.0f;
      if (r < cnt && c < dim) {
        z0 = film::dact<ACT>(acc[j][2 * h]) * film::ld(s_g + r * ldw + c);
      }
      if (r < cnt && c + 1 < dim) {
        z1 = film::dact<ACT>(acc[j][2 * h + 1]) *
             film::ld(s_g + r * ldw + c + 1);
      }
      *reinterpret_cast<uint32_t*>(s_z + r * ldw + c) =
          tmma::pack_bf16(z0, z1);
    }
  }
}

// dx = bf16(dz W^T) for one (16 rows, NJ x 8 columns of Dh) item, stored
// to the batch's edges' rows.
template <int NJ>
__device__ __forceinline__ void dx_item(const __nv_bfloat16* s_z,
                                        const __nv_bfloat16* s_w, int ldw,
                                        int k_steps, __nv_bfloat16* dx,
                                        int dh, const int* idx, int mt,
                                        int row, int cnt) {
  const int lane = threadIdx.x & 31;
  float acc[NJ][4];
  tmma::zero(acc);
  tmma::tile_nk(acc, s_z + (mt * 16 + (lane & 15)) * ldw, s_w + row * ldw,
                ldw, k_steps);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * 16 + (lane >> 2) + 8 * h;
    if (r >= cnt) continue;
    __nv_bfloat16* dst = dx + static_cast<size_t>(idx[r]) * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = row + j * 8 + 2 * (lane & 3);
      if (k + 1 < dh && dh % 2 == 0) {
        *reinterpret_cast<uint32_t*>(dst + k) =
            tmma::pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        if (k < dh) dst[k] = __float2bfloat16_rn(acc[j][2 * h]);
        if (k + 1 < dh) dst[k + 1] = __float2bfloat16_rn(acc[j][2 * h + 1]);
      }
    }
  }
}

// Type t's weights into s_w, zero-padded to [Dh_p][D_p]; the 16-byte
// pieces copied without waiting.
template <bool VEC>
__device__ __forceinline__ void stage_w(__nv_bfloat16* s_w, int ldw,
                                        const __nv_bfloat16* w, int t, int dh,
                                        int dim, int dh_p, int d_p) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const __nv_bfloat16* wt = w + static_cast<size_t>(t) * dh * dim;
  const int n8 = d_p / 8;
  for (int i = threadIdx.x; i < dh_p * n8; i += THREADS) {
    const int k = i / n8, c = (i % n8) * 8;
    __nv_bfloat16* dst = s_w + k * ldw + c;
    if (VEC && k < dh && c + 8 <= dim) {
      tmma::cp_async16(dst, wt + static_cast<size_t>(k) * dim + c);
    } else {
      for (int j = 0; j < 8; ++j) {
        dst[j] = (k < dh && c + j < dim)
                     ? wt[static_cast<size_t>(k) * dim + c + j] : zero;
      }
    }
  }
}

// A batch's x rows (zero rows past cnt) and cotangent rows g[rank] into
// shared memory; the 16-byte pieces copied without waiting.
template <bool VEC>
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* s_x, int ldx, __nv_bfloat16* s_g, int ldw,
    const __nv_bfloat16* x, const __nv_bfloat16* g, const int* idx,
    const int* rk, int cnt, int dh, int dim) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (VEC) {
    const int segx = dh / 8, segg = dim / 8;
    for (int s = threadIdx.x; s < BM * segx; s += THREADS) {
      const int r = s / segx, q = s - r * segx;
      __nv_bfloat16* dst = s_x + r * ldx + q * 8;
      if (r < cnt) {
        tmma::cp_async16(dst, x + static_cast<size_t>(idx[r]) * dh + q * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    for (int s = threadIdx.x; s < cnt * segg; s += THREADS) {
      const int r = s / segg, q = s - r * segg;
      tmma::cp_async16(s_g + r * ldw + q * 8,
                       g + static_cast<size_t>(rk[r]) * dim + q * 8);
    }
  } else {
    for (int i = threadIdx.x; i < BM * dh; i += THREADS) {
      const int r = i / dh, k = i - r * dh;
      s_x[r * ldx + k] = r < cnt ? x[static_cast<size_t>(idx[r]) * dh + k]
                                 : zero;
    }
    for (int i = threadIdx.x; i < cnt * dim; i += THREADS) {
      const int r = i / dim, c = i - r * dim;
      s_g[r * ldw + c] = g[static_cast<size_t>(rk[r]) * dim + c];
    }
  }
}

// Batch j of the block's run (panels, then types, then BM-edge batches of
// the type's edges in s_off order): its panel, type, first list position
// and edge count.
struct Batch {
  int panel, t, start, cnt;
};

__device__ __forceinline__ Batch batch_at(int j, const int* s_off,
                                          int n_types, int per_panel) {
  Batch b;
  b.panel = j / per_panel;
  int r = j - b.panel * per_panel;
  b.t = 0;
  for (int t = 0; t < n_types; ++t) {
    const int n = s_off[t + 1] - s_off[t];
    const int nb = (n + BM - 1) / BM;
    if (r < nb) {
      b.t = t;
      b.start = s_off[t] + r * BM;
      b.cnt = min(BM, s_off[t + 1] - b.start);
      break;
    }
    r -= nb;
  }
  return b;
}

template <int ACT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
typed_dense_agg_bwd_kernel(const Args p) {
  __shared__ int s_count[WARPS][tmma::MAX_TYPES];
  __shared__ int s_off[tmma::MAX_TYPES + 1];
  __shared__ int s_run[tmma::MAX_TYPES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = p.dh_p + 8, ldw = p.d_p + 8;
  auto* s_wb = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][Dh_p][ldw]
  __nv_bfloat16* s_xb = s_wb + 2 * p.dh_p * ldw;            // [2][BM][ldx]
  __nv_bfloat16* s_gb = s_xb + 2 * BM * ldx;                // [2][BM][ldw]
  __nv_bfloat16* s_z = s_gb + 2 * BM * ldw;                 // [BM][ldw]
  int* s_list = reinterpret_cast<int*>(s_z + BM * ldw);     // [epb]
  int* s_lrank = s_list + p.edges_per_block;                // [epb]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long lo = static_cast<long long>(blockIdx.x) * p.edges_per_block;
  const long long hi = min(static_cast<long long>(p.num_edges),
                           lo + p.edges_per_block);
  if (lo >= hi) return;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const unsigned below = (1u << lane) - 1u;

  // 1. The block's edges ordered by type, stably (counts, then positions),
  // with their ranks; an edge of no type gets dx = 0 here.
  for (int i = tid; i < 2 * BM * ldx / 8; i += THREADS) {
    reinterpret_cast<uint4*>(s_xb)[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid < tmma::MAX_TYPES) s_run[tid] = 0;
  __syncthreads();
  for (long long base = lo; base < hi; base += THREADS) {
    const long long e = base + tid;
    int t = e < hi ? p.types[e] : -1;
    if (t >= p.n_types || t < 0) {
      if (e < hi) {
        for (int k = 0; k < p.dh; ++k) p.dx[e * p.dh + k] = zero;
      }
      t = -1;
    }
    for (int u = 0; u < p.n_types; ++u) {
      const unsigned bal = __ballot_sync(0xffffffffu, t == u);
      if (lane == 0 && bal) atomicAdd(&s_run[u], __popc(bal));
    }
  }
  __syncthreads();
  if (tid == 0) {
    s_off[0] = 0;
    for (int u = 0; u < p.n_types; ++u) {
      s_off[u + 1] = s_off[u] + s_run[u];
      s_run[u] = s_off[u];
    }
  }
  __syncthreads();
  for (long long base = lo; base < hi; base += THREADS) {
    const long long e = base + tid;
    int t = e < hi ? p.types[e] : -1;
    if (t >= p.n_types) t = -1;
    unsigned mine = 0;
    for (int u = 0; u < p.n_types; ++u) {
      const unsigned bal = __ballot_sync(0xffffffffu, t == u);
      if (lane == 0) s_count[warp][u] = __popc(bal);
      if (t == u) mine = bal;
    }
    __syncthreads();
    if (t >= 0) {
      int pos = s_run[t] + __popc(mine & below);
      for (int v = 0; v < warp; ++v) pos += s_count[v][t];
      s_list[pos] = static_cast<int>(e);
      s_lrank[pos] = p.ranks[e];
    }
    __syncthreads();
    if (tid < p.n_types) {
      int add = 0;
      for (int v = 0; v < WARPS; ++v) add += s_count[v][tid];
      s_run[tid] += add;
    }
    __syncthreads();
  }

  // 2. The batches: per panel of dW tiles, per type, BM edges at a time;
  // the next batch's rows (and the next type's weights) are copied in
  // while this one runs.
  const int ntn = p.d_p / 8;                     // dW n-tiles
  const int n_tiles = (p.dh_p / 16) * ntn;       // dW tiles of 16 x 8
  const int n_panels = (n_tiles + PANEL - 1) / PANEL;
  int per_panel = 0;
  for (int u = 0; u < p.n_types; ++u) {
    per_panel += (s_off[u + 1] - s_off[u] + BM - 1) / BM;
  }
  const int n_batches = n_panels * per_panel;
  if (n_batches == 0) return;

  Batch b = batch_at(0, s_off, p.n_types, per_panel);
  int wbuf = 0;
  stage_w<VEC>(s_wb, ldw, p.w, b.t, p.dh, p.dim, p.dh_p, p.d_p);
  stage_rows<VEC>(s_xb, ldx, s_gb, ldw, p.x, p.g, s_list + b.start,
                  s_lrank + b.start, b.cnt, p.dh, p.dim);
  float dw[TILES_PER_WARP][4];
  tmma::zero(dw);
  for (int j = 0; j < n_batches; ++j) {
    const int buf = j & 1;
    const __nv_bfloat16* s_w = s_wb + wbuf * p.dh_p * ldw;
    const __nv_bfloat16* s_x = s_xb + buf * BM * ldx;
    const __nv_bfloat16* s_g = s_gb + buf * BM * ldw;
    const int* idx = s_list + b.start;
    tmma::cp_async_wait_all();
    __syncthreads();  // batch j's rows and weights are in; j - 1 is done
    Batch nb = b;
    bool seg_end = true;
    if (j + 1 < n_batches) {
      nb = batch_at(j + 1, s_off, p.n_types, per_panel);
      seg_end = nb.t != b.t || nb.panel != b.panel;
      if (seg_end) {
        stage_w<VEC>(s_wb + (wbuf ^ 1) * p.dh_p * ldw, ldw, p.w, nb.t, p.dh,
                     p.dim, p.dh_p, p.d_p);
      }
      stage_rows<VEC>(s_xb + (buf ^ 1) * BM * ldx, ldx,
                      s_gb + (buf ^ 1) * BM * ldw, ldw, p.x, p.g,
                      s_list + nb.start, s_lrank + nb.start, nb.cnt, p.dh,
                      p.dim);
    }

    // y = x W, then dz, in items of (16 rows, 32 columns).
    const int gz = (p.d_p + 31) / 32;
    for (int it = warp; it < M_TILES * gz; it += WARPS) {
      const int mt = it % M_TILES, col = (it / M_TILES) * 32;
      if (col + 32 <= p.d_p) {
        dz_item<ACT, 4>(s_x, ldx, s_w, s_g, s_z, ldw, p.dh_p / 16, p.dim, mt,
                        col, b.cnt);
      } else {
        dz_item<ACT, 2>(s_x, ldx, s_w, s_g, s_z, ldw, p.dh_p / 16, p.dim, mt,
                        col, b.cnt);
      }
    }
    __syncthreads();

    // dx = bf16(dz W^T), once (the first panel).
    if (b.panel == 0) {
      const int gx = (p.dh_p + 31) / 32;
      for (int it = warp; it < M_TILES * gx; it += WARPS) {
        const int mt = it % M_TILES, row = (it / M_TILES) * 32;
        if (row + 32 <= p.dh_p) {
          dx_item<4>(s_z, s_w, ldw, p.d_p / 16, p.dx, p.dh, idx, mt, row,
                     b.cnt);
        } else {
          dx_item<2>(s_z, s_w, ldw, p.d_p / 16, p.dx, p.dh, idx, mt, row,
                     b.cnt);
        }
      }
    }

    // The warp's dW tiles += x^T dz over the batch's BM edges.
    const int tile0 = b.panel * PANEL + warp * TILES_PER_WARP;
    const int mt0 = tile0 / ntn, nt0 = tile0 % ntn;
#pragma unroll
    for (int ks = 0; ks < M_TILES; ++ks) {
      uint32_t a[4];
      int mt = mt0, nt = nt0, a_mt = -1;
#pragma unroll
      for (int i = 0; i < TILES_PER_WARP; ++i) {
        if (tile0 + i < n_tiles) {
          if (mt != a_mt) {
            tmma::load_at(a, s_x + ks * 16 * ldx + mt * 16, ldx);
            a_mt = mt;
          }
          uint32_t bf[2];
          tmma::load_b_kn(bf, s_z + ks * 16 * ldw + nt * 8, ldw);
          tmma::mma(dw[i], a, bf[0], bf[1]);
        }
        next_tile(mt, nt, ntn);
      }
    }

    // The type's last batch of the panel: its dW tiles into dw, once.
    if (seg_end) {
      float* dwt = p.dw + static_cast<size_t>(b.t) * p.dh * p.dim;
      int mt = mt0, nt = nt0;
#pragma unroll
      for (int i = 0; i < TILES_PER_WARP; ++i) {
        if (tile0 + i < n_tiles) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = mt * 16 + (lane >> 2) + 8 * h;
            const int c = nt * 8 + 2 * (lane & 3);
            if (k >= p.dh) continue;
            float* d = dwt + static_cast<size_t>(k) * p.dim + c;
            if (c + 1 < p.dim && p.dim % 2 == 0) {
              atomicAdd(reinterpret_cast<float2*>(d),
                        make_float2(dw[i][2 * h], dw[i][2 * h + 1]));
            } else {
              if (c < p.dim) atomicAdd(d, dw[i][2 * h]);
              if (c + 1 < p.dim) atomicAdd(d + 1, dw[i][2 * h + 1]);
            }
          }
        }
        next_tile(mt, nt, ntn);
      }
      tmma::zero(dw);
      wbuf ^= 1;
    }
    b = nb;
  }
}

template <int ACT, bool VEC>
int launch(Args a, size_t smem, cudaStream_t stream) {
  auto kernel = typed_dense_agg_bwd_kernel<ACT, VEC>;
  static tmma::Occupancy occ;
  const int per_sm = occ.blocks_per_sm(kernel, THREADS, smem);
  if (per_sm <= 0) return static_cast<int>(occ.err);
  const int blocks = (a.num_edges + a.edges_per_block - 1) / a.edges_per_block;
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT>
int launch_act(const Args& a, bool vec, size_t smem, cudaStream_t stream) {
  return vec ? launch<ACT, true>(a, smem, stream)
             : launch<ACT, false>(a, smem, stream);
}

}  // namespace

// Returns cudaErrorInvalidValue for L outside [1, 8] or widths whose
// weights, batch rows and dz rows do not fit a block's shared memory (Dh =
// D past about 160). One block an SM (more where the SMs would take over
// MAX_EPB edges each): each adds its dW once per type.
extern "C" int typed_dense_agg_bwd_launch(const void* x, const void* w,
                                          const void* g, const void* types,
                                          const void* ranks, void* dx,
                                          void* dw, int num_edges, int dh,
                                          int dim, int n_types, int act,
                                          void* stream) {
  if (num_edges <= 0) return 0;
  if (dh <= 0 || dim <= 0 || n_types <= 0 || n_types > tmma::MAX_TYPES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh_p = tmma::pad16(dh), d_p = tmma::pad16(dim);
  const int blocks =
      max(tmma::sm_count(), (num_edges + MAX_EPB - 1) / MAX_EPB);
  const int epb = (num_edges + blocks - 1) / blocks;
  const size_t smem = smem_bytes(dh_p, d_p, epb);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(x),
         static_cast<const __nv_bfloat16*>(w),
         static_cast<const __nv_bfloat16*>(g),
         static_cast<const int*>(types),
         static_cast<const int*>(ranks),
         static_cast<__nv_bfloat16*>(dx),
         static_cast<float*>(dw), num_edges, dh, dim, n_types, dh_p, d_p,
         epb};
  const auto aligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const bool vec = dh % 8 == 0 && dim % 8 == 0 && aligned(x) && aligned(w) &&
                   aligned(g);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT_CALL(act, launch_act, a, vec, smem, s)
}
