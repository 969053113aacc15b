// K10a: typed dense aggregate, forward, with its typed products on the
// tensor cores.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_typed_dense_agg_kernel`
// (called by `_typed_dense_agg_impl`, the forward of
// `typed_dense_aggregate`, GNN-Edge-MLP1's `fused1` branch):
//   y_e        = x_e @ w[type_e]                          (f32 sums)
//   out[r, c]  = sum_{e: rank_e = r} bf16(act(y_e[c]))
// with x a bf16 [E, Dh] stream, w bf16 [L, Dh, D] (L <= 8), int32 types and
// nondecreasing gap-free int32 ranks [E], and out an f32 [rows, D] table,
// zeroed by the caller. An edge whose type is not in [0, L) adds nothing.
//
// Bound on the card: bytes (at QM9's widths a 2 Dh-byte row and two ints
// per edge, a 4D-byte table row per rank: 68 MB, 0.020 ms) over the
// products (2 E Dh D bf16 operations, 0.009 ms at the tensor cores' rate);
// the activation (gelu: some 45 instructions an element) costs about twice
// the bytes. The TPU kernel runs L type-masked products of every 256-edge
// sub-block on the MXU. Here a 64-edge chunk of the receiver-sorted stream,
// whose edges mix types, is ordered by type in shared memory
// (typed_mma.cuh order_by_type; by warp 0, for the next chunk while the
// block runs this one): its x rows are stored type by type in consecutive
// staging rows, each type's group padded to 16-row tiles, and each tile
// runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators)
// against its own type's weights only, in items of 32 columns. The weights
// of every type stay in shared memory for the block's life: blocks are
// persistent (one an SM, 16 warps, each over a contiguous run of chunks),
// and where L x Dh x D does not fit the columns are split into tiles (grid
// y), each block holding every type's weights for its column tile. Each
// item's terms bf16(act(y)) go to a term tile in stream order, and the
// sorted-rank walk of film_common.cuh sums them, a thread a column over a
// quarter of the chunk (interior segments stored, the quarter's first and
// last added atomically). The next chunk's x rows, ranks and types are
// loaded into registers while the current chunk computes. Widths that are
// not multiples of 16 are zero-padded in shared memory; rows of Dh not a
// multiple of 8 (or unaligned) take 2-byte loads without the look-ahead.
#include "film_common.cuh"
#include "typed_mma.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CH = film::CHUNK;  // edges a chunk
static_assert(CH == 64, "order_by_type orders 64 edges");
constexpr int MAX_TILES = CH / 16 + tmma::MAX_TYPES;
constexpr int QUARTER = CH / 4;  // edges a thread of the walk sums
// 16-byte x segments a thread loads ahead: rows of up to 256 columns.
constexpr int PF = 4;
constexpr int VEC_MAX_DH = 8 * PF * THREADS / CH;
// Dynamic shared memory a block may take beside its static arrays.
constexpr size_t SMEM_MAX = 232448 - 5120;

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const int* types;
  const int* ranks;
  float* out;
  int num_edges, dh, dim, n_types;
  int dh_p;  // Dh padded to a multiple of 16
  int nt;    // the columns of a block's tile, a multiple of 16
  int chunks_per_block;
};

// [L][Dh_p][nt + 8] weights, [CH + 1][Dh_p + 8] x rows (the last a zero
// row), [CH][nt + 2] terms (rows 4 banks apart), in bf16.
size_t smem_bytes(int n_types, int dh_p, int nt) {
  return 2 * (static_cast<size_t>(n_types) * dh_p * (nt + 8) +
              static_cast<size_t>(CH + 1) * (dh_p + 8) +
              static_cast<size_t>(CH) * (nt + 2));
}

// One (tile, NJ x 8 columns) item: y on the tensor cores, then each real
// row's terms bf16(act(y)) to the term tile at the edge's stream position.
template <int ACT, int NJ>
__device__ __forceinline__ void product_item(
    const __nv_bfloat16* a_row, const __nv_bfloat16* b, int ldw, int k_steps,
    const int* s_order_tile, __nv_bfloat16* s_term, int ldt, int col) {
  const int lane = threadIdx.x & 31;
  float acc[NJ][4];
  tmma::zero(acc);
  tmma::tile_kn(acc, a_row, b, ldw, k_steps);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = s_order_tile[(lane >> 2) + 8 * h];
    if (o < CH) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = col + j * 8 + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(s_term + o * ldt + c) =
            tmma::pack_bf16(film::act<ACT>(acc[j][2 * h]),
                            film::act<ACT>(acc[j][2 * h + 1]));
      }
    }
  }
}

// A chunk's ranks, types and order by type (typed_mma.cuh order_by_type).
struct ChunkOrder {
  int rank[CH];
  int type[CH];
  int phys[CH];
  int order[MAX_TILES * 16];
  int prow[MAX_TILES * 16];
  int tile_type[MAX_TILES];
  int tiles;
};

// Stores a chunk's ranks and types (held by threads 0..CH-1) into `c`.
__device__ __forceinline__ void put_chunk(ChunkOrder& c, int rank, int type,
                                          int n, int n_types) {
  const int tid = threadIdx.x;
  if (tid < CH) {
    c.rank[tid] = rank;
    c.type[tid] = (tid < n && type >= 0 && type < n_types) ? type : -1;
  }
}

__device__ __forceinline__ int edges_in(int num_edges, int ch) {
  return min(CH, static_cast<int>(num_edges - static_cast<long long>(ch) *
                                                  CH));
}

// Chunk `ch`'s x rows (the 16-byte path): segment tid + k THREADS of its
// rows into pf[k].
__device__ __forceinline__ void load_x(uint4 (&pf)[PF],
                                       const __nv_bfloat16* x, int num_edges,
                                       int segs, int ch) {
  const uint4* src =
      reinterpret_cast<const uint4*>(x + static_cast<long long>(ch) * CH *
                                             segs * 8);
  const int n = edges_in(num_edges, ch);
#pragma unroll
  for (int k = 0; k < PF; ++k) {
    const int s = threadIdx.x + k * THREADS;
    if (s < n * segs) pf[k] = src[s];
  }
}

// Chunk `ch`'s rank and type of edge threadIdx.x (threads 0..CH-1).
__device__ __forceinline__ void load_rt(int& rank, int& type,
                                        const int* ranks, const int* types,
                                        int num_edges, int ch) {
  const long long e = static_cast<long long>(ch) * CH + threadIdx.x;
  if (static_cast<int>(threadIdx.x) < edges_in(num_edges, ch)) {
    rank = ranks[e];
    type = types[e];
  }
}

// Warp 0 orders the chunk in `c` by type.
__device__ __forceinline__ void order_chunk(ChunkOrder& c, int n_types) {
  const int lane = threadIdx.x & 31;
  const int tiles = tmma::order_by_type(c.type[lane], c.type[lane + 32],
                                        n_types, CH, c.order, c.prow, c.phys,
                                        c.tile_type);
  if (lane == 0) c.tiles = tiles;
}

template <int ACT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
typed_dense_agg_kernel(const Args p) {
  // Two chunks' orders: warp 0 orders the next chunk while the block runs
  // the products of this one.
  __shared__ ChunkOrder s_chunk[2];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = p.dh_p + 8, ldw = p.nt + 8, ldt = p.nt + 2;
  auto* s_w = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_x = s_w + static_cast<size_t>(p.n_types) * p.dh_p * ldw;
  __nv_bfloat16* s_term = s_x + (CH + 1) * ldx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * p.nt;
  const int n_chunks = (p.num_edges + CH - 1) / CH;
  const int ch0 = blockIdx.x * p.chunks_per_block;
  const int ch1 = min(n_chunks, ch0 + p.chunks_per_block);
  if (ch0 >= ch1) return;

  // Every type's weights for the column tile, zero-padded to Dh_p rows,
  // copied without waiting; the x rows zeroed once (the pad columns and the
  // zero row CH stay zero).
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const bool w16 = p.dim % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
  const int n8 = p.nt / 8;
  for (int i = tid; i < p.n_types * p.dh_p * n8; i += THREADS) {
    const int c = (i % n8) * 8, k = (i / n8) % p.dh_p, t = i / (n8 * p.dh_p);
    const int col = c0 + c;
    __nv_bfloat16* dst = s_w + (static_cast<size_t>(t) * p.dh_p + k) * ldw + c;
    const __nv_bfloat16* src =
        p.w + (static_cast<size_t>(t) * p.dh + k) * p.dim + col;
    if (k < p.dh && w16 && col + 8 <= p.dim) {
      tmma::cp_async16(dst, src);
    } else {
      for (int j = 0; j < 8; ++j) {
        dst[j] = (k < p.dh && col + j < p.dim) ? src[j] : zero;
      }
    }
  }
  for (int i = tid; i < (CH + 1) * ldx / 8; i += THREADS) {
    reinterpret_cast<uint4*>(s_x)[i] = make_uint4(0, 0, 0, 0);
  }

  // Loads held in registers: a chunk's x rows (16-byte path) and the ranks
  // and types of the chunk after it.
  const int segs = p.dh / 8;
  uint4 pf[PF];
  int pf_rank = 0, pf_type = -1;
  load_rt(pf_rank, pf_type, p.ranks, p.types, p.num_edges, ch0);
  if (VEC) load_x(pf, p.x, p.num_edges, segs, ch0);
  put_chunk(s_chunk[0], pf_rank, pf_type, edges_in(p.num_edges, ch0),
            p.n_types);
  if (ch0 + 1 < ch1) {
    load_rt(pf_rank, pf_type, p.ranks, p.types, p.num_edges, ch0 + 1);
  }
  __syncthreads();
  if (warp == 0) order_chunk(s_chunk[0], p.n_types);
  tmma::cp_async_wait_all();

  for (int ch = ch0; ch < ch1; ++ch) {
    const long long e0 = static_cast<long long>(ch) * CH;
    const int n = edges_in(p.num_edges, ch);
    ChunkOrder& cur = s_chunk[(ch - ch0) & 1];
    ChunkOrder& next = s_chunk[(ch - ch0 + 1) & 1];
    __syncthreads();  // the order of this chunk is ready

    // 1. The x rows to their staging rows (by type, consecutive), the term
    // rows of edges of no type zeroed, the next chunk's ranks and types
    // stored; the loads after them go out.
    if (VEC) {
#pragma unroll
      for (int k = 0; k < PF; ++k) {
        const int s = tid + k * THREADS;
        if (s < n * segs) {
          const int row = cur.phys[s / segs];
          if (row >= 0) {
            *reinterpret_cast<uint4*>(s_x + row * ldx + (s % segs) * 8) =
                pf[k];
          }
        }
      }
    } else {
      for (int i = tid; i < n * p.dh; i += THREADS) {
        const int row = cur.phys[i / p.dh];
        if (row >= 0) s_x[row * ldx + i % p.dh] = p.x[e0 * p.dh + i];
      }
    }
    if (tid < n && cur.type[tid] < 0) {
      for (int j = 0; j < p.nt / 2; ++j) {
        reinterpret_cast<uint32_t*>(s_term + tid * ldt)[j] = 0u;
      }
    }
    if (ch + 1 < ch1) {
      put_chunk(next, pf_rank, pf_type, edges_in(p.num_edges, ch + 1),
                p.n_types);
      if (VEC) load_x(pf, p.x, p.num_edges, segs, ch + 1);
      if (ch + 2 < ch1) {
        load_rt(pf_rank, pf_type, p.ranks, p.types, p.num_edges, ch + 2);
      }
    }
    __syncthreads();

    // 2. Warp 0 orders the next chunk; each (tile, 32 columns) item runs on
    // the tensor cores (a last item of 16 where the tile's width is an odd
    // number of 16s), warp 0 taking the items of index WARPS - 1 on.
    if (warp == 0 && ch + 1 < ch1) order_chunk(next, p.n_types);
    const int groups = (p.nt + 31) / 32;
    const int items = cur.tiles * groups;
    for (int it = (warp + WARPS - 1) % WARPS; it < items; it += WARPS) {
      const int tile = it / groups, col = (it - tile * groups) * 32;
      const __nv_bfloat16* a_row =
          s_x + cur.prow[tile * 16 + (lane & 15)] * ldx;
      const __nv_bfloat16* b =
          s_w + static_cast<size_t>(cur.tile_type[tile]) * p.dh_p * ldw + col;
      if (col + 32 <= p.nt) {
        product_item<ACT, 4>(a_row, b, ldw, p.dh_p / 16,
                             cur.order + tile * 16, s_term, ldt, col);
      } else {
        product_item<ACT, 2>(a_row, b, ldw, p.dh_p / 16,
                             cur.order + tile * 16, s_term, ldt, col);
      }
    }
    __syncthreads();

    // 3. Per-rank f32 sums of the terms: a thread sums a column over a
    // quarter of the chunk (interior segments stored, the quarter's first
    // and last added atomically).
    for (int i = tid; i < p.nt * 4; i += THREADS) {
      const int q = i / p.nt, c = i - q * p.nt;
      const int col = c0 + c;
      const int i0 = q * QUARTER, i1 = min(n, i0 + QUARTER);
      if (col >= p.dim || i0 >= i1) continue;
      int r[QUARTER];
      float t[QUARTER];
#pragma unroll
      for (int k = 0; k < QUARTER; ++k) {
        if (i0 + k < i1) {
          r[k] = cur.rank[i0 + k];
          t[k] = film::ld(s_term + (i0 + k) * ldt + c);
        }
      }
      float* dst = p.out + col;
      const int first = r[0];
      int seg = first;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < QUARTER; ++k) {
        if (i0 + k < i1) {
          if (r[k] != seg) {
            film::flush(dst + static_cast<size_t>(seg) * p.dim, acc,
                        seg == first);
            seg = r[k];
            acc = 0.0f;
          }
          acc += t[k];
        }
      }
      atomicAdd(dst + static_cast<size_t>(seg) * p.dim, acc);
    }
  }
}

template <int ACT, bool VEC>
int launch(Args a, size_t smem, int col_tiles, cudaStream_t stream) {
  auto kernel = typed_dense_agg_kernel<ACT, VEC>;
  static tmma::Occupancy occ;
  const int per_sm = occ.blocks_per_sm(kernel, THREADS, smem);
  if (per_sm <= 0) return static_cast<int>(occ.err);
  const int n_chunks = (a.num_edges + CH - 1) / CH;
  const int want = (tmma::sm_count() * per_sm + col_tiles - 1) / col_tiles;
  a.chunks_per_block = (n_chunks + want - 1) / want;
  const int blocks = (n_chunks + a.chunks_per_block - 1) / a.chunks_per_block;
  kernel<<<dim3(blocks, col_tiles), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT>
int launch_act(const Args& a, bool vec, size_t smem, int col_tiles,
               cudaStream_t stream) {
  return vec ? launch<ACT, true>(a, smem, col_tiles, stream)
             : launch<ACT, false>(a, smem, col_tiles, stream);
}

}  // namespace

// The column tile is the widest (a multiple of 16, halved from D_p) whose
// shared memory fits; returns cudaErrorInvalidValue where none does (Dh
// past about 440 at L = 8) or for L outside [1, 8].
extern "C" int typed_dense_agg_launch(const void* x, const void* w,
                                      const void* types, const void* ranks,
                                      void* out, int num_edges, int dh,
                                      int dim, int n_types, int act,
                                      void* stream) {
  if (num_edges <= 0) return 0;
  if (dh <= 0 || dim <= 0 || n_types <= 0 || n_types > tmma::MAX_TYPES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const __nv_bfloat16*>(x),
         static_cast<const __nv_bfloat16*>(w),
         static_cast<const int*>(types), static_cast<const int*>(ranks),
         static_cast<float*>(out), num_edges, dh, dim, n_types,
         tmma::pad16(dh), tmma::pad16(dim), 0};
  while (smem_bytes(n_types, a.dh_p, a.nt) > SMEM_MAX && a.nt > 16) {
    a.nt = tmma::pad16(a.nt / 2);
  }
  const size_t smem = smem_bytes(n_types, a.dh_p, a.nt);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int col_tiles = (tmma::pad16(dim) + a.nt - 1) / a.nt;
  const bool vec = dh % 8 == 0 && dh <= VEC_MAX_DH &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT_CALL(act, launch_act, a, vec, smem, col_tiles, s)
}
