// K14: the source-order half of the GNN-Edge-MLP1 backward, with its two
// typed products on the tensor cores.
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
// slack row), gcb a bf16 [E, 2D] stream, w bf16 [L, D, D] (L <= 8) and
// out an f32 [R, D] table, zeroed by the caller. Edges at or past *e_real
// (the padded tail of the src-sorted stream, whose type decode is
// garbage: its col entry is never read) and edges of no non-self type add
// nothing.
//
// Bound on the card: bytes (a 4D-byte stream row per edge, a 2D-byte t
// row and a 4D-byte output row per source group: 0.058 ms at QM9's
// widths) over the two products (4 E_live D^2 bf16 operations, 0.007 ms
// at the tensor cores' rate); elu and act' (gelu: some 80 instructions an
// element with IEEE division and expf) cost more than the bytes. The TPU
// kernel runs the products of every non-self type, masked by a type
// one-hot, on the MXU. Here the products run on the tensor cores
// (typed_mma.cuh: mma.sync m16n8k16, bf16 in, f32 accumulators), each
// 16-row tile of a 32-edge chunk against the weights of each type its
// rows hold: the stream is sorted by (type, sender), so a tile holds one
// type but at the L - 1 type boundaries, and a row keeps only its own
// type's results. Blocks are persistent (one an SM) and keep every type's
// weights in shared memory (139 KB at L = 4, D = 128); y reads W by
// ldmatrix.trans (tile_kn), dx reads W's own rows as W^T by plain
// ldmatrix (tile_nk), so no transposed copy is made. A block's 16 warps
// form two groups of 8, each with its own rows, chunk plans and barrier,
// running apart on chunks of their own, so one group's products overlap
// the other's elementwise work (faster on the H100 than one group of 16
// warps on 64-edge chunks). The groups take every G-th pair
// of chunks (G blocks), so that the self-loop type's contiguous run of
// dead chunks spreads over all blocks; each first marks which of its
// chunks hold a live edge (the ranks and col entries of all of them
// loaded at once) and walks only those. Per chunk: bf16(x), elu'(x) (f32)
// and g go to shared memory from rows loaded into registers while the
// chunk before ran; y, then da into shared memory; dx, then the rounded
// terms into a stream-order tile (over x's rows); the sorted-rank walk of
// film_common.cuh sums the terms, a thread a column over half the chunk
// (interior runs stored, the half's first and last added atomically).
// Widths not multiples of 16 are zero-padded in shared memory; rows of D
// not a multiple of 8, wider than 128 or unaligned take 2-byte loads
// without the look-ahead. Built with -fmad=false: the elementwise parts
// round as the plain version does; the products sum in the tensor cores'
// order.
#include "film_common.cuh"
#include "typed_mma.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int GROUPS = 2;              // warp groups a block
constexpr int GT = THREADS / GROUPS;   // threads a group
constexpr int GWARPS = GT / 32;
constexpr int CH = 32;                 // edges a chunk
static_assert(CH == 32, "a warp marks and plans one chunk");
constexpr int TILES = CH / 16;
constexpr int MAX_PASSES = TILES * tmma::MAX_TYPES;
constexpr int HALF = CH / 2;           // edges a thread of the walk sums
// 16-byte row segments a thread loads ahead: rows of up to 128 columns.
constexpr int PF = 2;
constexpr int VEC_MAX_D = 8 * PF * GT / CH;
// Chunks a group marks live in its bitmask; more blocks where a stream
// has more than MAX_CHUNKS x GROUPS x G chunks.
constexpr int MAX_CHUNKS = 512;
// Dynamic shared memory a block may take beside its static arrays.
constexpr size_t SMEM_MAX = 232448 - 3072;

struct Args {
  const __nv_bfloat16* gcb;
  const __nv_bfloat16* t;
  const int* col;
  const __nv_bfloat16* w;
  const int* e_real;
  const int* ranks;
  float* out;
  int num_edges, dim, n_types;
  int d_p;  // D padded to a multiple of 16
  int n_chunks;
};

// [L][D_p][D_p + 8] weights; per group [CH][D_p + 8] bf16(x) rows (then
// the terms), da rows and g rows (bf16) and elu'(x) rows (f32).
size_t smem_bytes(int n_types, int d_p) {
  const size_t ld = d_p + 8;
  return 2 * (static_cast<size_t>(n_types) * d_p * ld +
              3 * GROUPS * CH * ld) +
         4 * GROUPS * CH * ld;
}

// A chunk's ranks and types (-1: no live edge), and its passes: the
// (16-row tile, type) pairs whose products it runs (0: no live edge).
struct Chunk {
  int rank[CH];
  int type[CH];
  int pass_tile[MAX_PASSES];
  int pass_type[MAX_PASSES];
  int passes;
};

// The threads of one group wait for each other (barrier 1 + group).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(GT) : "memory");
}

// The first edge of the group's chunk i: a block's two groups take
// neighbouring chunks, the G blocks every G-th pair.
__device__ __forceinline__ long long chunk_e0(int group, int i) {
  return (static_cast<long long>(blockIdx.x) * GROUPS + group +
          static_cast<long long>(i) * gridDim.x * GROUPS) * CH;
}

// The edge's compact type, or -1 past the stream, at or past e_real, or
// for a col entry outside [0, L).
__device__ __forceinline__ int type_of(const Args& p, long long e, int live,
                                       int rank) {
  if (e >= p.num_edges || e >= live) return -1;
  const int l = p.col[rank];
  return (l >= 0 && l < p.n_types) ? l : -1;
}

// The first of the group's chunks at or after i that holds a live edge,
// or `count`.
__device__ __forceinline__ int next_live(const unsigned* s_live, int i,
                                         int count) {
  while (i < count) {
    const unsigned bits = s_live[i >> 5] >> (i & 31);
    if (bits) return min(count, i + __ffs(bits) - 1);
    i = (i | 31) + 1;
  }
  return count;
}

// The rank of edge `lane` of the group's chunk i (its first warp).
__device__ __forceinline__ int load_rank(const Args& p, int group, int i,
                                         int lane) {
  const long long e = chunk_e0(group, i) + lane;
  return e < p.num_edges ? p.ranks[e] : 0;
}

// The group's first warp lists the chunk's passes: for each tile, each
// type its rows hold.
__device__ __forceinline__ void plan_chunk(Chunk& c, int n_types) {
  const int lane = threadIdx.x & 31;
  const int ty = c.type[lane];
  unsigned present = 0;  // bit TILES l + tile
  for (int l = 0; l < n_types; ++l) {
    const unsigned b = __ballot_sync(0xffffffffu, ty == l);
    present |= ((b & 0xffffu) ? 1u : 0u) << (TILES * l);
    present |= ((b >> 16) ? 2u : 0u) << (TILES * l);
  }
  if (lane == 0) {
    int n = 0;
    for (int tile = 0; tile < TILES; ++tile) {
      for (int l = 0; l < n_types; ++l) {
        if (present >> (TILES * l + tile) & 1u) {
          c.pass_tile[n] = tile;
          c.pass_type[n] = l;
          ++n;
        }
      }
    }
    c.passes = n;
  }
}

// Value k of 8 bf16 held two to a word (bf16 to f32 is exact).
__device__ __forceinline__ float bf(const uint4& v, int k) {
  const unsigned w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
  return __uint_as_float(k % 2 ? (w & 0xffff0000u) : (w << 16));
}

// One edge row's 8 columns from m and beta: bf16(x) and elu'(x) staged.
__device__ __forceinline__ void stage_x8(__nv_bfloat16* xd, float* dd,
                                         const uint4& m, const uint4& b) {
  float x[8], de[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[k] = film::act<film::ELU>(bf(m, k) + bf(b, k));
    de[k] = x[k] > 0.0f ? 1.0f : x[k] + 1.0f;
  }
  *reinterpret_cast<uint4*>(xd) =
      make_uint4(tmma::pack_bf16(x[0], x[1]), tmma::pack_bf16(x[2], x[3]),
                 tmma::pack_bf16(x[4], x[5]), tmma::pack_bf16(x[6], x[7]));
  reinterpret_cast<float4*>(dd)[0] = make_float4(de[0], de[1], de[2], de[3]);
  reinterpret_cast<float4*>(dd)[1] = make_float4(de[4], de[5], de[6], de[7]);
}

// y = bf16(x) W[l] for one (pass, NJ x 8 columns) item, then da =
// bf16(act'(y) g) of the rows of type l into s_da (0 past D).
template <int ACT, int NJ>
__device__ __forceinline__ void y_item(const Chunk& c, int pass, int col,
                                       const __nv_bfloat16* s_x,
                                       const __nv_bfloat16* s_w,
                                       const __nv_bfloat16* s_g,
                                       __nv_bfloat16* s_da, int ld, int d_p,
                                       int dim) {
  const int lane = threadIdx.x & 31;
  const int tile = c.pass_tile[pass], l = c.pass_type[pass];
  float acc[NJ][4];
  tmma::zero(acc);
  tmma::tile_kn(acc, s_x + (tile * 16 + (lane & 15)) * ld,
                s_w + static_cast<size_t>(l) * d_p * ld + col, ld, d_p / 16);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile * 16 + (lane >> 2) + 8 * h;
    if (c.type[r] != l) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = col + j * 8 + 2 * (lane & 3);
      float z0 = 0.0f, z1 = 0.0f;
      if (k < dim) {
        z0 = film::dact<ACT>(acc[j][2 * h]) * film::ld(s_g + r * ld + k);
      }
      if (k + 1 < dim) {
        z1 = film::dact<ACT>(acc[j][2 * h + 1]) *
             film::ld(s_g + r * ld + k + 1);
      }
      *reinterpret_cast<uint32_t*>(s_da + r * ld + k) = tmma::pack_bf16(z0, z1);
    }
  }
}

// dx = da W[l]^T for one (pass, NJ x 8 columns) item, then the terms
// bf16(elu'(x) dx) of the rows of type l into the term tile.
template <int NJ>
__device__ __forceinline__ void dx_item(const Chunk& c, int pass, int row,
                                        const __nv_bfloat16* s_da,
                                        const __nv_bfloat16* s_w,
                                        const float* s_dex,
                                        __nv_bfloat16* s_term, int ld,
                                        int d_p, int dim) {
  const int lane = threadIdx.x & 31;
  const int tile = c.pass_tile[pass], l = c.pass_type[pass];
  float acc[NJ][4];
  tmma::zero(acc);
  tmma::tile_nk(acc, s_da + (tile * 16 + (lane & 15)) * ld,
                s_w + (static_cast<size_t>(l) * d_p + row) * ld, ld, d_p / 16);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile * 16 + (lane >> 2) + 8 * h;
    if (c.type[r] != l) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = row + j * 8 + 2 * (lane & 3);
      const float* de = s_dex + r * ld + k;
      if (k + 1 < dim) {
        *reinterpret_cast<uint32_t*>(s_term + r * ld + k) = tmma::pack_bf16(
            de[0] * acc[j][2 * h], de[1] * acc[j][2 * h + 1]);
      } else if (k < dim) {
        s_term[r * ld + k] = __float2bfloat16_rn(de[0] * acc[j][2 * h]);
      }
    }
  }
}

template <int ACT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
emlp1_src_bwd_kernel(const Args p) {
  __shared__ Chunk s_chunks[GROUPS][2];
  __shared__ unsigned s_lives[GROUPS][MAX_CHUNKS / 32];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = p.d_p + 8;
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid / GT, gtid = tid - group * GT, gwarp = gtid >> 5;
  auto* s_w = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // The group's rows. s_x holds bf16(x) until y has run, then the terms
  // (pad columns and the rows of dead edges stay 0: their terms).
  __nv_bfloat16* s_x = s_w + static_cast<size_t>(p.n_types) * p.d_p * ld +
                       static_cast<size_t>(group) * 3 * CH * ld;
  __nv_bfloat16* s_da = s_x + CH * ld;
  __nv_bfloat16* s_g = s_da + CH * ld;
  auto* s_dex = reinterpret_cast<float*>(
                    s_w + static_cast<size_t>(p.n_types) * p.d_p * ld +
                    static_cast<size_t>(GROUPS) * 3 * CH * ld) +
                static_cast<size_t>(group) * CH * ld;
  Chunk* s_chunk = s_chunks[group];
  unsigned* s_live = s_lives[group];
  const int stride = static_cast<int>(gridDim.x) * GROUPS;
  const int first = static_cast<int>(blockIdx.x) * GROUPS + group;
  const int count = p.n_chunks > first
                        ? (p.n_chunks - first + stride - 1) / stride : 0;
  const int live = *p.e_real;
  const int dim = p.dim;

  // 1. Every type's weights, zero-padded to [D_p][D_p], copied without
  // waiting; the x and da rows zeroed once; each group marks its live
  // chunks; then the block waits for the weights.
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const bool w16 = dim % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
  const int n8 = p.d_p / 8;
  for (int i = tid; i < p.n_types * p.d_p * n8; i += THREADS) {
    const int c = (i % n8) * 8, k = (i / n8) % p.d_p, l = i / (n8 * p.d_p);
    __nv_bfloat16* dst = s_w + (static_cast<size_t>(l) * p.d_p + k) * ld + c;
    const __nv_bfloat16* src =
        p.w + (static_cast<size_t>(l) * dim + k) * dim + c;
    if (k < dim && w16 && c + 8 <= dim) {
      tmma::cp_async16(dst, src);
    } else {
      for (int j = 0; j < 8; ++j) {
        dst[j] = (k < dim && c + j < dim) ? src[j] : zero;
      }
    }
  }
  for (int i = gtid; i < 2 * CH * ld / 8; i += GT) {
    reinterpret_cast<uint4*>(s_x)[i] = make_uint4(0, 0, 0, 0);
  }
  if (gtid < MAX_CHUNKS / 32) s_live[gtid] = 0u;
  group_sync(group);
  // Four edges a thread at a time, their loads issued together; a warp's
  // 32 edges are one chunk.
  for (int base = 0; base < count * CH; base += 4 * GT) {
    int rank[4];
    long long e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * GT + gtid;
      e[u] = idx < count * CH ? chunk_e0(group, idx / CH) + idx % CH
                              : p.num_edges;
      rank[u] = (e[u] < p.num_edges && e[u] < live) ? p.ranks[e[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned any =
          __ballot_sync(0xffffffffu, type_of(p, e[u], live, rank[u]) >= 0);
      const int i = (base + u * GT + gtid) / CH;
      if (lane == 0 && any) atomicOr(&s_live[i >> 5], 1u << (i & 31));
    }
  }
  tmma::cp_async_wait_all();
  __syncthreads();

  // 2. The group's first live chunk's ranks, types and plan, its rows
  // loaded into registers, the next live chunk's ranks and types, and the
  // ranks of the one after it. In the loop each load is used an iteration
  // after it is issued (a type, col[rank], only once its rank is in), so
  // no warp waits on one between two barriers. From here on the two
  // groups run apart, each with its own barrier, so one group's products
  // overlap the other's elementwise phases and walk.
  int i_cur = next_live(s_live, 0, count);
  if (i_cur >= count) return;
  int i_nxt = next_live(s_live, i_cur + 1, count);
  int i_aft = next_live(s_live, i_nxt + 1, count);
  const int segs = dim / 8;
  uint4 pm[PF], pb[PF], pg[PF];
  int nxt_rank = 0, nxt_type = -1, aft_rank = 0;

  // Chunk i's rows of live edges (the 16-byte path): segment gtid + k GT
  // of the chunk's m rows and beta | g rows into registers.
  auto load_rows = [&](const Chunk& c, int i) {
    const long long e0 = chunk_e0(group, i);
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int s = gtid + k * GT;
      if (s < CH * segs) {
        const int r = s / segs, q = s - r * segs;
        if (c.type[r] >= 0) {
          const __nv_bfloat16* row = p.gcb + (e0 + r) * 2 * dim + q * 8;
          pm[k] = __ldg(reinterpret_cast<const uint4*>(
              p.t + static_cast<size_t>(c.rank[r]) * dim + q * 8));
          pb[k] = __ldg(reinterpret_cast<const uint4*>(row));
          pg[k] = __ldg(reinterpret_cast<const uint4*>(row + dim));
        }
      }
    }
  };

  if (gwarp == 0) {
    const int rank = load_rank(p, group, i_cur, lane);
    s_chunk[0].rank[lane] = rank;
    s_chunk[0].type[lane] =
        type_of(p, chunk_e0(group, i_cur) + lane, live, rank);
    if (i_nxt < count) {
      nxt_rank = load_rank(p, group, i_nxt, lane);
      nxt_type = type_of(p, chunk_e0(group, i_nxt) + lane, live, nxt_rank);
    }
    if (i_aft < count) aft_rank = load_rank(p, group, i_aft, lane);
    __syncwarp();
    plan_chunk(s_chunk[0], p.n_types);
  }
  group_sync(group);
  if (VEC) load_rows(s_chunk[0], i_cur);

  for (int it = 0; i_cur < count; ++it) {
    const Chunk& cur = s_chunk[it & 1];
    Chunk& nxt = s_chunk[(it + 1) & 1];
    const long long e0 = chunk_e0(group, i_cur);
    const int n = static_cast<int>(min(static_cast<long long>(CH),
                                       p.num_edges - e0));

    // A. bf16(x), elu'(x) and g of the live rows to shared memory (x 0
    // for the others); the next chunk's ranks and types stored.
    if (VEC) {
#pragma unroll
      for (int k = 0; k < PF; ++k) {
        const int s = gtid + k * GT;
        if (s < CH * segs) {
          const int r = s / segs, q = s - r * segs;
          __nv_bfloat16* xd = s_x + r * ld + q * 8;
          if (cur.type[r] >= 0) {
            stage_x8(xd, s_dex + r * ld + q * 8, pm[k], pb[k]);
            *reinterpret_cast<uint4*>(s_g + r * ld + q * 8) = pg[k];
          } else {
            *reinterpret_cast<uint4*>(xd) = make_uint4(0, 0, 0, 0);
          }
        }
      }
    } else {
      for (int i = gtid; i < CH * dim; i += GT) {
        const int r = i / dim, k = i - r * dim;
        if (cur.type[r] >= 0) {
          const __nv_bfloat16* row = p.gcb + (e0 + r) * 2 * dim;
          const float x = film::act<film::ELU>(
              film::ld(p.t + static_cast<size_t>(cur.rank[r]) * dim + k) +
              film::ld(row + k));
          s_x[r * ld + k] = __float2bfloat16_rn(x);
          s_dex[r * ld + k] = x > 0.0f ? 1.0f : x + 1.0f;
          s_g[r * ld + k] = row[dim + k];
        } else {
          s_x[r * ld + k] = zero;
        }
      }
    }
    if (gwarp == 0 && i_nxt < count) {
      nxt.rank[lane] = nxt_rank;
      nxt.type[lane] = nxt_type;
    }
    group_sync(group);

    // The next chunk's rows, the types of the one after it (its ranks are
    // in) and the ranks of the one after that go out; the first warp
    // plans the next chunk (and takes the last items).
    const int i_aft2 = next_live(s_live, i_aft + 1, count);
    if (VEC && i_nxt < count) load_rows(nxt, i_nxt);
    if (gwarp == 0) {
      if (i_aft < count) {
        nxt_rank = aft_rank;
        nxt_type = type_of(p, chunk_e0(group, i_aft) + lane, live, aft_rank);
      }
      if (i_aft2 < count) aft_rank = load_rank(p, group, i_aft2, lane);
      if (i_nxt < count) plan_chunk(nxt, p.n_types);
    }

    // B. y and da, in items of (pass, 32 columns).
    const int groups = (p.d_p + 31) / 32;
    const int items = cur.passes * groups;
    for (int j = (gwarp + GWARPS - 1) % GWARPS; j < items; j += GWARPS) {
      const int pass = j / groups, col = (j - pass * groups) * 32;
      if (col + 32 <= p.d_p) {
        y_item<ACT, 4>(cur, pass, col, s_x, s_w, s_g, s_da, ld, p.d_p, dim);
      } else {
        y_item<ACT, 2>(cur, pass, col, s_x, s_w, s_g, s_da, ld, p.d_p, dim);
      }
    }
    group_sync(group);

    // C. dx and the terms over x's rows, in items of (pass, 32 columns).
    for (int j = (gwarp + GWARPS - 1) % GWARPS; j < items; j += GWARPS) {
      const int pass = j / groups, row = (j - pass * groups) * 32;
      if (row + 32 <= p.d_p) {
        dx_item<4>(cur, pass, row, s_da, s_w, s_dex, s_x, ld, p.d_p, dim);
      } else {
        dx_item<2>(cur, pass, row, s_da, s_w, s_dex, s_x, ld, p.d_p, dim);
      }
    }
    group_sync(group);

    // D. Per-rank f32 sums of the terms: a thread sums a column over half
    // the chunk (interior runs stored, the half's first and last added
    // atomically).
    for (int i = gtid; i < dim * 2; i += GT) {
      const int h = i / dim, c = i - h * dim;
      const int i0 = h * HALF, i1 = min(n, i0 + HALF);
      if (i0 >= i1) continue;
      int r[HALF];
      float t[HALF];
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        if (i0 + k < i1) {
          r[k] = cur.rank[i0 + k];
          t[k] = film::ld(s_x + (i0 + k) * ld + c);
        }
      }
      float* dst = p.out + c;
      const int head = r[0];
      int seg = head;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        if (i0 + k < i1) {
          if (r[k] != seg) {
            film::flush(dst + static_cast<size_t>(seg) * dim, acc,
                        seg == head);
            seg = r[k];
            acc = 0.0f;
          }
          acc += t[k];
        }
      }
      atomicAdd(dst + static_cast<size_t>(seg) * dim, acc);
    }
    group_sync(group);
    i_cur = i_nxt;
    i_nxt = i_aft;
    i_aft = i_aft2;
  }
}

template <int ACT, bool VEC>
int launch(Args a, size_t smem, cudaStream_t stream) {
  auto kernel = emlp1_src_bwd_kernel<ACT, VEC>;
  static tmma::Occupancy occ;
  const int per_sm = occ.blocks_per_sm(kernel, THREADS, smem);
  if (per_sm <= 0) return static_cast<int>(occ.err);
  const int pairs = (a.n_chunks + GROUPS - 1) / GROUPS;
  const int blocks =
      min(pairs, max(tmma::sm_count() * per_sm,
                     (pairs + MAX_CHUNKS - 1) / MAX_CHUNKS));
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT>
int launch_act(const Args& a, bool vec, size_t smem, cudaStream_t stream) {
  return vec ? launch<ACT, true>(a, smem, stream)
             : launch<ACT, false>(a, smem, stream);
}

}  // namespace

// 1 where a block holds l_eff types' D x D weights and its chunk rows in
// shared memory (D up to 128 at L = 4), else 0: what the launch takes.
// ops/ranked_segment.py emlp1_src_bwd_fits mirrors it for the gate, which
// runs where no kernel is built; chip_smoke.py holds the two equal.
extern "C" int emlp1_src_bwd_fits(int dim, int l_eff) {
  return dim > 0 && l_eff > 0 && l_eff <= tmma::MAX_TYPES &&
         smem_bytes(l_eff, tmma::pad16(dim)) <= SMEM_MAX;
}

// Returns cudaErrorInvalidValue for what emlp1_src_bwd_fits refuses.
extern "C" int emlp1_src_bwd_launch(const void* gcb, const void* t,
                                    const void* col, const void* w,
                                    const void* e_real, const void* ranks,
                                    void* out, int num_edges, int dim,
                                    int l_eff, int act, void* stream) {
  if (num_edges <= 0) return 0;
  if (!emlp1_src_bwd_fits(dim, l_eff)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d_p = tmma::pad16(dim);
  const size_t smem = smem_bytes(l_eff, d_p);
  Args a{static_cast<const __nv_bfloat16*>(gcb),
         static_cast<const __nv_bfloat16*>(t),
         static_cast<const int*>(col),
         static_cast<const __nv_bfloat16*>(w),
         static_cast<const int*>(e_real),
         static_cast<const int*>(ranks),
         static_cast<float*>(out), num_edges, dim, l_eff, d_p,
         (num_edges + CH - 1) / CH};
  const auto aligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const bool vec = dim % 8 == 0 && dim <= VEC_MAX_D && aligned(gcb) &&
                   aligned(t);
  const auto s = static_cast<cudaStream_t>(stream);
  FILM_DISPATCH_ACT_CALL(act, launch_act, a, vec, smem, s)
}
