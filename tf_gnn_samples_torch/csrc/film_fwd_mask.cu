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
//
// Bound on the card: bytes, K1's traffic plus the [E, lanes] f32 mask
// store (20.7 MB at QM9's batch, 0.006 ms). The TPU kernel packs with a
// [D, lanes] MXU product of the 0/1 mask. Here the table comes from K1's
// own walk (film_rows.cuh: a lane owns 8 columns of a 64-edge chunk,
// 16-byte loads issued FWD_AHEAD edges before their sums, the same
// expression and the same sum order, so the tables agree bit for bit on
// every row that one chunk holds) with a mask epilogue: a lane's 8 sign
// bits of an edge and its neighbour's (the lane of the next 8 columns)
// make one 16-bit group, joined by one shuffle (__shfl_xor_sync(.., 1)).
// Items are numbered over D rounded up to 16 columns, so the two lanes of
// a group are always an even lane and the odd one after it, in one chunk
// and one block (where ceil(D / 8) is odd, a chunk's last item is a pad
// lane that loads, sums and stores nothing and votes 0). The block stages
// its chunks' groups in shared memory and stores the mask as contiguous
// [edges, lanes] rows, 16 bytes a thread, zero lanes included: each word
// by the block that holds the lanes of its group (a zero lane by the
// block that holds its chunk's first group).
#include "film_rows.cuh"

namespace {

constexpr int GROUP = 16;  // sign bits a mask lane holds

__host__ __device__ __forceinline__ int round16(int d) {
  return (d + GROUP - 1) / GROUP * GROUP;
}

template <int ACT, bool V>
__global__ void __launch_bounds__(THREADS)
film_fwd_mask_kernel(const __nv_bfloat16* __restrict__ msgs,
                     const __nv_bfloat16* __restrict__ gb,
                     const int* __restrict__ ranks, float* __restrict__ out,
                     float* __restrict__ mask, int num_edges, int dim,
                     int lanes) {
  extern __shared__ int s_rank[];
  const int dim16 = round16(dim), groups = dim16 / GROUP;
  // The groups of the block's edges: [edges][groups] 16-bit words.
  auto* s_mask =
      reinterpret_cast<unsigned short*>(s_rank + rows_cap(dim16));
  Item it;
  if (load_item_at(blockIdx.x, ranks, num_edges, dim16, s_rank, it)) {
    it.valid = min(VEC, dim - it.c);
    const bool real = it.valid > 0;
    const bool even = (it.c / VEC) % 2 == 0;
    const unsigned pair = 3u << (threadIdx.x & 30);
    unsigned short* m_out = s_mask + it.off * groups + it.c / GROUP;
    const __nv_bfloat16* m_col = msgs + it.e0 * dim + it.c;
    const int first = it.rk[0];
    int cur = first;
    float acc[VEC] = {};
    constexpr int AHEAD = FWD_AHEAD;
#pragma unroll 1
    for (int i0 = 0; i0 < it.n; i0 += AHEAD) {
      int r[AHEAD];
      uint4 mv[AHEAD], gv[AHEAD], bv[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        // Past the chunk's end: the last edge again, loaded but not summed.
        const int i = min(i0 + u, it.n - 1);
        r[u] = it.rk[i];
        if (real) {
          const __nv_bfloat16* row =
              gb + static_cast<size_t>(r[u]) * 2 * dim + it.c;
          mv[u] = load8<V>(m_col + static_cast<size_t>(i) * dim, it.valid);
          gv[u] = load8<V>(row, it.valid);
          bv[u] = load8<V>(row + dim, it.valid);
        } else {
          mv[u] = gv[u] = bv[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (i0 + u >= it.n) break;
        if (r[u] != cur) {
          if (real) {
            flush8<V>(out + static_cast<size_t>(cur) * dim + it.c, acc,
                      it.valid, cur == first);
          }
          cur = r[u];
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
        }
        unsigned bits = 0u;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float z = bf(gv[u], k) * bf(mv[u], k) + bf(bv[u], k);
          acc[k] += film::round_bf16(film::act<ACT>(z));
          bits |= static_cast<unsigned>(k < it.valid && z > 0.0f) << k;
        }
        const unsigned next = __shfl_xor_sync(pair, bits, 1);
        if (even) {
          m_out[(i0 + u) * groups] =
              static_cast<unsigned short>(bits | (next << VEC));
        }
      }
    }
    if (real) {
      flush8<V>(out + static_cast<size_t>(cur) * dim + it.c, acc, it.valid,
                true);
    }
  }
  __syncthreads();

  // The mask rows of the block's edges, four lanes a thread: the words of
  // the groups whose lanes are the block's, and the zero lanes of the
  // chunks whose first group is.
  long long e_lo;
  const int n_rk = block_edges(blockIdx.x, num_edges, dim16, e_lo);
  const long long slots = dim16 / VEC;
  const long long item0 = static_cast<long long>(blockIdx.x) * THREADS;
  const int quads = lanes / 4;
  for (int idx = threadIdx.x; idx < n_rk * quads; idx += THREADS) {
    const int el = idx / quads, w0 = (idx - el * quads) * 4;
    const long long e = e_lo + el;
    const long long slot0 = e / film::CHUNK * slots - item0;
    float v[4];
    bool own[4], all = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + j;
      own[j] = static_cast<unsigned long long>(
                   slot0 + (w < groups ? 2 * w : 0)) < THREADS;
      v[j] = w < groups ? static_cast<float>(s_mask[el * groups + w]) : 0.0f;
      all = all && own[j];
    }
    float* dst = mask + e * lanes + w0;
    if (all) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (own[j]) dst[j] = v[j];
      }
    }
  }
}

template <int ACT>
int launch(const __nv_bfloat16* m, const __nv_bfloat16* t, const int* rk,
           float* o, float* mk, int num_edges, int dim, int lanes,
           cudaStream_t s) {
  const int dim16 = round16(dim);
  const dim3 grid = rows_grid(num_edges, dim16);
  const size_t words = static_cast<size_t>(rows_cap(dim16)) * (dim16 / GROUP);
  const size_t smem = rows_smem(dim16) + (words * 2 + 3) / 4 * 4;
  if (dim % VEC == 0 && aligned16(m) && aligned16(t) && aligned16(o)) {
    return film::launch_smem(film_fwd_mask_kernel<ACT, true>, grid,
                             dim3(THREADS), smem, s, m, t, rk, o, mk,
                             num_edges, dim, lanes);
  }
  return film::launch_smem(film_fwd_mask_kernel<ACT, false>, grid,
                           dim3(THREADS), smem, s, m, t, rk, o, mk, num_edges,
                           dim, lanes);
}

}  // namespace

// lanes must be a multiple of 4 and at least ceil(dim / 16), and the mask
// 16-byte aligned (the wrapper's [E, _mask_lanes(D)] f32 tensor).
extern "C" int film_fwd_mask_launch(const void* msgs, const void* gb,
                                    const void* ranks, void* out, void* mask,
                                    int num_edges, int dim, int lanes, int act,
                                    void* stream) {
  if (num_edges <= 0) return 0;
  if (dim <= 0 || lanes < (dim + GROUP - 1) / GROUP || lanes % 4 != 0 ||
      !aligned16(mask)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FILM_DISPATCH_ACT_CALL(act, launch, static_cast<const __nv_bfloat16*>(msgs),
                         static_cast<const __nv_bfloat16*>(gb),
                         static_cast<const int*>(ranks),
                         static_cast<float*>(out), static_cast<float*>(mask),
                         num_edges, dim, lanes,
                         static_cast<cudaStream_t>(stream))
}
