// K12b: backward of the fused activate-aggregate (K12a), one launch over
// all of a layer's type slices.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_act_agg_bwd_kernel`
// (called by `_act_agg_bwd_impl`, the VJP of `act_ranked_aggregate`):
//   dmsg[e, d] = bf16(act'(float(m[e, d])) * float(g[rank_e, d]))
// with m a bf16 [E, D] stream, g the bf16 [rows, D] table cotangent, ranks
// int32 [E] below rows and dmsg a bf16 [E, D] stream. act' is recomputed in
// f32 from the bf16 message (no activation residual is kept), the product
// is taken in f32 and rounded once. No reduction, so no atomics: every
// dmsg element is written once, by the same arithmetic as the earlier
// body's (act_agg_bwd_per_slice.cu), so the two agree bit for bit.
//
// GNN-Edge-MLP1 calls it on each streamed edge type's slice of the
// type-major stream, all against the one cotangent table. Its earlier
// design took one launch a slice: a layer paid a launch, a wrapper call
// and a sub-wave tail per streamed type (22 on VarMisuse, whose slices of
// 4,000-40,000 edges are each under a wave of the card at D 128). Here one
// launch takes up to MAX_SLICES slices, as K12a (act_agg.cu) does: their
// message, rank and output pointers and edge counts ride in one
// __grid_constant__ parameter struct with each slice's first block, and a
// block finds its slice there. The grid is the layer's total work, a
// block per 256 slots of a slice, with no cap: only the last block of
// each slice is partial.
//
// Bound on the card: bytes, and close to the instruction rate for gelu'
// (about 50 instructions an element with its IEEE division and two expf,
// some 0.07 ms at VarMisuse's 38 million elements, beside 0.06 ms of
// bytes). Each edge reads a 2D-byte message row and a 4-byte rank and
// writes a 2D-byte row; each used cotangent row is read (from L2 after
// its first edge: the ranks are sorted). The TPU kernel expands the table
// with windowed one-hot MXU products against a VMEM-resident table; here
// a thread owns one slot of 8 columns of one slice's [E_l, D] output (16
// bytes of each bf16 operand; N = 8), so loads and stores are contiguous
// and coalesced and the threads of a warp read one or two ranks; single
// columns (N = 1) when D is not a multiple of 8 or a pointer is not
// 16-byte aligned, decided once for the launch.
//
// Occupancy: 256 threads a block and no minimum of blocks an SM: one slot
// a thread keeps registers near 32, so 8 blocks (2,048 threads, the SM's
// most) fit, each thread with its two 16-byte loads in flight. A first
// form gave each thread 4 slots whose loads it issued before computing
// any: with gelu' on 8 columns a slot it spilled at 64 registers and
// held 4 blocks an SM.
#include "film_common.cuh"

#include <climits>
#include <cstdint>

namespace {

constexpr int MAX_SLICES = 32;  // slices one launch takes (ACT_AGG_MAX_SLICES)
constexpr int THREADS = 256;    // slots a block

// The non-empty slices of one launch; block0[s] is slice s's first block
// of the grid, block0[count] the grid's size.
struct Slices {
  const __nv_bfloat16* msgs[MAX_SLICES];
  const int* ranks[MAX_SLICES];
  __nv_bfloat16* dmsg[MAX_SLICES];
  int num_edges[MAX_SLICES];
  int block0[MAX_SLICES + 1];
  int count;
};

template <int N>
struct alignas(2 * N) Bf16xN {
  __nv_bfloat16 v[N];
};

template <int ACT, int N>
__global__ void __launch_bounds__(THREADS)
act_agg_bwd_slices_kernel(const __grid_constant__ Slices sl,
                          const __nv_bfloat16* __restrict__ g, int dim) {
  using V = Bf16xN<N>;
  const int b = static_cast<int>(blockIdx.x);
  int s = 0;
  while (s + 1 < sl.count && b >= sl.block0[s + 1]) ++s;
  const int width = dim / N;  // slots a row
  const long long total = static_cast<long long>(sl.num_edges[s]) * width;
  const long long j =
      static_cast<long long>(b - sl.block0[s]) * THREADS + threadIdx.x;
  if (j >= total) return;
  // The slot's row: a 32-bit division where the slice's slots fit in 31
  // bits (the same for the whole block).
  const long long r =
      total <= INT_MAX
          ? static_cast<long long>(static_cast<unsigned int>(j) /
                                   static_cast<unsigned int>(width))
          : j / width;
  const long long rank = __ldg(sl.ranks[s] + r);
  const V mv = reinterpret_cast<const V*>(sl.msgs[s])[j];
  const V gv = reinterpret_cast<const V*>(g)[rank * width + (j - r * width)];
  V o;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    o.v[k] = __float2bfloat16_rn(film::dact<ACT>(__bfloat162float(mv.v[k])) *
                                 __bfloat162float(gv.v[k]));
  }
  reinterpret_cast<V*>(sl.dmsg[s])[j] = o;
}

template <int ACT>
int launch(const Slices& sl, const __nv_bfloat16* g, int dim, bool vec,
           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(sl.block0[sl.count]));
  if (vec) {
    act_agg_bwd_slices_kernel<ACT, 8><<<grid, THREADS, 0, s>>>(sl, g, dim);
  } else {
    act_agg_bwd_slices_kernel<ACT, 1><<<grid, THREADS, 0, s>>>(sl, g, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Host arrays of `num_slices` (at most MAX_SLICES) message, rank and
// output pointers and edge counts, all against the one cotangent table
// `g`; empty slices are skipped, and nothing is launched where every slice
// is empty. One launch otherwise.
extern "C" int act_agg_bwd_slices_launch(const void* const* msgs,
                                         const void* const* ranks,
                                         void* const* dmsg,
                                         const int* num_edges, int num_slices,
                                         const void* g, int dim, int act,
                                         void* stream) {
  if (num_slices < 0 || num_slices > MAX_SLICES || dim <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Slices sl = {};
  bool vec = dim % 8 == 0 && aligned16(g);
  for (int i = 0; i < num_slices; ++i) {
    if (num_edges[i] <= 0) continue;
    vec = vec && aligned16(msgs[i]) && aligned16(dmsg[i]);
  }
  const long long width = vec ? dim / 8 : dim;
  long long blocks = 0;
  for (int i = 0; i < num_slices; ++i) {
    if (num_edges[i] <= 0) continue;
    const int j = sl.count++;
    sl.msgs[j] = static_cast<const __nv_bfloat16*>(msgs[i]);
    sl.ranks[j] = static_cast<const int*>(ranks[i]);
    sl.dmsg[j] = static_cast<__nv_bfloat16*>(dmsg[i]);
    sl.num_edges[j] = num_edges[i];
    sl.block0[j] = static_cast<int>(blocks);
    blocks += (num_edges[i] * width + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sl.count == 0) return 0;
  sl.block0[sl.count] = static_cast<int>(blocks);
  FILM_DISPATCH_ACT_CALL(act, launch, sl, static_cast<const __nv_bfloat16*>(g),
                         dim, vec, static_cast<cudaStream_t>(stream))
}
