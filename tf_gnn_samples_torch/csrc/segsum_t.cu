// K6a: head-major ranked segment-sum.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_segsum_t_kernel`
// (called by `_segsum_t_impl`):
//   out[k, r] = sum_{e: rank_e = r} bf16(m_t[k, e])
// with m_t an f32 [K, E] stream (K attention heads), ranks nondecreasing
// and gap-free, and out an f32 [K, rows] table, zeroed by the caller.
// Every term is rounded to bf16 (the TPU kernel's cast before its one-hot
// MXU dot) and summed in f32.
//
// Bound on the card: bytes (4 bytes a term and a 4-byte rank an edge, one
// add), and at the QM9 batch (E 161,792, K 8: 7.5 MB) so few of them that
// the launch itself shows. In [K, E] the contiguous axis is the edge axis,
// so the segment walk runs ALONG memory. Its earlier design
// (segsum_t_walk.cu, kept as the A/B baseline) gave each (run of 8 edges,
// head) pair a thread: every head's grid row read all E ranks again, and
// every thread ended in at least one atomicAdd. Here:
// * a block owns a chunk of EDGES = 256 edges and stages its ranks in
//   shared memory once; its min(K, 4) warps take the heads in turn, each
//   reading the ranks there (632 blocks of 4 warps at the QM9 batch, one
//   wave on 132 SMs; 2 or 8 warps a block, and loading a warp's next
//   head while it sums one, ran no faster in exploratory runs on the
//   H100);
// * a lane owns the same run of RUN = 8 edges for every head and reads
//   the head's run as two 16-byte loads along the edge axis (E a multiple
//   of 4 and the stream 16-byte aligned; else 4-byte loads, template
//   parameter V false); the warp's first head's loads are issued before
//   the ranks are staged;
// * a lane sums each rank run of its 8 edges in stream order from 0.0f;
//   the partials of a segment that crosses runs are joined by a segmented
//   inclusive scan over the warp (shuffles), and the lane where a segment
//   ends puts its sum in the warp's row buffer in shared memory (the
//   chunk's rows are consecutive: at most 256). The warp then writes the
//   buffer out with coalesced stores; only the chunk's first and last
//   rows, which may continue in a neighbouring chunk, go to atomicAdd:
//   two a (chunk, head), where the earlier design issued at least one a
//   (run, head), and scattered stores.
//
// Sum order: the runs are the earlier design's (8 edges, aligned to
// multiples of 8), each summed in stream order from 0.0f. A segment over
// two runs is the sum of its two partials in either design (one f32 add,
// whose operands commute), so every row whose edges lie in at most two
// runs equals the earlier design's bit for bit. A row over three or more
// runs takes its partials in the scan's tree order here and in atomic
// order there: both are held within the order bound of the plain version.
#include <cstdint>

#include "film_common.cuh"

namespace {

constexpr int RUN = 8;               // consecutive edges a lane owns
constexpr int EDGES = 32 * RUN;      // a block's chunk: one warp's run a head
constexpr int MAX_WARPS = 4;         // warps a block, one head at a time each
constexpr unsigned FULL = 0xffffffffu;

// The n (<= RUN) terms of a run of one head, then zeros. V: n is 0, 4 or 8
// and p 16-byte aligned.
template <bool V>
__device__ __forceinline__ void load_run(const float* p, int n,
                                         float (&v)[RUN]) {
  if (V) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 a = n > 0 ? __ldg(reinterpret_cast<const float4*>(p)) : z;
    const float4 b = n > 4 ? __ldg(reinterpret_cast<const float4*>(p) + 1) : z;
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < RUN; ++u) v[u] = u < n ? __ldg(p + u) : 0.0f;
  }
}

// A block of min(K, MAX_WARPS) warps owns the chunk of EDGES edges
// starting at blockIdx.x * EDGES; warp w sums heads w, w + warps, ...
template <bool V>
__global__ void __launch_bounds__(MAX_WARPS * 32)
segsum_t_kernel(const float* __restrict__ msgs_t, const int* __restrict__ ranks,
                float* __restrict__ out, int num_edges, int rows,
                int num_heads) {
  __shared__ int s_rank[EDGES];
  __shared__ float s_out[MAX_WARPS][EDGES];  // a warp's rows of one head
  const long long e0 = static_cast<long long>(blockIdx.x) * EDGES;
  const int n_blk = static_cast<int>(min(static_cast<long long>(EDGES),
                                         num_edges - e0));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int i0 = lane * RUN;
  const int n = max(0, min(RUN, n_blk - i0));
  const float* m = msgs_t + static_cast<size_t>(e0) + i0;
  // The warp's first head's run, loaded while the ranks are staged.
  float v[RUN];
  load_run<V>(m + static_cast<size_t>(warp) * num_edges, n, v);
  for (int i = threadIdx.x; i < n_blk; i += blockDim.x) {
    s_rank[i] = ranks[e0 + i];
  }
  __syncthreads();
  // The chunk's rows first ... first + rows - 1, relative ranks from here.
  const int first = s_rank[0];
  const int rows_c = s_rank[n_blk - 1] - first + 1;
  int r[RUN];
#pragma unroll
  for (int u = 0; u < RUN; ++u) r[u] = s_rank[min(i0 + u, n_blk - 1)] - first;
  const int hr = r[0], tr = s_rank[min(i0 + max(n, 1) - 1, n_blk - 1)] - first;
  const bool single = hr == tr;  // the run is one segment
  // The run's first segment continues the previous lane's last one; its
  // last segment continues into the next lane's run.
  const bool cont = n > 0 && lane > 0 && s_rank[i0 - 1] - first == hr;
  const bool cont_next =
      n > 0 && i0 + RUN < n_blk && s_rank[i0 + RUN] - first == tr;
  // The scan's chain restarts at every run but one that carries the
  // previous run's last segment through to its own end (lane 0's always).
  const bool reset = !(n > 0 && single && cont);
  float* buf = s_out[warp];
  const int buffered = min(rows_c, EDGES);  // all of them for gap-free ranks
  for (int k = warp; k < num_heads; k += warps) {
    if (k != warp) load_run<V>(m + static_cast<size_t>(k) * num_edges, n, v);
    float* o = out + static_cast<size_t>(k) * rows + first;
    // A chunk sum into the row buffer; a row past it (ranks with gaps,
    // outside the kernel's contract) straight into the table. Rows in a
    // gap keep the buffer's zero.
    const auto put = [&](int x, float val) {
      if (x < EDGES) {
        buf[x] = val;
      } else {
        atomicAdd(o + x, val);
      }
    };
    for (int j = lane; j < buffered; j += 32) buf[j] = 0.0f;
    __syncwarp();
    int cur = hr;
    float acc = 0.0f, head = 0.0f;
    bool in_head = true;
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      if (u >= n) break;
      if (r[u] != cur) {
        if (in_head) {
          head = acc;
          in_head = false;
        } else {
          put(cur, acc);  // a segment wholly inside the run
        }
        cur = r[u];
        acc = 0.0f;
      }
      acc += film::round_bf16(v[u]);
    }
    // Segmented inclusive scan of the runs' last-segment sums over the
    // warp: lane - d's sum is added unless the chain restarted. Lane 0
    // restarts it, so every lane's scan ends at a restart.
    float s = acc;
    bool f = reset;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float s_up = __shfl_up_sync(FULL, s, d);
      const bool f_up = __shfl_up_sync(FULL, static_cast<int>(f), d) != 0;
      if (lane >= d) {
        if (!f) s = s_up + s;
        f = f || f_up;
      }
    }
    const float prev = __shfl_up_sync(FULL, s, 1);  // the previous run's
    if (n > 0) {
      if (!single) put(hr, cont ? prev + head : head);  // ends in the run
      if (!cont_next) put(tr, s);  // the last segment ends with the run
    }
    __syncwarp();
    // Every row of the chunk now holds its chunk sum: written out
    // coalesced, the first and last rows (which may continue in a
    // neighbouring chunk) by atomicAdd.
    for (int j = lane; j < buffered; j += 32) {
      film::flush(o + j, buf[j], j == 0 || j == rows_c - 1);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int segsum_t_launch(const void* msgs_t, const void* ranks, void* out,
                               int num_edges, int rows, int num_heads,
                               void* stream) {
  if (num_edges <= 0 || num_heads <= 0) return 0;
  const dim3 grid((num_edges + EDGES - 1) / EDGES);
  const dim3 block(32 * min(num_heads, MAX_WARPS));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(msgs_t);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  if (num_edges % 4 == 0 && reinterpret_cast<uintptr_t>(msgs_t) % 16 == 0) {
    segsum_t_kernel<true><<<grid, block, 0, s>>>(m, rk, o, num_edges, rows,
                                                 num_heads);
  } else {
    segsum_t_kernel<false><<<grid, block, 0, s>>>(m, rk, o, num_edges, rows,
                                                  num_heads);
  }
  return static_cast<int>(cudaGetLastError());
}
