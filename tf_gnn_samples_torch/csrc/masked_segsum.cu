// K15b: ranked segment-sum of a stream scaled by its packed sign mask.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_masked_segsum_kernel`
// (called by `_masked_segsum_impl`):
//   out[r, d] = sum_{e: rank_e = r} bf16(C[e, d] * factor(bit(e, d)))
// with C a bf16 [E, D] stream, bit(e, d) bit d mod 16 of the exact integer
// in lane d / 16 of the f32 [E, lanes] mask that K15a writes, factor(b) =
// leak + (1 - leak) * b (b itself for relu's leak 0; 0.2 or 1 for
// leaky_relu's 0.2), ranks nondecreasing (the src-sorted stream) and out
// an f32 [table_rows, D] table. The product is taken in f32, rounded to
// bf16 and summed in f32, as the TPU kernel does before and after its
// one-hot MXU dot.
//
// Bound on the card: bytes (a 2D-byte C row, the ceil(D / 16) used mask
// lanes and a 4-byte rank per edge, and the whole f32 table once; a
// shift, a multiply and an add per element). At the QM9 batch the table
// is 83 MB of the 130 MB. The earlier design (masked_segsum_walk.cu) gave
// each column a thread and added a chunk's first and last runs by
// atomicAdd, so the caller zeroed the table first: a second 83 MB write.
// Here the kernels write every row of the table exactly once, with plain
// stores, and the caller allocates it uninitialised:
//
// * masked_segsum_kernel walks the rows as K1 does (film_rows.cuh): a
//   lane owns 8 columns of one 64-edge chunk, loads C rows 16 bytes at a
//   time and issues the next AHEAD edges' C rows and mask words before
//   their sums. Items are numbered over D rounded up to 16 columns, as in
//   K15a (film_fwd_mask.cu), so a mask lane's two column lanes are an
//   even lane and the next one of one warp and read one 4-byte word; a
//   pad lane past D (ceil(D / 8) odd) does nothing. Each rank run of the
//   chunk is summed in stream order from 0.0f. A run wholly inside the
//   chunk is stored to its row. A run that continues from the previous
//   chunk (the chunk's first run) or into the next one (its last run) is
//   stored, as this chunk's partial, into a side buffer of two rows a
//   chunk (lead: the first run's, trail: the last run's). A lane also
//   stores exact zeros into the rows between two neighbouring ranks of its
//   chunk (a gap: outside the contract, but the diluted src stream's
//   checks write it), and between the previous chunk's last rank and its
//   first. The blocks together zero the rows before the first rank and
//   after the last, up to table_rows (57,153 rows at the QM9 batch),
//   16-byte stores spread over the grid.
// * masked_segsum_join_kernel then writes each row that crosses a chunk
//   boundary: the lane of the chunk where the run starts adds its trail
//   partial and each following chunk's lead partial, in chunk order
//   (past the next chunk, JOIN_AHEAD partials and ranks loaded before
//   their adds, volatile so that the compiler keeps them ahead).
//   A run of one chunk and the next (at most two partials, whose f32 sum
//   does not depend on their order) thus equals the earlier design's
//   atomic sum bit for bit, as does every row one chunk holds; a run over
//   three or more chunks is added in chunk order, the same on every run.
//   The owner walks partials, not edges: the QM9 batch's padded tail is
//   one rank run of 8,315 edges (130 chunks), whose owner reads 130
//   partials, 16 a round trip, where walking the edges it would read
//   8,315 C rows, 8 a round trip.
//
// No tensor cores: the kernels form no matrix product.
#include "film_rows.cuh"

namespace {

constexpr int GROUP = 16;       // sign bits a mask lane holds
constexpr int AHEAD = 8;        // edges whose loads a lane issues first
constexpr int JOIN_AHEAD = 16;  // partials a long run's join loads at once

__host__ __device__ __forceinline__ int round16(int d) {
  return (d + GROUP - 1) / GROUP * GROUP;
}

// 8 (or `valid`) f32 values of a partial: two 16-byte loads with V
// (volatile with VOL: a long run's loads then all stay ahead of their
// adds, where the compiler would move most of them down to their uses,
// one latency after another), else `valid` 4-byte loads and zeros after
// them.
template <bool V, bool VOL = false>
__device__ __forceinline__ void load8_f32(const float* p, int valid,
                                          float (&v)[VEC]) {
  if (V) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      if (VOL) {
        asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v[k]), "=f"(v[k + 1]), "=f"(v[k + 2]),
                       "=f"(v[k + 3])
                     : "l"(p + k));
      } else {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(p + k));
        v[k] = a.x; v[k + 1] = a.y; v[k + 2] = a.z; v[k + 3] = a.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = k < valid ? __ldcg(p + k) : 0.0f;
  }
}

// A rank, loaded as load8_f32<V, true> loads (volatile).
__device__ __forceinline__ int load_rank_vol(const int* p) {
  int r;
  asm volatile("ld.volatile.global.s32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}

// Stores exact zeros into rows [lo, hi) of the lane's columns.
template <bool V>
__device__ __forceinline__ void zero_rows(float* out, int lo, int hi,
                                          int dim, int c, int valid) {
  const float zero[VEC] = {};
  for (int r = lo; r < hi; ++r) {
    flush8<V>(out + static_cast<size_t>(r) * dim + c, zero, valid, false);
  }
}

// The grid's share of the rows that no lane's walk reaches: those before
// the first rank and those after the last, up to table_rows (contiguous
// floats at both ends of the table), 16-byte stores with V.
template <bool V>
__device__ __forceinline__ void zero_ends(const int* __restrict__ ranks,
                                          float* __restrict__ out,
                                          int num_edges, int dim,
                                          int table_rows) {
  const long long head = static_cast<long long>(__ldg(ranks)) * dim;
  const long long tail0 =
      (static_cast<long long>(__ldg(ranks + num_edges - 1)) + 1) * dim;
  const long long tail = static_cast<long long>(table_rows) * dim - tail0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (V) {
    float4* o = reinterpret_cast<float4*>(out);
    const long long h = head / 4, n = h + (tail > 0 ? tail / 4 : 0);
    for (long long i = start; i < n; i += step) {
      o[i < h ? i : tail0 / 4 + (i - h)] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const long long n = head + (tail > 0 ? tail : 0);
    for (long long i = start; i < n; i += step) {
      out[i < head ? i : tail0 + (i - head)] = 0.0f;
    }
  }
}

template <bool V>
__global__ void __launch_bounds__(THREADS)
masked_segsum_kernel(const float* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ c,
                     const int* __restrict__ ranks, float* __restrict__ side,
                     float* __restrict__ out, int num_edges, int dim,
                     int lanes, int table_rows, float leak) {
  extern __shared__ int s_rank[];
  zero_ends<V>(ranks, out, num_edges, dim, table_rows);
  Item it;
  if (!load_item_at(blockIdx.x, ranks, num_edges, round16(dim), s_rank, it)) {
    return;
  }
  it.valid = min(VEC, dim - it.c);
  if (it.valid <= 0) return;  // a pad lane of the last mask group
  const size_t chunk = it.e0 / film::CHUNK;
  const size_t chunks = (num_edges + film::CHUNK - 1) / film::CHUNK;
  float* lead = side + chunk * dim + it.c;
  float* trail = side + (chunks + chunk) * dim + it.c;
  const int first = it.rk[0];
  const int prev = it.e0 > 0 ? __ldg(ranks + it.e0 - 1) : -1;
  const int next = it.e0 + it.n < static_cast<size_t>(num_edges)
                       ? __ldg(ranks + it.e0 + it.n)
                       : -1;
  const bool continued = prev == first;
  if (it.e0 > 0) zero_rows<V>(out, prev + 1, first, dim, it.c, it.valid);
  const float rise = 1.0f - leak;
  const int shift = it.c % GROUP;  // 0 or 8: the lane's half of its group
  const float* m_col = mask + it.e0 * lanes + it.c / GROUP;
  const __nv_bfloat16* c_col = c + it.e0 * dim + it.c;
  int cur = first;
  bool first_run = true;
  float acc[VEC] = {};
#pragma unroll 1
  for (int i0 = 0; i0 < it.n; i0 += AHEAD) {
    int r[AHEAD];
    uint4 cv[AHEAD];
    float mw[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      // Past the chunk's end: the last edge again, loaded but not summed.
      const int i = min(i0 + u, it.n - 1);
      r[u] = it.rk[i];
      cv[u] = load8<V>(c_col + static_cast<size_t>(i) * dim, it.valid);
      mw[u] = __ldg(m_col + static_cast<size_t>(i) * lanes);
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (i0 + u >= it.n) break;
      if (r[u] != cur) {
        // The run that ended: the continued first run is this chunk's
        // lead partial, any other is its row's whole sum.
        flush8<V>(first_run && continued
                      ? lead
                      : out + static_cast<size_t>(cur) * dim + it.c,
                  acc, it.valid, false);
        zero_rows<V>(out, cur + 1, r[u], dim, it.c, it.valid);
        first_run = false;
        cur = r[u];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
      }
      const int packed = static_cast<int>(mw[u]) >> shift;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float bit = static_cast<float>((packed >> k) & 1);
        const float factor = leak + rise * bit;
        acc[k] += film::round_bf16(bf(cv[u], k) * factor);
      }
    }
  }
  // The chunk's last run: its lead partial if it is the continued first
  // run, its trail partial if it goes on into the next chunk, else its row.
  flush8<V>(first_run && continued
                ? lead
                : next == cur ? trail
                              : out + static_cast<size_t>(cur) * dim + it.c,
            acc, it.valid, false);
}

template <bool V>
__global__ void __launch_bounds__(THREADS)
masked_segsum_join_kernel(const int* __restrict__ ranks,
                          const float* __restrict__ side,
                          float* __restrict__ out, int num_edges, int dim) {
  const int slots = (dim + VEC - 1) / VEC;
  const long long chunks = (num_edges + film::CHUNK - 1) / film::CHUNK;
  const long long item = static_cast<long long>(blockIdx.x) * THREADS +
                         threadIdx.x;
  const long long a = item / slots;
  // The last chunk's runs continue into no chunk.
  if (a >= chunks - 1) return;
  const int col = static_cast<int>(item - a * slots) * VEC;
  const int valid = min(VEC, dim - col);
  const long long end = (a + 1) * film::CHUNK;  // chunk a + 1's first edge
  const int r = __ldg(ranks + end - 1);
  // Chunk a owns the row if its last run goes on into chunk a + 1 and
  // did not begin in an earlier chunk.
  if (__ldg(ranks + end) != r) return;
  if (a > 0 && __ldg(ranks + a * film::CHUNK - 1) == r) return;
  const float* lead = side + col;
  // Chunk a + 1 holds the run's next part; most runs end in it.
  long long j = a + 1;
  float tot[VEC], p[VEC];
  load8_f32<V>(side + (chunks + a) * dim + col, valid, tot);
  load8_f32<V>(lead + j * dim, valid, p);
  bool more = j + 1 < chunks && __ldg(ranks + (j + 1) * film::CHUNK) == r;
#pragma unroll
  for (int k = 0; k < VEC; ++k) tot[k] += p[k];
  // A run over three or more chunks: the next JOIN_AHEAD partials at a
  // time, all loaded before any is added. Those past the run's end add
  // +0.0f, which leaves tot as it is (a sum from +0.0f is never -0.0f).
#pragma unroll 1
  while (more) {
    ++j;
    float q[JOIN_AHEAD][VEC];
    int nx[JOIN_AHEAD];
#pragma unroll
    for (int u = 0; u < JOIN_AHEAD; ++u) {
      // Past the last chunk: the last chunk again, loaded but not added.
      const long long jj = min(j + u, chunks - 1);
      load8_f32<V, true>(lead + jj * dim, valid, q[u]);
      nx[u] = load_rank_vol(ranks + min(jj + 1, chunks - 1) * film::CHUNK);
      if (jj + 1 >= chunks) nx[u] = -1;
    }
    // Chunks j .. j + live - 1 hold the run: each but the last goes on
    // into the next.
    int live = JOIN_AHEAD;
#pragma unroll
    for (int u = JOIN_AHEAD - 1; u >= 0; --u) {
      if (nx[u] != r) live = u + 1;
    }
#pragma unroll
    for (int u = 0; u < JOIN_AHEAD; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) tot[k] += u < live ? q[u][k] : 0.0f;
    }
    more = live == JOIN_AHEAD && nx[JOIN_AHEAD - 1] == r;
    j += JOIN_AHEAD - 1;
  }
  flush8<V>(out + static_cast<size_t>(r) * dim + col, tot, valid, false);
}

template <bool V>
int launch(const float* mask, const __nv_bfloat16* c, const int* ranks,
           float* side, float* out, int num_edges, int dim, int lanes,
           int table_rows, float leak, cudaStream_t s) {
  const int dim16 = round16(dim);
  const int err = film::launch_smem(
      masked_segsum_kernel<V>, rows_grid(num_edges, dim16), dim3(THREADS),
      rows_smem(dim16), s, mask, c, ranks, side, out, num_edges, dim, lanes,
      table_rows, leak);
  if (err != 0) return err;
  const long long items =
      static_cast<long long>((num_edges + film::CHUNK - 1) / film::CHUNK) *
      ((dim + VEC - 1) / VEC);
  masked_segsum_join_kernel<V>
      <<<static_cast<unsigned int>((items + THREADS - 1) / THREADS), THREADS,
         0, s>>>(ranks, side, out, num_edges, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// side: f32 [2 * ceil(num_edges / 64), dim] scratch (the chunks' lead and
// trail partials); out: f32 [table_rows, dim], every row of which the
// launch writes. lanes must be at least ceil(dim / 16), ranks below
// table_rows (the wrapper checks the shapes).
extern "C" int masked_segsum_launch(const void* mask, const void* c,
                                    const void* ranks, void* side, void* out,
                                    int num_edges, int dim, int lanes,
                                    int table_rows, float leak, void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  if (lanes < (dim + GROUP - 1) / GROUP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* m = static_cast<const float*>(mask);
  const auto* cc = static_cast<const __nv_bfloat16*>(c);
  const auto* rk = static_cast<const int*>(ranks);
  auto* sd = static_cast<float*>(side);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dim % VEC == 0 && aligned16(c) && aligned16(side) && aligned16(out)) {
    return launch<true>(m, cc, rk, sd, o, num_edges, dim, lanes, table_rows,
                        leak, s);
  }
  return launch<false>(m, cc, rk, sd, o, num_edges, dim, lanes, table_rows,
                       leak, s);
}
