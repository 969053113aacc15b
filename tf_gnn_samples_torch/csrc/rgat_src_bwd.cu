// K9: the source-order half of the fused RGAT backward.
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_rgat_src_bwd_kernel`
// (called by `_rgat_src_bwd_impl`, in the backward of `rgat_fused_pass`).
// Over the SOURCE-sorted edge stream, with s_e the src rank of edge e, Dh =
// D / K columns per head and k(c) = c / Dh the head of column c:
//   m | lsrc              = t_ext[s_e]       (bf16 [R_src, D + K])
//   dagg | lt | den | cor = row(e)           (bf16, D + 3K wide)
//   pre   = lsrc + lt,  logit = pre > 0 ? pre : 0.2 * pre
//   attn  = exp(min(max(logit, -clamp), clamp)) / (den + 1e-7)
//   draw  = sum_{c in head k} m[c] * dagg[c]                      (f32)
//   dlog  = attn * (draw - cor) * (|logit| < clamp)
//   dpre  = pre > 0 ? dlog : 0.2 * dlog
//   out[s, c]     = sum_{e: s_e = s} bf16(attn[k(c)] * dagg[c])   c < D
//   out[s, D + k] = sum_{e: s_e = s} bf16(dpre[k])
// with out an f32 [R_src, D + K] table, zeroed by the caller. The indicator
// keeps the recompute exact where the forward clamped the logit before exp.
// Two forms, one kernel body:
// * the stream form (the JAX package's inputs): row(e) is row e of a bf16
//   [E, D + 3K] stream gcb. Padded edges and the diluted stream's fill
//   slots read a zero row there: dagg = den = cor = 0, attn = exp(.) /
//   1e-7 stays finite and both terms are exactly zero;
// * the gather form (what the fused RGAT backward calls): row(e) is row
//   f_e = fine[e] of the bf16 [RPAD, D + 3K] side table, and a key outside
//   [0, RPAD) (SD_FILL fill slots) reads nothing and adds exact zeros.
//
// Bound on the card: bytes (the stream form: a 2 (D + 3K)-byte row per
// edge; the gather form: a row per used fine key and a key per edge; both:
// a rank per edge, a 2 (D + K)-byte t row per source group and a
// 4 (D + K)-byte output row per rank). The TPU kernel expands t with a
// windowed one-hot MXU product and sums with another. The earlier design
// (rgat_src_bwd_walk.cu) read each edge's row twice from device memory
// (its phase A for the heads' dots, its phase B for the terms) and walked
// phase B with a thread per output column and 2-byte loads; the caller
// also gathered the [E, D + 3K] stream from the side table every layer.
// Here a block owns one 64-edge chunk and works in three steps:
// * It stages the chunk's rows in shared memory once (16-byte pieces where
//   the rows allow, else 4- or 2-byte ones; a gather-form key outside the
//   table stages a zero row and is marked), with the ranks.
// * Phase A, as before: a thread per (edge, head) pair, PA pairs a thread
//   at once, reads its Dh columns of the staged row and of the source
//   group's t row, reduces draw in f32 over j = 0..Dh-1 in order and
//   leaves attn and dpre in shared memory. The same operations in the
//   same order as the earlier design: attn and dpre, and so every term,
//   equal its bit for bit (the f32 product of two bf16 values is exact,
//   IEEE division and expf, no fast-math, -fmad=false).
// * Phase B: a lane owns PB = 2 consecutive output columns (D / 2 message
//   lanes and ceil(K / 2) dpre lanes, so most of the block's threads take
//   part) and walks the chunk from shared memory alone. Runs of one rank
//   are summed in stream order from 0.0f, interior runs stored, a chunk's
//   first and last runs added by atomicAdd (film_common.cuh), so a row
//   that one or two chunks hold equals the earlier design's bit for bit.
// Staging keeps the second read of each row out of device memory, where
// a design that re-read rows in phase B (lanes of 8 columns, film_rows.cuh)
// ran no faster than the earlier one at the QM9 batch (PERF.md).
#include <cstdint>

#include "film_common.cuh"

namespace {

constexpr int THREADS_K9 = 128;  // threads a block (one 64-edge chunk)
constexpr int PA = 4;            // (edge, head) pairs a thread takes at once
constexpr int PB = 2;            // output columns a phase-B lane owns

__device__ __forceinline__ float lo_bf16(unsigned x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float hi_bf16(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ void word(unsigned m, unsigned g, float& acc) {
  acc += lo_bf16(m) * lo_bf16(g);
  acc += hi_bf16(m) * hi_bf16(g);
}

// The staged row's stride in shared memory: a whole number of 16 bytes.
__host__ __device__ __forceinline__ int staged_cols(int row_cols) {
  return (row_cols + 7) & ~7;
}

// Shared memory of a block: the staged rows, attn and dpre of every
// (edge, head) pair, the ranks and the marks of rows read as zeros.
__host__ __device__ __forceinline__ size_t block_smem(int dim, int num_heads) {
  return static_cast<size_t>(film::CHUNK) *
         (staged_cols(dim + 3 * num_heads) * sizeof(__nv_bfloat16) +
          2 * num_heads * sizeof(float) + 2 * sizeof(int));
}

// MODE 2: 16-byte staging pieces and phase-A loads (Dh and K multiples of
// 8, rows and t rows 16-byte aligned) and 8-byte stores; MODE 1: 4-byte
// staging pieces and 8-byte stores (D and K even, rows 4-byte and out
// 8-byte aligned); MODE 0: 2-byte pieces and 4-byte stores.
template <int MODE, bool GATHER>
__global__ void __launch_bounds__(THREADS_K9)
rgat_src_bwd_rows_kernel(const __nv_bfloat16* __restrict__ gcb,
                         const __nv_bfloat16* __restrict__ side,
                         const int* __restrict__ fine,
                         const __nv_bfloat16* __restrict__ t_ext,
                         const int* __restrict__ ranks,
                         float* __restrict__ out, int num_edges, int dim,
                         int num_heads, int rpad, float clamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_cols = dim + 3 * num_heads, out_cols = dim + num_heads;
  const int ld = staged_cols(row_cols);
  auto* s_row = reinterpret_cast<__nv_bfloat16*>(smem);  // [CHUNK][ld]
  float* s_attn = reinterpret_cast<float*>(s_row + film::CHUNK * ld);
  float* s_dpre = s_attn + film::CHUNK * num_heads;     // [CHUNK][K] each
  int* s_rank = reinterpret_cast<int*>(s_dpre + film::CHUNK * num_heads);
  int* s_zero = s_rank + film::CHUNK;  // 1: the row was read as zeros
  const long long e0 = static_cast<long long>(blockIdx.x) * film::CHUNK;
  const int n = static_cast<int>(
      min(static_cast<long long>(film::CHUNK), num_edges - e0));
  const int tid = threadIdx.x;

  // The chunk's ranks and its rows' sources (null: zeros).
  __shared__ const __nv_bfloat16* s_src[film::CHUNK];
  for (int i = tid; i < n; i += THREADS_K9) {
    s_rank[i] = ranks[e0 + i];
    const __nv_bfloat16* src;
    if constexpr (GATHER) {
      const int f = fine[e0 + i];
      src = static_cast<unsigned int>(f) < static_cast<unsigned int>(rpad)
                ? side + static_cast<size_t>(f) * row_cols
                : nullptr;
    } else {
      src = gcb + static_cast<size_t>(e0 + i) * row_cols;
    }
    s_src[i] = src;
    s_zero[i] = src == nullptr;
  }
  __syncthreads();
  // Stage the rows: consecutive threads take consecutive pieces of a row.
  constexpr int P = MODE == 2 ? 8 : MODE == 1 ? 2 : 1;  // bf16 a piece
  const int pieces = (row_cols + P - 1) / P;
  for (int q = tid; q < n * pieces; q += THREADS_K9) {
    const int i = q / pieces, j = (q - i * pieces) * P;
    const __nv_bfloat16* src = s_src[i];
    __nv_bfloat16* dst = s_row + i * ld + j;
    if (MODE == 2) {
      *reinterpret_cast<uint4*>(dst) =
          src != nullptr ? __ldg(reinterpret_cast<const uint4*>(src + j))
                         : make_uint4(0u, 0u, 0u, 0u);
    } else if (MODE == 1) {
      *reinterpret_cast<unsigned int*>(dst) =
          src != nullptr ? __ldg(reinterpret_cast<const unsigned int*>(src + j))
                         : 0u;
    } else {
      *dst = src != nullptr ? src[j] : __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();
  const int head_dim = dim / num_heads;

  // Phase A: attention weight and logit cotangent of each (edge, head),
  // PA pairs a thread at a time so that their t-row loads overlap.
  const int pairs = n * num_heads;
  for (int p0 = tid; p0 < pairs; p0 += PA * THREADS_K9) {
    const __nv_bfloat16* m[PA];
    const __nv_bfloat16* dg[PA];
    float lsrc[PA], draw[PA];
#pragma unroll
    for (int u = 0; u < PA; ++u) {
      // Past the last pair: the last pair again, computed but not stored.
      const int p = min(p0 + u * THREADS_K9, pairs - 1);
      const int i = p / num_heads, k = p - i * num_heads;
      const __nv_bfloat16* trow =
          t_ext + static_cast<size_t>(s_rank[i]) * out_cols;
      m[u] = trow + k * head_dim;
      dg[u] = s_row + i * ld + k * head_dim;
      lsrc[u] = film::ld(trow + dim + k);
      draw[u] = 0.0f;
    }
    for (int j = 0; j < head_dim; j += MODE == 2 ? 8 : 1) {
#pragma unroll
      for (int u = 0; u < PA; ++u) {
        const __nv_bfloat16* dagg = dg[u] + j;
        if (MODE == 2) {
          const uint4 mv = __ldg(reinterpret_cast<const uint4*>(m[u] + j));
          const uint4 gv = *reinterpret_cast<const uint4*>(dagg);
          word(mv.x, gv.x, draw[u]);
          word(mv.y, gv.y, draw[u]);
          word(mv.z, gv.z, draw[u]);
          word(mv.w, gv.w, draw[u]);
        } else {
          draw[u] += film::ld(m[u] + j) * film::ld(dagg);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PA; ++u) {
      const int p = p0 + u * THREADS_K9;
      if (p >= pairs) break;
      const int i = p / num_heads, k = p - i * num_heads;
      if (GATHER && s_zero[i]) {  // a key outside the table: exact zeros
        s_attn[p] = 0.0f;
        s_dpre[p] = 0.0f;
        continue;
      }
      const __nv_bfloat16* g = s_row + i * ld + dim;
      const float lt = film::ld(g + k);
      const float den = film::ld(g + num_heads + k);
      const float cor = film::ld(g + 2 * num_heads + k);
      const float pre = lsrc[u] + lt;
      const float logit = pre > 0.0f ? pre : 0.2f * pre;
      const float attn =
          expf(fminf(fmaxf(logit, -clamp), clamp)) / (den + 1e-7f);
      float dlog = attn * (draw[u] - cor);
      dlog = dlog * (fabsf(logit) < clamp ? 1.0f : 0.0f);
      s_attn[p] = attn;
      s_dpre[p] = pre > 0.0f ? dlog : 0.2f * dlog;
    }
  }
  __syncthreads();

  // Phase B: per-rank sums of the bf16-rounded terms from shared memory,
  // a lane per PB columns.
  const int dl = (dim + PB - 1) / PB, kl = (num_heads + PB - 1) / PB;
  const int first = s_rank[0];
  for (int item = tid; item < dl + kl; item += THREADS_K9) {
    const bool msg = item < dl;
    const int c = msg ? item * PB : (item - dl) * PB;  // column of its part
    const int valid = min(PB, (msg ? dim : num_heads) - c);
    const int k0 = c / head_dim, k1 = min(c + 1, dim - 1) / head_dim;
    float* o = out + (msg ? c : dim + c);
    int cur = first;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush2<MODE != 0>(o + static_cast<size_t>(cur) * out_cols, a0, a1,
                          valid, cur == first);
        cur = r;
        a0 = a1 = 0.0f;
      }
      float t0, t1;
      if (msg) {
        const float* a = s_attn + i * num_heads;
        const __nv_bfloat16* g = s_row + i * ld + c;
        t0 = a[k0] * film::ld(g);
        t1 = a[k1] * film::ld(g + 1);
      } else {
        const float* dp = s_dpre + i * num_heads + c;
        t0 = dp[0];
        t1 = valid > 1 ? dp[1] : 0.0f;
      }
      a0 += film::round_bf16(t0);
      a1 += film::round_bf16(t1);
    }
    film::flush2<MODE != 0>(o + static_cast<size_t>(cur) * out_cols, a0, a1, valid,
                      true);
  }
}

template <int MODE>
int launch_mode(bool gather, dim3 grid, size_t smem, cudaStream_t s,
                const __nv_bfloat16* g, const __nv_bfloat16* side,
                const int* fine, const __nv_bfloat16* t, const int* rk,
                float* o, int num_edges, int dim, int num_heads, int rpad,
                float clamp) {
  const dim3 block(THREADS_K9);
  if (gather) {
    return film::launch_smem(rgat_src_bwd_rows_kernel<MODE, true>, grid,
                             block, smem, s, g, side, fine, t, rk, o,
                             num_edges, dim, num_heads, rpad, clamp);
  }
  return film::launch_smem(rgat_src_bwd_rows_kernel<MODE, false>, grid, block,
                           smem, s, g, side, fine, t, rk, o, num_edges, dim,
                           num_heads, rpad, clamp);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// The stream form passes gcb and null side and fine; the gather form a
// null gcb. dim must be a multiple of num_heads, and a block's shared
// memory (block_smem) at most the 227 KB an SM gives a block.
extern "C" int rgat_src_bwd_launch(const void* gcb, const void* side,
                                   const void* fine, const void* t_ext,
                                   const void* ranks, void* out,
                                   int num_edges, int dim, int num_heads,
                                   int rpad, float clamp, void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  const size_t smem = block_smem(dim, num_heads);
  if (num_heads <= 0 || dim % num_heads != 0 || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool gather = gcb == nullptr;
  const void* rows = gather ? side : gcb;
  const dim3 grid(static_cast<unsigned int>(
      (num_edges + film::CHUNK - 1) / film::CHUNK));
  const int row_cols = dim + 3 * num_heads, out_cols = dim + num_heads;
  const auto* g = static_cast<const __nv_bfloat16*>(gcb);
  const auto* sd = static_cast<const __nv_bfloat16*>(side);
  const auto* f = static_cast<const int*>(fine);
  const auto* t = static_cast<const __nv_bfloat16*>(t_ext);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if ((dim / num_heads) % 8 == 0 && num_heads % 8 == 0 &&
      aligned(rows, 16) && aligned(t_ext, 16) && aligned(out, 8)) {
    return launch_mode<2>(gather, grid, smem, s, g, sd, f, t, rk, o,
                          num_edges, dim, num_heads, rpad, clamp);
  }
  if (dim % 2 == 0 && num_heads % 2 == 0 && aligned(rows, 4) &&
      aligned(out, 8)) {
    return launch_mode<1>(gather, grid, smem, s, g, sd, f, t, rk, o,
                          num_edges, dim, num_heads, rpad, clamp);
  }
  return launch_mode<0>(gather, grid, smem, s, g, sd, f, t, rk, o, num_edges,
                        dim, num_heads, rpad, clamp);
}
