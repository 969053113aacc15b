// K9's earlier design: the source-order half of the fused RGAT backward
// over the [E, D+3K] stream, a thread per output column walking a 64-edge
// chunk in its phase B. rgat_src_bwd.cu (each chunk's rows staged in
// shared memory once, and a gather form that reads the side table through
// fine keys) replaced it on every model path; this body stays, unchanged,
// as the baseline that the redesign is held and timed against
// (tools/earlier_designs.py; launches counted under "rgat_src_bwd_walk", 0
// on every path).
//
// Replaces tf_gnn_samples_tpu/ops/ranked_segment.py `_rgat_src_bwd_kernel`
// (called by `_rgat_src_bwd_impl`, in the backward of `rgat_fused_pass`).
// Over the SOURCE-sorted edge stream, with s_e the src rank of edge e, Dh =
// D / K columns per head and k(c) = c / Dh the head of column c:
//   m | lsrc              = t_ext[s_e]       (bf16 [R_src, D + K])
//   dagg | lt | den | cor = gcb[e]           (bf16 [E, D + 3K])
//   pre   = lsrc + lt,  logit = pre > 0 ? pre : 0.2 * pre
//   attn  = exp(min(max(logit, -clamp), clamp)) / (den + 1e-7)
//   draw  = sum_{c in head k} m[c] * dagg[c]                      (f32)
//   dlog  = attn * (draw - cor) * (|logit| < clamp)
//   dpre  = pre > 0 ? dlog : 0.2 * dlog
//   out[s, c]     = sum_{e: s_e = s} bf16(attn[k(c)] * dagg[c])   c < D
//   out[s, D + k] = sum_{e: s_e = s} bf16(dpre[k])
// with out an f32 [R_src, D + K] table, zeroed by the caller. The indicator
// keeps the recompute exact where the forward clamped the logit before exp.
// Padded edges and the diluted stream's fill slots need no mask: their gcb
// row is zero, so dagg = den = cor = 0, attn = exp(.) / 1e-7 stays finite
// and both terms are exactly zero.
//
// Bound on the card: bytes (a 2 (D + 3K)-byte stream row per edge, a
// 2 (D + K)-byte t row and a 4 (D + K)-byte output row per source group).
// The TPU kernel expands t with a windowed one-hot MXU product and sums
// with another; here a block owns CHUNK consecutive edges and works in two
// phases. Phase A gives each (edge, head) pair a thread that reads its Dh
// columns of the edge's gcb row and of the source group's t row (16-byte
// pieces where the rows allow), reduces draw in f32 and leaves attn and
// dpre in shared memory. Phase B is the sorted-rank segment walk of
// film_common.cuh with a thread per output column: coalesced row reads, a
// running f32 sum while the rank is unchanged, atomics only for a chunk's
// first and last segments, which may continue in a neighbouring chunk.
// IEEE division and expf (no fast-math), built with -fmad=false.
#include "film_common.cuh"

#include <cstdint>

namespace {

constexpr int MAX_THREADS = 256;

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

template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
rgat_src_bwd_kernel(const __nv_bfloat16* __restrict__ gcb,
                    const __nv_bfloat16* __restrict__ t_ext,
                    const int* __restrict__ ranks, float* __restrict__ out,
                    int num_edges, int dim, int num_heads, float clamp) {
  __shared__ int s_rank[film::CHUNK];
  extern __shared__ float smem[];
  float* s_attn = smem;                               // [CHUNK][num_heads]
  float* s_dpre = smem + film::CHUNK * num_heads;     // [CHUNK][num_heads]
  const int n = film::load_chunk_ranks(ranks, num_edges, s_rank);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * film::CHUNK;
  const int head_dim = dim / num_heads;
  const int gcb_cols = dim + 3 * num_heads, out_cols = dim + num_heads;

  // Phase A: attention weight and logit cotangent of each (edge, head).
  for (int p = threadIdx.x; p < n * num_heads; p += blockDim.x) {
    const int i = p / num_heads, k = p % num_heads;
    const __nv_bfloat16* grow = gcb + (e0 + i) * gcb_cols;
    const __nv_bfloat16* trow = t_ext + static_cast<size_t>(s_rank[i]) * out_cols;
    const __nv_bfloat16* m = trow + k * head_dim;
    const __nv_bfloat16* dagg = grow + k * head_dim;
    float draw = 0.0f;
    if (VEC) {
      for (int j = 0; j < head_dim; j += 8) {
        const uint4 mv = *reinterpret_cast<const uint4*>(m + j);
        const uint4 gv = *reinterpret_cast<const uint4*>(dagg + j);
        word(mv.x, gv.x, draw);
        word(mv.y, gv.y, draw);
        word(mv.z, gv.z, draw);
        word(mv.w, gv.w, draw);
      }
    } else {
      for (int j = 0; j < head_dim; ++j) {
        draw += film::ld(m + j) * film::ld(dagg + j);
      }
    }
    const float lsrc = film::ld(trow + dim + k);
    const float lt = film::ld(grow + dim + k);
    const float den = film::ld(grow + dim + num_heads + k);
    const float cor = film::ld(grow + dim + 2 * num_heads + k);
    const float pre = lsrc + lt;
    const float logit = pre > 0.0f ? pre : 0.2f * pre;
    const float attn = expf(fminf(fmaxf(logit, -clamp), clamp)) / (den + 1e-7f);
    float dlog = attn * (draw - cor);
    dlog = dlog * (fabsf(logit) < clamp ? 1.0f : 0.0f);
    s_attn[p] = attn;
    s_dpre[p] = pre > 0.0f ? dlog : 0.2f * dlog;
  }
  __syncthreads();

  // Phase B: per-rank sums of the bf16-rounded terms, a thread per column.
  const int first = s_rank[0];
  for (int c = threadIdx.x; c < out_cols; c += blockDim.x) {
    const bool is_msg = c < dim;
    const int k = is_msg ? c / head_dim : c - dim;
    int cur = first;
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int r = s_rank[i];
      if (r != cur) {
        film::flush(out + static_cast<size_t>(cur) * out_cols + c, acc,
                    cur == first);
        cur = r;
        acc = 0.0f;
      }
      const float term =
          is_msg ? s_attn[i * num_heads + k] *
                       film::ld(gcb + (e0 + i) * gcb_cols + c)
                 : s_dpre[i * num_heads + k];
      acc += film::round_bf16(term);
    }
    atomicAdd(out + static_cast<size_t>(cur) * out_cols + c, acc);
  }
}

}  // namespace

// dim must be a multiple of num_heads; 2 * CHUNK * num_heads floats must fit
// the 48 KB of shared memory a block gets without opting in (the wrapper
// checks both).
extern "C" int rgat_src_bwd_walk_launch(const void* gcb, const void* t_ext,
                                        const void* ranks, void* out,
                                        int num_edges, int dim,
                                        int num_heads, float clamp,
                                        void* stream) {
  if (num_edges <= 0 || dim <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(film::CHUNK) * num_heads * sizeof(float);
  if (num_heads <= 0 || dim % num_heads != 0 ||
      smem + film::CHUNK * sizeof(int) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* g = static_cast<const __nv_bfloat16*>(gcb);
  const auto* t = static_cast<const __nv_bfloat16*>(t_ext);
  const auto* rk = static_cast<const int*>(ranks);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int cols = dim + num_heads;
  const dim3 grid = film::grid_for(num_edges);
  const dim3 block(cols < MAX_THREADS ? ((cols + 31) / 32) * 32 : MAX_THREADS);
  // 16-byte pieces need head slices and rows of both inputs that start on
  // 16 bytes.
  const bool vec = (dim / num_heads) % 8 == 0 && num_heads % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(gcb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(t_ext) % 16 == 0;
  if (vec) {
    rgat_src_bwd_kernel<true><<<grid, block, smem, s>>>(
        g, t, rk, o, num_edges, dim, num_heads, clamp);
  } else {
    rgat_src_bwd_kernel<false><<<grid, block, smem, s>>>(
        g, t, rk, o, num_edges, dim, num_heads, clamp);
  }
  return static_cast<int>(cudaGetLastError());
}
