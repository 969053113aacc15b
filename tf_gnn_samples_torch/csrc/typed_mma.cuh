// The typed product tile of K10a and K10b (typed_dense_agg.cu,
// typed_dense_agg_bwd.cu): bf16 products summed in f32 on Hopper's tensor
// cores by warp-level `mma.sync.aligned.m16n8k16` fed from shared memory by
// `ldmatrix`, and the per-chunk order of edges by type that lets a chunk of
// a receiver-sorted stream, whose edges mix up to 8 types, run each type's
// rows against that type's weights only.
//
// A warp computes a 16 x (8 NJ) tile of C = A B (NJ m16n8 accumulator
// tiles) over K = 16 k_steps. A is 16 rows of bf16 in shared memory, each
// lane naming the row it loads (row lane % 16), so a tile may take its rows
// from anywhere in a staged chunk; B is a [K][N] block (rows k, n
// contiguous; `ldmatrix.trans`) or an [N][K] block (rows n, k contiguous;
// plain `ldmatrix`, e.g. W read as W^T). Row strides are multiples of 8
// elements (16 bytes), and 8 more than the row so that the 8 rows one
// 8 x 8 matrix load reads fall in 8 different bank groups.
//
// Accumulator layout (PTX ISA, mma.m16n8k16 f32): lane l holds acc[0],
// acc[1] at row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of its 16 x 8
// tile, and acc[2], acc[3] at row l / 4 + 8, the same columns.
//
// The tensor cores sum a k-step's 16 exact products into the accumulator
// in an order of their own, aligning to the largest addend and truncating
// (not rounding to nearest) the bits shifted out; chip_smoke.py's K10 check
// holds the results to the f64 product within 2^-22 of sum |a_k b_k| per
// term, whatever the order. cp.async copies (global to shared, 16 bytes)
// stage weights and rows without holding registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tmma {

constexpr int MAX_TYPES = 8;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 name the rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two matrices; lanes 0-15 name the rows (the others' addresses unused).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// acc += A (16 x 16, row-major fragments) B (16 x 8, column fragments).
// Not volatile: the compiler may issue the next k-step's ldmatrix ahead.
__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte copy from global to shared memory that does not wait (sm_80+);
// cp_async_wait_all waits for the thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  }
}

// acc += A B for a 16-row tile of NJ x 8 columns (NJ even): `a_row` is
// this lane's A row (row lane % 16 of the tile) at k = 0, `b` the [K][N]
// block at (k = 0, the tile's first column) with row stride ldb.
template <int NJ>
__device__ __forceinline__ void tile_kn(float (&acc)[NJ][4],
                                        const __nv_bfloat16* a_row,
                                        const __nv_bfloat16* b, int ldb,
                                        int k_steps) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a = a_row + (lane >> 4) * 8;
  const __nv_bfloat16* bl = b + (lane & 15) * ldb + (lane >> 4) * 8;
#pragma unroll 2
  for (int ks = 0; ks < k_steps; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, a + ks * 16);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, bl + static_cast<size_t>(ks) * 16 * ldb + j * 8);
      mma(acc[j], af, bf[0], bf[1]);
      mma(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// The same with B an [N][K] block (row n, k contiguous) at (the tile's
// first column, k = 0): C = A B^T, e.g. dz W^T from W's own rows.
template <int NJ>
__device__ __forceinline__ void tile_nk(float (&acc)[NJ][4],
                                        const __nv_bfloat16* a_row,
                                        const __nv_bfloat16* b, int ldb,
                                        int k_steps) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a = a_row + (lane >> 4) * 8;
  const __nv_bfloat16* bl =
      b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int ks = 0; ks < k_steps; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, a + ks * 16);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, bl + static_cast<size_t>(j) * 8 * ldb + ks * 16);
      mma(acc[j], af, bf[0], bf[1]);
      mma(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// A^T fragments of a 16 x 16 block of a [K][M] matrix (rows k, m
// contiguous): the A operand of C = X^T Z with X staged row by row. `p`
// is the block's (k = 0, m = 0) element, ld the row stride.
__device__ __forceinline__ void load_at(uint32_t (&a)[4],
                                        const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(a, p + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                       ((lane >> 3) & 1) * 8);
}

// B fragments of a 16 x 8 block of a [K][N] matrix at `p`, stride ld.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2],
                                          const __nv_bfloat16* p, int ld) {
  ldsm_x2_trans(b, p + (threadIdx.x & 15) * ld);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// Orders a 64-edge chunk by type, for warp 0 to call. `type_a` and `type_b`
// are the lane's edges lane and lane + 32 (-1: no edge, or a type outside
// [0, n_types)). The edges of each type, in stream order, take consecutive
// rows of a staging tile (`phys`: the row of each edge, -1 for one of no
// type), types one after the other, and the tile rows from a position that
// is a multiple of 16 (`order`: the edge at each tile row, `prow`: its
// staging row), each group padded to whole 16-row tiles with `pad` (a
// zero row) in both; tile i runs type tile_type[i]. Consecutive rows keep
// the 8 rows of an ldmatrix phase in 8 bank groups. Returns the tile count
// (at most 64 / 16 + n_types), the same on every lane.
__device__ __forceinline__ int order_by_type(int type_a, int type_b,
                                             int n_types, int pad,
                                             int* __restrict__ order,
                                             int* __restrict__ prow,
                                             int* __restrict__ phys,
                                             int* __restrict__ tile_type) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (type_a < 0) phys[lane] = -1;
  if (type_b < 0) phys[lane + 32] = -1;
  int base = 0, packed = 0, tiles = 0;
  for (int t = 0; t < n_types; ++t) {
    const unsigned ba = __ballot_sync(0xffffffffu, type_a == t);
    const unsigned bb = __ballot_sync(0xffffffffu, type_b == t);
    const int na = __popc(ba), count = na + __popc(bb);
    if (count == 0) continue;
    if (type_a == t) {
      const int j = __popc(ba & below);
      order[base + j] = lane;
      prow[base + j] = packed + j;
      phys[lane] = packed + j;
    }
    if (type_b == t) {
      const int j = na + __popc(bb & below);
      order[base + j] = lane + 32;
      prow[base + j] = packed + j;
      phys[lane + 32] = packed + j;
    }
    const int padded = pad16(count);
    for (int q = base + count + lane; q < base + padded; q += 32) {
      order[q] = pad;
      prow[q] = pad;
    }
    if (lane < padded / 16) tile_type[tiles + lane] = t;
    tiles += padded / 16;
    base += padded;
    packed += count;
  }
  return tiles;
}

// A kernel's dynamic shared memory limit and blocks an SM, set and asked
// once per size (a launch's host time stays that of the launch alone).
struct Occupancy {
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = cudaSuccess;

  // Blocks of `threads` with `smem` bytes that fit on one SM, the limit
  // raised to `smem` first; 0 on an error (in `err`).
  template <typename Kernel>
  int blocks_per_sm(Kernel kernel, int threads, size_t bytes) {
    if (bytes != smem || blocks <= 0) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      blocks = 0;
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                            threads, bytes);
      }
      if (err == cudaSuccess && blocks <= 0) {
        err = cudaErrorInvalidConfiguration;
      }
      smem = bytes;
    }
    return blocks;
  }
};

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

}  // namespace tmma
