// Tile products and shared-memory staging shared by the tiled kernels
// (packed attention, tiled GPF).
//
// One warp owns a 16-row strip of a product C = A B^T, both operands in shared
// memory with the contraction dimension contiguous.  The accumulators use the
// mma.sync m16n8 layout whatever the element type: with g = lane / 4 and
// tg = lane % 4, acc[n][0..1] is row g, columns n*8 + tg*2 + {0, 1}, and
// acc[n][2..3] is row g + 8, same columns.  bf16 operands run on the tensor
// cores (m16n8k16, fp32 accumulate); fp32 operands run the same tile on the
// CUDA cores with fmaf, so fp32 results carry no bf16 or TF32 rounding and the
// kernels above this header are written once for both types.
#pragma once

#include <cstdint>

#include "common.cuh"

// Elements added to a tile's row so that fragment reads hit distinct banks.
template <typename T>
struct TilePad;
template <>
struct TilePad<__nv_bfloat16> {
  static constexpr int value = 8;
};
template <>
struct TilePad<float> {
  static constexpr int value = 4;
};

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory, one per register: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned), and
// lane (g, tg) receives elements [g][2 tg, 2 tg + 1] of each matrix, or with
// ``trans`` elements [2 tg, 2 tg + 1][g].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// acc[NT][4] += A[16 x K] B[NT*8 x K]^T.  ``a`` points at the warp's first row
// (row stride lda), ``b`` at the first of the NT*8 rows of B (row stride ldb).
// bf16: NT is even, and rows of both tiles are 16-byte aligned (ldmatrix).
template <int NT, int K>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const __nv_bfloat16* a, int lda,
                                       const __nv_bfloat16* b, int ldb, int g, int tg) {
  static_assert(NT % 2 == 0, "B fragments are loaded for two column tiles at a time");
  const int lane = g * 4 + tg;
  const int r = lane & 7;
  const int m = lane >> 3;
  // A: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
  const __nv_bfloat16* pa = a + ((m & 1) * 8 + r) * lda + (m >> 1) * 8;
  // B: matrices (tile n, k 0-7), (tile n, k 8-15), (tile n + 1, k 0-7), (tile n + 1, k 8-15)
  const __nv_bfloat16* pb = b + ((m >> 1) * 8 + r) * ldb + (m & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t fa[4];
    ldmatrix_x4(fa, pa + ks * 16);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t fb[4];
      ldmatrix_x4(fb, pb + n * 8 * ldb + ks * 16);
      mma_16816(acc[n], fa, fb);
      mma_16816(acc[n + 1], fa, fb + 2);
    }
  }
}

template <int NT, int K>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const float* a, int lda, const float* b,
                                       int ldb, int g, int tg) {
  const float* a0 = a + g * lda;
  const float* a1 = a0 + 8 * lda;
  const float* b0 = b + (tg * 2) * ldb;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a0[k];
    const float x1 = a1[k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float y0 = b0[(n * 8) * ldb + k];
      const float y1 = b0[(n * 8 + 1) * ldb + k];
      acc[n][0] = fmaf(x0, y0, acc[n][0]);
      acc[n][1] = fmaf(x0, y1, acc[n][1]);
      acc[n][2] = fmaf(x1, y0, acc[n][2]);
      acc[n][3] = fmaf(x1, y1, acc[n][3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Two neighbouring values, rounded to the tile's type, at an even column.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// acc[mt][NT][4] += V[mt] B, where V[mt] is a 16 x 64 strip of values held in
// the accumulator layout (``vals[mt][8][4]``, as a product's result leaves
// them), rounded to the tile's type first, and B is [64][NT*8] in shared
// memory, the contraction running down its rows, which is how a token tile
// lies there ([token][d]).  bf16: the accumulators of column tiles 2t and
// 2t + 1 are exactly the A fragment of k-step t, so the strip never leaves the
// registers and ``strip`` is not touched; B's fragments come transposed out of
// ldmatrix (NT even, rows 16-byte aligned).  fp32: the strips go through the
// warp's private ``strip`` ([MT*16][lds]) in shared memory.
template <int MT, int NT>
__device__ __forceinline__ void mma_from_acc(float (*acc)[NT][4], float (*vals)[8][4],
                                             __nv_bfloat16* strip, int lds,
                                             const __nv_bfloat16* b, int ldb, int g, int tg) {
  static_assert(NT % 2 == 0, "B fragments are loaded for two column tiles at a time");
  (void)strip;
  (void)lds;
  const int lane = g * 4 + tg;
  // matrices (k 0-7, tile n), (k 8-15, tile n), (k 0-7, tile n + 1), (k 8-15, tile n + 1)
  const __nv_bfloat16* pb = b + ((lane >> 3 & 1) * 8 + (lane & 7)) * ldb + (lane >> 4) * 8;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t fa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      fa[mt][0] = pack_bf16(vals[mt][2 * t][0], vals[mt][2 * t][1]);
      fa[mt][1] = pack_bf16(vals[mt][2 * t][2], vals[mt][2 * t][3]);
      fa[mt][2] = pack_bf16(vals[mt][2 * t + 1][0], vals[mt][2 * t + 1][1]);
      fa[mt][3] = pack_bf16(vals[mt][2 * t + 1][2], vals[mt][2 * t + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, pb + t * 16 * ldb + n * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(acc[mt][n], fa[mt], fb);
        mma_16816(acc[mt][n + 1], fa[mt], fb + 2);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void mma_from_acc(float (*acc)[NT][4], float (*vals)[8][4],
                                             float* strip, int lds, const float* b, int ldb, int g,
                                             int tg) {
  __syncwarp();  // the strip's last readers are done
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store_pair(strip + (mt * 16 + g) * lds + n * 8 + tg * 2, vals[mt][n][0], vals[mt][n][1]);
      store_pair(strip + (mt * 16 + g + 8) * lds + n * 8 + tg * 2, vals[mt][n][2], vals[mt][n][3]);
    }
  }
  __syncwarp();
  const float* b0 = b + tg * 2;
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float x0[MT], x1[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      x0[mt] = strip[(mt * 16 + g) * lds + k];
      x1[mt] = strip[(mt * 16 + g + 8) * lds + k];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(b0 + k * ldb + n * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][n][0] = fmaf(x0[mt], y.x, acc[mt][n][0]);
        acc[mt][n][1] = fmaf(x0[mt], y.y, acc[mt][n][1]);
        acc[mt][n][2] = fmaf(x1[mt], y.x, acc[mt][n][2]);
        acc[mt][n][3] = fmaf(x1[mt], y.y, acc[mt][n][3]);
      }
    }
  }
}

// Shared-memory elements a warp needs for mma_from_acc with MT strips.
template <typename T>
struct StripElems;
template <>
struct StripElems<__nv_bfloat16> {
  static constexpr int per_row = 0;
};
template <>
struct StripElems<float> {
  static constexpr int per_row = 64 + TilePad<float>::value;
};

// Largest / sum over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [r0, r0 + ROWS) x COLS columns of a row-major matrix in device memory
// (row stride ld_g elements, rows past n_rows read as zero) into the
// shared-memory tile ``s`` ([ROWS][COLS + pad]), with 16-byte loads: ``g`` and
// ld_g must keep every row 16-byte aligned.  Neighbouring lanes take
// neighbouring vectors of one row, so the loads coalesce.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_tile(T* s, const T* g, size_t ld_g, int r0, int n_rows,
                                           int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PAD = TilePad<T>::value;
  constexpr int VPR = COLS / VEC;  // vectors per row
  for (int e = tid; e < ROWS * VPR; e += THREADS) {
    const int r = e / VPR;
    const int cv = e % VPR;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows) {
      v = __ldg(reinterpret_cast<const uint4*>(g + static_cast<size_t>(r0 + r) * ld_g) + cv);
    }
    *reinterpret_cast<uint4*>(s + r * (COLS + PAD) + cv * VEC) = v;
  }
}

// The same copy with cp.async: the 16-byte vectors go from device memory to
// shared memory without passing through registers, rows past n_rows are
// zero-filled, and the copy completes only at cp_async_wait_all() (then a
// __syncthreads() makes every thread's part visible to the block), so it can
// run under the products of the previous tile.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_tile_async(T* s, const T* g, size_t ld_g, int r0, int n_rows,
                                                 int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PAD = TilePad<T>::value;
  constexpr int VPR = COLS / VEC;  // vectors per row
  for (int e = tid; e < ROWS * VPR; e += THREADS) {
    const int r = e / VPR;
    const int cv = e % VPR;
    const bool in = r0 + r < n_rows;
    // a row past the end reads nothing (src-size 0) from a valid address
    const T* src = g + static_cast<size_t>(in ? r0 + r : 0) * ld_g + cv * VEC;
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(s + r * (COLS + PAD) + cv * VEC));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
