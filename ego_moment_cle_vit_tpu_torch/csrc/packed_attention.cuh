// Shared by the attention kernels (packed and q-tiled, forward and backward):
// block and tile sizes, the logits of one 16-row accumulator strip, the
// exponential, and each row's delta = rowsum(dout * out) for the backward.
#pragma once

#include "mma_tiles.cuh"

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows a block owns, 16 per warp (queries; keys for dk / dv)
constexpr int kCols = 64;           // tokens per tile of the axis a block walks
// (kWarps, kRows and kCols size the fp32 kernels and the bias-gradient
// kernel; the bf16 Hopper kernels have their own tiles)

// exp for the softmax.  bf16: the fast intrinsic (its ~2^-21 relative error
// vanishes under the bf16 rounding of P); fp32: the exact one.
template <typename T>
__device__ __forceinline__ float soft_exp(float x);
template <>
__device__ __forceinline__ float soft_exp<__nv_bfloat16>(float x) {
  return __expf(x);
}
template <>
__device__ __forceinline__ float soft_exp<float>(float x) {
  return expf(x);
}

// Raw q . k products of a 16 x (NC * 8) strip -> fp32 logits: scale, bias, mask;
// keys past T -> -inf.  With KEYS_IN_ROWS the strip's rows are keys and its
// columns queries (the strip is a piece of S^T), else rows are queries and
// columns keys.  row0 is the token of the strip's row g, col0 the token of
// the tile's first column.  ``keys_valid`` says that every key of the tile
// lies below T, which with neither bias nor mask leaves only the scale (the
// common case: a ViT's full tiles).  A query past T keeps finite logits (it
// reads no bias or mask), so its softmax stays defined; it is never stored.
template <bool KEYS_IN_ROWS, int NC = 8>
__device__ __forceinline__ void to_logits(float (*s)[4], const float* bias_h, const float* mask_w,
                                          int Tn, float scale, int row0, int col0, int tg,
                                          bool keys_valid) {
  if (keys_valid && !bias_h && !mask_w) {
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    }
    return;
  }
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = col0 + n * 8 + tg * 2 + u;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        const int i = KEYS_IN_ROWS ? col : row;  // query
        const int j = KEYS_IN_ROWS ? row : col;  // key
        float v = -INFINITY;
        if (j < Tn) {
          v = s[n][half * 2 + u] * scale;
          if (i < Tn) {
            if (bias_h) v += __ldg(bias_h + static_cast<size_t>(i) * Tn + j);
            if (mask_w) v += __ldg(mask_w + static_cast<size_t>(i) * Tn + j);
          }
        }
        s[n][half * 2 + u] = v;
      }
    }
  }
}

// sum over N columns of x * y, two rows read with 16-byte loads
template <typename T, int N>
__device__ __forceinline__ float dot_cols(const T* __restrict__ x, const T* __restrict__ y) {
  constexpr int VEC = 16 / sizeof(T);
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < N / VEC; ++v) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + v);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(y) + v);
    const T* ea = reinterpret_cast<const T*>(&a);
    const T* eb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc = fmaf(to_f32(ea[e]), to_f32(eb[e]), acc);
  }
  return acc;
}

// delta = rowsum(dout * out) of a warp's 16 rows wrow0 .. wrow0 + 15 of one
// (image, head): ``dbase`` and ``obase`` point at the head's columns of row 0
// (row stride C).  Lanes 2i and 2i + 1 take half of row i's columns each; row
// i's value goes to delta_row[wrow0 + i] when it lies below T, and each lane
// gets the values of its accumulator rows g and g + 8 (rows past T: 0).
template <typename T, int D>
__device__ __forceinline__ void warp_row_delta(const T* dbase, const T* obase, int C, int Tn,
                                               int wrow0, int lane, float* delta_row,
                                               float& delta0, float& delta1) {
  const int r = wrow0 + (lane >> 1);
  const int c0 = (lane & 1) * (D / 2);
  float part = 0.f;
  if (r < Tn) {
    const size_t off = static_cast<size_t>(r) * C + c0;
    part = dot_cols<T, D / 2>(dbase + off, obase + off);
  }
  const float full = part + __shfl_xor_sync(0xffffffffu, part, 1);
  if ((lane & 1) == 0 && r < Tn) delta_row[r] = full;
  const int g = lane >> 2;
  delta0 = __shfl_sync(0xffffffffu, full, 2 * g);       // row g of the warp
  delta1 = __shfl_sync(0xffffffffu, full, 2 * g + 16);  // row g + 8
}
