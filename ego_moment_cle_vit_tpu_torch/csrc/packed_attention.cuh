// Shared by the packed-attention kernels (forward and backward): block and
// tile sizes, the logits of one 16 x 64 accumulator strip, and the exponential.
#pragma once

#include "mma_tiles.cuh"

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // rows a block owns, 16 per warp (queries; keys for dk / dv)
constexpr int kCols = 64;           // tokens per tile of the axis a block walks

// Blocks per SM the bf16 kernels are compiled for (128 registers per thread);
// the fp32 kernels, which keep their strips in more registers, take what they need.
template <typename T>
struct MinBlocks {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<__nv_bfloat16> {
  static constexpr int value = 2;
};

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

// Raw q . k products of a 16 x 64 strip -> fp32 logits: scale, bias, mask;
// keys past T -> -inf.  With KEYS_IN_ROWS the strip's rows are keys and its
// columns queries (the strip is a piece of S^T), else rows are queries and
// columns keys.  row0 is the token of the strip's row g, col0 the token of
// the tile's first column.  ``keys_valid`` says that every key of the tile
// lies below T, which with neither bias nor mask leaves only the scale (the
// common case: a ViT's full tiles).  A query past T keeps finite logits (it
// reads no bias or mask), so its softmax stays defined; it is never stored.
template <bool KEYS_IN_ROWS>
__device__ __forceinline__ void to_logits(float (*s)[4], const float* bias_h, const float* mask_w,
                                          int Tn, float scale, int row0, int col0, int tg,
                                          bool keys_valid) {
  if (keys_valid && !bias_h && !mask_w) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    }
    return;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
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
