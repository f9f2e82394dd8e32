// Shared by the fused attention-half kernels (forward and backward): block
// and tile sizes, the LayerNorm of a window's rows, the softmax of one
// 16 x 64 logit strip, and the two fp32 products mma_tiles.cuh lacks (the
// fp32 backward's; the bf16 backward runs on wgmma, attn_half_bwd_sm90.cuh).
//
// A window's ws*ws <= 64 tokens are padded to 64 rows, 16 per warp.  Row r of
// a block's [64][C] tile is token r of the window, which lies at pixel
// (y0 + r / ws, x0 + r % ws) of the [B, Hp, Wp, C] map; rows past ws*ws are
// zero and never stored.
#pragma once

#include "mma_tiles.cuh"

namespace attn_half {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTok = 64;    // rows of a window tile
constexpr int kHead = 32;   // head width, and rows of a weight piece
constexpr int kSlice = 64;  // rows and depth of the backward's reduction tiles

// Row strides, in elements, of the tiles in shared memory.
template <typename T, int C>
struct Ld {
  static constexpr int x = C + TilePad<T>::value;      // [token][C] tiles, [32][C] weight pieces
  static constexpr int d = kHead + TilePad<T>::value;  // [token][d] head tiles
  static constexpr int t = kTok + TilePad<T>::value;   // [d or token][token] tiles
};

__device__ __forceinline__ size_t window_pixel(int b, int Hp, int Wp, int ws, int y0, int x0,
                                               int t) {
  return (static_cast<size_t>(b) * Hp + (y0 + t / ws)) * Wp + (x0 + t % ws);
}

// LayerNorm of one row of C values held E = C / 32 per lane (columns
// e * 32 + lane), in place: v becomes xc = v - mean; returns rstd.  fp32, as
// the TPU kernel's _ln_fwd: mean, then the mean of xc^2.
template <int E>
__device__ __forceinline__ float center_row(float* v, float eps) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += v[e];
  const float mu = warp_sum(s) / (E * 32);
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] -= mu;
    q += v[e] * v[e];
  }
  return rsqrtf(warp_sum(q) / (E * 32) + eps);
}

// xn = LayerNorm(x) * ln_g + ln_b of the window's rows, rounded to T, each
// value handed to ``store(t, c, value)`` for row t and column c; rows past nt
// are zero.  One warp per row, four rows of a warp at a time so that their
// loads and reductions overlap.
template <typename T, int C, class Store>
__device__ void layer_norm_window_to(Store store, const T* __restrict__ x, int b, int Hp, int Wp,
                                     int ws, int y0, int x0, int nt,
                                     const float* __restrict__ ln_g,
                                     const float* __restrict__ ln_b, float eps, int warp,
                                     int lane) {
  constexpr int E = C / 32;
  constexpr int R = 4;
  for (int t0 = warp; t0 < kTok; t0 += kWarps * R) {
    float v[R][E];
    float rstd[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r * kWarps;
      const T* src = x + window_pixel(b, Hp, Wp, ws, y0, x0, t < nt ? t : 0) * C;
#pragma unroll
      for (int e = 0; e < E; ++e) v[r][e] = t < nt ? to_f32(src[e * 32 + lane]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) rstd[r] = center_row<E>(v[r], eps);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r * kWarps;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = e * 32 + lane;
        const float xn = v[r][e] * rstd[r] * __ldg(ln_g + c) + __ldg(ln_b + c);
        store(t, c, from_f32<T>(t < nt ? xn : 0.f));
      }
    }
  }
}

// The same into the [kTok][C + pad] tile ``s``.
template <typename T, int C>
__device__ void layer_norm_window(T* s, const T* __restrict__ x, int b, int Hp, int Wp, int ws,
                                  int y0, int x0, int nt, const float* __restrict__ ln_g,
                                  const float* __restrict__ ln_b, float eps, int warp, int lane) {
  layer_norm_window_to<T, C>([&](int t, int c, T v) { s[t * Ld<T, C>::x + c] = v; }, x, b, Hp,
                             Wp, ws, y0, x0, nt, ln_g, ln_b, eps, warp, lane);
}

// The window's rows of a [B, Hp, Wp, C] map into the [kTok][C + pad] tile
// ``s`` by 16-byte cp.async copies, all in flight at once; rows past nt are
// zero-filled.  The copy completes at cp_async_wait_all() (then a barrier).
template <typename T, int C>
__device__ void load_window_async(T* s, const T* __restrict__ g, int b, int Hp, int Wp, int ws,
                                  int y0, int x0, int nt, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = C / VEC;
  for (int e = tid; e < kTok * VPR; e += kThreads) {
    const int t = e / VPR;
    const int cv = e % VPR;
    const bool in = t < nt;
    // a row past the end reads nothing (src-size 0) from a valid address
    const T* src = g + window_pixel(b, Hp, Wp, ws, y0, x0, in ? t : 0) * C + cv * VEC;
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(s + t * Ld<T, C>::x + cv * VEC));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  }
}

// Raw q . k products of a 16 x 64 strip (query rows r0 and r0 + 8, all 64
// key columns) -> the probabilities, fp32, in place: logits times scale plus
// bias plus mask, keys past nt at -inf, softmax across the four lanes that
// share a row.  Query rows past nt read no bias or mask; they stay finite
// and are never stored.
__device__ __forceinline__ void window_probs(float (*s)[4], const float* __restrict__ bias_h,
                                             const float* __restrict__ mask_w, int nt,
                                             float scale, int r0, int tg) {
  const int r1 = r0 + 8;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = n * 8 + tg * 2 + u;
      float v0 = -INFINITY, v1 = -INFINITY;
      if (j < nt) {
        v0 = s[n][u] * scale;
        v1 = s[n][2 + u] * scale;
        if (r0 < nt) {
          v0 += __ldg(bias_h + r0 * nt + j);
          if (mask_w) v0 += __ldg(mask_w + r0 * nt + j);
        }
        if (r1 < nt) {
          v1 += __ldg(bias_h + r1 * nt + j);
          if (mask_w) v1 += __ldg(mask_w + r1 * nt + j);
        }
      }
      s[n][u] = v0;
      s[n][2 + u] = v1;
      mx0 = fmaxf(mx0, v0);
      mx1 = fmaxf(mx1, v1);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = expf(s[n][0] - mx0);
    s[n][1] = expf(s[n][1] - mx0);
    s[n][2] = expf(s[n][2] - mx1);
    s[n][3] = expf(s[n][3] - mx1);
    sum0 += s[n][0] + s[n][1];
    sum1 += s[n][2] + s[n][3];
  }
  const float inv0 = 1.f / quad_sum(sum0);
  const float inv1 = 1.f / quad_sum(sum1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] *= inv0;
    s[n][1] *= inv0;
    s[n][2] *= inv1;
    s[n][3] *= inv1;
  }
}

// acc[NT][4] += A[16 x K] B[K x NT*8] on the CUDA cores (fp32): A with the
// contraction contiguous ([row][k], as mma_nt takes it), B with it running
// down the rows ([k][n]).
template <int NT, int K>
__device__ __forceinline__ void mma_nn(float (*acc)[4], const float* a, int lda, const float* b,
                                       int ldb, int g, int tg) {
  const float* a0 = a + g * lda;
  const float* a1 = a0 + 8 * lda;
  const float* b0 = b + tg * 2;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a0[k];
    const float x1 = a1[k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(b0 + k * ldb + n * 8);
      acc[n][0] = fmaf(x0, y.x, acc[n][0]);
      acc[n][1] = fmaf(x0, y.y, acc[n][1]);
      acc[n][2] = fmaf(x1, y.x, acc[n][2]);
      acc[n][3] = fmaf(x1, y.y, acc[n][3]);
    }
  }
}

// acc[NT][4] += A[16 x K] B[K x NT*8] on the CUDA cores (fp32) with both
// operands stored with the contraction running down their rows: A as
// [k][row] (``a`` points at the warp's first row, row stride lda between
// consecutive k), B as [k][n].  This is the product X^T Y of two token-major
// tiles.
template <int NT, int K>
__device__ __forceinline__ void mma_tn(float (*acc)[4], const float* a, int lda, const float* b,
                                       int ldb, int g, int tg) {
  const float* b0 = b + tg * 2;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a[k * lda + g];
    const float x1 = a[k * lda + g + 8];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(b0 + k * ldb + n * 8);
      acc[n][0] = fmaf(x0, y.x, acc[n][0]);
      acc[n][1] = fmaf(x0, y.y, acc[n][1]);
      acc[n][2] = fmaf(x1, y.x, acc[n][2]);
      acc[n][3] = fmaf(x1, y.y, acc[n][3]);
    }
  }
}

}  // namespace attn_half
