// Pieces shared by the bf16 window-attention kernels on Hopper (sm_90a): the
// forward (window_attention_fwd_sm90.cuh, kernel 1) and the backward core
// (window_attention_bwd_sm90.cuh, kernels 1b and 4b).  Both give one
// warpgroup a (window position, head) and walk a chunk of images, each
// image's window arriving by TMA as [64][32] bf16 tiles (rows past T = ws*ws
// stay zero), and both hold a query row's 64 logits in the accumulators of
// an m64n64 wgmma: warp w rows 16w + g and 16w + g + 8 (g = lane / 4),
// columns 8n + 2(lane % 4) + {0, 1} in sc[n][0..3].
#pragma once

#include "sm90.cuh"

namespace wa_sm90 {

using namespace sm90;

constexpr int kThreads = 128;              // one warpgroup
constexpr int kD = 32;                     // head width
constexpr int kTok = 64;                   // window rows, padded to wgmma's M
constexpr int kTileBytes = kTok * kD * 2;  // one [64][32] bf16 tile, 64-byte swizzle
constexpr int kTermBytes = kThreads * 32 * 4;  // one fp32 logit term a thread's entry

// A 4-D tensor map over a [B, Hp, Wp, cols] bf16 map: boxes of one head's 32
// columns of one window (ws x ws pixels) of one image, at the 64-byte
// swizzle.  Every stride is a multiple of 16 bytes because cols is a multiple
// of 32 (C = 32 H); the wrapper has checked the base's alignment.
inline bool encode_window_map(CUtensorMap* map, const void* ptr, int cols, int B, int Hp, int Wp,
                              int ws) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(Wp),
                              static_cast<cuuint64_t>(Hp), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t strides[3] = {row, row * Wp, row * Wp * Hp};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), static_cast<cuuint32_t>(ws),
                             static_cast<cuuint32_t>(ws), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// This thread's logit terms of key block n (logit_terms), and all eight into
// shared memory (fill_terms), entry (n, e) of the accumulator layout: row
// r0 + 8 (e / 2), key 8n + 2tg + e % 2.  A padded key: -inf; a padded query:
// 0 (its logits stay finite and are never stored).  Bias and mask are summed
// once here, for every image the block walks.  Adding the two tables first
// rounds differently from adding them one at a time only where the mask is
// not zero; Swin's masks hold 0 or -100, and a -100 entry's probability
// (~e^-100) rounds to 0 in P~ either way.
__device__ __forceinline__ float4 logit_terms(const float* __restrict__ bias_h,
                                              const float* __restrict__ mask_w, int nt, int r0,
                                              int tg, int n) {
  float t[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = r0 + 8 * (e >> 1);
    const int j = 8 * n + 2 * tg + (e & 1);
    const bool in = i < nt && j < nt;
    t[e] = j >= nt ? -INFINITY : (in ? __ldg(bias_h + i * nt + j) : 0.f);
    if (in && mask_w) t[e] += __ldg(mask_w + i * nt + j);
  }
  return make_float4(t[0], t[1], t[2], t[3]);
}

__device__ __forceinline__ void fill_terms(float4* terms, const float* __restrict__ bias,
                                           const float* __restrict__ mask, int nt, int h, int win,
                                           int r0, int tg, int tid) {
  const float* bias_h = bias + static_cast<size_t>(h) * nt * nt;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    terms[n * kThreads + tid] = logit_terms(bias_h, mask_w, nt, r0, tg, n);
  }
}

// The exponentials of a window's logits in place and the inverses of this
// thread's two row sums: logits in fp32 (scale, then the terms), the row
// maximum and sum over the quad that holds a row, then P = sc * inv.  The
// forward (kFwd) rounds the scaled score before adding the terms, as the
// mma.sync forward did (s * scale, then + bias, + mask), and sets the blocks
// of 8 keys past T (nt), which hold only padded keys whose exponentials are
// exactly 0, without computing them.  The backward fuses the scale and the
// terms into one fma, as its logits always have, and keeps the
// straight-line code, which its register-bound loop runs faster.
// ``term(n)`` gives this thread's four terms of key block n, in
// fill_terms' order (the fused attention half's forward forms them in
// registers).
template <bool kFwd, class Term>
__device__ __forceinline__ void softmax_rows_with(float (*sc)[4], Term term, float scale, int nt,
                                                  float& inv0, float& inv1) {
  const int key_blocks = kFwd ? (nt + 7) >> 3 : 8;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (!kFwd || n < key_blocks) {
      const float4 t = term(n);
      if constexpr (kFwd) {
        sc[n][0] = __fmul_rn(sc[n][0], scale) + t.x;
        sc[n][1] = __fmul_rn(sc[n][1], scale) + t.y;
        sc[n][2] = __fmul_rn(sc[n][2], scale) + t.z;
        sc[n][3] = __fmul_rn(sc[n][3], scale) + t.w;
      } else {
        sc[n][0] = sc[n][0] * scale + t.x;
        sc[n][1] = sc[n][1] * scale + t.y;
        sc[n][2] = sc[n][2] * scale + t.z;
        sc[n][3] = sc[n][3] * scale + t.w;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (!kFwd || n < key_blocks) {
      sc[n][0] = expf(sc[n][0] - mx0);
      sc[n][1] = expf(sc[n][1] - mx0);
      sc[n][2] = expf(sc[n][2] - mx1);
      sc[n][3] = expf(sc[n][3] - mx1);
    } else {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    }
    sum0 += sc[n][0] + sc[n][1];
    sum1 += sc[n][2] + sc[n][3];
  }
  inv0 = 1.f / quad_sum(sum0);
  inv1 = 1.f / quad_sum(sum1);
}

// The same with the terms fill_terms laid down in shared memory.
template <bool kFwd>
__device__ __forceinline__ void softmax_rows(float (*sc)[4], const float4* terms, float scale,
                                             int tid, int nt, float& inv0, float& inv1) {
  softmax_rows_with<kFwd>(
      sc, [&](int n) { return terms[n * kThreads + tid]; }, scale, nt, inv0, inv1);
}

// An m64n32 accumulator strip (rows r0, r0 + 8 of the window at (y0, x0) of
// image b) times ``mul`` to the token rows of a [B, Hp, Wp, width] map at
// column ``col``; rows past T are padding and not stored.  Four lanes write
// one row's 16 bytes of a column chunk, so every 32-byte sector a warp
// touches is written whole by it.
__device__ __forceinline__ void store_strip(bf16* map, const float* acc, int b, int Hp, int Wp,
                                            int ws, int y0, int x0, int r0, int width, int col,
                                            int tg, float mul) {
  const int nt = ws * ws;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < nt) {
      const size_t pix = (static_cast<size_t>(b) * Hp + (y0 + r / ws)) * Wp + (x0 + r % ws);
      bf16* dst = map + pix * width + col;
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + tg * 2) = __floats2bfloat162_rn(
            acc[4 * dn + half * 2] * mul, acc[4 * dn + half * 2 + 1] * mul);
      }
    }
  }
}

}  // namespace wa_sm90
