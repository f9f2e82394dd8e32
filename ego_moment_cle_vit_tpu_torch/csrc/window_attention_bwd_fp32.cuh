// The fp32 window-attention backward (kernel 1b off the training dtype):
// one block per (window position, head) walking a chunk of images, on the
// CUDA cores out of shared memory, so the results carry no bf16 or TF32
// rounding.  It is bound by shared-memory traffic, not by its bytes.  The
// bf16 kernel is window_attention_bwd_sm90.cuh; both write one [T, T]
// bias-gradient partial per block for the ordered reduction in
// window_attention_bwd.cu.
#pragma once

#include "common.cuh"

namespace wa_bwd_fp32 {

constexpr int kThreads = 128;
constexpr int kHeadDim = 32;
constexpr int kMaxTok = 64;
constexpr int kPerThread = kMaxTok * kMaxTok / kThreads;  // dbias entries per thread

__global__ void __launch_bounds__(kThreads)
window_attention_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                         const float* __restrict__ mask, const float* __restrict__ dout,
                         float* __restrict__ dqkv, float* __restrict__ partial, int B, int Hp,
                         int Wp, int C, int H, int ws, float scale, int images_per_block) {
  extern __shared__ float smem[];
  constexpr int D = kHeadDim;
  constexpr int DP = D + 1;  // padded rows: conflict-free column walks
  const int nt = ws * ws;
  const int tp = nt + 1;
  float* sq = smem;
  float* sk = sq + nt * DP;
  float* sv = sk + nt * DP;
  float* sdo = sv + nt * DP;
  float* sp = sdo + nt * DP;  // [nt][tp] logits, then P
  float* sds = sp + nt * tp;  // [nt][tp] dp, then ds

  const int nwx = Wp / ws;
  const int win = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const float* bias_h = bias + static_cast<size_t>(h) * nt * nt;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;

  float dbias_acc[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) dbias_acc[u] = 0.f;

  const int b_begin = blockIdx.y * images_per_block;
  const int b_end = min(B, b_begin + images_per_block);
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();  // the previous image's products are done with shared memory
    for (int e = tid; e < nt * D; e += kThreads) {
      const int t = e / D;
      const int c = e % D;
      const size_t pix = (static_cast<size_t>(b) * Hp + (y0 + t / ws)) * Wp + (x0 + t % ws);
      const float* row = qkv + pix * c3 + h * D + c;
      sq[t * DP + c] = row[0];
      sk[t * DP + c] = row[C];
      sv[t * DP + c] = row[2 * C];
      sdo[t * DP + c] = dout[pix * C + h * D + c];
    }
    __syncthreads();

    // logits and dp = do v^T
    for (int e = tid; e < nt * nt; e += kThreads) {
      const int i = e / nt;
      const int j = e % nt;
      float acc = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        acc = fmaf(sq[i * DP + c], sk[j * DP + c], acc);
        dp = fmaf(sdo[i * DP + c], sv[j * DP + c], dp);
      }
      float logit = acc * scale + bias_h[e];
      if (mask_w) logit += mask_w[e];
      sp[i * tp + j] = logit;
      sds[i * tp + j] = dp;
    }
    __syncthreads();

    // softmax rows, delta_i = sum_j dp_ij P_ij, ds = P (dp - delta)
    for (int i = warp; i < nt; i += kThreads / 32) {
      float* prow = sp + i * tp;
      float* drow = sds + i * tp;
      float m = -INFINITY;
      for (int j = lane; j < nt; j += 32) m = fmaxf(m, prow[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < nt; j += 32) {
        const float p = expf(prow[j] - m);
        prow[j] = p;
        s += p;
      }
      const float inv = 1.f / warp_sum(s);
      float delta = 0.f;
      for (int j = lane; j < nt; j += 32) {
        const float p = prow[j] * inv;
        prow[j] = p;
        delta = fmaf(drow[j], p, delta);
      }
      delta = warp_sum(delta);
      for (int j = lane; j < nt; j += 32) drow[j] = prow[j] * (drow[j] - delta);
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = tid + u * kThreads;
      if (e < nt * nt) dbias_acc[u] += sds[(e / nt) * tp + e % nt];
    }

    // dq = ds k * scale, dk = ds^T q * scale, dv = P^T do
    for (int e = tid; e < nt * D; e += kThreads) {
      const int t = e / D;
      const int c = e % D;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < nt; ++j) {
        dq = fmaf(sds[t * tp + j], sk[j * DP + c], dq);
        dk = fmaf(sds[j * tp + t], sq[j * DP + c], dk);
        dv = fmaf(sp[j * tp + t], sdo[j * DP + c], dv);
      }
      const size_t pix = (static_cast<size_t>(b) * Hp + (y0 + t / ws)) * Wp + (x0 + t % ws);
      float* row = dqkv + pix * c3 + h * D + c;
      row[0] = dq * scale;
      row[C] = dk * scale;
      row[2 * C] = dv;
    }
  }

  // one [T, T] partial per block: partial[chunk][win][h][T*T]
  float* out = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * nt * nt;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int e = tid + u * kThreads;
    if (e < nt * nt) out[e] = dbias_acc[u];
  }
}

}  // namespace wa_bwd_fp32
