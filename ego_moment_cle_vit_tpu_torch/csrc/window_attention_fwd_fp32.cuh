// The fp32 window-attention forward (kernel 1 off the serving dtype): one
// block of four warps per (image, window, head) on the CUDA cores, q, k, v
// and the logits in shared memory as fp32, so the results carry no bf16 or
// TF32 rounding.  The bf16 kernel is window_attention_fwd_sm90.cuh.
#pragma once

#include "common.cuh"

namespace wa_fwd_fp32 {

constexpr int kThreads = 128;
constexpr int kHeadDim = 32;
constexpr int kMaxTok = 64;

__global__ void __launch_bounds__(kThreads)
window_attention_fwd_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                         const float* __restrict__ mask, float* __restrict__ out, int Hp, int Wp,
                         int C, int H, int ws, float scale) {
  extern __shared__ float smem[];
  constexpr int D = kHeadDim;
  constexpr int DP = D + 1;  // padded rows: conflict-free column walks
  const int nt = ws * ws;
  const int tp = nt + 1;
  float* sq = smem;
  float* sk = sq + nt * DP;
  float* sv = sk + nt * DP;
  float* sp = sv + nt * DP;  // [nt][tp] logits, then probabilities

  const int nwx = Wp / ws;
  const int win = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int b = blockIdx.y;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const int tid = threadIdx.x;
  const size_t c3 = 3 * static_cast<size_t>(C);

  for (int e = tid; e < nt * D; e += kThreads) {
    const int t = e / D;
    const int c = e % D;
    const int y = y0 + t / ws;
    const int x = x0 + t % ws;
    const float* row = qkv + ((static_cast<size_t>(b) * Hp + y) * Wp + x) * c3 + h * D + c;
    sq[t * DP + c] = row[0];
    sk[t * DP + c] = row[C];
    sv[t * DP + c] = row[2 * C];
  }
  __syncthreads();

  const float* bias_h = bias + static_cast<size_t>(h) * nt * nt;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;
  for (int e = tid; e < nt * nt; e += kThreads) {
    const int i = e / nt;
    const int j = e % nt;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc = fmaf(sq[i * DP + c], sk[j * DP + c], acc);
    float logit = acc * scale + bias_h[e];
    if (mask_w) logit += mask_w[e];
    sp[i * tp + j] = logit;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int i = warp; i < nt; i += kThreads / 32) {
    float* row = sp + i * tp;
    float m = -INFINITY;
    for (int j = lane; j < nt; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < nt; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      s += p;
    }
    const float inv = 1.f / warp_sum(s);
    for (int j = lane; j < nt; j += 32) row[j] *= inv;
  }
  __syncthreads();

  for (int e = tid; e < nt * D; e += kThreads) {
    const int i = e / D;
    const int c = e % D;
    const float* prow = sp + i * tp;
    float acc = 0.f;
    for (int j = 0; j < nt; ++j) acc = fmaf(prow[j], sv[j * DP + c], acc);
    const int y = y0 + i / ws;
    const int x = x0 + i % ws;
    out[((static_cast<size_t>(b) * Hp + y) * Wp + x) * C + h * D + c] = acc;
  }
}

}  // namespace wa_fwd_fp32
