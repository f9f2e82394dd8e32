// The attention forward for fp32 inputs, on the CUDA cores: shared by the
// packed-layout forward (packed_attention_fwd.cu, with bias and mask) and the
// q-tiled one (flash_attention_fwd.cu, the packed layout with one group and
// neither).  bf16 takes the Hopper kernel of attention_fwd_sm90.cuh; fp32 is
// off every main path and keeps the tile code of mma_tiles.cuh, whose fp32
// products run on the CUDA cores with fmaf, so fp32 results carry no bf16 or
// TF32 rounding.
//
// Per (image-group bw, head h), from qkv[BW, T, 3C], bias[Hb, T, T] and
// mask[Wm, T, T] (either may be null):
//   P   = softmax(q k^T * scale + bias[h % Hb] + mask[w % Wm])
//   out = P v,  lse = log(sum_j exp(logit_j)) per query row [BW, H, T] (if asked)
// One block of eight warps owns 128 query rows of one (group, head), 16 per
// warp, and walks the keys in tiles of 64 with an online softmax (running row
// maximum and sum, output rescaled when the maximum moves): a warp holds a
// 16 x 64 logit strip and a 16 x d output strip in registers and nothing of
// size T.  q, k and v tiles lie in shared memory as they lie in qkv,
// [token][d]; the next (k, v) tile arrives by cp.async into a second buffer
// under the products of the current one, one barrier per tile.  The
// probabilities go through the warp's strip in shared memory as the A operand
// of P v.  Keys past T are zero padding masked to -inf, warps whose 16
// queries all lie past T take part in the copies only, and query rows past T
// are not stored.
#pragma once

#include "packed_attention.cuh"

namespace fp32_fwd {

template <int D>
struct Smem {
  static constexpr int LDD = D + TilePad<float>::value;  // [token][d] tiles
  static constexpr size_t bytes =
      (static_cast<size_t>(kRows + 4 * kCols) * LDD +
       static_cast<size_t>(kRows) * StripElems<float>::per_row) *
      sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd(const float* __restrict__ qkv, const float* __restrict__ bias,
              const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
              int W, int Tn, int C, int H, int Hb, int Wm, float scale, int n_qt) {
  using S = Smem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kRows][LDD]
  float* skv = sq + kRows * S::LDD;  // two buffers of k [kCols][LDD], v [kCols][LDD]
  float* sp = skv + 4 * kCols * S::LDD;  // [kWarps][16][per_row], P per warp

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % H;
  const int bw = blockIdx.x / (n_qt * H);
  const int w = bw % W;
  const int q0 = qt * kRows;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const float* base = qkv + static_cast<size_t>(bw) * Tn * c3 + h * D;
  const float* bias_h = bias ? bias + static_cast<size_t>(h % Hb) * Tn * Tn : nullptr;
  const float* mask_w = mask ? mask + static_cast<size_t>(w % Wm) * Tn * Tn : nullptr;

  stage_tile_async<float, kRows, D, kThreads>(sq, base, c3, q0, Tn, tid);
  stage_tile_async<float, kCols, D, kThreads>(skv, base + C, c3, 0, Tn, tid);
  stage_tile_async<float, kCols, D, kThreads>(skv + kCols * S::LDD, base + 2 * C, c3, 0, Tn, tid);
  cp_async_commit();

  float* sp_w = sp + warp * 16 * StripElems<float>::per_row;
  const float* sq_w = sq + warp * 16 * S::LDD;
  const int r0 = q0 + warp * 16 + g;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[1][D / 8][4];
  zero_acc<D / 8>(o[0]);

  const int n_kt = (Tn + kCols - 1) / kCols;
  const bool active = q0 + warp * 16 < Tn;  // a warp whose 16 queries all lie past T only stages
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    const float* sk = skv + (kt & 1) * 2 * kCols * S::LDD;
    const float* sv = sk + kCols * S::LDD;
    // this tile has landed, and the other buffer's products are done: the
    // next tile is fetched into it under this tile's products
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kt) {
      float* nk = skv + ((kt + 1) & 1) * 2 * kCols * S::LDD;
      stage_tile_async<float, kCols, D, kThreads>(nk, base + C, c3, k0 + kCols, Tn, tid);
      stage_tile_async<float, kCols, D, kThreads>(nk + kCols * S::LDD, base + 2 * C, c3,
                                                  k0 + kCols, Tn, tid);
      cp_async_commit();
    }
    if (!active) continue;

    float s[1][8][4];
    zero_acc<8>(s[0]);
    mma_nt<8, D>(s[0], sq_w, S::LDD, sk, S::LDD, g, tg);
    to_logits<false>(s[0], bias_h, mask_w, Tn, scale, r0, k0, tg, k0 + kCols <= Tn);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[0][n][0], s[0][n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[0][n][2], s[0][n][3]));
    }
    // every tile holds at least one key below T, so the new maxima are finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = soft_exp<float>(m0 - mn0);
    const float corr1 = soft_exp<float>(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[0][dn][0] *= corr0;
      o[0][dn][1] *= corr0;
      o[0][dn][2] *= corr1;
      o[0][dn][3] *= corr1;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // s becomes the unnormalized P
      s[0][n][0] = soft_exp<float>(s[0][n][0] - mn0);
      s[0][n][1] = soft_exp<float>(s[0][n][1] - mn0);
      s[0][n][2] = soft_exp<float>(s[0][n][2] - mn1);
      s[0][n][3] = soft_exp<float>(s[0][n][3] - mn1);
      l0 += s[0][n][0] + s[0][n][1];
      l1 += s[0][n][2] + s[0][n][3];
    }
    mma_from_acc<1, D / 8>(o, s, sp_w, StripElems<float>::per_row, sv, S::LDD, g, tg);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < Tn) {
      const float inv = half ? inv1 : inv0;
      float* dst = out + (static_cast<size_t>(bw) * Tn + r) * C + h * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store_pair(dst + dn * 8 + tg * 2, o[0][dn][half * 2] * inv, o[0][dn][half * 2 + 1] * inv);
      }
      if (lse && tg == 0) {
        lse[(static_cast<size_t>(bw) * H + h) * Tn + r] = half ? m1 + logf(l1) : m0 + logf(l0);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* qkv, const float* bias, const float* mask, void* out, float* lse,
                   int BW, int W, int Tn, int C, int H, int Hb, int Wm, float scale,
                   cudaStream_t stream) {
  auto kernel = attention_fwd<D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tn + kRows - 1) / kRows;
  const unsigned blocks = static_cast<unsigned>(BW) * H * n_qt;
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const float*>(qkv), bias, mask,
                                             static_cast<float*>(out), lse, W, Tn, C, H, Hb, Wm,
                                             scale, n_qt);
  return cudaGetLastError();
}

}  // namespace fp32_fwd
