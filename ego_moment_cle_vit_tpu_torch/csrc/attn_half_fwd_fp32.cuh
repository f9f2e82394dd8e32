// The fp32 fused attention-half forward (attn_half_fwd.cu launches it), on the
// CUDA cores, so its results carry no bf16 or TF32 rounding.
//
// One block of four warps owns one window of one image: it normalizes the
// window's rows into shared memory once and walks the weights in 32-row
// pieces (the q, k and v rows of each head, then Wproj's rows), each arriving
// by cp.async into one buffer; the weights are read by every block and stay
// in the 50 MB L2.  Each warp owns 16 of the window's 64 (padded) rows for
// every product.  After a head's v piece the block attends: S = q k^T and the
// softmax in registers, then P v through the warp's strip, into an om tile
// [64][C] in shared memory.  The proj pieces then read om, and the epilogue
// adds bproj and x (read again, from L2) and stores the real rows.
#pragma once

#include "attn_half.cuh"

namespace ah_fwd_fp32 {

using namespace attn_half;

template <int C>
struct Smem {
  using L = Ld<float, C>;
  static constexpr int kPiece = kHead * L::x;
  // xn and om [kTok][C]; one weight piece; q, k, v [kTok][d]; the strips
  static constexpr size_t bytes = (2 * static_cast<size_t>(kTok) * L::x + kPiece +
                                   3 * kTok * L::d + kWarps * 16 * StripElems<float>::per_row) *
                                  sizeof(float);
};

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_half_fwd_f32(const float* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const float* __restrict__ wproj,
                  const float* __restrict__ bproj, const float* __restrict__ bias,
                  const float* __restrict__ mask, float* __restrict__ y, int Hp, int Wp, int H,
                  int ws, float scale, float eps) {
  using L = Ld<float, C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sxn = reinterpret_cast<float*>(smem_raw);
  float* som = sxn + kTok * L::x;
  float* sw = som + kTok * L::x;
  float* sqkv = sw + Smem<C>::kPiece;  // q, k, v of one head, each [kTok][d]
  float* strip = sqkv + 3 * kTok * L::d;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int nt = ws * ws;
  const int nwx = Wp / ws;
  const int win = blockIdx.x;
  const int b = blockIdx.y;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;
  const int row0 = warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  float* strip_w = strip + warp * 16 * StripElems<float>::per_row;

  // qkv pieces first: piece p < 3H holds part p % 3 (0 = q, 1 = k, 2 = v) of
  // head p / 3, the 32 rows part C + head 32 .. + 32 of Wqkv; then proj piece
  // j holds rows j 32 .. + 32 of Wproj
  const int n_qkv = 3 * H;
  const int n_pieces = n_qkv + C / kHead;
  auto stage_piece = [&](int p) {
    const float* src = p < n_qkv
                           ? wqkv + static_cast<size_t>((p % 3) * C + (p / 3) * kHead) * C
                           : wproj + static_cast<size_t>(p - n_qkv) * kHead * C;
    stage_tile_async<float, kHead, C, kThreads>(sw, src, C, 0, kHead, tid);
    cp_async_commit();
  };
  stage_piece(0);  // lands under the LayerNorm
  layer_norm_window<float, C>(sxn, x, b, Hp, Wp, ws, y0, x0, nt, ln_g, ln_b, eps, warp, lane);

  for (int p = 0; p < n_pieces; ++p) {
    // piece p has landed and xn (first) or om (proj) is complete
    cp_async_wait_all();
    __syncthreads();
    if (p < n_qkv) {
      const int h = p / 3;
      const int part = p % 3;
      float acc[4][4];
      zero_acc<4>(acc);
      mma_nt<4, C>(acc, sxn + warp * 16 * L::x, L::x, sw, L::x, g, tg);
      float* dst = sqkv + part * kTok * L::d;
      const float* bq = bqkv + part * C + h * kHead;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = n * 8 + tg * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          store_pair(dst + (row0 + half * 8) * L::d + col, acc[n][half * 2] + bq[col],
                     acc[n][half * 2 + 1] + bq[col + 1]);
        }
      }
      if (part == 2) {
        __syncthreads();  // q, k, v of head h are complete
        float s[1][8][4];
        zero_acc<8>(s[0]);
        mma_nt<8, kHead>(s[0], sqkv + warp * 16 * L::d, L::d, sqkv + kTok * L::d, L::d, g, tg);
        window_probs(s[0], bias + static_cast<size_t>(h) * nt * nt, mask_w, nt, scale, row0, tg);
        float o[1][4][4];
        zero_acc<4>(o[0]);
        mma_from_acc<1, 4>(o, s, strip_w, StripElems<float>::per_row, sqkv + 2 * kTok * L::d,
                           L::d, g, tg);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            store_pair(som + (row0 + half * 8) * L::x + h * kHead + n * 8 + tg * 2,
                       o[0][n][half * 2], o[0][n][half * 2 + 1]);
          }
        }
      }
    } else {
      const int j0 = (p - n_qkv) * kHead;  // output columns j0 .. j0 + 32
      float acc[4][4];
      zero_acc<4>(acc);
      mma_nt<4, C>(acc, som + warp * 16 * L::x, L::x, sw, L::x, g, tg);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + half * 8;
        if (r < nt) {
          const size_t at = window_pixel(b, Hp, Wp, ws, y0, x0, r) * C + j0;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = n * 8 + tg * 2;
            store_pair(y + at + col, x[at + col] + (acc[n][half * 2] + bproj[j0 + col]),
                       x[at + col + 1] + (acc[n][half * 2 + 1] + bproj[j0 + col + 1]));
          }
        }
      }
    }
    __syncthreads();  // the piece's readers are done
    if (p + 1 < n_pieces) stage_piece(p + 1);
  }
}

template <int C>
cudaError_t launch(const float* x, const float* ln_g, const float* ln_b, const float* wqkv,
                   const float* bqkv, const float* wproj, const float* bproj, const float* bias,
                   const float* mask, float* y, int B, int Hp, int Wp, int H, int ws, float scale,
                   float eps, cudaStream_t stream) {
  const size_t smem = Smem<C>::bytes;
  const cudaError_t err = emct_allow_smem(attn_half_fwd_f32<C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Hp / ws) * (Wp / ws), B);
  attn_half_fwd_f32<C><<<grid, kThreads, smem, stream>>>(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj,
                                                         bias, mask, y, Hp, Wp, H, ws, scale, eps);
  return cudaGetLastError();
}

}  // namespace ah_fwd_fp32
