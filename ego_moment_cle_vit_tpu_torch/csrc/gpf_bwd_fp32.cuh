// The fp32 dX of the GPF backward (kernel 2b, gpf_bwd.cu), off the main
// paths: the fp32 comparisons and the fp64 witness of chip_smoke.py.  The bf16
// dX is gpf_bwd_sm90.cuh.
//
// One block per (batch element, 64 rows, 64 features) streams the fp32
// factor W (the w kernel's [B, 2, N, N] scratch) and the tokens through shared
// memory and forms dX = W X on the CUDA cores in fp32 (mma_tiles.cuh's fp32
// mma_nt), then the folded cosine term dx_i -= gate_i proj_i / m_i^2 x_i with
// proj_i summed over the column tiles in order.  Its first block per batch
// element adds the dc partials in order.
#pragma once

#include "gpf_tiles.cuh"

namespace gpf_fp32 {

__global__ void __launch_bounds__(kThreads)
dx_kernel(const float* __restrict__ ta, const float* __restrict__ tp,
          const float* __restrict__ wmat, const float* __restrict__ proj_part,
          const float* __restrict__ norms, const float* __restrict__ dc_part,
          float* __restrict__ dta, float* __restrict__ dtp, float* __restrict__ dc, int N, int D,
          int P, int Q, int cosine, int tiles) {
  constexpr int LD = kTile + TilePad<float>::value;
  __shared__ __align__(16) float sw[kTile * LD];   // W tile [row][column token]
  __shared__ __align__(16) float sxt[kTile * LD];  // token tile transposed [feature][token]

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int d0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int tg = tid & 3;

  if (blockIdx.x == 0 && blockIdx.y == 0) sum_dc(dc_part, dc, b, P, Q, tiles);

  for (int set = 0; set < 2; ++set) {
    const float* x = (set ? tp : ta) + static_cast<size_t>(b) * N * D;
    float* dx = (set ? dtp : dta) + static_cast<size_t>(b) * N * D;
    const float* wm = wmat + (static_cast<size_t>(b) * 2 + set) * N * N;
    float acc[8][4];
    zero_acc<8>(acc);
    for (int jt = 0; jt < tiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile;
        const int c = e % kTile;
        sw[r * LD + c] =
            (i0 + r < N && j0 + c < N) ? wm[static_cast<size_t>(i0 + r) * N + j0 + c] : 0.f;
        // r: token of the tile, c: feature
        sxt[c * LD + r] =
            (j0 + r < N && d0 + c < D) ? x[static_cast<size_t>(j0 + r) * D + d0 + c] : 0.f;
      }
      __syncthreads();
      mma_nt<8, kTile>(acc, sw + warp * 16 * LD, LD, sxt, LD, g, tg);
    }

    // rows g and g + 8 of this warp: gate_i proj_i / m_i^2
    float fold[2] = {0.f, 0.f};
    if (cosine) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + warp * 16 + g + half * 8;
        if (i < N) fold[half] = cosine_fold(proj_part, norms, b, set, i, N, tiles);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + warp * 16 + g + (e >> 1) * 8;
        const int c = d0 + n * 8 + tg * 2 + (e & 1);
        if (i < N && c < D) {
          const size_t off = static_cast<size_t>(i) * D + c;
          float v = acc[n][e];
          if (cosine) v -= fold[e >> 1] * x[off];
          dx[off] = v;
        }
      }
    }
  }
}

}  // namespace gpf_fp32
