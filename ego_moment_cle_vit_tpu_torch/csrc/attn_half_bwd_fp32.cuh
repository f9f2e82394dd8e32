// The fp32 fused attention-half backward (kernel 4b off the training dtype)
// on the CUDA cores (mma_tiles.cuh's fp32 tiles), so the results carry no
// bf16 or TF32 rounding.  The bf16 kernels are attn_half_bwd_sm90.cuh;
// attn_half_bwd.cu runs the LayerNorm pass before these and the ordered sums
// after them.
//   1. attention: one block per (window position, head, chunk of images),
//      four warps.  For each image of its chunk it loads the window's xn
//      rows, forms the head's q, k, v (xn against the head's 96 rows of
//      Wqkv, one 32-row piece at a time) and do (dy against the head's 32
//      columns of Wproj, staged transposed), and runs the attention backward
//      as the window-attention backward does.  It writes om's and dqkv's
//      columns of the head to scratch and keeps its [T, T] bias-gradient sum
//      in registers, one partial per block.
//   2. dx: one block per 64 token rows (walking row tiles): dxn = dqkv Wqkv
//      as a tiled product (64-deep slices by cp.async, double buffered), into
//      an fp32 [64][C] tile, then the LayerNorm backward one warp per row,
//      dx written, and per-column dln_g / dln_b sums kept per lane: one
//      partial per block.
//   3. weight gradients: one block per (64 x 64 tile of dwqkv or dwproj,
//      chunk of tokens): the product X^T Y of two token-major tiles
//      (dqkv^T xn, dy^T om) over the chunk, one partial per block; the blocks
//      of the first column of tiles also sum their X columns (dbqkv, dbproj).
#pragma once

#include "attn_half.cuh"

namespace ah_bwd_fp32 {

using namespace attn_half;
using T = float;

// ---------------------------------------------------------------------------
// 1. attention, per (window, head, chunk of images)
// ---------------------------------------------------------------------------

template <int C>
struct AttnSmem {
  using L = Ld<T, C>;
  // one weight piece at a time (C = 256 has room for no more), staged when
  // needed
  static constexpr int kPiece = kHead * L::x;
  // xn and dy [kTok][C] (one buffer, xn then dy); the piece; q, k, v, do
  // [kTok][d]; q^T, do^T [d][kTok]; P~^T, ds~^T [kTok][kTok]; the strips
  static constexpr size_t bytes =
      (static_cast<size_t>(kTok) * L::x + kPiece + 4 * kTok * L::d + 2 * kHead * L::t +
       2 * kTok * L::t + kWarps * 16 * StripElems<T>::per_row) *
      sizeof(T);
};

// dst[i][o] = wproj[o][col0 + i] for i < 32, o < C: rows col0 .. col0 + 32 of
// Wproj^T, the B operand of do = dy Wproj for one head.
template <int C>
__device__ void stage_proj_columns(T* dst, const T* __restrict__ wproj, int col0, int tid) {
  for (int e = tid; e < kHead * C; e += kThreads) {
    const int o = e / kHead;
    const int i = e % kHead;
    dst[i * Ld<T, C>::x + o] = wproj[static_cast<size_t>(o) * C + col0 + i];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_attention(const T* __restrict__ xn, const T* __restrict__ wqkv,
                        const T* __restrict__ bqkv, const T* __restrict__ wproj,
                        const float* __restrict__ bias, const float* __restrict__ mask,
                        const T* __restrict__ dy, T* __restrict__ om_out,
                        T* __restrict__ dqkv_out, float* __restrict__ partial, int B, int Hp,
                        int Wp, int H, int ws, float scale, int images_per_block) {
  using S = AttnSmem<C>;
  using L = Ld<T, C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sxn = reinterpret_cast<T*>(smem_raw);
  T* sdy = sxn;  // the same buffer, after xn
  T* sw = sxn + kTok * L::x;
  T* sq = sw + S::kPiece;
  T* sk = sq + kTok * L::d;
  T* sv = sk + kTok * L::d;
  T* sdo = sv + kTok * L::d;
  T* sqt = sdo + kTok * L::d;   // q^T [d][token]
  T* sdot = sqt + kHead * L::t;  // do^T [d][token]
  T* spt = sdot + kHead * L::t;  // P~^T [key][query]
  T* sdst = spt + kTok * L::t;   // ds~^T [key][query]
  T* strip = sdst + kTok * L::t;  // fp32 only: [kWarps][16][per_row]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int nt = ws * ws;
  const int nwx = Wp / ws;
  const int win = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const float* bias_h = bias + static_cast<size_t>(h) * nt * nt;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;
  const int row0 = warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  T* strip_w = strip + warp * 16 * StripElems<T>::per_row;

  // piece p < 3: the q, k or v rows of head h in Wqkv; piece 3: Wproj's
  // columns of head h, transposed
  auto stage_piece = [&](int p, T* dst) {
    if (p < 3) {
      stage_tile<T, kHead, C, kThreads>(dst, wqkv + static_cast<size_t>(p * C + h * kHead) * C, C,
                                        0, kHead, tid);
    } else {
      stage_proj_columns<C>(dst, wproj, h * kHead, tid);
    }
  };
  auto piece = [&](int p) -> const T* {
    __syncthreads();  // the previous piece's readers are done
    stage_piece(p, sw);
    __syncthreads();
    return sw;
  };

  // a row of the window's tile -> this head's columns of the token in a
  // [B, Hp, Wp, width] map
  auto token = [&](int b, int r, int width) {
    return window_pixel(b, Hp, Wp, ws, y0, x0, r) * width + h * kHead;
  };

  float dbias_acc[8][4];
  zero_acc<8>(dbias_acc);
  const int b_begin = blockIdx.y * images_per_block;
  const int b_end = min(B, b_begin + images_per_block);
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();  // the previous image's products are done with shared memory
    load_window_async<T, C>(sxn, xn, b, Hp, Wp, ws, y0, x0, nt, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // q, k, v of head h, one piece at a time; q also transposed
    for (int p = 0; p < 3; ++p) {
      const T* w = piece(p);
      float acc[4][4];
      zero_acc<4>(acc);
      mma_nt<4, C>(acc, sxn + warp * 16 * L::x, L::x, w, L::x, g, tg);
      {
        T* dst = p == 0 ? sq : (p == 1 ? sk : sv);
        const T* bq = bqkv + p * C + h * kHead;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = n * 8 + tg * 2;
          const float b0 = to_f32(bq[col]);
          const float b1 = to_f32(bq[col + 1]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row0 + half * 8;
            const float v0 = acc[n][half * 2] + b0;
            const float v1 = acc[n][half * 2 + 1] + b1;
            store_pair(dst + r * L::d + col, v0, v1);
            if (p == 0) {
              sqt[col * L::t + r] = from_f32<T>(v0);
              sqt[(col + 1) * L::t + r] = from_f32<T>(v1);
            }
          }
        }
      }
    }
    __syncthreads();  // xn's readers are done
    load_window_async<T, C>(sdy, dy, b, Hp, Wp, ws, y0, x0, nt, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // do = dy Wproj for the head's columns, rounded; also transposed
    {
      const T* w = piece(3);
      float acc[4][4];
      zero_acc<4>(acc);
      mma_nt<4, C>(acc, sdy + warp * 16 * L::x, L::x, w, L::x, g, tg);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = n * 8 + tg * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + half * 8;
          const float v0 = acc[n][half * 2];
          const float v1 = acc[n][half * 2 + 1];
          store_pair(sdo + r * L::d + col, v0, v1);
          sdot[col * L::t + r] = from_f32<T>(v0);
          sdot[(col + 1) * L::t + r] = from_f32<T>(v1);
        }
      }
    }
    __syncthreads();  // q, k, v, do and the transposes are complete

    // S = q k^T and dp = do v^T for the warp's 16 queries, all 64 keys
    float s[1][8][4], dp[1][8][4];
    zero_acc<8>(s[0]);
    zero_acc<8>(dp[0]);
    mma_nt<8, kHead>(s[0], sq + warp * 16 * L::d, L::d, sk, L::d, g, tg);
    mma_nt<8, kHead>(dp[0], sdo + warp * 16 * L::d, L::d, sv, L::d, g, tg);
    window_probs(s[0], bias_h, mask_w, nt, scale, row0, tg);

    // om = P~ v, for dwproj
    float o[1][4][4];
    zero_acc<4>(o[0]);
    mma_from_acc<1, 4>(o, s, strip_w, StripElems<T>::per_row, sv, L::d, g, tg);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + half * 8;
      if (r < nt) {
        T* dst = om_out + token(b, r, C);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          store_pair(dst + n * 8 + tg * 2, o[0][n][half * 2], o[0][n][half * 2 + 1]);
        }
      }
    }

    // delta = rowsum(dp P), ds = P (dp - delta) in dp's registers; the bias
    // gradient; P~^T and ds~^T for the products over queries
    float delta0 = 0.f, delta1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      delta0 += dp[0][n][0] * s[0][n][0] + dp[0][n][1] * s[0][n][1];
      delta1 += dp[0][n][2] * s[0][n][2] + dp[0][n][3] * s[0][n][3];
    }
    delta0 = quad_sum(delta0);
    delta1 = quad_sum(delta1);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = n * 8 + tg * 2 + u;
        const float ds0 = s[0][n][u] * (dp[0][n][u] - delta0);
        const float ds1 = s[0][n][2 + u] * (dp[0][n][2 + u] - delta1);
        dbias_acc[n][u] += ds0;
        dbias_acc[n][2 + u] += ds1;
        spt[j * L::t + row0] = from_f32<T>(s[0][n][u]);
        spt[j * L::t + row0 + 8] = from_f32<T>(s[0][n][2 + u]);
        sdst[j * L::t + row0] = from_f32<T>(ds0);
        sdst[j * L::t + row0 + 8] = from_f32<T>(ds1);
        dp[0][n][u] = ds0;
        dp[0][n][2 + u] = ds1;
      }
    }

    // dq = ds~ k * scale
    float dq[1][4][4];
    zero_acc<4>(dq[0]);
    mma_from_acc<1, 4>(dq, dp, strip_w, StripElems<T>::per_row, sk, L::d, g, tg);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + half * 8;
      if (r < nt) {
        T* dst = dqkv_out + token(b, r, 3 * C);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          store_pair(dst + n * 8 + tg * 2, dq[0][n][half * 2] * scale,
                     dq[0][n][half * 2 + 1] * scale);
        }
      }
    }
    __syncthreads();  // P~^T and ds~^T are complete

    // dk = ds~^T q * scale and dv = P~^T do for the warp's 16 keys
    float dk[4][4], dv[4][4];
    zero_acc<4>(dk);
    zero_acc<4>(dv);
    mma_nt<4, kTok>(dk, sdst + warp * 16 * L::t, L::t, sqt, L::t, g, tg);
    mma_nt<4, kTok>(dv, spt + warp * 16 * L::t, L::t, sdot, L::t, g, tg);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + half * 8;
      if (r < nt) {
        T* dst = dqkv_out + token(b, r, 3 * C);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = n * 8 + tg * 2;
          store_pair(dst + C + col, dk[n][half * 2] * scale, dk[n][half * 2 + 1] * scale);
          store_pair(dst + 2 * C + col, dv[n][half * 2], dv[n][half * 2 + 1]);
        }
      }
    }
  }

  // one [T, T] partial per block: partial[chunk][win][h][T*T]
  float* out = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * nt * nt;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = n * 8 + tg * 2 + u;
      if (j < nt) {
        if (row0 < nt) out[row0 * nt + j] = dbias_acc[n][u];
        if (row0 + 8 < nt) out[(row0 + 8) * nt + j] = dbias_acc[n][2 + u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dx: dxn = dqkv Wqkv, then the LayerNorm backward
// ---------------------------------------------------------------------------

template <int C>
struct DxSmem {
  static constexpr int LD = kSlice + TilePad<T>::value;  // [64][64] slices
  static constexpr int LDF = C + 4;                      // the fp32 dxn tile [64][C]
  // two buffers of (dqkv slice, Wqkv slice); dxn
  static constexpr size_t bytes =
      4 * static_cast<size_t>(kSlice) * LD * sizeof(T) + static_cast<size_t>(kTok) * LDF * 4;
};

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_dx(const T* __restrict__ x, const float* __restrict__ ln_g,
                 const T* __restrict__ wqkv, const T* __restrict__ dy,
                 const T* __restrict__ dqkv, T* __restrict__ dx, float* __restrict__ partial,
                 int M, float eps) {
  using S = DxSmem<C>;
  constexpr int E = C / 32;
  constexpr int kDepth = 3 * C / kSlice;          // slices of the contraction
  constexpr int kSteps = (C / kSlice) * kDepth;   // (column piece, slice) steps of a row tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sbuf = reinterpret_cast<T*>(smem_raw);
  float* sdxn = reinterpret_cast<float*>(sbuf + 4 * kSlice * S::LD);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int n_rt = (M + kTok - 1) / kTok;
  float dg[E], db[E];  // this lane's columns' sums of dxn xhat and dxn
#pragma unroll
  for (int e = 0; e < E; ++e) dg[e] = db[e] = 0.f;

  for (int rt = blockIdx.x; rt < n_rt; rt += gridDim.x) {
    const int m0 = rt * kTok;
    // step s: output columns (s / kDepth) 64 .. + 64, contraction (s % kDepth) 64 .. + 64
    auto fetch = [&](int step, int buf) {
      const int n0 = (step / kDepth) * kSlice;
      const int k0 = (step % kDepth) * kSlice;
      T* sa = sbuf + buf * 2 * kSlice * S::LD;
      stage_tile_async<T, kSlice, kSlice, kThreads>(sa, dqkv + k0, 3 * C, m0, M, tid);
      stage_tile_async<T, kSlice, kSlice, kThreads>(sa + kSlice * S::LD, wqkv + n0, C, k0, 3 * C,
                                                    tid);
      cp_async_commit();
    };
    __syncthreads();  // the previous tile's epilogue is done with shared memory
    fetch(0, 0);
    float acc[8][4];
    zero_acc<8>(acc);
    for (int step = 0; step < kSteps; ++step) {
      // this slice has landed and the other buffer's products are done
      cp_async_wait_all();
      __syncthreads();
      if (step + 1 < kSteps) fetch(step + 1, (step + 1) & 1);
      const T* sa = sbuf + (step & 1) * 2 * kSlice * S::LD;
      mma_nn<8, kSlice>(acc, sa + warp * 16 * S::LD, S::LD, sa + kSlice * S::LD, S::LD, g, tg);
      if (step % kDepth == kDepth - 1) {  // a column piece is complete
        const int n0 = (step / kDepth) * kSlice;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* dst = sdxn + (warp * 16 + g + half * 8) * S::LDF + n0 + n * 8 + tg * 2;
            dst[0] = acc[n][half * 2];
            dst[1] = acc[n][half * 2 + 1];
          }
        }
        zero_acc<8>(acc);
      }
    }
    __syncthreads();  // dxn is complete

    // the LayerNorm backward, one warp per row
    for (int r = warp; r < kTok; r += kWarps) {
      const int m = m0 + r;
      if (m >= M) break;
      const T* xr = x + static_cast<size_t>(m) * C;
      float v[E], dxh[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = to_f32(xr[e * 32 + lane]);
      const float rstd = center_row<E>(v, eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = e * 32 + lane;
        const float xhat = v[e] * rstd;
        const float dn = sdxn[r * S::LDF + c];
        dg[e] += dn * xhat;
        db[e] += dn;
        dxh[e] = dn * __ldg(ln_g + c);
        v[e] = xhat;
        s1 += dxh[e];
        s2 += dxh[e] * xhat;
      }
      const float mean1 = warp_sum(s1) / C;
      const float mean2 = warp_sum(s2) / C;
      const T* dyr = dy + static_cast<size_t>(m) * C;
      T* dxr = dx + static_cast<size_t>(m) * C;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = e * 32 + lane;
        dxr[c] = from_f32<T>(to_f32(dyr[c]) + rstd * (dxh[e] - mean1 - v[e] * mean2));
      }
    }
  }

  // the block's dln_g, dln_b partials, its warps added in a fixed order
  __syncthreads();
  float* sred = sdxn;  // [kWarps][2][C]
#pragma unroll
  for (int e = 0; e < E; ++e) {
    sred[(warp * 2) * C + e * 32 + lane] = dg[e];
    sred[(warp * 2 + 1) * C + e * 32 + lane] = db[e];
  }
  __syncthreads();
  for (int c = tid; c < 2 * C; c += kThreads) {
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += sred[w * 2 * C + c];
    partial[static_cast<size_t>(blockIdx.x) * 2 * C + c] = a;
  }
}

// ---------------------------------------------------------------------------
// 3. weight gradients: dwqkv = dqkv^T xn, dwproj = dy^T om, and column sums
// ---------------------------------------------------------------------------

struct WgradSmem {
  static constexpr int LD = kSlice + TilePad<T>::value;
  static constexpr size_t bytes = 4 * static_cast<size_t>(kSlice) * LD * sizeof(T);
};

template <int C>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_wgrad(const T* __restrict__ dqkv, const T* __restrict__ xn,
                    const T* __restrict__ dy, const T* __restrict__ om,
                    float* __restrict__ partial_w, float* __restrict__ partial_col, int M,
                    int per_chunk) {
  using S = WgradSmem;
  constexpr int kCols = C / kSlice;                 // tile columns of either gradient
  constexpr int kQkvTiles = (3 * C / kSlice) * kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sbuf = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int chunk = blockIdx.y;
  const bool qkv = blockIdx.x < kQkvTiles;
  const int tile = qkv ? blockIdx.x : blockIdx.x - kQkvTiles;
  const int rt = tile / kCols;  // output rows rt 64 .. + 64 (columns of X)
  const int ct = tile % kCols;  // output columns ct 64 .. + 64 (columns of Y)
  const T* X = (qkv ? dqkv : dy) + rt * kSlice;
  const int ldx = qkv ? 3 * C : C;
  const T* Y = (qkv ? xn : om) + ct * kSlice;
  const int m_begin = chunk * per_chunk;
  const int m_end = min(M, m_begin + per_chunk);
  const int n_k = (m_end - m_begin + kSlice - 1) / kSlice;
  const bool sums = ct == 0;  // the first column of tiles also sums X's columns

  auto fetch = [&](int kt, int buf) {
    T* sa = sbuf + buf * 2 * kSlice * S::LD;
    stage_tile_async<T, kSlice, kSlice, kThreads>(sa, X, ldx, m_begin + kt * kSlice, m_end, tid);
    stage_tile_async<T, kSlice, kSlice, kThreads>(sa + kSlice * S::LD, Y, C,
                                                  m_begin + kt * kSlice, m_end, tid);
    cp_async_commit();
  };
  fetch(0, 0);
  float acc[8][4];
  zero_acc<8>(acc);
  float colsum = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    // this slice has landed and the other buffer's products are done
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_k) fetch(kt + 1, (kt + 1) & 1);
    const T* sa = sbuf + (kt & 1) * 2 * kSlice * S::LD;
    mma_tn<8, kSlice>(acc, sa + warp * 16, S::LD, sa + kSlice * S::LD, S::LD, g, tg);
    if (sums && tid < kSlice) {
      for (int r = 0; r < kSlice; ++r) colsum += to_f32(sa[r * S::LD + tid]);
    }
  }

  float* out = partial_w + static_cast<size_t>(chunk) * 4 * C * C + (qkv ? 0 : 3 * C * C) +
               static_cast<size_t>(rt * kSlice) * C + ct * kSlice;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* dst = out + static_cast<size_t>(warp * 16 + g + half * 8) * C + n * 8 + tg * 2;
      dst[0] = acc[n][half * 2];
      dst[1] = acc[n][half * 2 + 1];
    }
  }
  if (sums && tid < kSlice) {
    partial_col[static_cast<size_t>(chunk) * 4 * C + (qkv ? 0 : 3 * C) + rt * kSlice + tid] =
        colsum;
  }
}

}  // namespace ah_bwd_fp32
