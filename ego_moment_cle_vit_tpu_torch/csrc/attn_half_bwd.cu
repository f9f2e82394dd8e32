// The attention half of a Swin block, fused, backward.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/attn_half.py, _bwd_kernel
//   (the VJP of fused_attn_half_spatial).
//
// Computes, from the forward's inputs and dy[B, Hp, Wp, C] (M = B Hp Wp
// tokens, T = ws*ws, d = 32, C in {128, 256}), at the TPU kernel's rounding
// points:
//   xn, qkv, P, om          recomputed as in the forward (xn, qkv, om rounded)
//   dom = dy Wproj          fp32, rounded
//   per head: dv = P~^T do, dp = do v^T, ds = P (dp - rowsum(dp P)),
//             dq = ds~ k * scale, dk = ds~^T q * scale   (P~, ds~, dq, dk, dv
//             rounded); dbias[h] = sum of fp32 ds over images and windows
//   dwproj = dy^T om,  dbproj = sum of fp32 dy
//   dwqkv = dqkv^T xn, dbqkv = sum of the rounded dqkv
//   dxn = dqkv Wqkv (fp32), then the fp32 LayerNorm backward:
//   dln_g = sum dxn xhat, dln_b = sum dxn,
//   dx = dy + rstd (dxn g - mean(dxn g) - xhat mean(dxn g xhat))
// with the weights in the port's [out, in] layout.  The mask gets no gradient.
//
// What bounds it on an H100: operations (the recomputed forward plus about
// three times its products, ~40 flops per byte of x, dy and dx at C = 128).
//
// Design.  The TPU kernel adds the seven parameter gradients into resident
// output blocks across a grid that runs in order.  A CUDA grid has no order,
// and per-window partials of the weight gradients would not fit (one dwqkv
// partial is 786 KB in fp32 at C = 256, against 2,048 windows at stage 1 of a
// batch of 128).  So the work is cut in three kernels, and every sum over
// tokens is taken in a fixed order, without float atomics:
//   0. LayerNorm: xn for every token, one warp per row, to scratch (the
//      forward's arithmetic, so the same bits).
//   1. attention: one block per (window position, head, chunk of images),
//      four warps.  For each image of its chunk it loads the window's xn
//      rows, forms the head's q, k, v (xn against the head's 96 rows of
//      Wqkv, one product) and do (dy against the head's 32 columns of
//      Wproj, staged transposed), the weights resident in shared memory in
//      bf16, and runs the attention backward as the window-attention
//      backward kernel does.  It writes om's and dqkv's columns of the head
//      to scratch (in the input type) and keeps its [T, T] bias-gradient sum
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
//   Then small kernels add the partials in a fixed order.
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, fp32
// accumulate); fp32 runs the same code on the CUDA cores (mma_tiles.cuh).

#include "attn_half.cuh"

using namespace attn_half;

namespace {

// ---------------------------------------------------------------------------
// 0. xn = LayerNorm(x) * ln_g + ln_b for every token, rounded: the attention
//    kernel's q, k, v input and the weight-gradient kernel's dwqkv operand
// ---------------------------------------------------------------------------

constexpr int kLnWarps = 8;  // rows per block of the LayerNorm pass

template <typename T, int C>
__global__ void __launch_bounds__(kLnWarps * 32)
attn_half_bwd_layer_norm(const T* __restrict__ x, const float* __restrict__ ln_g,
                         const float* __restrict__ ln_b, T* __restrict__ xn, int M, float eps) {
  constexpr int E = C / 32;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* src = x + static_cast<size_t>(m) * C;
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = to_f32(src[e * 32 + lane]);
  const float rstd = center_row<E>(v, eps);
  T* dst = xn + static_cast<size_t>(m) * C;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = e * 32 + lane;
    dst[c] = from_f32<T>(v[e] * rstd * __ldg(ln_g + c) + __ldg(ln_b + c));
  }
}

// ---------------------------------------------------------------------------
// 1. attention, per (window, head, chunk of images)
// ---------------------------------------------------------------------------

template <typename T, int C>
struct AttnSmem {
  using L = Ld<T, C>;
  // bf16 keeps its four weight pieces resident across the images; fp32 at
  // C = 256 has room for one, staged when needed
  static constexpr bool kResident = sizeof(T) == 2;
  static constexpr int kPiece = kHead * L::x;
  // xn and dy [kTok][C] (one buffer, xn then dy, unless C = 256 in bf16,
  // where one block per SM fits either way and both load at once); the
  // pieces; q, k, v, do [kTok][d]; q^T, do^T [d][kTok]; P~^T, ds~^T
  // [kTok][kTok]; fp32: the strips
  static constexpr int kActs = kResident && C == 256 ? 2 : 1;
  static constexpr size_t bytes =
      (static_cast<size_t>(kActs) * kTok * L::x + (kResident ? 4 : 1) * kPiece + 4 * kTok * L::d +
       2 * kHead * L::t + 2 * kTok * L::t + kWarps * 16 * StripElems<T>::per_row) *
      sizeof(T);
};

// dst[i][o] = wproj[o][col0 + i] for i < 32, o < C: rows col0 .. col0 + 32 of
// Wproj^T, the B operand of do = dy Wproj for one head.
template <typename T, int C>
__device__ void stage_proj_columns(T* dst, const T* __restrict__ wproj, int col0, int tid) {
  for (int e = tid; e < kHead * C; e += kThreads) {
    const int o = e / kHead;
    const int i = e % kHead;
    dst[i * Ld<T, C>::x + o] = wproj[static_cast<size_t>(o) * C + col0 + i];
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_attention(const T* __restrict__ xn, const T* __restrict__ wqkv,
                        const T* __restrict__ bqkv, const T* __restrict__ wproj,
                        const float* __restrict__ bias, const float* __restrict__ mask,
                        const T* __restrict__ dy, T* __restrict__ om_out,
                        T* __restrict__ dqkv_out, float* __restrict__ partial, int B, int Hp,
                        int Wp, int H, int ws, float scale, int images_per_block) {
  using S = AttnSmem<T, C>;
  using L = Ld<T, C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sxn = reinterpret_cast<T*>(smem_raw);
  T* sdy = sxn + (S::kActs - 1) * kTok * L::x;  // fp32: the same buffer, after xn
  T* sw = sxn + S::kActs * kTok * L::x;
  T* sq = sw + (S::kResident ? 4 : 1) * S::kPiece;
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
      stage_proj_columns<T, C>(dst, wproj, h * kHead, tid);
    }
  };
  auto piece = [&](int p) -> const T* {
    if constexpr (S::kResident) {
      return sw + p * S::kPiece;
    } else {
      __syncthreads();  // the previous piece's readers are done
      stage_piece(p, sw);
      __syncthreads();
      return sw;
    }
  };
  if constexpr (S::kResident) {
    // made visible by the barrier after the first image's xn
    for (int p = 0; p < 4; ++p) stage_piece(p, sw + p * S::kPiece);
  }

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
    if constexpr (S::kActs == 2) load_window_async<T, C>(sdy, dy, b, Hp, Wp, ws, y0, x0, nt, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // q, k, v of head h (bf16: one product over the three resident pieces);
    // q also transposed
    constexpr int kQ = S::kResident ? 3 : 1;
    for (int p0 = 0; p0 < 3; p0 += kQ) {
      const T* w = piece(p0);
      float acc[4 * kQ][4];
      zero_acc<4 * kQ>(acc);
      mma_nt<4 * kQ, C>(acc, sxn + warp * 16 * L::x, L::x, w, L::x, g, tg);
#pragma unroll
      for (int gi = 0; gi < kQ; ++gi) {
        const int p = p0 + gi;
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
            const float v0 = acc[gi * 4 + n][half * 2] + b0;
            const float v1 = acc[gi * 4 + n][half * 2 + 1] + b1;
            store_pair(dst + r * L::d + col, v0, v1);
            if (p == 0) {
              sqt[col * L::t + r] = from_f32<T>(v0);
              sqt[(col + 1) * L::t + r] = from_f32<T>(v1);
            }
          }
        }
      }
    }
    if constexpr (S::kActs == 1) {
      __syncthreads();  // xn's readers are done
      load_window_async<T, C>(sdy, dy, b, Hp, Wp, ws, y0, x0, nt, tid);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }

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

template <typename T, int C>
struct DxSmem {
  static constexpr int LD = kSlice + TilePad<T>::value;  // [64][64] slices
  static constexpr int LDF = C + 4;                      // the fp32 dxn tile [64][C]
  // two buffers of (dqkv slice, Wqkv slice); dxn
  static constexpr size_t bytes =
      4 * static_cast<size_t>(kSlice) * LD * sizeof(T) + static_cast<size_t>(kTok) * LDF * 4;
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_dx(const T* __restrict__ x, const float* __restrict__ ln_g,
                 const T* __restrict__ wqkv, const T* __restrict__ dy,
                 const T* __restrict__ dqkv, T* __restrict__ dx, float* __restrict__ partial,
                 int M, float eps) {
  using S = DxSmem<T, C>;
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

template <typename T>
struct WgradSmem {
  static constexpr int LD = kSlice + TilePad<T>::value;
  static constexpr size_t bytes = 4 * static_cast<size_t>(kSlice) * LD * sizeof(T);
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_wgrad(const T* __restrict__ dqkv, const T* __restrict__ xn,
                    const T* __restrict__ dy, const T* __restrict__ om,
                    float* __restrict__ partial_w, float* __restrict__ partial_col, int M,
                    int per_chunk) {
  using S = WgradSmem<T>;
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

// ---------------------------------------------------------------------------
// ordered sums of the partials
// ---------------------------------------------------------------------------

// out[e] = sum over c < n_chunks of partial[c * stride + e], in that order.
__global__ void ordered_sum(const float* __restrict__ partial, size_t stride,
                            float* __restrict__ out, int n_chunks, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += partial[static_cast<size_t>(c) * stride + idx];
  out[idx] = acc;
}

// dbias[h][e] = sum over chunks and windows of partial[chunk][win][h][e], in a
// fixed order.
__global__ void dbias_sum(const float* __restrict__ partial, float* __restrict__ dbias,
                          int n_chunks, int n_win, int H, int tt) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * tt) return;
  const int h = idx / tt;
  const int e = idx % tt;
  float acc = 0.f;
  for (int s = 0; s < n_chunks * n_win; ++s) {
    acc += partial[(static_cast<size_t>(s) * H + h) * tt + e];
  }
  dbias[idx] = acc;
}

cudaError_t sum_into(const float* partial, size_t stride, float* out, int n_chunks, int n,
                     cudaStream_t stream) {
  ordered_sum<<<(n + 255) / 256, 256, 0, stream>>>(partial, stride, out, n_chunks, n);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *ln_g, *ln_b, *wqkv, *bqkv, *wproj, *bias, *mask, *dy;
  void *dx, *dln_g, *dln_b, *dwqkv, *dbqkv, *dwproj, *dbproj, *dbias;
  void *xn_s, *om_s, *dqkv_s, *p_bias, *p_w, *p_col, *p_ln;
  int B, Hp, Wp, H, ws;
  float scale, eps;
  int n_attn, n_w, n_dx;
};

template <typename T, int C>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* wqkv = static_cast<const T*>(a.wqkv);
  T* xn_s = static_cast<T*>(a.xn_s);
  T* om_s = static_cast<T*>(a.om_s);
  T* dqkv_s = static_cast<T*>(a.dqkv_s);
  const float* ln_g = static_cast<const float*>(a.ln_g);
  float* p_w = static_cast<float*>(a.p_w);
  float* p_col = static_cast<float*>(a.p_col);
  float* p_ln = static_cast<float*>(a.p_ln);
  const int nt = a.ws * a.ws;
  const int n_win = (a.Hp / a.ws) * (a.Wp / a.ws);
  const int M = a.B * a.Hp * a.Wp;

  attn_half_bwd_layer_norm<T, C><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      x, ln_g, static_cast<const float*>(a.ln_b), xn_s, M, a.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto attention = attn_half_bwd_attention<T, C>;
  if ((err = emct_allow_smem(attention, AttnSmem<T, C>::bytes)) != cudaSuccess) return err;
  const int per_block = (a.B + a.n_attn - 1) / a.n_attn;
  attention<<<dim3(n_win * a.H, a.n_attn), kThreads, AttnSmem<T, C>::bytes, stream>>>(
      xn_s, wqkv, static_cast<const T*>(a.bqkv), static_cast<const T*>(a.wproj),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.mask), dy, om_s, dqkv_s,
      static_cast<float*>(a.p_bias), a.B, a.Hp, a.Wp, a.H, a.ws, a.scale, per_block);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dx_kernel = attn_half_bwd_dx<T, C>;
  if ((err = emct_allow_smem(dx_kernel, DxSmem<T, C>::bytes)) != cudaSuccess) return err;
  dx_kernel<<<a.n_dx, kThreads, DxSmem<T, C>::bytes, stream>>>(
      x, ln_g, wqkv, dy, dqkv_s, static_cast<T*>(a.dx), p_ln, M, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto wgrad = attn_half_bwd_wgrad<T, C>;
  if ((err = emct_allow_smem(wgrad, WgradSmem<T>::bytes)) != cudaSuccess) return err;
  const int n_rt = (M + kSlice - 1) / kSlice;
  const int per_chunk = (n_rt + a.n_w - 1) / a.n_w * kSlice;
  const int tiles = (3 * C / kSlice) * (C / kSlice) + (C / kSlice) * (C / kSlice);
  wgrad<<<dim3(tiles, a.n_w), kThreads, WgradSmem<T>::bytes, stream>>>(
      dqkv_s, xn_s, dy, om_s, p_w, p_col, M, per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t w_stride = 4 * static_cast<size_t>(C) * C;
  if ((err = sum_into(p_w, w_stride, static_cast<float*>(a.dwqkv), a.n_w, 3 * C * C, stream)) ||
      (err = sum_into(p_w + 3 * C * C, w_stride, static_cast<float*>(a.dwproj), a.n_w, C * C,
                      stream)) ||
      (err = sum_into(p_col, 4 * C, static_cast<float*>(a.dbqkv), a.n_w, 3 * C, stream)) ||
      (err = sum_into(p_col + 3 * C, 4 * C, static_cast<float*>(a.dbproj), a.n_w, C, stream)) ||
      (err = sum_into(p_ln, 2 * C, static_cast<float*>(a.dln_g), a.n_dx, C, stream)) ||
      (err = sum_into(p_ln + C, 2 * C, static_cast<float*>(a.dln_b), a.n_dx, C, stream))) {
    return err;
  }
  const int total = a.H * nt * nt;
  dbias_sum<<<(total + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(a.p_bias),
                                                     static_cast<float*>(a.dbias), a.n_attn,
                                                     n_win, a.H, nt * nt);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx [B, Hp, Wp, C], wqkv [3C, C], bqkv [3C], wproj [C, C], bproj [C]
// (dtype; bproj is not read); ln_g, ln_b [C] f32; bias [H, T, T] f32; mask
// [nW, T, T] f32 or null.  Outputs f32: dln_g, dln_b [C], dwqkv [3C, C],
// dbqkv [3C], dwproj [C, C], dbproj [C], dbias [H, T, T].  Scratch: xn_s, om_s
// [M, C] and dqkv_s [M, 3C] (dtype); f32 partials p_bias [n_attn, nW, H, T, T],
// p_w [n_w, 4 C C], p_col [n_w, 4C], p_ln [n_dx, 2C]; n_attn image chunks and
// n_w chunks of 64-token tiles, none of them empty.  Requires C in {128, 256},
// C / H == 32, ws <= 8, Hp and Wp multiples of ws; the Python wrapper checks
// shapes, contiguity and alignment first.
extern "C" int attn_half_bwd(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                             const void* bqkv, const void* wproj, const void* bproj,
                             const void* bias, const void* mask, const void* dy, void* dx,
                             void* dln_g, void* dln_b, void* dwqkv, void* dbqkv, void* dwproj,
                             void* dbproj, void* dbias, void* xn_s, void* om_s, void* dqkv_s,
                             void* p_bias, void* p_w, void* p_col, void* p_ln, int B, int Hp,
                             int Wp, int C, int H, int ws, float scale, float eps, int n_attn,
                             int n_w, int n_dx, int dtype, void* stream) {
  (void)bproj;
  if (B < 1 || H < 1 || C % H != 0 || C / H != kHead || ws < 1 || ws * ws > kTok ||
      Hp % ws != 0 || Wp % ws != 0 || n_attn < 1 || n_attn > B || n_w < 1 || n_dx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = (B + n_attn - 1) / n_attn;
  const int n_rt = (B * Hp * Wp + kSlice - 1) / kSlice;
  const int per_chunk = (n_rt + n_w - 1) / n_w;
  if ((n_attn - 1) * per_block >= B || n_w > n_rt || (n_w - 1) * per_chunk >= n_rt) {
    return static_cast<int>(cudaErrorInvalidValue);  // an empty chunk
  }
  const BwdArgs a{x,      ln_g,  ln_b,   wqkv,   bqkv,  wproj,  bias, mask, dy,
                  dx,     dln_g, dln_b,  dwqkv,  dbqkv, dwproj, dbproj, dbias,
                  xn_s,   om_s,  dqkv_s, p_bias, p_w,   p_col,  p_ln, B,    Hp,
                  Wp,     H,     ws,     scale,  eps,   n_attn, n_w,  n_dx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == EMCT_DTYPE_BF16 && C == 128) {
    err = launch<__nv_bfloat16, 128>(a, s);
  } else if (dtype == EMCT_DTYPE_BF16 && C == 256) {
    err = launch<__nv_bfloat16, 256>(a, s);
  } else if (dtype == EMCT_DTYPE_F32 && C == 128) {
    err = launch<float, 128>(a, s);
  } else if (dtype == EMCT_DTYPE_F32 && C == 256) {
    err = launch<float, 256>(a, s);
  }
  return static_cast<int>(err);
}
