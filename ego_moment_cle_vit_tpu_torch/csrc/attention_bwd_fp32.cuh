// The attention backward for fp32 inputs, on the CUDA cores: shared by the
// packed-layout backward (packed_attention_bwd.cu, with bias and mask) and the
// q-tiled one (flash_attention_bwd.cu, the packed layout with one group and
// neither).  bf16 takes the Hopper kernels of attention_bwd_sm90.cuh; fp32 is
// off every main path and keeps the tile code of mma_tiles.cuh, whose fp32
// products run on the CUDA cores with fmaf, so fp32 results carry no bf16 or
// TF32 rounding.
//
// Per (image-group bw, head h), from qkv[BW, T, 3C], the forward's out[BW, T,
// C] and lse[BW, H, T], dout[BW, T, C], bias[Hb, T, T] and mask[Wm, T, T]:
//   P     = exp(q k^T * scale + bias[h % Hb] + mask[w % Wm] - lse)
//   delta = rowsum(dout * out)
//   dv = P^T dout,  dp = dout v^T,  ds = P * (dp - delta)
//   dq = ds k * scale,  dk = ds^T q * scale
// The work is cut along the axis each result is summed over, so each sum stays
// inside one block (no float atomics: two runs give the same bits):
//   1. dq kernel, one block per 128 query rows: each warp takes delta for its
//      16 rows from dout and out and writes it to a scratch, then walks the key
//      tiles once, rebuilds P from lse, forms ds and adds ds k.
//   2. dk/dv kernel, one block per 128 keys: it walks the query tiles with
//      keys as rows (S^T = k q^T, dp^T = v dout^T), rebuilds P^T and ds^T from
//      lse and delta, and adds P^T dout and ds^T q.
// The tiles of the walked axis arrive by cp.async into two buffers, the next
// under the products of the current one.  Keys past T are zero padding masked
// to -inf; query rows past T are staged as zeros with lse = +inf, so they add
// nothing to dk or dv.
#pragma once

#include "packed_attention.cuh"

namespace fp32_bwd {

template <typename T, int D>
struct Tiles {
  static constexpr int LDD = D + TilePad<T>::value;  // [token][d] tiles
  static constexpr int kOwn = kRows * LDD;            // elements of one [128][d] tile
  static constexpr int kWalk = kCols * LDD;           // elements of one [64][d] tile
  static constexpr int kStrips = kWarps * 16 * StripElems<T>::per_row;  // one strip per warp
  // dq kernel: q, dout; two buffers of (k, v); the ds strips
  static constexpr size_t dq_bytes = (2 * kOwn + 4 * kWalk + kStrips) * sizeof(T);
  // dk/dv kernel: k, v; two buffers of (q, dout); the strips (P^T, then
  // ds^T); two buffers of the query tile's lse and delta
  static constexpr size_t dkv_bytes =
      (2 * kOwn + 4 * kWalk + kStrips) * sizeof(T) + 4 * kCols * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq(const T* __restrict__ qkv, const float* __restrict__ bias,
                 const float* __restrict__ mask, const T* __restrict__ out,
                 const T* __restrict__ dout, const float* __restrict__ lse_in,
                 T* __restrict__ dqkv, float* __restrict__ delta_out, int W, int Tn, int C, int H,
                 int Hb, int Wm, float scale, int n_qt) {
  using S = Tiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + S::kOwn;
  T* skv = sdo + S::kOwn;       // two buffers of k [kCols][LDD], v [kCols][LDD]
  T* sds = skv + 4 * S::kWalk;  // [kWarps][16][per_row]

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
  const T* base = qkv + static_cast<size_t>(bw) * Tn * c3 + h * D;
  const T* dbase = dout + static_cast<size_t>(bw) * Tn * C + h * D;
  const T* obase = out + static_cast<size_t>(bw) * Tn * C + h * D;
  const float* bias_h = bias ? bias + static_cast<size_t>(h % Hb) * Tn * Tn : nullptr;
  const float* mask_w = mask ? mask + static_cast<size_t>(w % Wm) * Tn * Tn : nullptr;
  const size_t stat_row = (static_cast<size_t>(bw) * H + h) * Tn;

  // fetches the (k, v) tile at key k0 into buffer ``buf``, to land under the
  // products of the tile before it
  auto fetch_kv = [&](int buf, int k0) {
    T* nk = skv + buf * 2 * S::kWalk;
    stage_tile_async<T, kCols, D, kThreads>(nk, base + C, c3, k0, Tn, tid);
    stage_tile_async<T, kCols, D, kThreads>(nk + S::kWalk, base + 2 * C, c3, k0, Tn, tid);
    cp_async_commit();
  };
  stage_tile_async<T, kRows, D, kThreads>(sq, base, c3, q0, Tn, tid);
  stage_tile_async<T, kRows, D, kThreads>(sdo, dbase, C, q0, Tn, tid);
  fetch_kv(0, 0);

  float delta0, delta1;
  warp_row_delta<T, D>(dbase, obase, C, Tn, q0 + warp * 16, lane, delta_out + stat_row, delta0,
                       delta1);
  const int r0 = q0 + warp * 16 + g;
  // a query past T: P = exp(. - inf) = 0, so its row adds nothing
  const float lse0 = r0 < Tn ? __ldg(lse_in + stat_row + r0) : INFINITY;
  const float lse1 = r0 + 8 < Tn ? __ldg(lse_in + stat_row + r0 + 8) : INFINITY;

  const T* sq_w = sq + warp * 16 * S::LDD;
  const T* sdo_w = sdo + warp * 16 * S::LDD;
  T* sds_w = sds + warp * 16 * StripElems<T>::per_row;
  const int n_kt = (Tn + kCols - 1) / kCols;
  const bool active = q0 + warp * 16 < Tn;  // a warp whose 16 queries all lie past T only stages

  float dq[1][D / 8][4];
  zero_acc<D / 8>(dq[0]);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    const T* sk = skv + (kt & 1) * 2 * S::kWalk;
    const T* sv = sk + S::kWalk;
    // this tile has landed and the other buffer's products are done
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kt) fetch_kv((kt + 1) & 1, k0 + kCols);
    if (!active) continue;
    float s[1][8][4], dp[8][4];
    zero_acc<8>(s[0]);
    zero_acc<8>(dp);
    mma_nt<8, D>(s[0], sq_w, S::LDD, sk, S::LDD, g, tg);
    mma_nt<8, D>(dp, sdo_w, S::LDD, sv, S::LDD, g, tg);
    to_logits<false>(s[0], bias_h, mask_w, Tn, scale, r0, k0, tg, k0 + kCols <= Tn);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // s becomes ds
      s[0][n][0] = soft_exp<T>(s[0][n][0] - lse0) * (dp[n][0] - delta0);
      s[0][n][1] = soft_exp<T>(s[0][n][1] - lse0) * (dp[n][1] - delta0);
      s[0][n][2] = soft_exp<T>(s[0][n][2] - lse1) * (dp[n][2] - delta1);
      s[0][n][3] = soft_exp<T>(s[0][n][3] - lse1) * (dp[n][3] - delta1);
    }
    mma_from_acc<1, D / 8>(dq, s, sds_w, StripElems<T>::per_row, sk, S::LDD, g, tg);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < Tn) {
      T* dst = dqkv + (static_cast<size_t>(bw) * Tn + r) * c3 + h * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store_pair(dst + dn * 8 + tg * 2, dq[0][dn][half * 2] * scale,
                   dq[0][dn][half * 2 + 1] * scale);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv(const T* __restrict__ qkv, const float* __restrict__ bias,
                  const float* __restrict__ mask, const T* __restrict__ dout,
                  const float* __restrict__ lse_in, const float* __restrict__ delta_in,
                  T* __restrict__ dqkv, int W, int Tn, int C, int H, int Hb, int Wm, float scale,
                  int n_rt) {
  using S = Tiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + S::kOwn;
  T* sqdo = sv + S::kOwn;        // two buffers of q [kCols][LDD], dout [kCols][LDD]
  T* sst = sqdo + 4 * S::kWalk;  // [kWarps][16][per_row], P^T then ds^T
  float* sstat = reinterpret_cast<float*>(sst + S::kStrips);  // two buffers of lse, delta [kCols]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int kt = blockIdx.x % n_rt;
  const int h = (blockIdx.x / n_rt) % H;
  const int bw = blockIdx.x / (n_rt * H);
  const int w = bw % W;
  const int k0 = kt * kRows;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(bw) * Tn * c3 + h * D;
  const T* dbase = dout + static_cast<size_t>(bw) * Tn * C + h * D;
  const float* bias_h = bias ? bias + static_cast<size_t>(h % Hb) * Tn * Tn : nullptr;
  const float* mask_w = mask ? mask + static_cast<size_t>(w % Wm) * Tn * Tn : nullptr;
  const size_t stat_row = (static_cast<size_t>(bw) * H + h) * Tn;

  // fetches the (q, dout) tile at query q0 and its row statistics into buffer
  // ``buf``, to land under the products of the tile before it
  auto fetch_qdo = [&](int buf, int q0) {
    T* nq = sqdo + buf * 2 * S::kWalk;
    stage_tile_async<T, kCols, D, kThreads>(nq, base, c3, q0, Tn, tid);
    stage_tile_async<T, kCols, D, kThreads>(nq + S::kWalk, dbase, C, q0, Tn, tid);
    cp_async_commit();
    if (tid < kCols) {
      const int i = q0 + tid;
      // a query past T: P = exp(. - inf) = 0
      sstat[buf * 2 * kCols + tid] = i < Tn ? lse_in[stat_row + i] : INFINITY;
      sstat[buf * 2 * kCols + kCols + tid] = i < Tn ? delta_in[stat_row + i] : 0.f;
    }
  };
  stage_tile_async<T, kRows, D, kThreads>(sk, base + C, c3, k0, Tn, tid);
  stage_tile_async<T, kRows, D, kThreads>(sv, base + 2 * C, c3, k0, Tn, tid);
  fetch_qdo(0, 0);

  const T* sk_w = sk + warp * 16 * S::LDD;
  const T* sv_w = sv + warp * 16 * S::LDD;
  T* sst_w = sst + warp * 16 * StripElems<T>::per_row;
  const int r0 = k0 + warp * 16 + g;  // this thread's first key
  float dk[1][D / 8][4], dv[1][D / 8][4];
  zero_acc<D / 8>(dk[0]);
  zero_acc<D / 8>(dv[0]);

  const bool keys_valid = k0 + (warp + 1) * 16 <= Tn;  // this warp's 16 keys
  const bool active = k0 + warp * 16 < Tn;  // a warp whose 16 keys all lie past T only stages
  const int n_qt = (Tn + kCols - 1) / kCols;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kCols;
    const T* sq = sqdo + (qt & 1) * 2 * S::kWalk;
    const T* sdo = sq + S::kWalk;
    const float* slse = sstat + (qt & 1) * 2 * kCols;
    const float* sdelta = slse + kCols;
    // this tile has landed and the other buffer's products are done
    cp_async_wait_all();
    __syncthreads();
    if (qt + 1 < n_qt) fetch_qdo((qt + 1) & 1, q0 + kCols);
    if (!active) continue;

    float st[1][8][4], dpt[1][8][4];  // S^T and dp^T: 16 keys x 64 queries
    zero_acc<8>(st[0]);
    zero_acc<8>(dpt[0]);
    mma_nt<8, D>(st[0], sk_w, S::LDD, sq, S::LDD, g, tg);
    mma_nt<8, D>(dpt[0], sv_w, S::LDD, sdo, S::LDD, g, tg);
    to_logits<true>(st[0], bias_h, mask_w, Tn, scale, r0, q0, tg, keys_valid);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // st becomes P^T, dpt becomes ds^T
      const int c = n * 8 + tg * 2;
      const float lse_a = slse[c], lse_b = slse[c + 1];
      const float del_a = sdelta[c], del_b = sdelta[c + 1];
      st[0][n][0] = soft_exp<T>(st[0][n][0] - lse_a);
      st[0][n][1] = soft_exp<T>(st[0][n][1] - lse_b);
      st[0][n][2] = soft_exp<T>(st[0][n][2] - lse_a);
      st[0][n][3] = soft_exp<T>(st[0][n][3] - lse_b);
      dpt[0][n][0] = st[0][n][0] * (dpt[0][n][0] - del_a);
      dpt[0][n][1] = st[0][n][1] * (dpt[0][n][1] - del_b);
      dpt[0][n][2] = st[0][n][2] * (dpt[0][n][2] - del_a);
      dpt[0][n][3] = st[0][n][3] * (dpt[0][n][3] - del_b);
    }
    mma_from_acc<1, D / 8>(dv, st, sst_w, StripElems<T>::per_row, sdo, S::LDD, g, tg);
    mma_from_acc<1, D / 8>(dk, dpt, sst_w, StripElems<T>::per_row, sq, S::LDD, g, tg);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < Tn) {
      T* dst = dqkv + (static_cast<size_t>(bw) * Tn + r) * c3 + h * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store_pair(dst + C + dn * 8 + tg * 2, dk[0][dn][half * 2] * scale,
                   dk[0][dn][half * 2 + 1] * scale);
        store_pair(dst + 2 * C + dn * 8 + tg * 2, dv[0][dn][half * 2], dv[0][dn][half * 2 + 1]);
      }
    }
  }
}

// dq, then dk / dv; ``delta`` [BW, H, T] f32 is written by the first kernel
// and read by the second.
template <int D>
cudaError_t launch(const float* qkv, const float* bias, const float* mask, const float* out,
                   const float* dout, const float* lse, float* dqkv, float* delta, int BW, int W,
                   int Tn, int C, int H, int Hb, int Wm, float scale, cudaStream_t stream) {
  using S = Tiles<float, D>;
  const int n_rt = (Tn + kRows - 1) / kRows;  // 128-token tiles of the axis a block owns
  const unsigned blocks = static_cast<unsigned>(BW) * H * n_rt;
  auto dq_kernel = attention_bwd_dq<float, D>;
  cudaError_t err = emct_allow_smem(dq_kernel, S::dq_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<blocks, kThreads, S::dq_bytes, stream>>>(qkv, bias, mask, out, dout, lse, dqkv,
                                                       delta, W, Tn, C, H, Hb, Wm, scale, n_rt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkv_kernel = attention_bwd_dkv<float, D>;
  err = emct_allow_smem(dkv_kernel, S::dkv_bytes);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<blocks, kThreads, S::dkv_bytes, stream>>>(qkv, bias, mask, dout, lse, delta, dqkv,
                                                         W, Tn, C, H, Hb, Wm, scale, n_rt);
  return cudaGetLastError();
}

}  // namespace fp32_bwd
