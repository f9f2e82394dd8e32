// Multi-head self-attention on packed token groups, backward.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/window_attention.py, _bwd_kernel
//   (the VJP of flash_window_attention; the ViT backbone runs it with one
//   group per image, T = 197, no bias and no mask).
//
// Computes, per image b, group w and head h (T tokens, d = C/H in {32, 64}),
// from qkv[B, W, T, 3C], bias[Hb, T, T], mask[Wm, T, T] and dout[B, W, T, C]:
//   P  = softmax(q k^T * scale + bias[h % Hb] + mask[w % Wm])   (recomputed, fp32)
//   dv = P~^T do            P~ = P rounded to the input type
//   dp = do v^T
//   ds = P * (dp - rowsum(dp * P))                              (fp32)
//   dq = ds~ k * scale,  dk = ds~^T q * scale                   ds~ = ds rounded
//   dbias[hb] = sum of ds over images, groups and the heads that share hb
// dq, dk, dv go to dqkv[B, W, T, 3C].  The mask gets no gradient.  Nothing of
// the forward is stored but its inputs.
//
// What bounds it on an H100: memory at the ViT shapes.  Per token and head it
// reads 4d values and writes 3d and needs 10*T*d flops, ~140 flops per byte
// of bf16 at T = 197, under the tensor cores' ~295.
//
// Design.  The TPU kernel holds every [T, T] tile of an image on chip and adds
// dk, dv and dbias into resident blocks across a sequential grid.  Here no
// [T, T] tile fits a block's registers and blocks run in no order, so the work
// is cut along the axis each result is summed over, and each sum stays inside
// one block (no float atomics: two runs give the same bits):
//   1. dq kernel, one block per 128 query rows.  Pass 1 walks the key tiles and
//      takes each row's running maximum, sum of exponentials and sum of
//      exp * dp online, which give the row's log-sum-exp and
//      delta = rowsum(dp * P); both go to a small scratch.  Pass 2 walks the
//      key tiles again with P = exp(logit - lse) exact, forms ds and adds
//      ds~ k into the dq accumulators.
//   2. dk/dv kernel, one block per 128 keys.  It walks the query tiles, computes
//      S^T = k q^T and dp^T = v do^T directly with keys as rows, rebuilds P^T
//      and ds^T from the scratch, and adds P~^T do and ds~^T q into register
//      accumulators.
//   3. only when the bias gradient is asked for: a dbias kernel, one block per
//      (128 query rows, 64 keys, head, chunk of (image, group) pairs), which
//      rebuilds ds for that tile over its chunk and writes one partial; a last
//      kernel adds the partials in a fixed order.
// This costs 18*T*d flops per token and head (22 with dbias) against the
// minimal 10: logits and dp are rebuilt in every pass instead of being stored.
// All products go through mma_tiles.cuh: tensor cores for bf16, CUDA cores for
// fp32.  P and ds are rounded to the input type as the A operand of the
// second products (bf16: in registers, the accumulator layout of one product
// being the A fragment layout of the next; fp32: through the warp's strip in
// shared memory).  Every tile lies in shared memory as it lies in device
// memory, [token][d]: a product whose contraction runs over tokens reads its B
// fragments transposed (ldmatrix.trans; fp32 reads rows).  The tiles of the
// walked axis arrive by cp.async into two buffers, the next one under the
// products of the current one, with one barrier per tile; warps whose 16 rows
// all lie past T take part in the copies only.  Keys past T are zero padding
// masked to -inf; query rows past T are staged as zeros with lse = +inf, so
// they add nothing to dk, dv or dbias.

#include "packed_attention.cuh"

namespace {

template <typename T, int D>
struct Tiles {
  static constexpr int LDD = D + TilePad<T>::value;    // [token][d] tiles
  static constexpr int kOwn = kRows * LDD;              // elements of one [128][d] tile
  static constexpr int kWalk = kCols * LDD;             // elements of one [64][d] tile
  // one 16 x 64 strip per warp, fp32 only (bf16 feeds the second product
  // from registers)
  static constexpr int kStrips = kWarps * 16 * StripElems<T>::per_row;
  // dq kernel: q, do; two buffers of (k, v); the ds strips
  static constexpr size_t dq_bytes = (2 * kOwn + 4 * kWalk + kStrips) * sizeof(T);
  // dk/dv kernel: k, v; two buffers of (q, do); the strips (P^T, then ds^T);
  // two buffers of the query tile's lse and delta
  static constexpr size_t dkv_bytes =
      (2 * kOwn + 4 * kWalk + kStrips) * sizeof(T) + 4 * kCols * sizeof(float);
  // dbias kernel: q, do, k, v
  static constexpr size_t dbias_bytes = (2 * kOwn + 2 * kWalk) * sizeof(T);
};

// ---------------------------------------------------------------------------
// 1. row statistics and dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dq(const T* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, const T* __restrict__ dout,
                        T* __restrict__ dqkv, float* __restrict__ lse_out,
                        float* __restrict__ delta_out, int W, int Tn, int C, int H, int Hb, int Wm,
                        float scale, int n_qt) {
  using S = Tiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + S::kOwn;
  T* skv = sdo + S::kOwn;         // two buffers of k [kCols][LDD], v [kCols][LDD]
  T* sds = skv + 4 * S::kWalk;    // fp32 only: [kWarps][16][per_row]

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
  const float* bias_h = bias ? bias + static_cast<size_t>(h % Hb) * Tn * Tn : nullptr;
  const float* mask_w = mask ? mask + static_cast<size_t>(w % Wm) * Tn * Tn : nullptr;

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

  const T* sq_w = sq + warp * 16 * S::LDD;
  const T* sdo_w = sdo + warp * 16 * S::LDD;
  T* sds_w = sds + warp * 16 * StripElems<T>::per_row;
  const int r0 = q0 + warp * 16 + g;
  const int n_kt = (Tn + kCols - 1) / kCols;
  const bool active = q0 + warp * 16 < Tn;  // a warp whose 16 queries all lie past T only stages

  // pass 1: running maximum m, l = sum exp(logit - m), dl = sum exp(logit - m) dp
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    const T* sk = skv + (kt & 1) * 2 * S::kWalk;
    const T* sv = sk + S::kWalk;
    // this tile has landed and the other buffer's products are done
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kt) fetch_kv((kt + 1) & 1, k0 + kCols);
    if (!active) continue;
    float s[8][4], dp[8][4];
    zero_acc<8>(s);
    zero_acc<8>(dp);
    mma_nt<8, D>(s, sq_w, S::LDD, sk, S::LDD, g, tg);
    mma_nt<8, D>(dp, sdo_w, S::LDD, sv, S::LDD, g, tg);
    to_logits<false>(s, bias_h, mask_w, Tn, scale, r0, k0, tg, k0 + kCols <= Tn);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // every tile holds at least one key below T, so the new maxima are finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = soft_exp<T>(m0 - mn0);
    const float corr1 = soft_exp<T>(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= corr0;
    l1 *= corr1;
    dl0 *= corr0;
    dl1 *= corr1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p0 = soft_exp<T>(s[n][u] - mn0);
        const float p1 = soft_exp<T>(s[n][2 + u] - mn1);
        l0 += p0;
        l1 += p1;
        dl0 = fmaf(p0, dp[n][u], dl0);
        dl1 = fmaf(p1, dp[n][2 + u], dl1);
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float lse0 = m0 + logf(l0);
  const float lse1 = m1 + logf(l1);
  const float delta0 = quad_sum(dl0) / l0;
  const float delta1 = quad_sum(dl1) / l1;
  if (tg == 0) {
    const size_t row = (static_cast<size_t>(bw) * H + h) * Tn;
    if (r0 < Tn) {
      lse_out[row + r0] = lse0;
      delta_out[row + r0] = delta0;
    }
    if (r0 + 8 < Tn) {
      lse_out[row + r0 + 8] = lse1;
      delta_out[row + r0 + 8] = delta1;
    }
  }

  // pass 2: dq = ds~ k * scale
  float dq[1][D / 8][4];
  zero_acc<D / 8>(dq[0]);
  __syncthreads();  // pass 1's last products are done with their buffer
  fetch_kv(0, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    const T* sk = skv + (kt & 1) * 2 * S::kWalk;
    const T* sv = sk + S::kWalk;
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

// ---------------------------------------------------------------------------
// 2. dk and dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dkv(const T* __restrict__ qkv, const float* __restrict__ bias,
                         const float* __restrict__ mask, const T* __restrict__ dout,
                         T* __restrict__ dqkv, const float* __restrict__ lse_in,
                         const float* __restrict__ delta_in, int W, int Tn, int C, int H, int Hb,
                         int Wm, float scale, int n_rt) {
  using S = Tiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + S::kOwn;
  T* sqdo = sv + S::kOwn;         // two buffers of q [kCols][LDD], do [kCols][LDD]
  T* sst = sqdo + 4 * S::kWalk;   // fp32 only: [kWarps][16][per_row], P~^T then ds~^T
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

  // fetches the (q, do) tile at query q0 and its row statistics into buffer
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

// ---------------------------------------------------------------------------
// 3. dbias: per-block partials, then an ordered sum
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dbias(const T* __restrict__ qkv, const float* __restrict__ bias,
                           const float* __restrict__ mask, const T* __restrict__ dout,
                           const float* __restrict__ lse_in, const float* __restrict__ delta_in,
                           float* __restrict__ partial, int BW, int W, int Tn, int C, int H,
                           int Hb, int Wm, float scale, int n_rt, int n_ct, int per_chunk) {
  using S = Tiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + S::kOwn;
  T* sk = sdo + S::kOwn;
  T* sv = sk + S::kWalk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int kt = blockIdx.x % n_ct;
  const int qt = (blockIdx.x / n_ct) % n_rt;
  const int h = (blockIdx.x / (n_ct * n_rt)) % H;
  const int chunk = blockIdx.x / (n_ct * n_rt * H);
  const int q0 = qt * kRows;
  const int k0 = kt * kCols;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const float* bias_h = bias ? bias + static_cast<size_t>(h % Hb) * Tn * Tn : nullptr;
  const T* sq_w = sq + warp * 16 * S::LDD;
  const T* sdo_w = sdo + warp * 16 * S::LDD;
  const int r0 = q0 + warp * 16 + g;

  float acc[8][4];
  zero_acc<8>(acc);
  const int bw_end = min(BW, (chunk + 1) * per_chunk);
  for (int bw = chunk * per_chunk; bw < bw_end; ++bw) {
    const T* base = qkv + static_cast<size_t>(bw) * Tn * c3 + h * D;
    const T* dbase = dout + static_cast<size_t>(bw) * Tn * C + h * D;
    const float* mask_w = mask ? mask + static_cast<size_t>((bw % W) % Wm) * Tn * Tn : nullptr;
    const size_t stat_row = (static_cast<size_t>(bw) * H + h) * Tn;
    __syncthreads();
    stage_tile<T, kRows, D, kThreads>(sq, base, c3, q0, Tn, tid);
    stage_tile<T, kRows, D, kThreads>(sdo, dbase, C, q0, Tn, tid);
    stage_tile<T, kCols, D, kThreads>(sk, base + C, c3, k0, Tn, tid);
    stage_tile<T, kCols, D, kThreads>(sv, base + 2 * C, c3, k0, Tn, tid);
    __syncthreads();
    float s[8][4], dp[8][4];
    zero_acc<8>(s);
    zero_acc<8>(dp);
    mma_nt<8, D>(s, sq_w, S::LDD, sk, S::LDD, g, tg);
    mma_nt<8, D>(dp, sdo_w, S::LDD, sv, S::LDD, g, tg);
    to_logits<false>(s, bias_h, mask_w, Tn, scale, r0, k0, tg, k0 + kCols <= Tn);
    const float lse0 = r0 < Tn ? __ldg(lse_in + stat_row + r0) : INFINITY;
    const float lse1 = r0 + 8 < Tn ? __ldg(lse_in + stat_row + r0 + 8) : INFINITY;
    const float delta0 = r0 < Tn ? __ldg(delta_in + stat_row + r0) : 0.f;
    const float delta1 = r0 + 8 < Tn ? __ldg(delta_in + stat_row + r0 + 8) : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        acc[n][u] += soft_exp<T>(s[n][u] - lse0) * (dp[n][u] - delta0);
        acc[n][2 + u] += soft_exp<T>(s[n][2 + u] - lse1) * (dp[n][2 + u] - delta1);
      }
    }
  }

  float* dst = partial + (static_cast<size_t>(chunk) * H + h) * Tn * Tn;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = k0 + n * 8 + tg * 2 + u;
      if (j < Tn) {
        if (r0 < Tn) dst[static_cast<size_t>(r0) * Tn + j] = acc[n][u];
        if (r0 + 8 < Tn) dst[static_cast<size_t>(r0 + 8) * Tn + j] = acc[n][2 + u];
      }
    }
  }
}

// dbias[hb][e] = sum over chunks, then over the heads h = hb, hb + Hb, ..., of
// partial[chunk][h][e], in that fixed order.
__global__ void packed_attention_dbias_reduce(const float* __restrict__ partial,
                                              float* __restrict__ dbias, int n_chunks, int H,
                                              int Hb, int tt) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= Hb * tt) return;
  const int hb = idx / tt;
  const int e = idx % tt;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    for (int h = hb; h < H; h += Hb) {
      acc += partial[(static_cast<size_t>(c) * H + h) * tt + e];
    }
  }
  dbias[idx] = acc;
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const float* bias, const float* mask, const void* dout,
                   void* dqkv, float* stats, float* partial, float* dbias, int BW, int W, int Tn,
                   int C, int H, int Hb, int Wm, float scale, int n_chunks, cudaStream_t stream) {
  using S = Tiles<T, D>;
  const T* qkv_t = static_cast<const T*>(qkv);
  const T* dout_t = static_cast<const T*>(dout);
  T* dqkv_t = static_cast<T*>(dqkv);
  float* lse = stats;
  float* delta = stats + static_cast<size_t>(BW) * H * Tn;
  const int n_rt = (Tn + kRows - 1) / kRows;  // tiles of the axis a block owns
  const int n_ct = (Tn + kCols - 1) / kCols;  // tiles of the axis it walks
  const unsigned blocks = static_cast<unsigned>(BW) * H * n_rt;

  auto dq_kernel = packed_attention_bwd_dq<T, D>;
  cudaError_t err = emct_allow_smem(dq_kernel, S::dq_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<blocks, kThreads, S::dq_bytes, stream>>>(qkv_t, bias, mask, dout_t, dqkv_t, lse,
                                                       delta, W, Tn, C, H, Hb, Wm, scale, n_rt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = packed_attention_bwd_dkv<T, D>;
  err = emct_allow_smem(dkv_kernel, S::dkv_bytes);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<blocks, kThreads, S::dkv_bytes, stream>>>(qkv_t, bias, mask, dout_t, dqkv_t, lse,
                                                         delta, W, Tn, C, H, Hb, Wm, scale, n_rt);
  err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return err;

  auto dbias_kernel = packed_attention_bwd_dbias<T, D>;
  err = emct_allow_smem(dbias_kernel, S::dbias_bytes);
  if (err != cudaSuccess) return err;
  const int per_chunk = (BW + n_chunks - 1) / n_chunks;
  const unsigned dbias_blocks = static_cast<unsigned>(n_chunks) * H * n_rt * n_ct;
  dbias_kernel<<<dbias_blocks, kThreads, S::dbias_bytes, stream>>>(
      qkv_t, bias, mask, dout_t, lse, delta, partial, BW, W, Tn, C, H, Hb, Wm, scale, n_rt, n_ct,
      per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = Hb * Tn * Tn;
  packed_attention_dbias_reduce<<<(total + 255) / 256, 256, 0, stream>>>(partial, dbias, n_chunks,
                                                                         H, Hb, Tn * Tn);
  return cudaGetLastError();
}

}  // namespace

// qkv, dqkv [B, W, T, 3C] and dout [B, W, T, C] (dtype); bias [Hb, T, T] f32 or
// null; mask [Wm, T, T] f32 or null; stats: 2 * B*W*H*T f32 scratch; dbias
// [Hb, T, T] f32 or null (then no bias gradient is computed); partial
// [n_chunks, H, T, T] f32 scratch when dbias is given, with
// (n_chunks - 1) * ceil(B*W / n_chunks) < B*W.  Requires C / H in {32, 64};
// the Python wrapper checks shapes, contiguity and alignment first.
extern "C" int packed_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                    const void* dout, void* dqkv, void* stats, void* partial,
                                    void* dbias, int B, int W, int Tn, int C, int H, int Hb,
                                    int Wm, float scale, int n_chunks, int dtype, void* stream) {
  if (B < 1 || W < 1 || Tn < 1 || H < 1 || C % H != 0 || Hb < 1 || Wm < 1 || H % Hb != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int BW = B * W;
  if (dbias != nullptr) {
    if (partial == nullptr || n_chunks < 1 || n_chunks > BW) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int per_chunk = (BW + n_chunks - 1) / n_chunks;
    if ((n_chunks - 1) * per_chunk >= BW) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  float* stats_f = static_cast<float*>(stats);
  float* partial_f = static_cast<float*>(partial);
  float* dbias_f = static_cast<float*>(dbias);
  cudaError_t err = cudaErrorInvalidValue;
#define EMCT_LAUNCH(TYPE, DIM)                                                                \
  err = launch<TYPE, DIM>(qkv, bias_f, mask_f, dout, dqkv, stats_f, partial_f, dbias_f, BW, W, \
                          Tn, C, H, Hb, Wm, scale, n_chunks, s)
  if (dtype == EMCT_DTYPE_BF16 && d == 64) {
    EMCT_LAUNCH(__nv_bfloat16, 64);
  } else if (dtype == EMCT_DTYPE_BF16 && d == 32) {
    EMCT_LAUNCH(__nv_bfloat16, 32);
  } else if (dtype == EMCT_DTYPE_F32 && d == 64) {
    EMCT_LAUNCH(float, 64);
  } else if (dtype == EMCT_DTYPE_F32 && d == 32) {
    EMCT_LAUNCH(float, 32);
  }
#undef EMCT_LAUNCH
  return static_cast<int>(err);
}
