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
// What bounds it on an H100: memory once the products run on wgmma (x, dy,
// dx and the scratch written and read back), the operations (22 M C^2 +
// 12 M T C) a fraction of that at the tensor-core rate.
//
// Design.  The TPU kernel adds the seven parameter gradients into resident
// output blocks across a grid that runs in order.  A CUDA grid has no order,
// and per-window partials of the weight gradients would not fit (one dwqkv
// partial is 786 KB in fp32 at C = 256, against 2,048 windows at stage 1 of a
// batch of 128).  So the work is cut in passes, and every sum over tokens is
// taken in a fixed order, without float atomics:
//   0. LayerNorm: xn for every token, one warp per row, to scratch (the
//      forward's arithmetic, so the same bits); bf16 also keeps each row's
//      mean and rstd for the dx pass.
//   then bf16 (attn_half_bwd_sm90.cuh): qkv and do on wgmma, the
//   window-attention backward core of kernel 1b in place on them (dqkv, om,
//   dbias partials), dx with the LayerNorm backward in its epilogue, and the
//   weight and bias gradients, all wgmma fed by TMA rings;
//   or fp32 (attn_half_bwd_fp32.cuh): the per-window attention kernel, the
//   dx kernel and the weight-gradient kernel on the CUDA cores.
//   Then small kernels add the partials in a fixed order.

#include "attn_half_bwd_fp32.cuh"
#include "attn_half_bwd_sm90.cuh"

using namespace attn_half;

namespace {

// ---------------------------------------------------------------------------
// 0. xn = LayerNorm(x) * ln_g + ln_b for every token, rounded: the q, k, v
//    input and the dwqkv operand; with ``stats``, each row's (mean, rstd)
// ---------------------------------------------------------------------------

constexpr int kLnWarps = 8;  // rows per block of the LayerNorm pass

template <typename T, int C>
__global__ void __launch_bounds__(kLnWarps * 32)
attn_half_bwd_layer_norm(const T* __restrict__ x, const float* __restrict__ ln_g,
                         const float* __restrict__ ln_b, T* __restrict__ xn,
                         float2* __restrict__ stats, int M, float eps) {
  constexpr int E = C / 32;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* src = x + static_cast<size_t>(m) * C;
  float v[E];
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = to_f32(src[e * 32 + lane]);
    sum += v[e];
  }
  const float mu = warp_sum(sum) / C;  // center_row's mean: the same sums in the same order
  const float rstd = center_row<E>(v, eps);
  T* dst = xn + static_cast<size_t>(m) * C;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = e * 32 + lane;
    dst[c] = from_f32<T>(v[e] * rstd * __ldg(ln_g + c) + __ldg(ln_b + c));
  }
  if (stats && lane == 0) stats[m] = make_float2(mu, rstd);
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
  void *xn_s, *om_s, *dqkv_s, *p_bias, *p_w, *p_col, *p_ln, *stats;
  int B, Hp, Wp, H, ws;
  float scale, eps;
  int n_attn, n_w, n_dx, n_qkv, attn_stages;
  size_t attn_smem;
};

// the seven ordered sums, whichever path made the partials
template <int C>
cudaError_t sum_partials(const BwdArgs& a, cudaStream_t stream) {
  const float* p_w = static_cast<const float*>(a.p_w);
  const float* p_col = static_cast<const float*>(a.p_col);
  const float* p_ln = static_cast<const float*>(a.p_ln);
  const size_t w_stride = 4 * static_cast<size_t>(C) * C;
  cudaError_t err;
  if ((err = sum_into(p_w, w_stride, static_cast<float*>(a.dwqkv), a.n_w, 3 * C * C, stream)) ||
      (err = sum_into(p_w + 3 * C * C, w_stride, static_cast<float*>(a.dwproj), a.n_w, C * C,
                      stream)) ||
      (err = sum_into(p_col, 4 * C, static_cast<float*>(a.dbqkv), a.n_w, 3 * C, stream)) ||
      (err = sum_into(p_col + 3 * C, 4 * C, static_cast<float*>(a.dbproj), a.n_w, C, stream)) ||
      (err = sum_into(p_ln, 2 * C, static_cast<float*>(a.dln_g), a.n_dx, C, stream)) ||
      (err = sum_into(p_ln + C, 2 * C, static_cast<float*>(a.dln_b), a.n_dx, C, stream))) {
    return err;
  }
  const int nt = a.ws * a.ws;
  const int n_win = (a.Hp / a.ws) * (a.Wp / a.ws);
  const int total = a.H * nt * nt;
  dbias_sum<<<(total + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(a.p_bias),
                                                     static_cast<float*>(a.dbias), a.n_attn,
                                                     n_win, a.H, nt * nt);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t layer_norm(const BwdArgs& a, cudaStream_t stream) {
  const int M = a.B * a.Hp * a.Wp;
  attn_half_bwd_layer_norm<T, C><<<(M + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.ln_g),
      static_cast<const float*>(a.ln_b), static_cast<T*>(a.xn_s), static_cast<float2*>(a.stats),
      M, a.eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bf16(const BwdArgs& a, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t err = layer_norm<bf16, C>(a, stream);
  if (err != cudaSuccess) return err;
  const ah_bwd90::Launch l{
      static_cast<const bf16*>(a.x),      static_cast<const bf16*>(a.xn_s),
      static_cast<const bf16*>(a.dy),     static_cast<const bf16*>(a.wqkv),
      static_cast<const bf16*>(a.bqkv),   static_cast<const bf16*>(a.wproj),
      static_cast<const float*>(a.ln_g),  static_cast<const float*>(a.bias),
      static_cast<const float*>(a.mask),  static_cast<const float2*>(a.stats),
      static_cast<bf16*>(a.dx),           static_cast<bf16*>(a.dqkv_s),
      static_cast<bf16*>(a.om_s),         static_cast<float*>(a.p_bias),
      static_cast<float*>(a.p_w),         static_cast<float*>(a.p_col),
      static_cast<float*>(a.p_ln),        a.B, a.Hp, a.Wp, C, a.H, a.ws, a.scale,
      a.n_attn,                           a.attn_stages, a.attn_smem, a.n_w, a.n_dx, a.n_qkv,
      ah_bwd90::kQkvStages,               ah_bwd90::DxShape<C>::kStages,
      ah_bwd90::kWgradStages};
  if ((err = ah_bwd90::launch<C>(l, stream)) != cudaSuccess) return err;
  return sum_partials<C>(a, stream);
}

template <int C>
cudaError_t launch_fp32(const BwdArgs& a, cudaStream_t stream) {
  using namespace ah_bwd_fp32;
  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);
  const float* wqkv = static_cast<const float*>(a.wqkv);
  float* xn_s = static_cast<float*>(a.xn_s);
  float* om_s = static_cast<float*>(a.om_s);
  float* dqkv_s = static_cast<float*>(a.dqkv_s);
  const float* ln_g = static_cast<const float*>(a.ln_g);
  const int n_win = (a.Hp / a.ws) * (a.Wp / a.ws);
  const int M = a.B * a.Hp * a.Wp;
  cudaError_t err = layer_norm<float, C>(a, stream);
  if (err != cudaSuccess) return err;

  auto attention = attn_half_bwd_attention<C>;
  if ((err = emct_allow_smem(attention, AttnSmem<C>::bytes)) != cudaSuccess) return err;
  const int per_block = (a.B + a.n_attn - 1) / a.n_attn;
  attention<<<dim3(n_win * a.H, a.n_attn), kThreads, AttnSmem<C>::bytes, stream>>>(
      xn_s, wqkv, static_cast<const float*>(a.bqkv), static_cast<const float*>(a.wproj),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.mask), dy, om_s, dqkv_s,
      static_cast<float*>(a.p_bias), a.B, a.Hp, a.Wp, a.H, a.ws, a.scale, per_block);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dx_kernel = attn_half_bwd_dx<C>;
  if ((err = emct_allow_smem(dx_kernel, DxSmem<C>::bytes)) != cudaSuccess) return err;
  dx_kernel<<<a.n_dx, kThreads, DxSmem<C>::bytes, stream>>>(
      x, ln_g, wqkv, dy, dqkv_s, static_cast<float*>(a.dx), static_cast<float*>(a.p_ln), M,
      a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto wgrad = attn_half_bwd_wgrad<C>;
  if ((err = emct_allow_smem(wgrad, WgradSmem::bytes)) != cudaSuccess) return err;
  const int n_rt = (M + kSlice - 1) / kSlice;
  const int per_chunk = (n_rt + a.n_w - 1) / a.n_w * kSlice;
  const int tiles = (3 * C / kSlice) * (C / kSlice) + (C / kSlice) * (C / kSlice);
  wgrad<<<dim3(tiles, a.n_w), kThreads, WgradSmem::bytes, stream>>>(
      dqkv_s, xn_s, dy, om_s, static_cast<float*>(a.p_w), static_cast<float*>(a.p_col), M,
      per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_partials<C>(a, stream);
}

}  // namespace

// x, dy, dx [B, Hp, Wp, C], wqkv [3C, C], bqkv [3C], wproj [C, C], bproj [C]
// (dtype; bproj is not read); ln_g, ln_b [C] f32; bias [H, T, T] f32; mask
// [nW, T, T] f32 or null.  Outputs f32: dln_g, dln_b [C], dwqkv [3C, C],
// dbqkv [3C], dwproj [C, C], dbproj [C], dbias [H, T, T].  Scratch: xn_s, om_s
// [M, C] and dqkv_s [M, 3C] (dtype); f32 partials p_bias [n_attn, nW, H, T, T],
// p_w [n_w, 4 C C], p_col [n_w, 4C], p_ln [n_dx, 2C]; n_attn image chunks and
// n_w chunks of 64-token tiles, none of them empty.  bf16 also takes stats
// [M, 2] f32 scratch, the blocks of its qkv / do product (n_qkv) and the
// attention core's ring (attn_stages, attn_smem bytes); all of it from
// kernels/attn_half.py:bwd_geometry.  Requires C in
// {128, 256}, C / H == 32, ws <= 8, Hp and Wp multiples of ws; the Python
// wrapper checks shapes, contiguity and alignment first.
extern "C" int attn_half_bwd(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                             const void* bqkv, const void* wproj, const void* bproj,
                             const void* bias, const void* mask, const void* dy, void* dx,
                             void* dln_g, void* dln_b, void* dwqkv, void* dbqkv, void* dwproj,
                             void* dbproj, void* dbias, void* xn_s, void* om_s, void* dqkv_s,
                             void* p_bias, void* p_w, void* p_col, void* p_ln, void* stats,
                             int B, int Hp, int Wp, int C, int H, int ws, float scale, float eps,
                             int n_attn, int n_w, int n_dx, int n_qkv, int attn_stages,
                             long long attn_smem, int dtype, void* stream) {
  (void)bproj;
  if (B < 1 || H < 1 || C % H != 0 || C / H != kHead || ws < 1 || ws * ws > kTok ||
      Hp % ws != 0 || Wp % ws != 0 || n_attn < 1 || n_attn > B || n_w < 1 || n_dx < 1 ||
      (dtype == EMCT_DTYPE_BF16 && n_qkv < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = (B + n_attn - 1) / n_attn;
  const int n_rt = (B * Hp * Wp + kSlice - 1) / kSlice;
  const int per_chunk = (n_rt + n_w - 1) / n_w;
  if ((n_attn - 1) * per_block >= B || n_w > n_rt || (n_w - 1) * per_chunk >= n_rt) {
    return static_cast<int>(cudaErrorInvalidValue);  // an empty chunk
  }
  const BwdArgs a{x,      ln_g,  ln_b,   wqkv,   bqkv,  wproj,  bias,   mask,  dy,
                  dx,     dln_g, dln_b,  dwqkv,  dbqkv, dwproj, dbproj, dbias, xn_s,
                  om_s,   dqkv_s, p_bias, p_w,   p_col, p_ln,   stats,  B,     Hp,
                  Wp,     H,     ws,     scale,  eps,   n_attn, n_w,    n_dx,  n_qkv,
                  attn_stages, static_cast<size_t>(attn_smem)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == EMCT_DTYPE_BF16 && stats) {
    if (C == 128) err = launch_bf16<128>(a, s);
    if (C == 256) err = launch_bf16<256>(a, s);
  } else if (dtype == EMCT_DTYPE_F32 && !stats) {
    if (C == 128) err = launch_fp32<128>(a, s);
    if (C == 256) err = launch_fp32<256>(a, s);
  }
  return static_cast<int>(err);
}
