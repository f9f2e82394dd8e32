// Multi-head self-attention on packed token groups, backward (kernel 3b).
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/window_attention.py:155,
//   _bwd_kernel (its pallas_call at :270; the VJP of flash_window_attention).
//   The ViT backbone runs it with one group per image, T = 197, 12 heads of
//   64, no bias and no mask, at batch 128 (two views of 64).
//
// Computes, per image b, group w and head h (T tokens, d = C/H in {32, 64}),
// from qkv[B, W, T, 3C], bias[Hb, T, T], mask[Wm, T, T], the forward's
// out[B, W, T, C] and lse[B*W, H, T], and dout[B, W, T, C]:
//   P  = exp(q k^T * scale + bias[h % Hb] + mask[w % Wm] - lse)   (rebuilt, fp32)
//   delta = rowsum(dout * out)
//   dv = P~^T dout          P~ = P rounded to the input type
//   ds = P * (dout v^T - delta)                                    (fp32)
//   dq = ds~ k * scale,  dk = ds~^T q * scale                      ds~ = ds rounded
//   dbias[hb] = sum of ds over images, groups and the heads that share hb
// dq, dk, dv go to dqkv[B, W, T, 3C].  The mask gets no gradient.
//
// What bounds it on an H100: memory at the ViT shape.  The seven products
// (two rebuilt) come to 14*T^2*d flops per (image, head) against 7*T*d bf16
// values moved, ~140 flops per byte at T = 197, under the tensor cores' ~295.
//
// Design.  The TPU kernel holds every [T, T] tile of an image on chip and adds
// dk, dv and dbias into resident blocks across a sequential grid.  Here the
// forward saves each row's log-sum-exp (kernel 3 writes it when asked), so
// P is rebuilt exactly with no statistics pass, and the work is cut along the
// axis each result is summed over (no float atomics: two runs give the same
// bits).  bf16 runs the Hopper kernels of attention_bwd_sm90.cuh (wgmma for
// every product, a TMA ring of key or query tiles fed by a producer warp,
// blocks of 64 rows, the walked axis cut to the next multiple of 16 past T:
// T = 197 runs as 256 x 208).  fp32, off every main path, runs
// attention_bwd_fp32.cuh on the CUDA cores.  Only when the bias gradient is
// asked for: a dbias kernel, one block per (128 query rows, 64 keys, head,
// chunk of (image, group) pairs), which rebuilds ds for that tile over its
// chunk (mma_tiles.cuh's mma.sync) from lse and the delta the dq kernel
// wrote, and writes one partial; a last kernel adds the partials in a fixed
// order.

#include "attention_bwd_fp32.cuh"
#include "attention_bwd_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// dbias: per-block partials, then an ordered sum
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dbias(const T* __restrict__ qkv, const float* __restrict__ bias,
                           const float* __restrict__ mask, const T* __restrict__ dout,
                           const float* __restrict__ lse_in, const float* __restrict__ delta_in,
                           float* __restrict__ partial, int BW, int W, int Tn, int C, int H,
                           int Hb, int Wm, float scale, int n_rt, int n_ct, int per_chunk) {
  using S = fp32_bwd::Tiles<T, D>;
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
cudaError_t launch_dbias(const void* qkv, const float* bias, const float* mask, const void* dout,
                         const float* lse, const float* delta, float* partial, float* dbias,
                         int BW, int W, int Tn, int C, int H, int Hb, int Wm, float scale,
                         int n_chunks, cudaStream_t stream) {
  using S = fp32_bwd::Tiles<T, D>;
  constexpr size_t bytes = (2 * S::kOwn + 2 * S::kWalk) * sizeof(T);  // q, dout, k, v
  const int n_rt = (Tn + kRows - 1) / kRows;
  const int n_ct = (Tn + kCols - 1) / kCols;
  auto dbias_kernel = packed_attention_bwd_dbias<T, D>;
  cudaError_t err = emct_allow_smem(dbias_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int per_chunk = (BW + n_chunks - 1) / n_chunks;
  const unsigned blocks = static_cast<unsigned>(n_chunks) * H * n_rt * n_ct;
  dbias_kernel<<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), bias, mask, static_cast<const T*>(dout), lse, delta, partial,
      BW, W, Tn, C, H, Hb, Wm, scale, n_rt, n_ct, per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = Hb * Tn * Tn;
  packed_attention_dbias_reduce<<<(total + 255) / 256, 256, 0, stream>>>(partial, dbias, n_chunks,
                                                                         H, Hb, Tn * Tn);
  return cudaGetLastError();
}

}  // namespace

// qkv, dqkv [B, W, T, 3C], out and dout [B, W, T, C] (dtype); bias [Hb, T, T]
// f32 or null; mask [Wm, T, T] f32 or null; lse [B*W, H, T] f32 from the
// forward; delta: B*W*H*T f32 scratch; dbias [Hb, T, T] f32 or null (then no
// bias gradient is computed); partial [n_chunks, H, T, T] f32 scratch when
// dbias is given, with (n_chunks - 1) * ceil(B*W / n_chunks) < B*W.  bf16
// takes the launch geometry of kernels/packed_attention.py:bwd_geometry.  Requires C / H in {32, 64}; the
// Python wrapper checks shapes, contiguity and alignment first.
extern "C" int packed_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                    const void* out, const void* lse, const void* dout, void* dqkv,
                                    void* delta, void* partial, void* dbias, int B, int W, int Tn,
                                    int C, int H, int Hb, int Wm, float scale, int n_chunks,
                                    int row_blocks, int last, int stages, int smem, int dtype,
                                    void* stream) {
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
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
#define EMCT_BF16(DIM)                                                                             \
  err = sm90_bwd::launch<DIM>(qkv, bias_f, mask_f, out, dout, lse_f, dqkv, delta_f, BW, W, Tn, C, \
                              H, Hb, Wm, scale, row_blocks, last, stages,                          \
                              static_cast<size_t>(smem), s)
#define EMCT_F32(DIM)                                                                            \
  err = fp32_bwd::launch<DIM>(static_cast<const float*>(qkv), bias_f, mask_f,                    \
                              static_cast<const float*>(out), static_cast<const float*>(dout),   \
                              lse_f, static_cast<float*>(dqkv), delta_f, BW, W, Tn, C, H, Hb, Wm, \
                              scale, s)
  if (dtype == EMCT_DTYPE_BF16 && d == 64) {
    EMCT_BF16(64);
  } else if (dtype == EMCT_DTYPE_BF16 && d == 32) {
    EMCT_BF16(32);
  } else if (dtype == EMCT_DTYPE_F32 && d == 64) {
    EMCT_F32(64);
  } else if (dtype == EMCT_DTYPE_F32 && d == 32) {
    EMCT_F32(32);
  }
#undef EMCT_BF16
#undef EMCT_F32
  if (err != cudaSuccess || dbias == nullptr) return static_cast<int>(err);
  float* partial_f = static_cast<float*>(partial);
  float* dbias_f = static_cast<float*>(dbias);
#define EMCT_DBIAS(TYPE, DIM)                                                                  \
  err = launch_dbias<TYPE, DIM>(qkv, bias_f, mask_f, dout, lse_f, delta_f, partial_f, dbias_f, \
                                BW, W, Tn, C, H, Hb, Wm, scale, n_chunks, s)
  if (dtype == EMCT_DTYPE_BF16 && d == 64) {
    EMCT_DBIAS(__nv_bfloat16, 64);
  } else if (dtype == EMCT_DTYPE_BF16 && d == 32) {
    EMCT_DBIAS(__nv_bfloat16, 32);
  } else if (dtype == EMCT_DTYPE_F32 && d == 64) {
    EMCT_DBIAS(float, 64);
  } else {
    EMCT_DBIAS(float, 32);
  }
#undef EMCT_DBIAS
  return static_cast<int>(err);
}
