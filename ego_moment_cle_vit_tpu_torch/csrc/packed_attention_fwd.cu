// Multi-head self-attention on packed token groups, forward.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/window_attention.py, _fwd_kernel
//   (called by flash_window_attention; the ViT backbone runs it with one group
//   per image, T = 197, no bias and no mask).
//
// Computes, per image b, group w and head h (T tokens, d = C/H in {32, 64}):
//   P   = softmax(q k^T * scale + bias[h % Hb] + mask[w % Wm])     (fp32)
//   out = P~ v,  P~ = the probabilities rounded to the input type
//   lse = log(sum_j exp(logit_j))  per query row, fp32 [B*W, H, T], when asked
// with q, k, v read from qkv[B, W, T, 3C] (head h in columns h*d .. (h+1)*d of
// each third) and out written as [B, W, T, C].  bias and mask may be null,
// which stands for zeros.  lse may be null (serving): then nothing is
// written; training asks for it, so the backward rebuilds P without a
// statistics pass of its own.
//
// What bounds it on an H100: memory at the ViT shapes.  Per token and head it
// reads 3d values and writes d, and does 4*T*d flops: ~100 flops per byte of
// bf16 at T = 197, under the ~295 at which the tensor cores become the limit.
//
// Design.  The TPU kernel keeps a whole [T, T] logit tile of every head in
// fast memory; on this card a [197, 197] fp32 tile does not fit one block's
// registers.  One block of eight warps owns 128 query rows of one (image,
// group, head), 16 per warp, and walks the keys in tiles of 64 with an online
// softmax (running row maximum and sum, output rescaled when the maximum
// moves), so a warp holds a 16 x 64 logit strip and a 16 x d output strip in
// registers and nothing of size T.  q, k and v tiles lie in shared memory as
// they lie in qkv, [token][d]; they arrive by cp.async, the next (k, v) tile
// under the products of the current one (two buffers, one barrier per tile),
// and reach the tensor cores through ldmatrix (transposed for v, whose
// contraction runs down its rows).  bf16 is compiled for two blocks per SM
// (128 registers).  Warps whose 16 queries all lie past T take part in the
// copies only.  Full key tiles without bias or mask take a path that only
// scales, and bf16 uses the fast exponential.
// Both products go through mma_tiles.cuh: tensor cores for bf16, CUDA cores
// for fp32.  The unnormalized probabilities are rounded to the input type as the A
// operand of P v (bf16: in registers; fp32: through the warp's strip in shared
// memory); the row sum is taken in fp32 before the rounding and divided out at
// the end.  Keys past T are zero padding masked to -inf; query rows past T are
// not stored.  Nothing here depends on T, so longer sequences
// take the same code.

#include "packed_attention.cuh"

namespace {

template <typename T, int D>
struct Smem {
  static constexpr int LDD = D + TilePad<T>::value;    // [token][d] tiles
  static constexpr size_t bytes =
      (static_cast<size_t>(kRows + 4 * kCols) * LDD +
       static_cast<size_t>(kRows) * StripElems<T>::per_row) *
      sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
packed_attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ mask, T* __restrict__ out,
                            float* __restrict__ lse, int W, int Tn, int C, int H, int Hb, int Wm,
                            float scale, int n_qt) {
  using S = Smem<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [kRows][LDD]
  T* skv = sq + kRows * S::LDD;            // two buffers of k [kCols][LDD], v [kCols][LDD]
  T* sp = skv + 4 * kCols * S::LDD;        // fp32 only: [kWarps][16][per_row], P~ per warp

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
  const float* bias_h = bias ? bias + static_cast<size_t>(h % Hb) * Tn * Tn : nullptr;
  const float* mask_w = mask ? mask + static_cast<size_t>(w % Wm) * Tn * Tn : nullptr;

  stage_tile_async<T, kRows, D, kThreads>(sq, base, c3, q0, Tn, tid);
  stage_tile_async<T, kCols, D, kThreads>(skv, base + C, c3, 0, Tn, tid);
  stage_tile_async<T, kCols, D, kThreads>(skv + kCols * S::LDD, base + 2 * C, c3, 0, Tn, tid);
  cp_async_commit();

  T* sp_w = sp + warp * 16 * StripElems<T>::per_row;
  const T* sq_w = sq + warp * 16 * S::LDD;
  const int r0 = q0 + warp * 16 + g;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[1][D / 8][4];
  zero_acc<D / 8>(o[0]);

  const int n_kt = (Tn + kCols - 1) / kCols;
  const bool active = q0 + warp * 16 < Tn;  // a warp whose 16 queries all lie past T only stages
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    const T* sk = skv + (kt & 1) * 2 * kCols * S::LDD;
    const T* sv = sk + kCols * S::LDD;
    // this tile has landed, and the other buffer's products are done: the
    // next tile is fetched into it under this tile's products
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kt) {
      T* nk = skv + ((kt + 1) & 1) * 2 * kCols * S::LDD;
      stage_tile_async<T, kCols, D, kThreads>(nk, base + C, c3, k0 + kCols, Tn, tid);
      stage_tile_async<T, kCols, D, kThreads>(nk + kCols * S::LDD, base + 2 * C, c3, k0 + kCols, Tn,
                                              tid);
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
    const float corr0 = soft_exp<T>(m0 - mn0);
    const float corr1 = soft_exp<T>(m1 - mn1);
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
      s[0][n][0] = soft_exp<T>(s[0][n][0] - mn0);
      s[0][n][1] = soft_exp<T>(s[0][n][1] - mn0);
      s[0][n][2] = soft_exp<T>(s[0][n][2] - mn1);
      s[0][n][3] = soft_exp<T>(s[0][n][3] - mn1);
      l0 += s[0][n][0] + s[0][n][1];
      l1 += s[0][n][2] + s[0][n][3];
    }
    mma_from_acc<1, D / 8>(o, s, sp_w, StripElems<T>::per_row, sv, S::LDD, g, tg);
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
      T* dst = out + (static_cast<size_t>(bw) * Tn + r) * C + h * D;
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

template <typename T, int D>
cudaError_t launch(const void* qkv, const float* bias, const float* mask, void* out, float* lse,
                   int BW, int W, int Tn, int C, int H, int Hb, int Wm, float scale,
                   cudaStream_t stream) {
  auto kernel = packed_attention_fwd_kernel<T, D>;
  const size_t smem = Smem<T, D>::bytes;
  cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tn + kRows - 1) / kRows;
  const unsigned blocks = static_cast<unsigned>(BW) * H * n_qt;
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(qkv), bias, mask,
                                             static_cast<T*>(out), lse, W, Tn, C, H, Hb, Wm,
                                             scale, n_qt);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, W, T, 3C] and out [B, W, T, C] (dtype); bias [Hb, T, T] f32 or null
// (Hb = H or 1); mask [Wm, T, T] f32 or null (Wm = W or 1); lse [B*W, H, T]
// f32 or null.  Requires C / H in {32, 64}; the Python wrapper checks shapes,
// contiguity and alignment first.
extern "C" int packed_attention_fwd(const void* qkv, const void* bias, const void* mask, void* out,
                                    void* lse, int B, int W, int Tn, int C, int H, int Hb, int Wm,
                                    float scale, int dtype, void* stream) {
  if (B < 1 || W < 1 || Tn < 1 || H < 1 || C % H != 0 || Hb < 1 || Wm < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  cudaError_t err = cudaErrorInvalidValue;
#define EMCT_LAUNCH(TYPE, DIM) \
  err = launch<TYPE, DIM>(qkv, bias_f, mask_f, out, static_cast<float*>(lse), B * W, W, Tn, C, H, \
                         Hb, Wm, scale, s)
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
