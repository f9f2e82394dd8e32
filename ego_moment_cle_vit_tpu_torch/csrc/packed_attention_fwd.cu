// Multi-head self-attention on packed token groups, forward (kernel 3).
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/window_attention.py:133,
//   _fwd_kernel (its pallas_call at :240; called by flash_window_attention).
//   The ViT backbone runs it with one group per image, T = 197, 12 heads of
//   64, no bias and no mask, at batch 64 (serving) and 128 (training, with
//   lse).
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
// fast memory.  bf16 runs the Hopper kernel of attention_fwd_sm90.cuh (wgmma
// for both products, a TMA ring of key tiles that holds all of a head's k and
// v at T <= 256, blocks of two 64-row warpgroups, the last key tile cut to
// the next multiple of 16: T = 197 runs as 256 x 208), with the launch
// geometry of kernels/packed_attention.py:fwd_geometry.  fp32, off every
// main path, runs attention_fwd_fp32.cuh on the CUDA cores.

#include "attention_fwd_fp32.cuh"
#include "attention_fwd_sm90.cuh"

// qkv [B, W, T, 3C] and out [B, W, T, C] (dtype); bias [Hb, T, T] f32 or null
// (Hb = H or 1); mask [Wm, T, T] f32 or null (Wm = W or 1); lse [B*W, H, T]
// f32 or null.  bf16 takes the launch geometry of
// kernels/packed_attention.py:fwd_geometry.  Requires C / H in {32, 64}; the
// Python wrapper checks shapes, contiguity and alignment first.
extern "C" int packed_attention_fwd(const void* qkv, const void* bias, const void* mask, void* out,
                                    void* lse, int B, int W, int Tn, int C, int H, int Hb, int Wm,
                                    float scale, int row_blocks, int last, int stages, int smem,
                                    int dtype, void* stream) {
  if (B < 1 || W < 1 || Tn < 1 || H < 1 || C % H != 0 || Hb < 1 || Wm < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
#define EMCT_BF16(DIM)                                                                         \
  err = sm90_fwd::launch<DIM>(qkv, bias_f, mask_f, out, lse_f, B * W, W, Tn, C, H, Hb, Wm, scale, \
                              row_blocks, last, stages, static_cast<size_t>(smem), s)
#define EMCT_F32(DIM) \
  err = fp32_fwd::launch<DIM>(qkv, bias_f, mask_f, out, lse_f, B * W, W, Tn, C, H, Hb, Wm, scale, s)
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
  return static_cast<int>(err);
}
