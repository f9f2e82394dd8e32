// The attention half of a Swin block, fused, forward.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/attn_half.py, _fwd_kernel
//   (called by fused_attn_half_spatial).
//
// Computes, per image b and window w (T = ws*ws <= 64 tokens, d = C/H = 32,
// C in {128, 256}), from the pre-LN map x[B, Hp, Wp, C]:
//   xn  = LayerNorm(x) * ln_g + ln_b           fp32, rounded to the input type
//   qkv = xn Wqkv^T + bqkv                     summed in fp32, rounded
//   om  = softmax(q k^T * scale + bias[h] + mask[w]) v   per head; P rounded
//         before P v as on the TPU, the sum fp32, om rounded
//   y   = x + (om Wproj^T + bproj)             summed in fp32, rounded once
// with Wqkv [3C, C] and Wproj [C, C] in the port's [out, in] layout.
//
// What bounds it on an H100: at Swin-Base's stage 0 (C = 128) operations and
// bytes about equally (2 M C 4C + 4 M T C flops against x read and y written
// once); at stage 1 (C = 256) operations.
//
// The TPU kernel holds the [C, 3C] and [C, C] weights in VMEM beside a row of
// windows; at C = 256 they alone are 512 KB in bf16, over the 227 KB a
// Hopper block can have, so here the weights stream from L2.  bf16 (the
// serving and training dtype): attn_half_fwd_sm90.cuh, a group of windows
// a block on wgmma, the weights through a TMA ring they all read, blocks
// walking groups of windows.  fp32: attn_half_fwd_fp32.cuh, one window a
// block on the CUDA cores.  The dtype alone picks the body.

#include "attn_half_fwd_fp32.cuh"
#include "attn_half_fwd_sm90.cuh"

// x, y [B, Hp, Wp, C], wqkv [3C, C], bqkv [3C], wproj [C, C], bproj [C]
// (dtype); ln_g, ln_b [C] f32; bias [H, T, T] f32; mask [nW, T, T] f32 or
// null.  bf16 also takes its grid ``n_blocks`` and shared memory ``smem``
// (bytes) from kernels/attn_half.py:fwd_geometry; fp32 ignores them.
// Requires C in {128, 256}, C / H == 32, ws <= 8, Hp and Wp multiples of ws;
// the Python wrapper checks shapes, contiguity and alignment first.
extern "C" int attn_half_fwd(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                             const void* bqkv, const void* wproj, const void* bproj,
                             const void* bias, const void* mask, void* y, int B, int Hp, int Wp,
                             int C, int H, int ws, float scale, float eps, int n_blocks,
                             long long smem, int dtype, void* stream) {
  if (B < 1 || H < 1 || C % H != 0 || C / H != attn_half::kHead || ws < 1 ||
      ws * ws > attn_half::kTok || Hp % ws != 0 || Wp % ws != 0 || (C != 128 && C != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* bb = static_cast<const float*>(ln_b);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == EMCT_DTYPE_BF16) {
    using bf16 = __nv_bfloat16;
    const ah_fwd90::Params p{static_cast<const bf16*>(x), g, bb, static_cast<const bf16*>(bqkv),
                             static_cast<const bf16*>(bproj), bias_f, mask_f,
                             static_cast<bf16*>(y), B, Hp, Wp, ws, scale, eps};
    const auto* wq = static_cast<const bf16*>(wqkv);
    const auto* wp = static_cast<const bf16*>(wproj);
    const size_t bytes = static_cast<size_t>(smem);
    err = C == 128 ? ah_fwd90::launch<128>(p, wq, wp, n_blocks, bytes, s)
                   : ah_fwd90::launch<256>(p, wq, wp, n_blocks, bytes, s);
  } else if (dtype == EMCT_DTYPE_F32) {
    const auto* xf = static_cast<const float*>(x);
    const auto* wq = static_cast<const float*>(wqkv);
    const auto* bq = static_cast<const float*>(bqkv);
    const auto* wp = static_cast<const float*>(wproj);
    const auto* bp = static_cast<const float*>(bproj);
    auto* yf = static_cast<float*>(y);
    err = C == 128 ? ah_fwd_fp32::launch<128>(xf, g, bb, wq, bq, wp, bp, bias_f, mask_f, yf, B, Hp,
                                              Wp, H, ws, scale, eps, s)
                   : ah_fwd_fp32::launch<256>(xf, g, bb, wq, bq, wp, bp, bias_f, mask_f, yf, B, Hp,
                                              Wp, H, ws, scale, eps, s);
  }
  return static_cast<int>(err);
}
