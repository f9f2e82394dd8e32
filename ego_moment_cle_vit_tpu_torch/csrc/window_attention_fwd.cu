// Shifted-window multi-head self-attention, forward, straight from the
// image-layout qkv map.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/window_attention.py,
//   _fwd_kernel_spatial (called by flash_window_attention_spatial).
//
// Computes, per image b, window w and head h (T = ws*ws tokens, d = C/H = 32):
//   out[w, :, h] = softmax(q k^T * scale + bias[h] + mask[w]) v
// with q/k/v read from qkv[B, Hp, Wp, 3C] at the window's spatial rows and
// the result written back into out[B, Hp, Wp, C] at the same positions, so
// the window partition and reverse happen in the kernel's own addressing.
//
// What bounds it on an H100: memory.  Per token and head it reads 3d and
// writes d values and does 4*T*d flops, about 25 flops per byte in bf16,
// far under the ~295 flops/byte at which the tensor cores become the limit.
// Each qkv element is read once, each output written once, and the T x T
// logits stay on chip.
//
// bf16 (the serving dtype): window_attention_fwd_sm90.cuh, one warpgroup a
// block walking a chunk of images for one (window, head), windows fed by a
// TMA ring, both products on wgmma, the bias and mask summed once a block.
// fp32: window_attention_fwd_fp32.cuh, one block per (image, window, head)
// on the CUDA cores.  The dtype alone picks the body.

#include <cstdint>

#include "window_attention_fwd_fp32.cuh"
#include "window_attention_fwd_sm90.cuh"

// qkv [B, Hp, Wp, 3C] (dtype), bias [H, T, T] f32, mask [nW, T, T] f32 or
// null, out [B, Hp, Wp, C] (dtype).  bf16 also takes the image chunks, the
// ring's ``stages`` and its shared memory ``smem`` (bytes), all from
// kernels/window_attention.py:fwd_geometry; fp32 ignores them.  Requires
// C / H == 32, ws <= 8, Hp and Wp multiples of ws; the Python wrapper checks
// all of it before the call.
extern "C" int window_attention_fwd(const void* qkv, const void* bias, const void* mask,
                                    void* out, int B, int Hp, int Wp, int C, int H, int ws,
                                    float scale, int n_chunks, int stages, long long smem,
                                    int dtype, void* stream) {
  constexpr int kHeadDim = wa_fwd_fp32::kHeadDim;
  if (B < 1 || H <= 0 || C % H != 0 || C / H != kHeadDim || ws <= 0 ||
      ws * ws > wa_fwd_fp32::kMaxTok || Hp % ws != 0 || Wp % ws != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  if (dtype == EMCT_DTYPE_BF16) {
    return static_cast<int>(wa_fwd90::launch(qkv, bias_f, mask_f, out, B, Hp, Wp, C, H, ws,
                                             scale, n_chunks, stages,
                                             static_cast<size_t>(smem), s));
  }
  if (dtype != EMCT_DTYPE_F32) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = ws * ws;
  const size_t bytes =
      (3 * static_cast<size_t>(nt) * (kHeadDim + 1) + static_cast<size_t>(nt) * (nt + 1)) *
      sizeof(float);
  cudaError_t err = emct_allow_smem(wa_fwd_fp32::window_attention_fwd_f32, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Hp / ws) * (Wp / ws) * H, B);
  wa_fwd_fp32::window_attention_fwd_f32<<<grid, wa_fwd_fp32::kThreads, bytes, s>>>(
      static_cast<const float*>(qkv), bias_f, mask_f, static_cast<float*>(out), Hp, Wp, C, H, ws,
      scale);
  return static_cast<int>(cudaGetLastError());
}
