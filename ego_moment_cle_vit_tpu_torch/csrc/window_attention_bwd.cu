// Shifted-window multi-head self-attention, backward, straight from the
// image-layout qkv map.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/window_attention.py,
//   _bwd_kernel_spatial (the VJP of flash_window_attention_spatial).
//
// Computes, per image b, window w and head h (T = ws*ws tokens, d = C/H = 32),
// from qkv[B, Hp, Wp, 3C], bias[H, T, T], mask[nW, T, T] and dout[B, Hp, Wp, C]:
//   P  = softmax(q k^T * scale + bias[h] + mask[w])        (recomputed, fp32)
//   dv = P~^T do            P~ = P rounded to the input type
//   dp = do v^T
//   ds = P * (dp - rowsum(dp * P))                         (fp32)
//   dq = ds~ k * scale,  dk = ds~^T q * scale              ds~ = ds rounded
//   dbias[h] = sum over images and windows of ds
// dq, dk, dv go to dqkv[B, Hp, Wp, 3C] at the window's spatial rows, so the
// window partition and reverse are the kernel's own addressing.  The mask gets
// no gradient.  The probabilities are never stored: the forward saves qkv only.
//
// What bounds it on an H100: memory.  Per token and head it reads 4d values
// (q, k, v, do) and writes 3d, and does 10*T*d flops: ~35 flops per byte in
// bf16, far under the ~295 at which the tensor cores become the limit.
//
// The bias gradient is a sum over every image and window.  The TPU kernel
// carries it across a sequential grid; a CUDA grid has no order, so one block
// owns a (window, head) pair, walks a chunk of images, keeps its [T, T] fp32
// sum in registers and writes one partial per block.  A second kernel adds
// the partials in a fixed order, so the gradient is the same from run to run
// (no float atomics).
//
// bf16 (the training dtype): window_attention_bwd_sm90.cuh, one warpgroup a
// block, windows fed by a TMA ring, every product on wgmma.  fp32:
// window_attention_bwd_fp32.cuh, the same per-block design on the CUDA cores.

#include <cstdint>

#include "window_attention_bwd_fp32.cuh"
#include "window_attention_bwd_sm90.cuh"

namespace {

// dbias[h][e] = sum over chunks and windows of partial[chunk][win][h][e], in a
// fixed order.
__global__ void window_attention_dbias_reduce(const float* __restrict__ partial,
                                              float* __restrict__ dbias, int n_chunks, int n_win,
                                              int H, int tt) {
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

}  // namespace

// qkv, dqkv [B, Hp, Wp, 3C] and dout [B, Hp, Wp, C] (dtype); bias, dbias
// [H, T, T] f32; mask [nW, T, T] f32 or null; partial [n_chunks, nW, H, T, T]
// f32 scratch, with no chunk of ceil(B / n_chunks) images empty.  bf16 also
// takes the ring's ``stages`` and its shared memory ``smem`` (bytes), both
// from kernels/window_attention.py:bwd_geometry.  Requires C / H == 32,
// ws <= 8, Hp and Wp multiples of ws; the Python wrapper checks all of it.
extern "C" int window_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                    const void* dout, void* dqkv, void* partial, void* dbias,
                                    int B, int Hp, int Wp, int C, int H, int ws, float scale,
                                    int n_chunks, int stages, long long smem, int dtype,
                                    void* stream) {
  constexpr int kHeadDim = wa_bwd_fp32::kHeadDim;
  if (H <= 0 || C % H != 0 || C / H != kHeadDim || ws <= 0 || ws * ws > wa_bwd_fp32::kMaxTok ||
      Hp % ws != 0 || Wp % ws != 0 || n_chunks < 1 || n_chunks > B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = ws * ws;
  const int n_win = (Hp / ws) * (Wp / ws);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  float* partial_f = static_cast<float*>(partial);
  cudaError_t err;
  if (dtype == EMCT_DTYPE_BF16) {
    err = wa_bwd90::launch(qkv, dout, bias_f, mask_f, dqkv, nullptr, partial_f, B, Hp, Wp, C, H,
                           ws, scale, n_chunks, stages, static_cast<size_t>(smem), s);
  } else if (dtype == EMCT_DTYPE_F32) {
    const int per_block = (B + n_chunks - 1) / n_chunks;
    const size_t bytes = (4 * static_cast<size_t>(nt) * (kHeadDim + 1) +
                          2 * static_cast<size_t>(nt) * (nt + 1)) * sizeof(float);
    err = emct_allow_smem(wa_bwd_fp32::window_attention_bwd_f32, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wa_bwd_fp32::window_attention_bwd_f32<<<dim3(n_win * H, n_chunks), wa_bwd_fp32::kThreads,
                                            bytes, s>>>(
        static_cast<const float*>(qkv), bias_f, mask_f, static_cast<const float*>(dout),
        static_cast<float*>(dqkv), partial_f, B, Hp, Wp, C, H, ws, scale, per_block);
    err = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = H * nt * nt;
  window_attention_dbias_reduce<<<(total + 255) / 256, 256, 0, s>>>(partial_f,
                                                                    static_cast<float*>(dbias),
                                                                    n_chunks, n_win, H, nt * nt);
  return static_cast<int>(cudaGetLastError());
}
