// q-tiled multi-head self-attention over long token sequences, backward
// (kernel 6b).
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/flash_attention.py:94,
//   _bwd_kernel (its pallas_call at :177; the VJP of flash_attention_tiled).
//   The ViT backbone runs it at a 448 input (T = 785, 12 heads of 64) and at
//   ViT-Large/512 (T = 1025, 16 heads of 64), at batch 128 (two views of 64).
//
// Computes, per image b and head h (T tokens, d = C/H in {32, 64}), from
// qkv[B, T, 3C], the forward's out[B, T, C] and lse[B, H, T], and
// dout[B, T, C]:
//   P     = exp(q k^T * scale - lse)                        (rebuilt, fp32)
//   delta = rowsum(dout * out)              (= rowsum(dp * P), fp32)
//   dv    = P~^T dout            P~ = P rounded to the input type
//   ds    = P * (dout v^T - delta)                          (fp32)
//   dq    = ds~ k * scale,  dk = ds~^T q * scale            ds~ = ds rounded
// dq, dk, dv go to dqkv[B, T, 3C]; delta goes to a [B, H, T] fp32 scratch.
//
// What bounds it on an H100: the tensor cores.  Seven T x T x d products per
// (image, head), 14*T^2*d flops (two rebuilt), against reading 4*T*d and
// writing 3*T*d values: ~560 flops per byte of bf16 at T = 785, over the card's
// ~295.
//
// Design.  The TPU kernel recomputes the probabilities per 128-query tile
// and adds dk, dv into resident [T, d] blocks across a sequential grid.  Here
// blocks run in no order, so the work is cut along the axis each result is
// summed over and every sum stays inside one block (no float atomics: two
// runs give the same bits): a dq kernel whose blocks own query rows and walk
// the keys, then a dk/dv kernel whose blocks own keys and walk the queries.
// With the forward's lse saved there is no statistics pass.  The layout is
// the packed one with one group per image, so bf16 runs the packed backward's
// Hopper kernels (attention_bwd_sm90.cuh: wgmma for every product, P and ds
// fed to the second products from registers, a TMA ring of walked tiles fed
// by a producer warp, 64-row blocks, the last walked tile cut to the next
// multiple of 16: T = 785 runs as 832 x 800).  fp32, off every main path,
// runs attention_bwd_fp32.cuh on the CUDA cores.

#include "attention_bwd_fp32.cuh"
#include "attention_bwd_sm90.cuh"

// qkv, dqkv [B, T, 3C], out and dout [B, T, C] (dtype); lse [B, H, T] f32
// from the forward; delta: B*H*T f32 scratch.  bf16 takes the launch geometry
// of kernels/packed_attention.py:bwd_geometry.
// Requires C / H in {32, 64}; the Python wrapper checks shapes, contiguity and
// alignment first.
extern "C" int flash_attention_bwd(const void* qkv, const void* out, const void* dout,
                                   const void* lse, void* dqkv, void* delta, int B, int Tn, int C,
                                   int H, float scale, int row_blocks, int last, int stages,
                                   int smem, int dtype, void* stream) {
  if (B < 1 || Tn < 1 || H < 1 || C % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
#define EMCT_BF16(DIM)                                                                          \
  err = sm90_bwd::launch<DIM>(qkv, nullptr, nullptr, out, dout, lse_f, dqkv, delta_f, B, 1, Tn, \
                              C, H, 1, 1, scale, row_blocks, last, stages,                      \
                              static_cast<size_t>(smem), s)
#define EMCT_F32(DIM)                                                                            \
  err = fp32_bwd::launch<DIM>(static_cast<const float*>(qkv), nullptr, nullptr,                  \
                              static_cast<const float*>(out), static_cast<const float*>(dout),   \
                              lse_f, static_cast<float*>(dqkv), delta_f, B, 1, Tn, C, H, 1, 1,   \
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
  return static_cast<int>(err);
}

// Registers and blocks an SM holds of the bf16 kernels at d = 64, at ``smem``
// bytes of shared memory: out = {dq regs, dq blocks, dk/dv regs, dk/dv
// blocks}.  chip_smoke.py prints them.
extern "C" int flash_attention_bwd_occupancy(int smem, int* out) {
  return static_cast<int>(sm90_bwd::occupancy(static_cast<size_t>(smem), out));
}
