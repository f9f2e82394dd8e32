// q-tiled multi-head self-attention over long token sequences, forward
// (kernel 6).
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/flash_attention.py:75,
//   _fwd_kernel (its pallas_call at :152; called by flash_attention_tiled).
//   The ViT backbone runs it at a 448 input (T = 785, 12 heads of 64) and at
//   ViT-Large/512 (T = 1025, 16 heads of 64), no bias, keys past T masked.
//
// Computes, per image b and head h (T tokens, d = C/H in {32, 64}), from
// qkv[B, T, 3C] (head h in columns h*d .. (h+1)*d of each third):
//   P   = softmax(q k^T * scale)                                  (fp32)
//   out = P~ v,  P~ = the probabilities rounded to the input type
//   lse = log(sum_j exp(logit_j))  per query row, fp32 [B, H, T]
// out is written as [B, T, C].  lse is what the backward needs to rebuild P
// exactly from the logits without a statistics pass of its own.
//
// What bounds it on an H100: the tensor cores at the ViT-448 shape.  Per
// (image, head) it reads 3*T*d and writes T*d values and does 4*T^2*d flops:
// at T = 785, d = 64 that is ~390 flops per byte of bf16, over the ~295 at
// which the tensor cores, not the memory, become the limit.
//
// Design.  The TPU kernel keeps the whole key and value sequence of a head
// resident in VMEM and computes a [128, T] logit tile per grid step; here a
// [128, 785] fp32 tile fits neither registers nor shared memory, so blocks
// walk the keys in tiles of 64 with an online softmax.  The layout is the
// packed one with one group per image, so bf16 runs the packed forward's
// Hopper kernel (attention_fwd_sm90.cuh: wgmma for both products, a TMA ring
// of four key tiles refilled by the last warp done with a stage, blocks of
// two 64-row warpgroups, the last key tile cut to the next multiple of 16: T
// = 785 runs as 832 x 800), with the launch geometry of
// kernels/packed_attention.py:fwd_geometry.  fp32, off every main path, runs
// attention_fwd_fp32.cuh on the CUDA cores.

#include "attention_fwd_fp32.cuh"
#include "attention_fwd_sm90.cuh"

// qkv [B, T, 3C] and out [B, T, C] (dtype), lse [B, H, T] f32.  bf16 takes
// the launch geometry of kernels/packed_attention.py:fwd_geometry.  Requires
// C / H in {32, 64}; the Python wrapper checks shapes, contiguity and
// alignment first.
extern "C" int flash_attention_fwd(const void* qkv, void* out, void* lse, int B, int Tn, int C,
                                   int H, float scale, int row_blocks, int last, int stages,
                                   int smem, int dtype, void* stream) {
  if (B < 1 || Tn < 1 || H < 1 || C % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
#define EMCT_BF16(DIM)                                                                        \
  err = sm90_fwd::launch<DIM>(qkv, nullptr, nullptr, out, lse_f, B, 1, Tn, C, H, 1, 1, scale, \
                              row_blocks, last, stages, static_cast<size_t>(smem), s)
#define EMCT_F32(DIM) \
  err = fp32_fwd::launch<DIM>(qkv, nullptr, nullptr, out, lse_f, B, 1, Tn, C, H, 1, 1, scale, s)
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

// Registers a thread and blocks an SM of the bf16 kernel at d = 64, at
// ``smem`` bytes of shared memory: out = {registers, blocks}.  chip_smoke.py
// prints them.
extern "C" int flash_attention_fwd_occupancy(int smem, int* out) {
  return static_cast<int>(sm90_fwd::occupancy(static_cast<size_t>(smem), out));
}
