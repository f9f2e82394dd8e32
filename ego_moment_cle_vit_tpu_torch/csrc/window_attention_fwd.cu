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
// The design therefore reads each qkv element once, writes each output once
// and keeps the T x T logits on chip.  One block of four warps per (image,
// window, head); heads of one window sit in neighbouring blocks, so their
// 64-byte row segments share cache lines.
//
// bf16 (the serving dtype), T <= 64: q and k rows and v^T are staged in
// shared memory with 16-byte loads; each warp owns 16 query rows and runs
// both products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate).  The logits stay in registers: fp32 scale + bias + mask,
// max-subtracted softmax across the four lanes that share a row, then the
// probabilities are rounded to bf16 in place as the A operand of P v, as
// the TPU kernel does.  Tokens T..63 are zero padding, masked to -inf.
//
// fp32: the same per-block design on the CUDA cores, q/k/v and the logits
// in shared memory as fp32, so the results carry no bf16 or TF32 rounding.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHeadDim = 32;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTokPad = 64;  // T padded to 4 warps x 16 rows
constexpr int kQKStride = kHeadDim + 8;  // bf16 row stride: conflict-free fragment loads
constexpr int kVTStride = kTokPad + 8;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
window_attention_fwd_bf16(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                          const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int Hp,
                          int Wp, int C, int H, int ws, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sq[kTokPad * kQKStride];
  __shared__ __align__(16) __nv_bfloat16 sk[kTokPad * kQKStride];
  __shared__ __align__(16) __nv_bfloat16 svt[kHeadDim * kVTStride];  // v transposed

  const int nt = ws * ws;
  const int nwx = Wp / ws;
  const int win = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int b = blockIdx.y;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const int tid = threadIdx.x;
  const size_t c3 = 3 * static_cast<size_t>(C);

  // one token row of one head is 32 bf16 = four 16-byte vectors per tensor
  for (int e = tid; e < kTokPad * 4; e += kThreads) {
    const int t = e >> 2;
    const int part = e & 3;
    uint4 q4 = make_uint4(0, 0, 0, 0), k4 = q4, v4 = q4;
    if (t < nt) {
      const int y = y0 + t / ws;
      const int x = x0 + t % ws;
      const uint4* row = reinterpret_cast<const uint4*>(
                             qkv + ((static_cast<size_t>(b) * Hp + y) * Wp + x) * c3 + h * kHeadDim) +
                         part;
      q4 = __ldg(row);
      k4 = __ldg(row + C / 8);
      v4 = __ldg(row + C / 4);
    }
    *reinterpret_cast<uint4*>(sq + t * kQKStride + part * 8) = q4;
    *reinterpret_cast<uint4*>(sk + t * kQKStride + part * 8) = k4;
    const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&v4);
#pragma unroll
    for (int u = 0; u < 8; ++u) svt[(part * 8 + u) * kVTStride + t] = vv[u];
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int m0 = warp * 16;

  // S = Q K^T for rows m0..m0+15, all 64 (padded) key columns
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const __nv_bfloat16* qa = sq + (m0 + g) * kQKStride + ks * 16 + tg * 2;
    const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * kQKStride), ld32(qa + 8),
                           ld32(qa + 8 * kQKStride + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* kb = sk + (n * 8 + g) * kQKStride + ks * 16 + tg * 2;
      const uint32_t bb[2] = {ld32(kb), ld32(kb + 8)};
      mma_16816(s[n], a, bb);
    }
  }

  // logits in fp32: scale, bias, mask; padded keys -> -inf
  const float* bias_h = bias + static_cast<size_t>(h) * nt * nt;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;
  const int r0 = m0 + g;
  const int r1 = r0 + 8;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = n * 8 + tg * 2 + u;
      float v0 = -INFINITY, v1 = -INFINITY;
      if (j < nt) {
        v0 = s[n][u] * scale;
        v1 = s[n][2 + u] * scale;
        if (r0 < nt) {
          v0 += __ldg(bias_h + r0 * nt + j);
          if (mask_w) v0 += __ldg(mask_w + r0 * nt + j);
        }
        if (r1 < nt) {
          v1 += __ldg(bias_h + r1 * nt + j);
          if (mask_w) v1 += __ldg(mask_w + r1 * nt + j);
        }
      }
      s[n][u] = v0;
      s[n][2 + u] = v1;
      mx0 = fmaxf(mx0, v0);
      mx1 = fmaxf(mx1, v1);
    }
  }
  // a row's 64 values live in the 4 lanes of its group
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = expf(s[n][0] - mx0);
    s[n][1] = expf(s[n][1] - mx0);
    s[n][2] = expf(s[n][2] - mx1);
    s[n][3] = expf(s[n][3] - mx1);
    sum0 += s[n][0] + s[n][1];
    sum1 += s[n][2] + s[n][3];
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  const float inv0 = 1.f / sum0;
  const float inv1 = 1.f / sum1;

  // O = P V: the S accumulators of key tiles 2t, 2t+1 are the A fragment of k-step t
  float o[4][4];
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t a[4] = {
        pack_bf16(s[2 * t][0] * inv0, s[2 * t][1] * inv0),
        pack_bf16(s[2 * t][2] * inv1, s[2 * t][3] * inv1),
        pack_bf16(s[2 * t + 1][0] * inv0, s[2 * t + 1][1] * inv0),
        pack_bf16(s[2 * t + 1][2] * inv1, s[2 * t + 1][3] * inv1),
    };
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      const __nv_bfloat16* vb = svt + (dn * 8 + g) * kVTStride + t * 16 + tg * 2;
      const uint32_t bb[2] = {ld32(vb), ld32(vb + 8)};
      mma_16816(o[dn], a, bb);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r < nt) {
      const int y = y0 + r / ws;
      const int x = x0 + r % ws;
      __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * Hp + y) * Wp + x) * C + h * kHeadDim;
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8 + tg * 2) =
            __floats2bfloat162_rn(o[dn][2 * half], o[dn][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
window_attention_fwd_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                         const float* __restrict__ mask, float* __restrict__ out, int Hp, int Wp,
                         int C, int H, int ws, float scale) {
  extern __shared__ float smem[];
  constexpr int D = kHeadDim;
  constexpr int DP = D + 1;  // padded rows: conflict-free column walks
  const int nt = ws * ws;
  const int tp = nt + 1;
  float* sq = smem;
  float* sk = sq + nt * DP;
  float* sv = sk + nt * DP;
  float* sp = sv + nt * DP;  // [nt][tp] logits, then probabilities

  const int nwx = Wp / ws;
  const int win = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int b = blockIdx.y;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const int tid = threadIdx.x;
  const size_t c3 = 3 * static_cast<size_t>(C);

  for (int e = tid; e < nt * D; e += kThreads) {
    const int t = e / D;
    const int c = e % D;
    const int y = y0 + t / ws;
    const int x = x0 + t % ws;
    const float* row = qkv + ((static_cast<size_t>(b) * Hp + y) * Wp + x) * c3 + h * D + c;
    sq[t * DP + c] = row[0];
    sk[t * DP + c] = row[C];
    sv[t * DP + c] = row[2 * C];
  }
  __syncthreads();

  const float* bias_h = bias + static_cast<size_t>(h) * nt * nt;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;
  for (int e = tid; e < nt * nt; e += kThreads) {
    const int i = e / nt;
    const int j = e % nt;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc = fmaf(sq[i * DP + c], sk[j * DP + c], acc);
    float logit = acc * scale + bias_h[e];
    if (mask_w) logit += mask_w[e];
    sp[i * tp + j] = logit;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int i = warp; i < nt; i += kThreads / 32) {
    float* row = sp + i * tp;
    float m = -INFINITY;
    for (int j = lane; j < nt; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < nt; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      s += p;
    }
    const float inv = 1.f / warp_sum(s);
    for (int j = lane; j < nt; j += 32) row[j] *= inv;
  }
  __syncthreads();

  for (int e = tid; e < nt * D; e += kThreads) {
    const int i = e / D;
    const int c = e % D;
    const float* prow = sp + i * tp;
    float acc = 0.f;
    for (int j = 0; j < nt; ++j) acc = fmaf(prow[j], sv[j * DP + c], acc);
    const int y = y0 + i / ws;
    const int x = x0 + i % ws;
    out[((static_cast<size_t>(b) * Hp + y) * Wp + x) * C + h * D + c] = acc;
  }
}

}  // namespace

// qkv [B, Hp, Wp, 3C] (dtype), bias [H, T, T] f32, mask [nW, T, T] f32 or
// null, out [B, Hp, Wp, C] (dtype).  Requires C / H == 32, ws <= 8, Hp and
// Wp multiples of ws; the Python wrapper checks all of it before the call.
extern "C" int window_attention_fwd(const void* qkv, const void* bias, const void* mask,
                                    void* out, int B, int Hp, int Wp, int C, int H, int ws,
                                    float scale, int dtype, void* stream) {
  if (H <= 0 || C % H != 0 || C / H != kHeadDim || ws <= 0 || ws * ws > kTokPad ||
      Hp % ws != 0 || Wp % ws != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Hp / ws) * (Wp / ws) * H, B);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  if (dtype == EMCT_DTYPE_BF16) {
    window_attention_fwd_bf16<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), bias_f, mask_f,
        static_cast<__nv_bfloat16*>(out), Hp, Wp, C, H, ws, scale);
  } else if (dtype == EMCT_DTYPE_F32) {
    const int nt = ws * ws;
    const size_t smem =
        (3 * static_cast<size_t>(nt) * (kHeadDim + 1) + static_cast<size_t>(nt) * (nt + 1)) *
        sizeof(float);
    cudaError_t err = emct_allow_smem(window_attention_fwd_f32, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_fwd_f32<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(qkv), bias_f, mask_f, static_cast<float*>(out), Hp, Wp, C, H,
        ws, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
