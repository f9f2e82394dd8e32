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
// bf16 (the training dtype), T <= 64: four warps; q, k, v and do rows are
// staged in shared memory with 16-byte loads, row-major and (q, k, do)
// transposed, and all five products run on the tensor cores with mma.sync
// m16n8k16 (bf16 in, fp32 accumulate).  Each warp owns 16 query rows for
// S = q k^T, dp = do v^T, the softmax, ds and dq = ds k, all in registers: the
// [T, T] logits, probabilities and ds never reach shared memory in fp32.  P
// and ds are written once, transposed and rounded to bf16, so that the same
// warp layout (16 key rows each) gives dv = P^T do and dk = ds^T q.  Tokens
// T..63 are zero padding: their keys are masked to -inf, their queries meet a
// zero do.
//
// fp32: the same per-block design on the CUDA cores out of shared memory, so
// the results carry no bf16 or TF32 rounding.  It is bound by shared-memory
// traffic, not by its bytes.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHeadDim = 32;
constexpr int kMaxTok = 64;
constexpr int kPerThread = kMaxTok * kMaxTok / kThreads;  // dbias entries per thread

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kRowStride = kHeadDim + 8;  // bf16 [token][d] rows: conflict-free fragment loads
constexpr int kColStride = kMaxTok + 8;   // bf16 [d or token][token] rows
// shared memory, in bf16 elements: q, k, v, do row-major; q, k, do transposed;
// P^T and ds^T
constexpr int kSmemBf16 = 4 * kMaxTok * kRowStride + 3 * kHeadDim * kColStride +
                          2 * kMaxTok * kColStride;

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

// acc[8][4] += A B^T for the warp's 16 rows of ``a`` (rows m0.., [row][d]) and
// all 64 rows of ``b`` ([row][d]): the contraction runs over d = 32.
__device__ __forceinline__ void rows_times_rows(float (*acc)[4], const __nv_bfloat16* a,
                                                const __nv_bfloat16* b, int m0, int g, int tg) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const __nv_bfloat16* pa = a + (m0 + g) * kRowStride + ks * 16 + tg * 2;
    const uint32_t fa[4] = {ld32(pa), ld32(pa + 8 * kRowStride), ld32(pa + 8),
                            ld32(pa + 8 * kRowStride + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* pb = b + (n * 8 + g) * kRowStride + ks * 16 + tg * 2;
      const uint32_t fb[2] = {ld32(pb), ld32(pb + 8)};
      mma_16816(acc[n], fa, fb);
    }
  }
}

// o[4][4] = A^T-layout product: rows m0.. of ``at`` ([row][64 tokens]) times the
// transposed operand ``bt`` ([d][64 tokens]); the contraction runs over tokens.
__device__ __forceinline__ void cols_times_cols(float (*o)[4], const __nv_bfloat16* at,
                                                const __nv_bfloat16* bt, int m0, int g, int tg) {
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const __nv_bfloat16* pa = at + (m0 + g) * kColStride + ks * 16 + tg * 2;
    const uint32_t fa[4] = {ld32(pa), ld32(pa + 8 * kColStride), ld32(pa + 8),
                            ld32(pa + 8 * kColStride + 8)};
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      const __nv_bfloat16* pb = bt + (dn * 8 + g) * kColStride + ks * 16 + tg * 2;
      const uint32_t fb[2] = {ld32(pb), ld32(pb + 8)};
      mma_16816(o[dn], fa, fb);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
window_attention_bwd_bf16(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                          const float* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dqkv, float* __restrict__ partial, int B,
                          int Hp, int Wp, int C, int H, int ws, float scale,
                          int images_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kMaxTok * kRowStride;
  __nv_bfloat16* sv = sk + kMaxTok * kRowStride;
  __nv_bfloat16* sdo = sv + kMaxTok * kRowStride;
  __nv_bfloat16* sqt = sdo + kMaxTok * kRowStride;   // [d][token]
  __nv_bfloat16* skt = sqt + kHeadDim * kColStride;
  __nv_bfloat16* sdot = skt + kHeadDim * kColStride;
  __nv_bfloat16* spt = sdot + kHeadDim * kColStride;  // P^T [key][query]
  __nv_bfloat16* sdst = spt + kMaxTok * kColStride;   // ds^T [key][query]

  const int nt = ws * ws;
  const int nwx = Wp / ws;
  const int win = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int m0 = warp * 16;
  const int r0 = m0 + g;
  const int r1 = r0 + 8;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const float* bias_h = bias + static_cast<size_t>(h) * nt * nt;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;

  // this thread's share of the [T, T] bias gradient, in the fragment layout
  float dbias_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dbias_acc[n][0] = dbias_acc[n][1] = dbias_acc[n][2] =
      dbias_acc[n][3] = 0.f;

  const int b_begin = blockIdx.y * images_per_block;
  const int b_end = min(B, b_begin + images_per_block);
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();  // the previous image's products are done with shared memory
    // one token row of one head is 32 bf16 = four 16-byte vectors per tensor
    for (int e = tid; e < kMaxTok * 4; e += kThreads) {
      const int t = e >> 2;
      const int part = e & 3;
      uint4 q4 = make_uint4(0, 0, 0, 0), k4 = q4, v4 = q4, d4 = q4;
      if (t < nt) {
        const size_t pix = (static_cast<size_t>(b) * Hp + (y0 + t / ws)) * Wp + (x0 + t % ws);
        const uint4* row = reinterpret_cast<const uint4*>(qkv + pix * c3 + h * kHeadDim) + part;
        q4 = __ldg(row);
        k4 = __ldg(row + C / 8);
        v4 = __ldg(row + C / 4);
        d4 = __ldg(reinterpret_cast<const uint4*>(dout + pix * C + h * kHeadDim) + part);
      }
      *reinterpret_cast<uint4*>(sq + t * kRowStride + part * 8) = q4;
      *reinterpret_cast<uint4*>(sk + t * kRowStride + part * 8) = k4;
      *reinterpret_cast<uint4*>(sv + t * kRowStride + part * 8) = v4;
      *reinterpret_cast<uint4*>(sdo + t * kRowStride + part * 8) = d4;
      const __nv_bfloat16* qq = reinterpret_cast<const __nv_bfloat16*>(&q4);
      const __nv_bfloat16* kk = reinterpret_cast<const __nv_bfloat16*>(&k4);
      const __nv_bfloat16* dd = reinterpret_cast<const __nv_bfloat16*>(&d4);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        sqt[(part * 8 + u) * kColStride + t] = qq[u];
        skt[(part * 8 + u) * kColStride + t] = kk[u];
        sdot[(part * 8 + u) * kColStride + t] = dd[u];
      }
    }
    __syncthreads();

    // S = q k^T and dp = do v^T for query rows m0..m0+15, all 64 (padded) keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    rows_times_rows(s, sq, sk, m0, g, tg);
    rows_times_rows(dp, sdo, sv, m0, g, tg);

    // logits in fp32: scale, bias, mask; padded keys -> -inf
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

    // P, delta_i = sum_j dp_ij P_ij, ds = P (dp - delta), all fp32 in registers
    float delta0 = 0.f, delta1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] *= inv0;
      s[n][1] *= inv0;
      s[n][2] *= inv1;
      s[n][3] *= inv1;
      delta0 += dp[n][0] * s[n][0] + dp[n][1] * s[n][1];
      delta1 += dp[n][2] * s[n][2] + dp[n][3] * s[n][3];
    }
    delta0 += __shfl_xor_sync(0xffffffffu, delta0, 1);
    delta0 += __shfl_xor_sync(0xffffffffu, delta0, 2);
    delta1 += __shfl_xor_sync(0xffffffffu, delta1, 1);
    delta1 += __shfl_xor_sync(0xffffffffu, delta1, 2);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = n * 8 + tg * 2 + u;
        const float ds0 = s[n][u] * (dp[n][u] - delta0);
        const float ds1 = s[n][2 + u] * (dp[n][2 + u] - delta1);
        dbias_acc[n][u] += ds0;
        dbias_acc[n][2 + u] += ds1;
        // P^T and ds^T, rounded to bf16, for the products over query rows
        spt[j * kColStride + r0] = __float2bfloat16(s[n][u]);
        spt[j * kColStride + r1] = __float2bfloat16(s[n][2 + u]);
        sdst[j * kColStride + r0] = __float2bfloat16(ds0);
        sdst[j * kColStride + r1] = __float2bfloat16(ds1);
        dp[n][u] = ds0;
        dp[n][2 + u] = ds1;
      }
    }

    // dq = ds k * scale: the ds accumulators of key tiles 2t, 2t+1 are the A
    // fragment of k-step t
    float o[4][4];
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t fa[4] = {
          pack_bf16(dp[2 * t][0], dp[2 * t][1]),
          pack_bf16(dp[2 * t][2], dp[2 * t][3]),
          pack_bf16(dp[2 * t + 1][0], dp[2 * t + 1][1]),
          pack_bf16(dp[2 * t + 1][2], dp[2 * t + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        const __nv_bfloat16* pb = skt + (dn * 8 + g) * kColStride + t * 16 + tg * 2;
        const uint32_t fb[2] = {ld32(pb), ld32(pb + 8)};
        mma_16816(o[dn], fa, fb);
      }
    }
    // this thread's two token rows of the window, in the spatial layout
    __nv_bfloat16* row0 = nullptr;
    __nv_bfloat16* row1 = nullptr;
    if (r0 < nt) {
      row0 = dqkv + ((static_cast<size_t>(b) * Hp + (y0 + r0 / ws)) * Wp + (x0 + r0 % ws)) * c3 +
             h * kHeadDim;
    }
    if (r1 < nt) {
      row1 = dqkv + ((static_cast<size_t>(b) * Hp + (y0 + r1 / ws)) * Wp + (x0 + r1 % ws)) * c3 +
             h * kHeadDim;
    }
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      if (row0) {
        *reinterpret_cast<__nv_bfloat162*>(row0 + dn * 8 + tg * 2) =
            __floats2bfloat162_rn(o[dn][0] * scale, o[dn][1] * scale);
      }
      if (row1) {
        *reinterpret_cast<__nv_bfloat162*>(row1 + dn * 8 + tg * 2) =
            __floats2bfloat162_rn(o[dn][2] * scale, o[dn][3] * scale);
      }
    }
    __syncthreads();  // P^T and ds^T are complete

    // dk = ds^T q * scale and dv = P^T do for key rows m0..m0+15
    cols_times_cols(o, sdst, sqt, m0, g, tg);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      if (row0) {
        *reinterpret_cast<__nv_bfloat162*>(row0 + C + dn * 8 + tg * 2) =
            __floats2bfloat162_rn(o[dn][0] * scale, o[dn][1] * scale);
      }
      if (row1) {
        *reinterpret_cast<__nv_bfloat162*>(row1 + C + dn * 8 + tg * 2) =
            __floats2bfloat162_rn(o[dn][2] * scale, o[dn][3] * scale);
      }
    }
    cols_times_cols(o, spt, sdot, m0, g, tg);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      if (row0) {
        *reinterpret_cast<__nv_bfloat162*>(row0 + 2 * C + dn * 8 + tg * 2) =
            __floats2bfloat162_rn(o[dn][0], o[dn][1]);
      }
      if (row1) {
        *reinterpret_cast<__nv_bfloat162*>(row1 + 2 * C + dn * 8 + tg * 2) =
            __floats2bfloat162_rn(o[dn][2], o[dn][3]);
      }
    }
  }

  // one [T, T] partial per block: partial[chunk][win][h][T*T]
  float* out = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * nt * nt;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = n * 8 + tg * 2 + u;
      if (j < nt) {
        if (r0 < nt) out[r0 * nt + j] = dbias_acc[n][u];
        if (r1 < nt) out[r1 * nt + j] = dbias_acc[n][2 + u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
window_attention_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ bias,
                         const float* __restrict__ mask, const float* __restrict__ dout,
                         float* __restrict__ dqkv, float* __restrict__ partial, int B, int Hp,
                         int Wp, int C, int H, int ws, float scale, int images_per_block) {
  extern __shared__ float smem[];
  constexpr int D = kHeadDim;
  constexpr int DP = D + 1;  // padded rows: conflict-free column walks
  const int nt = ws * ws;
  const int tp = nt + 1;
  float* sq = smem;
  float* sk = sq + nt * DP;
  float* sv = sk + nt * DP;
  float* sdo = sv + nt * DP;
  float* sp = sdo + nt * DP;  // [nt][tp] logits, then P
  float* sds = sp + nt * tp;  // [nt][tp] dp, then ds

  const int nwx = Wp / ws;
  const int win = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const float* bias_h = bias + static_cast<size_t>(h) * nt * nt;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;

  float dbias_acc[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) dbias_acc[u] = 0.f;

  const int b_begin = blockIdx.y * images_per_block;
  const int b_end = min(B, b_begin + images_per_block);
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();  // the previous image's products are done with shared memory
    for (int e = tid; e < nt * D; e += kThreads) {
      const int t = e / D;
      const int c = e % D;
      const size_t pix = (static_cast<size_t>(b) * Hp + (y0 + t / ws)) * Wp + (x0 + t % ws);
      const float* row = qkv + pix * c3 + h * D + c;
      sq[t * DP + c] = row[0];
      sk[t * DP + c] = row[C];
      sv[t * DP + c] = row[2 * C];
      sdo[t * DP + c] = dout[pix * C + h * D + c];
    }
    __syncthreads();

    // logits and dp = do v^T
    for (int e = tid; e < nt * nt; e += kThreads) {
      const int i = e / nt;
      const int j = e % nt;
      float acc = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        acc = fmaf(sq[i * DP + c], sk[j * DP + c], acc);
        dp = fmaf(sdo[i * DP + c], sv[j * DP + c], dp);
      }
      float logit = acc * scale + bias_h[e];
      if (mask_w) logit += mask_w[e];
      sp[i * tp + j] = logit;
      sds[i * tp + j] = dp;
    }
    __syncthreads();

    // softmax rows, delta_i = sum_j dp_ij P_ij, ds = P (dp - delta)
    for (int i = warp; i < nt; i += kThreads / 32) {
      float* prow = sp + i * tp;
      float* drow = sds + i * tp;
      float m = -INFINITY;
      for (int j = lane; j < nt; j += 32) m = fmaxf(m, prow[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < nt; j += 32) {
        const float p = expf(prow[j] - m);
        prow[j] = p;
        s += p;
      }
      const float inv = 1.f / warp_sum(s);
      float delta = 0.f;
      for (int j = lane; j < nt; j += 32) {
        const float p = prow[j] * inv;
        prow[j] = p;
        delta = fmaf(drow[j], p, delta);
      }
      delta = warp_sum(delta);
      for (int j = lane; j < nt; j += 32) drow[j] = prow[j] * (drow[j] - delta);
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = tid + u * kThreads;
      if (e < nt * nt) dbias_acc[u] += sds[(e / nt) * tp + e % nt];
    }

    // dq = ds k * scale, dk = ds^T q * scale, dv = P^T do
    for (int e = tid; e < nt * D; e += kThreads) {
      const int t = e / D;
      const int c = e % D;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < nt; ++j) {
        dq = fmaf(sds[t * tp + j], sk[j * DP + c], dq);
        dk = fmaf(sds[j * tp + t], sq[j * DP + c], dk);
        dv = fmaf(sp[j * tp + t], sdo[j * DP + c], dv);
      }
      const size_t pix = (static_cast<size_t>(b) * Hp + (y0 + t / ws)) * Wp + (x0 + t % ws);
      float* row = dqkv + pix * c3 + h * D + c;
      row[0] = dq * scale;
      row[C] = dk * scale;
      row[2 * C] = dv;
    }
  }

  // one [T, T] partial per block: partial[chunk][win][h][T*T]
  float* out = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * nt * nt;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int e = tid + u * kThreads;
    if (e < nt * nt) out[e] = dbias_acc[u];
  }
}

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
// f32 scratch, with n_chunks * ceil(B / n_chunks) >= B.  Requires C / H == 32,
// ws <= 8, Hp and Wp multiples of ws; the Python wrapper checks all of it.
extern "C" int window_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                    const void* dout, void* dqkv, void* partial, void* dbias,
                                    int B, int Hp, int Wp, int C, int H, int ws, float scale,
                                    int n_chunks, int dtype, void* stream) {
  if (H <= 0 || C % H != 0 || C / H != kHeadDim || ws <= 0 || ws * ws > kMaxTok ||
      Hp % ws != 0 || Wp % ws != 0 || n_chunks < 1 || n_chunks > B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = ws * ws;
  const int n_win = (Hp / ws) * (Wp / ws);
  const int per_block = (B + n_chunks - 1) / n_chunks;
  const dim3 grid(n_win * H, n_chunks);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  float* partial_f = static_cast<float*>(partial);
  if (dtype == EMCT_DTYPE_BF16) {
    const size_t smem = static_cast<size_t>(kSmemBf16) * sizeof(__nv_bfloat16);
    cudaError_t err = emct_allow_smem(window_attention_bwd_bf16, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_bwd_bf16<<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), bias_f, mask_f,
        static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dqkv), partial_f, B,
        Hp, Wp, C, H, ws, scale, per_block);
  } else if (dtype == EMCT_DTYPE_F32) {
    const size_t smem = (4 * static_cast<size_t>(nt) * (kHeadDim + 1) +
                         2 * static_cast<size_t>(nt) * (nt + 1)) * sizeof(float);
    cudaError_t err = emct_allow_smem(window_attention_bwd_f32, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_bwd_f32<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(qkv), bias_f, mask_f, static_cast<const float*>(dout),
        static_cast<float*>(dqkv), partial_f, B, Hp, Wp, C, H, ws, scale, per_block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = H * nt * nt;
  window_attention_dbias_reduce<<<(total + 255) / 256, 256, 0, s>>>(partial_f,
                                                                    static_cast<float*>(dbias),
                                                                    n_chunks, n_win, H, nt * nt);
  return static_cast<int>(cudaGetLastError());
}
