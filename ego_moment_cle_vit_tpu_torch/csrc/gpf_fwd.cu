// Fused Graph Polynomial Fusion, forward: both token Grams and the
// polynomial in one pass.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/gpf.py, _gpf_kernel (called by
//   fused_gpf_pallas).
//
// Computes, per batch element (tokens [N, D], any float type, read as fp32):
//   R_a = X_a X_a^T, R_p = X_p X_p^T   (cosine: rows scaled by 1/max(|x|, eps))
//   G   = sum_pq c[p, q] A_p(R_a) * A_q(R_p),  A_0 = 1, A_1 = R,
//         A_k = A_{k-1} * max(R, 0) for k >= 2
//   out = max(0, (G + G^T) / 2)  (or max(0, G) without symmetrization), fp32.
//
// What bounds it on an H100: memory, at the serving shapes.  One batch
// element reads N*D token values (twice that for two distinct token sets)
// and writes N*N fp32 values; a Gram costs 2*N*N*D flops, N flops per
// byte of bf16 tokens (49 at N = 49), well under the tensor cores' ~295.
// Design: one block per batch element streams its tokens through shared
// memory in 64-column chunks and keeps both N x N Gram accumulators in
// registers (N <= 64: at most 16 entries per thread per Gram), so the Grams
// never reach device memory.  The cosine normalization divides each Gram
// entry by the clamped row norms taken from the Gram diagonal, which is the
// same quantity as normalizing the rows first.  When anchor and positive are
// the same tensor (serving passes one tensor twice) the second Gram is not
// recomputed.  With one block per batch element, a batch of 64 fills 64 of
// the card's 132 SMs; splitting D across blocks is left to a later version.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;
constexpr int kMaxN = 64;
constexpr int kPerThread = (kMaxN * kMaxN + kThreads - 1) / kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gpf_fwd_kernel(const T* __restrict__ ta, const T* __restrict__ tp,
               const float* __restrict__ coeffs, float* __restrict__ out, int N, int D, int P,
               int Q, int cosine, float eps, int symmetric, int same) {
  extern __shared__ float smem[];
  constexpr int KP = kChunk + 1;
  float* sa = smem;          // [N][KP] anchor chunk
  float* sp = sa + N * KP;   // [N][KP] positive chunk
  float* ga = sp + N * KP;   // [N][N] anchor Gram, later the fused graph
  float* gp = ga + N * N;    // [N][N] positive Gram

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = N * N;
  const T* xa = ta + static_cast<size_t>(b) * N * D;
  const T* xp = tp + static_cast<size_t>(b) * N * D;

  float acc_a[kPerThread];
  float acc_p[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    acc_a[u] = 0.f;
    acc_p[u] = 0.f;
  }

  for (int k0 = 0; k0 < D; k0 += kChunk) {
    const int kc = min(kChunk, D - k0);
    __syncthreads();
    for (int e = tid; e < N * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int c = e % kChunk;
      const bool in = c < kc;
      const size_t off = static_cast<size_t>(r) * D + k0 + c;
      sa[r * KP + c] = in ? to_f32(xa[off]) : 0.f;
      if (!same) sp[r * KP + c] = in ? to_f32(xp[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = tid + u * kThreads;
      if (e < nn) {
        const float* ra = sa + (e / N) * KP;
        const float* rb = sa + (e % N) * KP;
        float s = acc_a[u];
#pragma unroll 16
        for (int c = 0; c < kChunk; ++c) s = fmaf(ra[c], rb[c], s);
        acc_a[u] = s;
        if (!same) {
          const float* pa = sp + (e / N) * KP;
          const float* pb = sp + (e % N) * KP;
          float t = acc_p[u];
#pragma unroll 16
          for (int c = 0; c < kChunk; ++c) t = fmaf(pa[c], pb[c], t);
          acc_p[u] = t;
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int e = tid + u * kThreads;
    if (e < nn) {
      ga[e] = acc_a[u];
      gp[e] = same ? acc_a[u] : acc_p[u];
    }
  }
  __syncthreads();

  float fused_vals[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int e = tid + u * kThreads;
    fused_vals[u] = 0.f;
    if (e < nn) {
      const int i = e / N;
      const int j = e % N;
      float ra = ga[e];
      float rp = gp[e];
      if (cosine) {
        ra = ra / (fmaxf(sqrtf(ga[i * N + i]), eps) * fmaxf(sqrtf(ga[j * N + j]), eps));
        rp = rp / (fmaxf(sqrtf(gp[i * N + i]), eps) * fmaxf(sqrtf(gp[j * N + j]), eps));
      }
      const float rac = fmaxf(ra, 0.f);
      const float rpc = fmaxf(rp, 0.f);
      float fused = 0.f;
      float ra_pow = 1.f;
      for (int p = 0; p <= P; ++p) {
        float rp_pow = 1.f;
        for (int q = 0; q <= Q; ++q) {
          fused += __ldg(coeffs + p * (Q + 1) + q) * (ra_pow * rp_pow);
          rp_pow *= (q == 0 ? rp : rpc);
        }
        ra_pow *= (p == 0 ? ra : rac);
      }
      fused_vals[u] = fused;
    }
  }
  __syncthreads();  // every Gram read is done before ga is overwritten

#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int e = tid + u * kThreads;
    if (e < nn) ga[e] = fused_vals[u];
  }
  __syncthreads();

  float* o = out + static_cast<size_t>(b) * nn;
  for (int e = tid; e < nn; e += kThreads) {
    const int i = e / N;
    const int j = e % N;
    const float g = symmetric ? 0.5f * (ga[e] + ga[j * N + i]) : ga[e];
    o[e] = fmaxf(g, 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* ta, const void* tp, const void* coeffs, void* out, int B, int N,
                   int D, int P, int Q, int cosine, float eps, int symmetric, cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(N) * (kChunk + 1) + 2 * static_cast<size_t>(N) * N) * sizeof(float);
  auto kernel = gpf_fwd_kernel<T>;
  cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int same = ta == tp ? 1 : 0;
  kernel<<<B, kThreads, smem, stream>>>(static_cast<const T*>(ta), static_cast<const T*>(tp),
                                         static_cast<const float*>(coeffs),
                                         static_cast<float*>(out), N, D, P, Q, cosine, eps,
                                         symmetric, same);
  return cudaGetLastError();
}

}  // namespace

// tokens_a, tokens_p [B, N, D] (dtype), coeffs [P+1, Q+1] f32, out [B, N, N]
// f32.  Requires 1 <= N <= 64; the Python wrapper checks shapes first.
extern "C" int gpf_fwd(const void* tokens_a, const void* tokens_p, const void* coeffs, void* out,
                       int B, int N, int D, int P, int Q, int cosine, float eps, int symmetric,
                       int dtype, void* stream) {
  if (N < 1 || N > kMaxN || D < 1 || P < 0 || Q < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == EMCT_DTYPE_F32) {
    err = launch<float>(tokens_a, tokens_p, coeffs, out, B, N, D, P, Q, cosine, eps, symmetric, s);
  } else if (dtype == EMCT_DTYPE_BF16) {
    err = launch<__nv_bfloat16>(tokens_a, tokens_p, coeffs, out, B, N, D, P, Q, cosine, eps,
                                symmetric, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
