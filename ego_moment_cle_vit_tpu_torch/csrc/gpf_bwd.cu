// Fused Graph Polynomial Fusion, backward: the analytic VJP in one pass.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/gpf.py, _gpf_bwd_kernel (the VJP
//   of fused_gpf_pallas).
//
// Per batch element, from tokens X_a, X_p [N, D], coeffs c [P+1, Q+1] and the
// output cotangent g [N, N] (fp32 inside):
//   R_a, R_p      the two Grams, recomputed (cosine: rows over max(|x|, eps))
//   A_k(R)        = R * max(R, 0)^(k-1), A_0 = 1;  A'_k = k * max(R, 0)^(k-1)
//   F             = sum_pq c[p,q] A_p(R_a) A_q(R_p), symmetrized if asked
//   df            = g * [F > 0], symmetrized if asked
//   dR_a          = df * sum_pq c[p,q] A'_p(R_a) A_q(R_p)      (dR_p alike)
//   dc[p,q]       = sum(df * A_p(R_a) * A_q(R_p))              -> dc [B, P+1, Q+1]
//   dX            = (dR + dR^T) X,  then the cosine normalization's backward
//                   with its |x| > eps gate                    -> dta, dtp [B, N, D]
// The caller sums dc over the batch.
//
// What bounds it on an H100: memory.  One batch element reads 2*N*D token
// values and N*N fp32 cotangents and writes 2*N*D values; two Grams and two
// [N,N] x [N,D] products are 8*N*N*D flops, about N flops per byte of bf16.
// Design: one block per batch element, like the forward.  The Grams are built
// from 64-column chunks streamed through shared memory and stay on chip, as
// do the six [N, N] work tiles.  The cosine backward is folded into the
// [N, N] factor so the tokens are streamed only once more:
//   dx_i = sum_j W_ij x_j,  W_ij = S_ij / (m_i m_j) - [i == j] gate_i proj_i / m_i^2,
//   S = dR + dR^T,  proj_i = sum_j S_ij R_ij,  m_i = max(|x_i|, eps),
// which equals (dxh - gate * xh * (xh . dxh)) / m with xh = x / m.  When both
// token pointers are the same tensor its Gram is built once, and the two
// gradients are still written apart: the caller (autograd) adds them.
// With one block per batch element a batch of 64 fills 64 of the card's 132
// SMs; splitting D across blocks is left to a later version.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;
constexpr int kMaxN = 64;
constexpr int kMaxDeg = 3;  // P, Q <= 3
constexpr int kMaxCoef = (kMaxDeg + 1) * (kMaxDeg + 1);
constexpr int kPerThread = (kMaxN * kMaxN + kThreads - 1) / kThreads;

// values[k] = A_k(r), grads[k] = A'_k(r) for k = 0..kMaxDeg
__device__ __forceinline__ void powers(float r, float* values, float* grads) {
  const float rc = fmaxf(r, 0.f);
  values[0] = 1.f;
  grads[0] = 0.f;
  float rc_pow = 1.f;  // rc^(k-1)
#pragma unroll
  for (int k = 1; k <= kMaxDeg; ++k) {
    values[k] = r * rc_pow;
    grads[k] = static_cast<float>(k) * rc_pow;
    rc_pow *= rc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gpf_bwd_kernel(const T* __restrict__ ta, const T* __restrict__ tp,
               const float* __restrict__ coeffs, const float* __restrict__ g,
               T* __restrict__ dta, T* __restrict__ dtp, float* __restrict__ dc, int N, int D,
               int P, int Q, int cosine, float eps, int symmetric, int same) {
  extern __shared__ float smem[];
  constexpr int KP = kChunk + 1;
  const int nn = N * N;
  float* sa = smem;          // [N][KP] anchor chunk
  float* sp = sa + N * KP;   // [N][KP] positive chunk
  float* ga = sp + N * KP;   // [N][N] raw anchor Gram
  float* gp = ga + nn;       // [N][N] raw positive Gram
  float* f1 = gp + nn;       // F, then dR_a
  float* f2 = f1 + nn;       // masked g, then S_a, then W_a
  float* f3 = f2 + nn;       // dR_p
  float* f4 = f3 + nn;       // S_p, then W_p
  __shared__ float ma[kMaxN], mp[kMaxN], gate_a[kMaxN], gate_p[kMaxN];
  __shared__ float proj_a[kMaxN], proj_p[kMaxN];
  __shared__ float red[kWarps][kMaxCoef];
  __shared__ float sc[kMaxCoef];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* xa = ta + static_cast<size_t>(b) * N * D;
  const T* xp = tp + static_cast<size_t>(b) * N * D;

  if (tid < kMaxCoef) {
    const int p = tid / (kMaxDeg + 1);
    const int q = tid % (kMaxDeg + 1);
    sc[tid] = (p <= P && q <= Q) ? coeffs[p * (Q + 1) + q] : 0.f;
  }

  // --- both Grams, as in the forward ---
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

  // row norms off the Gram diagonals
  if (tid < N) {
    const float na = sqrtf(ga[tid * N + tid]);
    const float np = sqrtf(gp[tid * N + tid]);
    ma[tid] = cosine ? fmaxf(na, eps) : 1.f;
    mp[tid] = cosine ? fmaxf(np, eps) : 1.f;
    gate_a[tid] = na > eps ? 1.f : 0.f;
    gate_p[tid] = np > eps ? 1.f : 0.f;
  }
  __syncthreads();

  // --- pass 1: the pre-activation polynomial F ---
  for (int e = tid; e < nn; e += kThreads) {
    const int i = e / N;
    const int j = e % N;
    float av[kMaxDeg + 1], ag[kMaxDeg + 1], bv[kMaxDeg + 1], bg[kMaxDeg + 1];
    powers(ga[e] / (ma[i] * ma[j]), av, ag);
    powers(gp[e] / (mp[i] * mp[j]), bv, bg);
    float fused = 0.f;
#pragma unroll
    for (int p = 0; p <= kMaxDeg; ++p) {
#pragma unroll
      for (int q = 0; q <= kMaxDeg; ++q) {
        // unused degrees are skipped, not multiplied by zero: their powers may overflow
        if (p <= P && q <= Q) fused = fmaf(sc[p * (kMaxDeg + 1) + q], av[p] * bv[q], fused);
      }
    }
    f1[e] = fused;
  }
  __syncthreads();

  // --- pass 2: the cotangent behind the clamp ---
  const float* gb = g + static_cast<size_t>(b) * nn;
  for (int e = tid; e < nn; e += kThreads) {
    const int i = e / N;
    const int j = e % N;
    const float fs = symmetric ? 0.5f * (f1[e] + f1[j * N + i]) : f1[e];
    f2[e] = fs > 0.f ? gb[e] : 0.f;
  }
  __syncthreads();

  // --- pass 3: dR_a, dR_p and the coefficient gradients ---
  float dc_acc[kMaxCoef];
#pragma unroll
  for (int k = 0; k < kMaxCoef; ++k) dc_acc[k] = 0.f;
  for (int e = tid; e < nn; e += kThreads) {
    const int i = e / N;
    const int j = e % N;
    const float df = symmetric ? 0.5f * (f2[e] + f2[j * N + i]) : f2[e];
    float av[kMaxDeg + 1], ag[kMaxDeg + 1], bv[kMaxDeg + 1], bg[kMaxDeg + 1];
    powers(ga[e] / (ma[i] * ma[j]), av, ag);
    powers(gp[e] / (mp[i] * mp[j]), bv, bg);
    float dra = 0.f, drp = 0.f;
#pragma unroll
    for (int p = 0; p <= kMaxDeg; ++p) {
#pragma unroll
      for (int q = 0; q <= kMaxDeg; ++q) {
        if (p <= P && q <= Q) {
          const float term = df * sc[p * (kMaxDeg + 1) + q];
          dra = fmaf(term, ag[p] * bv[q], dra);
          drp = fmaf(term, av[p] * bg[q], drp);
          dc_acc[p * (kMaxDeg + 1) + q] = fmaf(df, av[p] * bv[q], dc_acc[p * (kMaxDeg + 1) + q]);
        }
      }
    }
    f1[e] = dra;
    f3[e] = drp;
  }
#pragma unroll
  for (int k = 0; k < kMaxCoef; ++k) {
    const float v = warp_sum(dc_acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (tid < kMaxCoef) {
    const int p = tid / (kMaxDeg + 1);
    const int q = tid % (kMaxDeg + 1);
    if (p <= P && q <= Q) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][tid];
      dc[(static_cast<size_t>(b) * (P + 1) + p) * (Q + 1) + q] = v;
    }
  }

  // --- pass 4: S = dR + dR^T ---
  for (int e = tid; e < nn; e += kThreads) {
    const int eT = (e % N) * N + e / N;
    f2[e] = f1[e] + f1[eT];
    f4[e] = f3[e] + f3[eT];
  }
  __syncthreads();

  // --- passes 5, 6: fold the cosine backward into W ---
  if (cosine) {
    for (int i = warp; i < N; i += kWarps) {
      float pa = 0.f, pp = 0.f;
      for (int j = lane; j < N; j += 32) {
        pa = fmaf(f2[i * N + j], ga[i * N + j] / (ma[i] * ma[j]), pa);
        pp = fmaf(f4[i * N + j], gp[i * N + j] / (mp[i] * mp[j]), pp);
      }
      pa = warp_sum(pa);
      pp = warp_sum(pp);
      if (lane == 0) {
        proj_a[i] = pa;
        proj_p[i] = pp;
      }
    }
    __syncthreads();
    for (int e = tid; e < nn; e += kThreads) {
      const int i = e / N;
      const int j = e % N;
      float wa = f2[e] / (ma[i] * ma[j]);
      float wp = f4[e] / (mp[i] * mp[j]);
      if (i == j) {
        wa -= gate_a[i] * proj_a[i] / (ma[i] * ma[i]);
        wp -= gate_p[i] * proj_p[i] / (mp[i] * mp[i]);
      }
      f2[e] = wa;
      f4[e] = wp;
    }
  }

  // --- dX = W X, streamed in 64-column chunks ---
  T* oa = dta + static_cast<size_t>(b) * N * D;
  T* op = dtp + static_cast<size_t>(b) * N * D;
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
    const float* xs_p = same ? sa : sp;
    for (int o = tid; o < N * kChunk; o += kThreads) {
      const int i = o / kChunk;
      const int c = o % kChunk;
      float da = 0.f, dp = 0.f;
      for (int j = 0; j < N; ++j) {
        da = fmaf(f2[i * N + j], sa[j * KP + c], da);
        dp = fmaf(f4[i * N + j], xs_p[j * KP + c], dp);
      }
      if (c < kc) {
        const size_t off = static_cast<size_t>(i) * D + k0 + c;
        oa[off] = from_f32<T>(da);
        op[off] = from_f32<T>(dp);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* ta, const void* tp, const void* coeffs, const void* g, void* dta,
                   void* dtp, void* dc, int B, int N, int D, int P, int Q, int cosine, float eps,
                   int symmetric, cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(N) * (kChunk + 1) + 6 * static_cast<size_t>(N) * N) * sizeof(float);
  auto kernel = gpf_bwd_kernel<T>;
  cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int same = ta == tp ? 1 : 0;
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(ta), static_cast<const T*>(tp), static_cast<const float*>(coeffs),
      static_cast<const float*>(g), static_cast<T*>(dta), static_cast<T*>(dtp),
      static_cast<float*>(dc), N, D, P, Q, cosine, eps, symmetric, same);
  return cudaGetLastError();
}

}  // namespace

// tokens_a, tokens_p, dta, dtp [B, N, D] (dtype); coeffs [P+1, Q+1] f32;
// g [B, N, N] f32; dc [B, P+1, Q+1] f32.  Requires 1 <= N <= 64 and
// P, Q <= 3; the Python wrapper checks shapes first.  dta and dtp must be two
// buffers even when tokens_a and tokens_p are one.
extern "C" int gpf_bwd(const void* tokens_a, const void* tokens_p, const void* coeffs,
                       const void* g, void* dta, void* dtp, void* dc, int B, int N, int D, int P,
                       int Q, int cosine, float eps, int symmetric, int dtype, void* stream) {
  if (N < 1 || N > kMaxN || D < 1 || P < 0 || Q < 0 || P > kMaxDeg || Q > kMaxDeg || dta == dtp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == EMCT_DTYPE_F32) {
    err = launch<float>(tokens_a, tokens_p, coeffs, g, dta, dtp, dc, B, N, D, P, Q, cosine, eps,
                        symmetric, s);
  } else if (dtype == EMCT_DTYPE_BF16) {
    err = launch<__nv_bfloat16>(tokens_a, tokens_p, coeffs, g, dta, dtp, dc, B, N, D, P, Q,
                                cosine, eps, symmetric, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
