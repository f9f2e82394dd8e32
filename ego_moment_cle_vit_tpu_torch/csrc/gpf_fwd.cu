// Fused Graph Polynomial Fusion, forward: both token Grams and the
// polynomial in one pass.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/gpf.py, _gpf_kernel (called by
//   fused_gpf_pallas).
//
// Computes, per batch element (tokens [N, D], bf16 or fp32):
//   R_a = X_a X_a^T, R_p = X_p X_p^T   (cosine: rows scaled by 1/max(|x|, eps))
//   G   = sum_pq c[p, q] A_p(R_a) * A_q(R_p),  A_0 = 1, A_1 = R,
//         A_k = A_{k-1} * max(R, 0) for k >= 2
//   out = max(0, (G + G^T) / 2)  (or max(0, G) without symmetrization), fp32.
//
// What bounds it on an H100: memory.  One batch element reads N*D token
// values (twice that for two distinct token sets) and writes N*N fp32 values;
// a Gram costs 2*N*N*D flops, N flops per byte of bf16 tokens (196 for a
// ViT at 224), under the tensor cores' ~295.
//
// Design.  The TPU kernel holds a whole [N, N] graph per grid step; here the
// output is tiled: one block of four warps per (batch element, 64 x 64 output
// tile) streams the row tokens and the column tokens of both sets through
// shared memory in 64-feature chunks and keeps its tile of both Grams in
// registers (mma_nt: tensor cores for bf16 tokens, whose products are exact in
// fp32; CUDA cores for fp32 tokens).  So N is unbounded and a ViT's 196 tokens
// give 16 blocks per batch element.  The cosine normalization divides each
// Gram entry by the clamped row norms, which the block sums from the staged
// chunks; that is the same quantity as normalizing the rows first.
// Symmetrization needs no second pass: both Grams are symmetric and the
// polynomial acts entry by entry, so G^T = G and (G + G^T) / 2 = G; the flag
// changes nothing here.  When anchor and positive are the same tensor the
// second Gram is not computed.

#include "gpf_tiles.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
gpf_fwd_kernel(const T* __restrict__ ta, const T* __restrict__ tp,
               const float* __restrict__ coeffs, float* __restrict__ out, int N, int D, int P,
               int Q, int cosine, float eps, int same, int vec_ok) {
  using S = GramSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* panels = reinterpret_cast<T*>(smem_raw);
  __shared__ float m_a[2 * kTile], m_p[2 * kTile];  // clamped norms: rows, then columns

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int tg = tid & 3;
  const T* xa = ta + static_cast<size_t>(b) * N * D;
  const T* xp = tp + static_cast<size_t>(b) * N * D;

  float acc_a[8][4], acc_p[8][4], nsq_a, nsq_p;
  gram_tiles<T>(xa, xp, N, D, i0, j0, same != 0, vec_ok != 0, panels, acc_a, acc_p, nsq_a, nsq_p);
  m_a[tid] = cosine ? fmaxf(sqrtf(nsq_a), eps) : 1.f;
  m_p[tid] = cosine ? fmaxf(sqrtf(same ? nsq_a : nsq_p), eps) : 1.f;
  __syncthreads();

  float* o = out + static_cast<size_t>(b) * N * N;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int li = warp * 16 + g + (e >> 1) * 8;
      const int lj = n * 8 + tg * 2 + (e & 1);
      const int i = i0 + li;
      const int j = j0 + lj;
      if (i < N && j < N) {
        const float ra = acc_a[n][e] / (m_a[li] * m_a[kTile + lj]);
        const float rp = (same ? acc_a[n][e] : acc_p[n][e]) / (m_p[li] * m_p[kTile + lj]);
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
        o[static_cast<size_t>(i) * N + j] = fmaxf(fused, 0.f);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* ta, const void* tp, const void* coeffs, void* out, int B, int N,
                   int D, int P, int Q, int cosine, float eps, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(GramSmem<T>::kPanel) * sizeof(T);
  auto kernel = gpf_fwd_kernel<T>;
  cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int same = ta == tp ? 1 : 0;
  const int vec = 16 / static_cast<int>(sizeof(T));
  const int vec_ok = (D % vec == 0 && reinterpret_cast<uintptr_t>(ta) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(tp) % 16 == 0)
                         ? 1
                         : 0;
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(ta), static_cast<const T*>(tp),
                                           static_cast<const float*>(coeffs),
                                           static_cast<float*>(out), N, D, P, Q, cosine, eps, same,
                                           vec_ok);
  return cudaGetLastError();
}

}  // namespace

// tokens_a, tokens_p [B, N, D] (dtype), coeffs [P+1, Q+1] f32, out [B, N, N]
// f32.  ``symmetric`` is accepted and changes nothing (see above).  The Python
// wrapper checks shapes first.
extern "C" int gpf_fwd(const void* tokens_a, const void* tokens_p, const void* coeffs, void* out,
                       int B, int N, int D, int P, int Q, int cosine, float eps, int symmetric,
                       int dtype, void* stream) {
  (void)symmetric;
  if (B < 1 || B > 65535 || N < 1 || D < 1 || P < 0 || Q < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == EMCT_DTYPE_F32) {
    err = launch<float>(tokens_a, tokens_p, coeffs, out, B, N, D, P, Q, cosine, eps, s);
  } else if (dtype == EMCT_DTYPE_BF16) {
    err = launch<__nv_bfloat16>(tokens_a, tokens_p, coeffs, out, B, N, D, P, Q, cosine, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
