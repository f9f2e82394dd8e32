// Fused Graph Polynomial Fusion, backward: the analytic VJP.
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
//
// Design.  The TPU kernel holds six [N, N] work tiles of one batch element on
// chip; at a ViT's 196 tokens that is past one block, and dX needs a sum over
// all N columns of a row before it can be written.  Two kernels, every sum
// inside a block or over ordered partials (no float atomics):
//   1. w kernel, one block per (batch element, 64 x 64 tile): rebuilds its
//      tile of both Grams like the forward, evaluates the polynomial and its
//      derivatives entry by entry, and writes the factor W = S / (m m^T) of
//      each token set to a scratch [B, 2, N, N], with S = dR + dR^T and m the
//      clamped norms (1 for dot).  Because R_a, R_p and F are symmetric,
//      S_ij = (g_ij + g_ji) [F_ij > 0] poly'_ij with or without the
//      symmetrization flag, so a block needs its own tile and the mirrored
//      tile of g and no second pass.  It also writes the tile's part of
//      proj_i = sum_j S_ij R_ij (the cosine backward's row reduction) and of dc.
//   2. dx kernel, one block per (batch element, 64 rows, 64 features): streams
//      W and the tokens through shared memory, dX = W X on the CUDA cores in
//      fp32 (W is fp32; rounding it to bf16 for the tensor cores would cost
//      the gradient three digits), then the folded cosine term
//      dx_i -= gate_i proj_i / m_i^2 x_i with proj_i summed over the column
//      tiles in order.  Its first block per batch element adds the dc
//      partials in order.
// The scratch costs 2*N*N fp32 written and read per batch element on top of
// the bytes above.  When both token pointers are the same tensor its Gram is
// built once, and the two gradients are still written apart: the caller
// (autograd) adds them.

#include "gpf_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. the [N, N] factors
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
gpf_bwd_w_kernel(const T* __restrict__ ta, const T* __restrict__ tp,
                 const float* __restrict__ coeffs, const float* __restrict__ gout,
                 float* __restrict__ wmat, float* __restrict__ proj_part,
                 float* __restrict__ norms, float* __restrict__ dc_part, int N, int D, int P,
                 int Q, int cosine, float eps, int symmetric, int same, int vec_ok) {
  using S = GramSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* panels = reinterpret_cast<T*>(smem_raw);
  __shared__ float m_a[2 * kTile], m_p[2 * kTile];  // clamped norms: rows, then columns
  __shared__ float red[kWarps][kMaxCoef];
  __shared__ float sc[kMaxCoef];

  const int b = blockIdx.z;
  const int it = blockIdx.y;
  const int jt = blockIdx.x;
  const int tiles = gridDim.x;
  const int i0 = it * kTile;
  const int j0 = jt * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const T* xa = ta + static_cast<size_t>(b) * N * D;
  const T* xp = tp + static_cast<size_t>(b) * N * D;

  if (tid < kMaxCoef) {
    const int p = tid / (kMaxDeg + 1);
    const int q = tid % (kMaxDeg + 1);
    sc[tid] = (p <= P && q <= Q) ? coeffs[p * (Q + 1) + q] : 0.f;
  }

  float acc_a[8][4], acc_p[8][4], nsq_a, nsq_p;
  gram_tiles<T>(xa, xp, N, D, i0, j0, same != 0, vec_ok != 0, panels, acc_a, acc_p, nsq_a, nsq_p);
  const float norm_a = sqrtf(nsq_a);
  const float norm_p = sqrtf(same ? nsq_a : nsq_p);
  m_a[tid] = cosine ? fmaxf(norm_a, eps) : 1.f;
  m_p[tid] = cosine ? fmaxf(norm_p, eps) : 1.f;
  // norms[b][set][0: clamped norm, 1: gate][N], written once per row tile
  if (jt == 0 && tid < kTile && i0 + tid < N) {
    float* nb = norms + static_cast<size_t>(b) * 4 * N;
    nb[0 * N + i0 + tid] = m_a[tid];
    nb[1 * N + i0 + tid] = (!cosine || norm_a > eps) ? 1.f : 0.f;
    nb[2 * N + i0 + tid] = m_p[tid];
    nb[3 * N + i0 + tid] = (!cosine || norm_p > eps) ? 1.f : 0.f;
  }
  __syncthreads();

  const float* gb = gout + static_cast<size_t>(b) * N * N;
  float* wa = wmat + static_cast<size_t>(b) * 2 * N * N;
  float* wp = wa + static_cast<size_t>(N) * N;
  float dc_acc[kMaxCoef];
#pragma unroll
  for (int k = 0; k < kMaxCoef; ++k) dc_acc[k] = 0.f;
  float proj_a[2] = {0.f, 0.f}, proj_p[2] = {0.f, 0.f};  // rows g and g + 8

#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int li = warp * 16 + g + (e >> 1) * 8;
      const int lj = n * 8 + tg * 2 + (e & 1);
      const int i = i0 + li;
      const int j = j0 + lj;
      if (i < N && j < N) {
        const float mm_a = m_a[li] * m_a[kTile + lj];
        const float mmp = m_p[li] * m_p[kTile + lj];
        const float ra = acc_a[n][e] / mm_a;
        const float rp = (same ? acc_a[n][e] : acc_p[n][e]) / mmp;
        float av[kMaxDeg + 1], ag[kMaxDeg + 1], bv[kMaxDeg + 1], bg[kMaxDeg + 1];
        powers(ra, av, ag);
        powers(rp, bv, bg);
        float fused = 0.f, da = 0.f, dp = 0.f;
#pragma unroll
        for (int p = 0; p <= kMaxDeg; ++p) {
#pragma unroll
          for (int q = 0; q <= kMaxDeg; ++q) {
            // unused degrees are skipped, not multiplied by zero: their powers may overflow
            if (p <= P && q <= Q) {
              const float c = sc[p * (kMaxDeg + 1) + q];
              fused = fmaf(c, av[p] * bv[q], fused);
              da = fmaf(c, ag[p] * bv[q], da);
              dp = fmaf(c, av[p] * bg[q], dp);
            }
          }
        }
        const float gij = gb[static_cast<size_t>(i) * N + j];
        const float gji = gb[static_cast<size_t>(j) * N + i];
        const bool pos = fused > 0.f;
        const float gs = pos ? gij + gji : 0.f;
        const float df = symmetric ? 0.5f * gs : (pos ? gij : 0.f);
#pragma unroll
        for (int p = 0; p <= kMaxDeg; ++p) {
#pragma unroll
          for (int q = 0; q <= kMaxDeg; ++q) {
            if (p <= P && q <= Q) {
              dc_acc[p * (kMaxDeg + 1) + q] = fmaf(df, av[p] * bv[q], dc_acc[p * (kMaxDeg + 1) + q]);
            }
          }
        }
        const float s_a = gs * da;
        const float s_p = gs * dp;
        wa[static_cast<size_t>(i) * N + j] = s_a / mm_a;
        wp[static_cast<size_t>(i) * N + j] = s_p / mmp;
        proj_a[e >> 1] = fmaf(s_a, ra, proj_a[e >> 1]);
        proj_p[e >> 1] = fmaf(s_p, rp, proj_p[e >> 1]);
      }
    }
  }

  // proj_part[b][set][jt][N]: this tile's share of each row's reduction
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float pa = quad_sum(proj_a[half]);
    const float pp = quad_sum(proj_p[half]);
    const int i = i0 + warp * 16 + g + half * 8;
    if (tg == 0 && i < N) {
      float* pb = proj_part + static_cast<size_t>(b) * 2 * tiles * N;
      pb[static_cast<size_t>(jt) * N + i] = pa;
      pb[(static_cast<size_t>(tiles) + jt) * N + i] = pp;
    }
  }

  // dc_part[b][tile][kMaxCoef]
#pragma unroll
  for (int k = 0; k < kMaxCoef; ++k) {
    const float v = warp_sum(dc_acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (tid < kMaxCoef) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi][tid];
    dc_part[(static_cast<size_t>(b) * tiles * tiles + it * tiles + jt) * kMaxCoef + tid] = v;
  }
}

// ---------------------------------------------------------------------------
// 2. dX = W X and the folded cosine term
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
gpf_bwd_dx_kernel(const T* __restrict__ ta, const T* __restrict__ tp,
                  const float* __restrict__ wmat, const float* __restrict__ proj_part,
                  const float* __restrict__ norms, const float* __restrict__ dc_part,
                  T* __restrict__ dta, T* __restrict__ dtp, float* __restrict__ dc, int N, int D,
                  int P, int Q, int cosine, int tiles) {
  constexpr int LD = kTile + TilePad<float>::value;
  __shared__ __align__(16) float sw[kTile * LD];   // W tile [row][column token]
  __shared__ __align__(16) float sxt[kTile * LD];  // token tile transposed [feature][token]

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int d0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int tg = tid & 3;

  if (blockIdx.x == 0 && blockIdx.y == 0 && tid < kMaxCoef) {
    const int p = tid / (kMaxDeg + 1);
    const int q = tid % (kMaxDeg + 1);
    if (p <= P && q <= Q) {
      const float* part = dc_part + static_cast<size_t>(b) * tiles * tiles * kMaxCoef + tid;
      float v = 0.f;
      for (int t = 0; t < tiles * tiles; ++t) v += part[static_cast<size_t>(t) * kMaxCoef];
      dc[(static_cast<size_t>(b) * (P + 1) + p) * (Q + 1) + q] = v;
    }
  }

  for (int set = 0; set < 2; ++set) {
    const T* x = (set ? tp : ta) + static_cast<size_t>(b) * N * D;
    T* dx = (set ? dtp : dta) + static_cast<size_t>(b) * N * D;
    const float* wm = wmat + (static_cast<size_t>(b) * 2 + set) * N * N;
    float acc[8][4];
    zero_acc<8>(acc);
    for (int jt = 0; jt < tiles; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile;
        const int c = e % kTile;
        sw[r * LD + c] =
            (i0 + r < N && j0 + c < N) ? wm[static_cast<size_t>(i0 + r) * N + j0 + c] : 0.f;
        // r: token of the tile, c: feature
        sxt[c * LD + r] = (j0 + r < N && d0 + c < D)
                              ? to_f32(x[static_cast<size_t>(j0 + r) * D + d0 + c])
                              : 0.f;
      }
      __syncthreads();
      mma_nt<8, kTile>(acc, sw + warp * 16 * LD, LD, sxt, LD, g, tg);
    }

    // rows g and g + 8 of this warp: gate_i proj_i / m_i^2
    float fold[2] = {0.f, 0.f};
    if (cosine) {
      const float* nb = norms + (static_cast<size_t>(b) * 4 + 2 * set) * N;
      const float* pb = proj_part + (static_cast<size_t>(b) * 2 + set) * tiles * N;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + warp * 16 + g + half * 8;
        if (i < N) {
          float proj = 0.f;
          for (int jt = 0; jt < tiles; ++jt) proj += pb[static_cast<size_t>(jt) * N + i];
          const float m = nb[i];
          fold[half] = nb[N + i] * proj / (m * m);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + warp * 16 + g + (e >> 1) * 8;
        const int c = d0 + n * 8 + tg * 2 + (e & 1);
        if (i < N && c < D) {
          const size_t off = static_cast<size_t>(i) * D + c;
          float v = acc[n][e];
          if (cosine) v -= fold[e >> 1] * to_f32(x[off]);
          dx[off] = from_f32<T>(v);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* ta, const void* tp, const void* coeffs, const void* g, void* dta,
                   void* dtp, void* dc, float* scratch, int B, int N, int D, int P, int Q,
                   int cosine, float eps, int symmetric, cudaStream_t stream) {
  const int tiles = (N + kTile - 1) / kTile;
  // scratch: W [B,2,N,N], proj_part [B,2,tiles,N], norms [B,4,N], dc_part [B,tiles^2,16]
  float* wmat = scratch;
  float* proj_part = wmat + static_cast<size_t>(B) * 2 * N * N;
  float* norms = proj_part + static_cast<size_t>(B) * 2 * tiles * N;
  float* dc_part = norms + static_cast<size_t>(B) * 4 * N;

  const size_t smem = 4 * static_cast<size_t>(GramSmem<T>::kPanel) * sizeof(T);
  auto w_kernel = gpf_bwd_w_kernel<T>;
  cudaError_t err = emct_allow_smem(w_kernel, smem);
  if (err != cudaSuccess) return err;
  const int same = ta == tp ? 1 : 0;
  const int vec = 16 / static_cast<int>(sizeof(T));
  const int vec_ok = (D % vec == 0 && reinterpret_cast<uintptr_t>(ta) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(tp) % 16 == 0)
                         ? 1
                         : 0;
  w_kernel<<<dim3(tiles, tiles, B), kThreads, smem, stream>>>(
      static_cast<const T*>(ta), static_cast<const T*>(tp), static_cast<const float*>(coeffs),
      static_cast<const float*>(g), wmat, proj_part, norms, dc_part, N, D, P, Q, cosine, eps,
      symmetric, same, vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gpf_bwd_dx_kernel<T><<<dim3((D + kTile - 1) / kTile, tiles, B), kThreads, 0, stream>>>(
      static_cast<const T*>(ta), static_cast<const T*>(tp), wmat, proj_part, norms, dc_part,
      static_cast<T*>(dta), static_cast<T*>(dtp), static_cast<float*>(dc), N, D, P, Q, cosine,
      tiles);
  return cudaGetLastError();
}

}  // namespace

// tokens_a, tokens_p, dta, dtp [B, N, D] (dtype); coeffs [P+1, Q+1] f32;
// g [B, N, N] f32; dc [B, P+1, Q+1] f32; scratch: f32, at least
// B * (2*N*N + 2*tiles*N + 4*N + 16*tiles*tiles) values with
// tiles = ceil(N / 64).  Requires P, Q <= 3; the Python wrapper checks shapes
// first.  dta and dtp must be two buffers even when tokens_a and tokens_p are
// one.
extern "C" int gpf_bwd(const void* tokens_a, const void* tokens_p, const void* coeffs,
                       const void* g, void* dta, void* dtp, void* dc, void* scratch, int B, int N,
                       int D, int P, int Q, int cosine, float eps, int symmetric, int dtype,
                       void* stream) {
  if (B < 1 || B > 65535 || N < 1 || D < 1 || P < 0 || Q < 0 || P > kMaxDeg || Q > kMaxDeg ||
      dta == dtp || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch_f = static_cast<float*>(scratch);
  cudaError_t err;
  if (dtype == EMCT_DTYPE_F32) {
    err = launch<float>(tokens_a, tokens_p, coeffs, g, dta, dtp, dc, scratch_f, B, N, D, P, Q,
                        cosine, eps, symmetric, s);
  } else if (dtype == EMCT_DTYPE_BF16) {
    err = launch<__nv_bfloat16>(tokens_a, tokens_p, coeffs, g, dta, dtp, dc, scratch_f, B, N, D,
                                P, Q, cosine, eps, symmetric, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
