// Coupled Newton–Schulz iteration for M^-1/2 (iSQRT-COV), fp32 throughout.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/newton_schulz.py, _ns_kernel
//   (called by newton_schulz_isqrt_pallas through _forward when _fp32_fits:
//   the moment head's dense route, N >= D, e.g. ViT-Base at a 448 input:
//   M = Zc^T W Zc of shape [64, 768, 768]).
//
// Computes, per matrix b of M[B, D, D] (bf16 or fp32 in, fp32 inside):
//   tr = trace(M) + eps,  Z = M / tr,  Y = I
//   k times:  T = Z Y;  Y <- 1.5 Y - 0.5 Y T;  Z <- 1.5 Z - 0.5 T^T Z
//   out = Y / sqrt(tr)   (in M's type)
// the symmetric three-product form of the TPU kernel, in its order.  Two
// products are skipped, with the same bits: the first step's, whose Y is the
// identity (T = Z and Y T = Z exactly), and the last step's Z update, which
// nothing reads.
//
// What bounds it on an H100: fp32 operations.  (3k - 3) products of D^3
// multiply-adds per matrix against one read of M and one write of the result:
// at [64, 768, 768], k = 5, 7.0e11 flops over 67 TFLOP/s (CUDA cores; no
// TF32, since the port's fp32 reference is true fp32) is ~10.4 ms; the bytes
// take ~0.05 ms.
//
// Design.  The TPU kernel keeps Y, Z and T resident in VMEM for the whole
// iteration.  A 768^2 fp32 matrix is 2.36 MB, ten times the 227 KB of shared
// memory a block can use, so nothing here stays on chip: Y, Z and T live in a
// device scratch and every product is one launch of a batched tiled fp32 GEMM
// with the update fused into its epilogue (C = alpha X + beta op(A) B).  A
// tile of Y <- 1.5 Y - 0.5 Y T reads whole rows of Y that other blocks are
// still reading, so Y and Z ping-pong between two buffers each.  T^T is read
// by addressing (A's tile is loaded along its columns), never materialized.
// The GEMM: one block of 256 threads owns a 128 x 128 tile of C and walks K in
// slices of 16; the A and B slices go to shared memory by cp.async (A lands
// transposed, so both are read along the tile's rows), two buffers, the next
// slice in flight under the products of the current one, one barrier per
// slice; each thread sums an 8 x 8 piece with fmaf from four 16-byte shared
// loads per k.  A small kernel takes each trace, a second forms Z and the
// first step's Y, a last one scales and casts; 3k launches in all, which the
// wrapper counts as one.

#include <algorithm>

#include "mma_tiles.cuh"  // cp_async_commit, cp_async_wait_all

namespace {

constexpr int kBM = 128;  // C tile rows
constexpr int kBN = 128;  // C tile columns
constexpr int kBK = 16;   // K slice
constexpr int kPad = 4;   // keeps 16-byte alignment and spreads the stores
constexpr int kLd = kBM + kPad;
constexpr int kThreads = 256;
constexpr int kLoads = kBM * kBK / kThreads;  // elements of each operand a thread fetches

// tr[b] = trace(M[b]) + eps
template <typename T>
__global__ void ns_trace(const T* __restrict__ m, float* __restrict__ tr, int D, float eps) {
  const T* mb = m + static_cast<size_t>(blockIdx.x) * D * D;
  float acc = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    acc += to_f32(mb[static_cast<size_t>(i) * (D + 1)]);
  }
  __shared__ float part[32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < (blockDim.x >> 5) ? part[threadIdx.x] : 0.f;
    acc = warp_sum(acc);
    if (threadIdx.x == 0) tr[blockIdx.x] = acc + eps;
  }
}

// Z = M / tr, and Y = I or, with ``first_step``, the first step's
// Y1 = 1.5 I - 0.5 Y0 T = 1.5 I - 0.5 Z (from Y0 = I, T = Z Y0 = Z exactly)
template <typename T>
__global__ void ns_init(const T* __restrict__ m, const float* __restrict__ tr,
                        float* __restrict__ z, float* __restrict__ y, int D, size_t total,
                        bool first_step) {
  const size_t dd = static_cast<size_t>(D) * D;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t e = i % dd;
    const float zi = to_f32(m[i]) / tr[i / dd];
    const float eye = (e / D == e % D) ? 1.f : 0.f;
    z[i] = zi;
    y[i] = first_step ? 1.5f * eye - 0.5f * zi : eye;
  }
}

// out = Y / sqrt(tr), cast to the output type
template <typename T>
__global__ void ns_finish(const float* __restrict__ y, const float* __restrict__ tr,
                          T* __restrict__ out, int D, size_t total) {
  const size_t dd = static_cast<size_t>(D) * D;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    out[i] = from_f32<T>(y[i] / sqrtf(tr[i / dd]));
  }
}

// One element of a slice, device memory -> shared memory without passing
// through registers; out of range it lands as zero (src-size 0 reads nothing
// from the valid address it is given).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// C[b] = alpha X[b] + beta op(A[b]) B[b] for D x D row-major fp32 matrices;
// op(A) = A^T when TRANS_A; X null means C = op(A) B.  Grid: (column tiles,
// row tiles, batch).
template <bool TRANS_A>
__global__ void __launch_bounds__(kThreads, 2)
ns_gemm(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ X,
        float* __restrict__ C, int D, float alpha, float beta) {
  __shared__ __align__(16) float As[2][kBK][kLd];  // As[k][m] = op(A)[m0 + m][k0 + k]
  __shared__ __align__(16) float Bs[2][kBK][kLd];  // Bs[k][n] = B[k0 + k][n0 + n]

  const size_t off = static_cast<size_t>(blockIdx.z) * D * D;
  A += off;
  B += off;
  C += off;
  if (X) X += off;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid >> 4;  // rows ty*4 .. +3 and 64 + ty*4 .. +3

  // a thread's share of the slice at k0: element e = tid + i * kThreads.
  // op(A) with TRANS_A and B are read along their rows (consecutive threads,
  // consecutive addresses); op(A) = A is read along its rows too, 16 k at a
  // time, and lands transposed.
  auto fetch = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      if constexpr (TRANS_A) {
        const int kk = e / kBM, mm = e % kBM;
        const int r = k0 + kk, c = m0 + mm;
        const bool in = r < D && c < D;
        cp_async4(&As[buf][kk][mm], A + (in ? static_cast<size_t>(r) * D + c : 0), in);
      } else {
        const int mm = e / kBK, kk = e % kBK;
        const int r = m0 + mm, c = k0 + kk;
        const bool in = r < D && c < D;
        cp_async4(&As[buf][kk][mm], A + (in ? static_cast<size_t>(r) * D + c : 0), in);
      }
      const int kk = e / kBN, nn = e % kBN;
      const int r = k0 + kk, c = n0 + nn;
      const bool in = r < D && c < D;
      cp_async4(&Bs[buf][kk][nn], B + (in ? static_cast<size_t>(r) * D + c : 0), in);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int n_k = (D + kBK - 1) / kBK;
  fetch(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    // this slice has landed, and every thread is done with the other buffer's
    // products: the next slice is fetched into it under this slice's products
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_k) fetch(buf ^ 1, (kt + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= D) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= D) continue;
      const size_t idx = static_cast<size_t>(r) * D + c;
      C[idx] = X ? alpha * X[idx] + beta * acc[i][j] : acc[i][j];
    }
  }
}

template <bool TRANS_A>
cudaError_t gemm(const float* A, const float* B, const float* X, float* C, int Bn, int D,
                 float alpha, float beta, cudaStream_t stream) {
  const dim3 grid((D + kBN - 1) / kBN, (D + kBM - 1) / kBM, Bn);
  ns_gemm<TRANS_A><<<grid, kThreads, 0, stream>>>(A, B, X, C, D, alpha, beta);
  return cudaGetLastError();
}

unsigned elementwise_blocks(size_t total) {
  return static_cast<unsigned>(std::min<size_t>((total + 255) / 256, 132 * 16));
}

template <typename T>
cudaError_t run(const void* m_v, void* out_v, float* work, int Bn, int D, int iters, float eps,
                cudaStream_t stream) {
  const T* m = static_cast<const T*>(m_v);
  T* out = static_cast<T*>(out_v);
  const size_t dd = static_cast<size_t>(D) * D;
  const size_t total = dd * Bn;
  float* y[2] = {work, work + total};
  float* z[2] = {work + 2 * total, work + 3 * total};
  float* t = work + 4 * total;
  float* tr = work + 5 * total;

  ns_trace<T><<<Bn, 256, 0, stream>>>(m, tr, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The first step from Y0 = I needs one product: T = Z Y0 = Z and Y0 T = Z
  // exactly, so Y1 = 1.5 I - 0.5 Z comes with Z, and Z1 = 1.5 Z - 0.5 Z^T Z.
  int cur = iters > 0 ? 1 : 0;
  ns_init<T><<<elementwise_blocks(total), 256, 0, stream>>>(m, tr, z[0], y[cur], D, total,
                                                            iters > 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (iters > 1) {
    err = gemm<true>(z[0], z[0], z[0], z[1], Bn, D, 1.5f, -0.5f, stream);
    if (err != cudaSuccess) return err;
  }
  for (int it = 1; it < iters; ++it) {
    // T = Z Y
    err = gemm<false>(z[cur], y[cur], nullptr, t, Bn, D, 0.f, 1.f, stream);
    if (err != cudaSuccess) return err;
    // Y <- 1.5 Y - 0.5 Y T
    err = gemm<false>(y[cur], t, y[cur], y[cur ^ 1], Bn, D, 1.5f, -0.5f, stream);
    if (err != cudaSuccess) return err;
    // Z <- 1.5 Z - 0.5 T^T Z, read by the next step only
    if (it + 1 < iters) {
      err = gemm<true>(t, z[cur], z[cur], z[cur ^ 1], Bn, D, 1.5f, -0.5f, stream);
      if (err != cudaSuccess) return err;
    }
    cur ^= 1;
  }
  ns_finish<T><<<elementwise_blocks(total), 256, 0, stream>>>(y[cur], tr, out, D, total);
  return cudaGetLastError();
}

}  // namespace

// m, out [B, D, D] (dtype); work: 5 * B * D * D + B f32 scratch (Y and Z two
// buffers each, T, the traces).  The Python wrapper checks shapes and
// contiguity first.
extern "C" int newton_schulz_isqrt(const void* m, void* out, void* work, int B, int D, int iters,
                                   float eps, int dtype, void* stream) {
  if (B < 1 || D < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == EMCT_DTYPE_BF16) {
    err = run<__nv_bfloat16>(m, out, w, B, D, iters, eps, s);
  } else if (dtype == EMCT_DTYPE_F32) {
    err = run<float>(m, out, w, B, D, iters, eps, s);
  }
  return static_cast<int>(err);
}
