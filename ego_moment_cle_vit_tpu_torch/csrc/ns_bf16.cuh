// Shared pieces of the bf16 Newton–Schulz kernels 5′ (newton_schulz_bf16.cu)
// and 5″ (newton_schulz_bf16_streamed.cu): the normalization and first step,
// the rescale, and one batched tensor-core GEMM with the iteration's update in
// its epilogue.
//
// The wrapper hands in tr = trace(M) + eps, summed by PyTorch as the plain
// versions sum it (kernels/newton_schulz.py); Mn = bf16(M / tr) and the
// rescale Y / sqrt(tr) are IEEE fp32 divisions and a square root, so a kernel
// and its plain version iterate on the same bits and differ only by the sum
// order inside the products.
//
// Both kernels iterate on Dp x Dp matrices, Dp = D rounded up to a multiple of
// kTile, so that the GEMM needs no edge masks.  The padding is exact: Mn and Y
// are zero outside their leading D x D block, every product of two such
// matrices is too (the extra terms of each sum are exact zeros), and
// 1.5 Y - 0.5 (...) keeps it so.  At the widths the model reaches (1024, 1536)
// Dp = D.
#pragma once

#include <algorithm>

#include "mma_tiles.cuh"  // mma_16816, ldmatrix_x4(_trans), cp_async_commit

namespace ns_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kTile = 128;    // C tile rows and columns, and the padding grain
constexpr int kBK = 32;       // K slice
constexpr int kStages = 3;    // K slices in flight
constexpr int kThreads = 128;  // 4 warps, each a 64 x 64 piece of the tile
constexpr int kLdA = kBK + 8;    // A slice row: 80 bytes, ldmatrix rows on distinct banks
constexpr int kLdB = kTile + 8;  // B slice row: 272 bytes, likewise
constexpr int kStageElems = kTile * kLdA + kBK * kLdB;
constexpr size_t kSmemBytes = kStages * kStageElems * sizeof(bf16);  // 56,832 bytes

inline int padded(int d) { return (d + kTile - 1) / kTile * kTile; }

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Mn = bf16(M / tr), padded to Dp x Dp with zeros, and Y = I or, with
// ``first_step``, the first step's result bf16(1.5 I - 0.5 Mn): from Y = I
// every product of that step is an exact copy of I or Mn, in both groupings.
template <typename T>
__global__ void init_kernel(const T* __restrict__ m, const float* __restrict__ tr,
                            bf16* __restrict__ mn, bf16* __restrict__ y, int D, int Dp,
                            size_t total, bool first_step) {
  const size_t dd = static_cast<size_t>(Dp) * Dp;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = i / dd;
    const int r = static_cast<int>((i % dd) / Dp);
    const int c = static_cast<int>(i % Dp);
    const bool in = r < D && c < D;
    const bf16 v = __float2bfloat16_rn(in ? to_f32(m[(b * D + r) * D + c]) / tr[b] : 0.f);
    const float eye = (in && r == c) ? 1.f : 0.f;
    mn[i] = v;
    y[i] = __float2bfloat16_rn(first_step ? 1.5f * eye - 0.5f * __bfloat162float(v) : eye);
  }
}

// out = Y / sqrt(tr) over the leading D x D block, in fp32, cast to out's type
template <typename T>
__global__ void finish_kernel(const bf16* __restrict__ y, const float* __restrict__ tr,
                              T* __restrict__ out, int D, int Dp, size_t total) {
  const size_t dd = static_cast<size_t>(D) * D;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = i / dd;
    const int r = static_cast<int>((i % dd) / D);
    const int c = static_cast<int>(i % D);
    out[i] = from_f32<T>(__bfloat162float(y[(b * Dp + r) * Dp + c]) / sqrtf(tr[b]));
  }
}

// C[b] = bf16(alpha X[b] + beta A[b] B[b]) for Dp x Dp row-major bf16
// matrices, or C[b] = bf16(A[b] B[b]) when X is null.  The products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums); the epilogue forms the
// update in fp32 (alpha X exact for alpha = 1.5, beta A B exact for beta =
// -0.5, one rounding of their sum) and rounds once to bf16.
//
// A block of 4 warps owns a 128 x 128 tile of C and walks K in slices of 32:
// the A slice [128][32] and the B slice [32][128] land in shared memory by
// cp.async, kStages slices in flight, one barrier per slice.  A fragments come
// from ldmatrix, B fragments from ldmatrix.trans (B's rows are the
// contraction).  Grid: (column tiles, row tiles, batch).
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, const bf16* __restrict__ X,
            bf16* __restrict__ C, int Dp, float alpha, float beta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const size_t off = static_cast<size_t>(blockIdx.z) * Dp * Dp;
  A += off;
  B += off;
  C += off;
  if (X) X += off;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 64;  // the warp's rows within the tile
  const int wn = (warp & 1) * 64;   // and columns
  const int g = lane >> 2;
  const int tg = lane & 3;

  // slice at k0 into stage s: A rows m0.. (4 vectors of 8 a row), B rows k0..
  // (16 vectors a row); neighbouring threads take neighbouring vectors
  auto fetch = [&](int s, int k0) {
    bf16* as = smem + s * kStageElems;
    bf16* bs = as + kTile * kLdA;
#pragma unroll
    for (int i = 0; i < kTile * kBK / 8 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 2, cv = e & 3;
      cp_async16(as + r * kLdA + cv * 8, A + static_cast<size_t>(m0 + r) * Dp + k0 + cv * 8);
    }
#pragma unroll
    for (int i = 0; i < kBK * kTile / 8 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 4, cv = e & 15;
      cp_async16(bs + r * kLdB + cv * 8, B + static_cast<size_t>(k0 + r) * Dp + n0 + cv * 8);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) zero_acc<8>(acc[mt]);

  const int n_k = Dp / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) fetch(s, s * kBK);
    cp_async_commit();
  }
  // per-lane ldmatrix offsets: A rows lane % 16, k half lane / 16; B k rows
  // (lane / 8 % 2) * 8 + lane % 8, column tile lane / 16
  const int a_off = (wm + (lane & 15)) * kLdA + (lane >> 4) * 8;
  const int b_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * kLdB + wn + (lane >> 4) * 8;
  for (int kt = 0; kt < n_k; ++kt) {
    // slice kt has landed, and every warp is done with slice kt - 1, whose
    // stage takes slice kt + kStages - 1
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < n_k) fetch(next % kStages, next * kBK);
    cp_async_commit();

    const bf16* as = smem + (kt % kStages) * kStageElems;
    const bf16* bs = as + kTile * kLdA;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t fa[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(fa[mt], as + a_off + mt * 16 * kLdA + ks * 16);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, bs + b_off + ks * 16 * kLdB + nt * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_16816(acc[mt][nt], fa[mt], fb);
          mma_16816(acc[mt][nt + 1], fa[mt], fb + 2);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + g + half * 8;
        const int c = n0 + wn + nt * 8 + tg * 2;
        const size_t idx = static_cast<size_t>(r) * Dp + c;
        float v0 = acc[mt][nt][2 * half];
        float v1 = acc[mt][nt][2 * half + 1];
        if (X) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(X + idx));
          v0 = fmaf(beta, v0, alpha * x.x);
          v1 = fmaf(beta, v1, alpha * x.y);
        }
        store_pair(C + idx, v0, v1);
      }
    }
  }
}

inline cudaError_t gemm(const bf16* A, const bf16* B, const bf16* X, bf16* C, int Bn, int Dp,
                        float alpha, float beta, cudaStream_t stream) {
  const dim3 grid(Dp / kTile, Dp / kTile, Bn);
  gemm_kernel<<<grid, kThreads, kSmemBytes, stream>>>(A, B, X, C, Dp, alpha, beta);
  return cudaGetLastError();
}

inline unsigned elementwise_blocks(size_t total) {
  return static_cast<unsigned>(std::min<size_t>((total + 255) / 256, 132 * 16));
}

// The buffers of one call, carved from the wrapper's scratch: Mn, Y and its
// ping-pong twin, and two product buffers, each [B, Dp, Dp] bf16.
struct Buffers {
  bf16* mn;
  bf16* y[2];
  bf16* t1;
  bf16* t2;
};

// M [B, D, D] -> out = M^-1/2 [B, D, D], k steps: Mn and the first step, then
// each kernel's own ``steps(buf, Dp, &cur)``, which runs the remaining k - 1
// steps and leaves in ``cur`` the index of the Y buffer that holds the result,
// then the rescale.
template <typename T, typename Steps>
cudaError_t run(const T* m, T* out, void* work, const float* tr, int Bn, int D, int iters,
                cudaStream_t stream, Steps steps) {
  cudaError_t err = emct_allow_smem(gemm_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int Dp = padded(D);
  const size_t n = static_cast<size_t>(Bn) * Dp * Dp;
  bf16* w = static_cast<bf16*>(work);
  const Buffers buf = {w, {w + n, w + 2 * n}, w + 3 * n, w + 4 * n};
  init_kernel<T><<<elementwise_blocks(n), 256, 0, stream>>>(m, tr, buf.mn, buf.y[0], D, Dp, n,
                                                            iters > 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int cur = 0;
  err = steps(buf, Dp, &cur);
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(Bn) * D * D;
  finish_kernel<T><<<elementwise_blocks(total), 256, 0, stream>>>(buf.y[cur], tr, out, D, Dp,
                                                                  total);
  return cudaGetLastError();
}

// The C entry of both kernels: m, out [B, D, D] (dtype); tr: B floats,
// trace(M) + eps; work: 5 * B * Dp * Dp bf16 scratch, Dp = D rounded up to a
// multiple of 128.  The Python wrapper checks shapes and contiguity first.
template <typename Steps>
int entry(const void* m, void* out, void* work, const void* tr, int B, int D, int iters,
          int dtype, void* stream, Steps steps) {
  if (B < 1 || D < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(tr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == EMCT_DTYPE_BF16) {
    err = run(static_cast<const bf16*>(m), static_cast<bf16*>(out), work, t, B, D, iters, s,
              steps);
  } else if (dtype == EMCT_DTYPE_F32) {
    err = run(static_cast<const float*>(m), static_cast<float*>(out), work, t, B, D, iters, s,
              steps);
  }
  return static_cast<int>(err);
}

}  // namespace ns_bf16
