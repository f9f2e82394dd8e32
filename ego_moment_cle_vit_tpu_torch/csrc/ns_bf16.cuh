// Shared pieces of the bf16 Newton–Schulz kernels 5′ (newton_schulz_bf16.cu)
// and 5″ (newton_schulz_bf16_streamed.cu): the normalization and first step,
// the rescale, and the frame that runs a kernel's steps between them.  Every
// product of both kernels is one launch of ns_sm90.cuh's Hopper GEMM, with
// the iteration's update in its epilogue.
//
// The wrapper hands in tr = trace(M) + eps, summed by PyTorch as the plain
// versions sum it (kernels/newton_schulz.py); Mn = bf16(M / tr) and the
// rescale Y / sqrt(tr) are IEEE fp32 divisions and a square root, so a kernel
// and its plain version iterate on the same bits and differ only by the sum
// order inside the products.
//
// Both kernels iterate on Dp x Dp matrices, Dp = D rounded up to a multiple of
// kTile (the GEMM's 256-column tile), so that the GEMM needs no edge masks.
// The padding is exact: Mn and Y are zero outside their leading D x D block,
// every product of two such matrices is too (the extra terms of each sum are
// exact zeros), and 1.5 Y - 0.5 (...) keeps it so.  At the widths the model
// reaches (1024, 1536) Dp = D.
#pragma once

#include "ns_sm90.cuh"

namespace ns_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kTile = ns_sm90::kCols;  // the padding grain

inline int padded(int d) { return (d + kTile - 1) / kTile * kTile; }

// The elementwise kernels take a row of one matrix a block: grid (column
// chunks, rows, batch), kEw threads a block, two neighbouring columns a
// thread, so no thread divides to find its element.
constexpr int kEw = 128;

// Mn = bf16(M / tr), padded to Dp x Dp with zeros, and Y = I or, with
// ``first_step``, the first step's result bf16(1.5 I - 0.5 Mn): from Y = I
// every product of that step is an exact copy of I or Mn, in both groupings.
// Grid (Dp / (2 kEw), Dp, B).
template <typename T>
__global__ void __launch_bounds__(kEw)
init_kernel(const T* __restrict__ m, const float* __restrict__ tr, bf16* __restrict__ mn,
            bf16* __restrict__ y, int D, int Dp, bool first_step) {
  const int b = blockIdx.z;
  const int r = blockIdx.y;
  const int c = (blockIdx.x * kEw + threadIdx.x) * 2;
  const float t = tr[b];
  bf16 v[2], e[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const bool in = r < D && c + u < D;
    v[u] = __float2bfloat16_rn(
        in ? to_f32(m[(static_cast<size_t>(b) * D + r) * D + c + u]) / t : 0.f);
    const float eye = (in && r == c + u) ? 1.f : 0.f;
    e[u] = __float2bfloat16_rn(first_step ? 1.5f * eye - 0.5f * __bfloat162float(v[u]) : eye);
  }
  const size_t at = (static_cast<size_t>(b) * Dp + r) * Dp + c;
  *reinterpret_cast<__nv_bfloat162*>(mn + at) = __halves2bfloat162(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(y + at) = __halves2bfloat162(e[0], e[1]);
}

// out = Y / sqrt(tr) over the leading D x D block, in fp32, cast to out's
// type.  Grid (ceil(D / (2 kEw)), D, B).
template <typename T>
__global__ void __launch_bounds__(kEw)
finish_kernel(const bf16* __restrict__ y, const float* __restrict__ tr, T* __restrict__ out,
              int D, int Dp) {
  const int b = blockIdx.z;
  const int r = blockIdx.y;
  const int c = (blockIdx.x * kEw + threadIdx.x) * 2;
  const float s = sqrtf(tr[b]);
  const bf16* src = y + (static_cast<size_t>(b) * Dp + r) * Dp;
  T* dst = out + (static_cast<size_t>(b) * D + r) * D;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (c + u < D) dst[c + u] = from_f32<T>(__bfloat162float(src[c + u]) / s);
  }
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
  cudaError_t err = ns_sm90::prepare();
  if (err != cudaSuccess) return err;
  const int Dp = padded(D);
  const size_t n = static_cast<size_t>(Bn) * Dp * Dp;
  bf16* w = static_cast<bf16*>(work);
  const Buffers buf = {w, {w + n, w + 2 * n}, w + 3 * n, w + 4 * n};
  const int chunk = 2 * kEw;  // columns a block
  init_kernel<T><<<dim3(Dp / chunk, Dp, Bn), kEw, 0, stream>>>(m, tr, buf.mn, buf.y[0], D, Dp,
                                                               iters > 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int cur = 0;
  err = steps(buf, Dp, &cur);
  if (err != cudaSuccess) return err;
  finish_kernel<T><<<dim3((D + chunk - 1) / chunk, D, Bn), kEw, 0, stream>>>(buf.y[cur], tr,
                                                                              out, D, Dp);
  return cudaGetLastError();
}

// The C entry of both kernels: m, out [B, D, D] (dtype); tr: B floats,
// trace(M) + eps; work: 5 * B * Dp * Dp bf16 scratch, Dp = D rounded up to a
// multiple of kTile.  The Python wrapper checks shapes and contiguity first.
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
