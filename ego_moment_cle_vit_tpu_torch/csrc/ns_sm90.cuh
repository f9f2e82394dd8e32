// The products of both bf16 Newton–Schulz iterations on Hopper, kernel 5′
// (newton_schulz_bf16.cu) and kernel 5″ (newton_schulz_bf16_streamed.cu):
// C[b] = bf16(alpha X[b] + beta A[b] B[b]), or C[b] = bf16(A[b] B[b]) when X
// is null, for Dp x Dp row-major bf16 matrices, Dp a multiple of 256.
//
// What bounds it on an H100: bf16 tensor-core operations.  One product of
// [64, 1536, 1536] is 4.6e11 flops, 0.47 ms at 989 TFLOP/s, against 0.9 GB
// of operands and result (0.27 ms at 3.35 TB/s even if no tile were read
// twice); one of [64, 1024, 1024] 1.4e11 flops, 0.14 ms, against 0.4 GB.
// The design feeds the tensor cores through wgmma, the only route to their
// full rate: gemm_sm90.cuh's block, two consumer warpgroups on
// m64n256k16 and a producer warp keeping four stages of TMA copies in flight,
// computes a [128][256] tile of A B; its epilogue forms the update in fp32
// (alpha X exact for alpha = 1.5, beta A B exact for beta = -0.5, one
// rounding of their sum, the fmaf of the mma.sync kernel 5′ ran before) and
// rounds once to bf16.  Grid: (column tiles, row tiles, batch), column tiles
// fastest, so the blocks that share an A row strip run together and find it
// in L2.
#pragma once

#include "gemm_sm90.cuh"

namespace ns_sm90 {

using namespace gemm_sm90;

constexpr int kStages = 4;  // kernels/newton_schulz.py:streamed_gemm_geometry
constexpr size_t kSmemBytes = Layout<1>::bytes(kStages);

__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
            const bf16* __restrict__ X, bf16* __restrict__ C, int Dp, float alpha, float beta) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<1> ring(smem_raw, kStages);
  ring.init();
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x * kCols;
  const int n_k = Dp / kK;

  if (threadIdx.x >= kConsumers) {  // the producer warp: its first lane issues every copy
    if (threadIdx.x == kConsumers) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        bar_wait(ring.empty() + s, ((kt / kStages) & 1) ^ 1);
        bar_arrive_tx(ring.full() + s, kABytes + kBBytes);
        tma_load(ring.a(s, 0), &tm_a, ring.full() + s, kt * kK, m0, b);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tma_load(ring.b(s) + j * 64 * kK, &tm_b, ring.full() + s, n0 + 64 * j, kt * kK, b);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float acc[kAcc];
  consume<1>(acc, ring, n_k, wg);

  const int lane = threadIdx.x & 31;
  const int r0 = m0 + wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int c0 = n0 + (lane & 3) * 2;
  const size_t off = static_cast<size_t>(b) * Dp * Dp;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t idx = off + static_cast<size_t>(r0 + half * 8) * Dp + c0 + j * 8;
      float v0 = acc[4 * j + 2 * half];
      float v1 = acc[4 * j + 2 * half + 1];
      if (X) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(X + idx));
        v0 = fmaf(beta, v0, alpha * x.x);
        v1 = fmaf(beta, v1, alpha * x.y);
      }
      store_pair(C + idx, v0, v1);
    }
  }
}

// One launch over Bn matrices; Dp must be a multiple of kCols (and so of
// kRows and kK): anything else is refused, never run another way.
inline cudaError_t gemm(const bf16* A, const bf16* B, const bf16* X, bf16* C, int Bn, int Dp,
                        float alpha, float beta, cudaStream_t stream) {
  if (Dp < kCols || Dp % kCols != 0) return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  if (!encode_tiles(&tm_a, A, Dp, Dp, Bn, Dp, kRows) ||
      !encode_tiles(&tm_b, B, Dp, Dp, Bn, Dp, kK)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(Dp / kCols, Dp / kRows, Bn);
  gemm_sm90_kernel<<<grid, kThreads, kSmemBytes, stream>>>(tm_a, tm_b, X, C, Dp, alpha, beta);
  return cudaGetLastError();
}

// The kernel's shared memory may pass 48 KB only once allowed.
inline cudaError_t prepare() { return emct_allow_smem(gemm_sm90_kernel, kSmemBytes); }

}  // namespace ns_sm90
