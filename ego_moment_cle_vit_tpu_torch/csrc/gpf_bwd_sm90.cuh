// The bf16 dX of the GPF backward (kernel 2b, gpf_bwd.cu) on Hopper (sm_90a).
// The fp32 dX is gpf_bwd_fp32.cuh.
//
// Computes, per batch element b and token set (anchor, positive), from the w
// kernel's factor split in two bf16 terms, W_hi = bf16(W) and W_lo = bf16(W -
// W_hi) ([B, 2, N, pitch] each, pitch = N rounded up to a multiple of 8), and
// the bf16 tokens X [N, D]:
//   dX = W_hi X + W_lo X                        (fp32 sums in the accumulator)
//   dx_i -= gate_i proj_i / m_i^2 x_i           (cosine only, proj_i summed over
//                                                the w kernel's column tiles in order)
// then rounds once to bf16.  Every product of a bf16 W term and a bf16 token
// is exact in fp32, so the two terms carry W to about 2^-16 of its size where
// one bf16 W would carry it to 2^-8 (three digits of the gradient).
//
// What bounds it on an H100: bf16 tensor-core operations.  At [64, 1024,
// 1024] x2 the two terms are 2 x 2 * 2 N^2 D = 5.5e11 flops a call, 0.56 ms
// at 989 TFLOP/s; the split W is 0.54 GB read once (0.16 ms).  The design
// feeds the tensor cores through wgmma (gemm_sm90.cuh's block: a [128 rows]
// [256 features] tile, two consumer warpgroups on m64n256k16, a producer warp
// with a three-stage ring of the W_hi, W_lo and token tiles of 64 tokens),
// so W is read D / 256 times, not D / 64 as by the CUDA-core loop it
// replaces.  Rows and tokens past N arrive as zeros (the W and token tensor
// maps end at N), so they add nothing.  Tokens whose rows break TMA's 16-byte
// rule (D % 8 != 0, or a start off a 16-byte boundary) are written into the
// same swizzled layout by the producer warp's 32 lanes with ordinary loads.
// Grid: (feature tiles, row tiles, 2 B), feature tiles fastest, so the
// blocks that read one W strip run together and find it in L2.  The block
// that owns (b, the first row and feature tiles) of the anchor set also sums
// dc.
#pragma once

#include "gemm_sm90.cuh"
#include "gpf_tiles.cuh"

namespace gpf_sm90 {

using namespace gemm_sm90;

// gpf_tiles.cuh's kThreads (the w kernel's block) lies in the global
// namespace; this block is gemm_sm90.cuh's
constexpr int kThreads = gemm_sm90::kThreads;
constexpr int kStages = 3;  // kernels/gpf.py:bwd_geometry
constexpr size_t kSmemBytes = Layout<2>::bytes(kStages);

struct Params {
  const bf16* ta;  // [B, N, D] tokens, anchor
  const bf16* tp;  // and positive
  const float* proj_part;
  const float* norms;
  const float* dc_part;
  bf16* dta;
  bf16* dtp;
  float* dc;
  int N, D, P, Q, cosine, tiles;  // tiles: the w kernel's 64-token tiles
  int x_tma;                      // the tokens arrive by TMA (else by the producer's lanes)
};

__global__ void __launch_bounds__(kThreads, 1)
dx_kernel(const __grid_constant__ CUtensorMap tm_whi, const __grid_constant__ CUtensorMap tm_wlo,
          const __grid_constant__ CUtensorMap tm_xa, const __grid_constant__ CUtensorMap tm_xp,
          const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<2> ring(smem_raw, kStages);
  ring.init();
  const int z = blockIdx.z;  // 2 b + set
  const int b = z >> 1;
  const int set = z & 1;
  const int i0 = blockIdx.y * kRows;
  const int d0 = blockIdx.x * kCols;
  const int n_k = (p.N + kK - 1) / kK;
  const bf16* x = (set ? p.tp : p.ta) + static_cast<size_t>(b) * p.N * p.D;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const CUtensorMap* tm_x = set ? &tm_xp : &tm_xa;
    // boxes of the token tile that start inside D (the rest feed only
    // columns that are never stored)
    const int boxes = min(4, (p.D - d0 + 63) / 64);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      bar_wait(ring.empty() + s, ((kt / kStages) & 1) ^ 1);
      if (!p.x_tma) {
        for (int j = 0; j < 4; ++j) {
          stage_box(ring.b(s) + j * 64 * kK, x, p.N, p.D, kt * kK, d0 + 64 * j, lane);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        __syncwarp();
      }
      if (lane == 0) {
        bar_arrive_tx(ring.full() + s, 2 * kABytes + (p.x_tma ? boxes * kBoxBytes : 0));
        tma_load(ring.a(s, 0), &tm_whi, ring.full() + s, kt * kK, i0, z);
        tma_load(ring.a(s, 1), &tm_wlo, ring.full() + s, kt * kK, i0, z);
        if (p.x_tma) {
          for (int j = 0; j < boxes; ++j) {
            tma_load(ring.b(s) + j * 64 * kK, tm_x, ring.full() + s, d0 + 64 * j, kt * kK, b);
          }
        }
      }
    }
    return;
  }

  if (set == 0 && blockIdx.x == 0 && blockIdx.y == 0) {
    sum_dc(p.dc_part, p.dc, b, p.P, p.Q, p.tiles);
  }
  const int wg = threadIdx.x / 128;
  float acc[kAcc];
  consume<2>(acc, ring, n_k, wg);

  const int lane = threadIdx.x & 31;
  const int r0 = i0 + wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int c0 = d0 + (lane & 3) * 2;
  bf16* dx = (set ? p.dtp : p.dta) + static_cast<size_t>(b) * p.N * p.D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + half * 8;
    if (i >= p.N) continue;
    const float fold =
        p.cosine ? cosine_fold(p.proj_part, p.norms, b, set, i, p.N, p.tiles) : 0.f;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int c = c0 + j * 8;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e < p.D) {
          const size_t off = static_cast<size_t>(i) * p.D + c + e;
          float v = acc[4 * j + 2 * half + e];
          if (p.cosine) v -= fold * __bfloat162float(x[off]);
          dx[off] = __float2bfloat16(v);
        }
      }
    }
  }
}

// The dX launch after the w kernel: whi / wlo the split factor [B, 2, N,
// pitch], tm_xa / tm_xp the token maps (unread unless p.x_tma); the geometry (pitch, stages, shared memory) comes from the Python
// wrapper and must be the one this code expects.
inline cudaError_t launch(const Params& p, const CUtensorMap& tm_xa, const CUtensorMap& tm_xp,
                          const bf16* whi, const bf16* wlo, int B, int pitch, int stages,
                          size_t smem, cudaStream_t stream) {
  if (pitch != (p.N + 7) / 8 * 8 || stages != kStages || smem != kSmemBytes || smem > kMaxSmem ||
      2 * B > 65535) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap tm_whi, tm_wlo;
  if (!encode_tiles(&tm_whi, whi, p.N, p.N, 2 * B, pitch, kRows) ||
      !encode_tiles(&tm_wlo, wlo, p.N, p.N, 2 * B, pitch, kRows)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = emct_allow_smem(dx_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.D + kCols - 1) / kCols, (p.N + kRows - 1) / kRows, 2 * B);
  dx_kernel<<<grid, kThreads, smem, stream>>>(tm_whi, tm_wlo, tm_xa, tm_xp, p);
  return cudaGetLastError();
}

}  // namespace gpf_sm90
