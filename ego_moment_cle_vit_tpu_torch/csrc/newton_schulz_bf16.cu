// Newton–Schulz iteration for M^-1/2 in bf16 storage, single-matrix form
// (kernel 5′).
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/newton_schulz.py,
//   _ns_kernel_bf16 (called by newton_schulz_isqrt_pallas through
//   _forward_bf16 when _bf16_resident_fits: 826 <= D <= 1059; the moment
//   head's dense route at D = 1024, e.g. ViT-Large/16 at a 512 input, where
//   N = D = 1024 and M = Zc^T W Zc is [64, 1024, 1024]).
//
// Computes, per matrix b of M[B, D, D] (bf16 or fp32 in), given tr = trace(M)
// + eps from the wrapper (fp32): Mn = bf16(M / tr); from Y = I
//   k times:  T1 = bf16(Y Y);  T2 = bf16(Mn T1);  Y <- bf16(1.5 Y - 0.5 Y T2)
// with every product summed in fp32, the TPU kernel's function in its order;
// then out = Y / sqrt(tr) in fp32, cast to M's type (_forward_bf16's frame
// around the TPU kernel, here in the first and the last launch).
// For a symmetric M every iterate is a polynomial in M, so the coupled
// iteration's Z equals M Y and one matrix is carried.  The first step's three
// products are exact copies (Y = I gives T1 = I, T2 = Mn, Y T2 = Mn), so they
// are skipped with the same bits: the step's result bf16(1.5 I - 0.5 Mn) comes
// with Mn, and 3(k - 1) products remain.
//
// What bounds it on an H100: bf16 tensor-core operations.  3(k - 1) products
// of D^3 multiply-adds per matrix against one read of M and one write of the
// result: at [64, 1024, 1024], k = 5, 1.65e12 flops over 989 TFLOP/s is
// 1.67 ms; the bytes take 0.08 ms.
//
// Design.  The TPU kernel keeps M, Y, T1 and T2 resident in VMEM (8 MB at
// D = 1024) and updates Y in place by row halves, which is safe there because
// one program runs the halves one after the other.  A 1024^2 bf16 matrix is
// 2 MB, nine times a block's 227 KB of shared memory, so here the matrices
// live in a device scratch and every product is one launch of the batched
// Hopper GEMM that 5″ runs too (ns_sm90.cuh on gemm_sm90.cuh: [128][256]
// tiles, two consumer warpgroups on wgmma m64n256k16, a producer warp feeding
// a four-stage TMA ring), the update in its epilogue.  Its k16 steps sum in
// k order as the mma.sync GEMM before it did.  Blocks run in no order, and a
// tile of Y <- 1.5 Y - 0.5 Y T2 reads whole rows of Y that other blocks are
// still reading, so Y ping-pongs between two buffers; the values do not
// depend on it.  The tile needs Dp, the width the products run at, to be a
// multiple of 256: D is padded to it with zeros, which is exact
// (ns_bf16.cuh); D = 1024 pays nothing, D = 1059 runs at 1280.  A small
// kernel forms Mn (padded) and the first step, one rescales; 3k - 1 launches
// in all, which the wrapper counts as one.

#include "ns_bf16.cuh"
#include "ns_sm90.cuh"

namespace {

using ns_bf16::bf16;

// steps 2..k; ``cur`` indexes the Y buffer that holds Y
cudaError_t steps(const ns_bf16::Buffers& buf, int Bn, int Dp, int iters, cudaStream_t stream,
                  int* cur) {
  for (int it = 1; it < iters; ++it) {
    bf16* y = buf.y[*cur];
    // T1 = Y Y
    cudaError_t err = ns_sm90::gemm(y, y, nullptr, buf.t1, Bn, Dp, 0.f, 1.f, stream);
    if (err != cudaSuccess) return err;
    // T2 = Mn T1
    err = ns_sm90::gemm(buf.mn, buf.t1, nullptr, buf.t2, Bn, Dp, 0.f, 1.f, stream);
    if (err != cudaSuccess) return err;
    // Y <- 1.5 Y - 0.5 Y T2, into the other Y buffer
    err = ns_sm90::gemm(y, buf.t2, y, buf.y[*cur ^ 1], Bn, Dp, 1.5f, -0.5f, stream);
    if (err != cudaSuccess) return err;
    *cur ^= 1;
  }
  return cudaSuccess;
}

}  // namespace

// m, out [B, D, D] (dtype); tr: B floats, trace(M) + eps; work: 5 * B * Dp *
// Dp bf16 scratch, Dp = D rounded up to a multiple of 256 (Mn, Y twice, two
// products; kernels/newton_schulz.py:bf16_gemm_geometry).  The Python
// wrapper checks shapes and contiguity first.
extern "C" int newton_schulz_isqrt_bf16(const void* m, void* out, void* work, const void* tr,
                                        int B, int D, int iters, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return ns_bf16::entry(m, out, work, tr, B, D, iters, dtype, stream,
                        [&](const ns_bf16::Buffers& buf, int Dp, int* cur) {
                          return steps(buf, B, Dp, iters, s, cur);
                        });
}
