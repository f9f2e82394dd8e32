// Newton–Schulz iteration for M^-1/2 in bf16 storage, regrouped for the
// widest matrices (kernel 5″).
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/newton_schulz.py,
//   _ns_kernel_bf16_streamed (called by newton_schulz_isqrt_pallas through
//   _forward_bf16 when _bf16_streamed_fits and no earlier variant fits:
//   D = 1536, the moment head's dense route on Swin-Large, whose last stage
//   holds 40 x 40 = 1600 >= 1536 tokens at a 1280 input; M = Zc^T W Zc is
//   [64, 1536, 1536]).
//
// Computes, per matrix b of M[B, D, D] (bf16 or fp32 in), given tr = trace(M)
// + eps from the wrapper (fp32): Mn = bf16(M / tr); from Y = I
//   k times:  P = bf16(Y Mn);  P <- bf16(P Y);  Y <- bf16(1.5 Y - 0.5 P Y)
// with every product summed in fp32, the TPU kernel's function in its order;
// then out = Y / sqrt(tr) in fp32, cast to M's type (_forward_bf16's frame
// around the TPU kernel, here in the first and the last launch).
// It has the fixed point of kernel 5′ (all iterates commute, being
// polynomials in M: Y Mn Y Y = Y Y Mn Y), but rounds at other points, so its
// results differ from 5′'s in the last bf16 bits.  The first step's products
// are exact copies (Y = I gives P = Mn, P Y = Mn, P Y = Mn), so they are
// skipped with the same bits, as in 5′: 3(k - 1) products remain.
//
// What bounds it on an H100: bf16 tensor-core operations.  At [64, 1536,
// 1536], k = 5: 12 products of 1536^3 multiply-adds per matrix, 5.57e12 flops
// over 989 TFLOP/s, 5.63 ms; the bytes (M read, the result written) 0.18 ms.
//
// Design.  The TPU kernel exists because 5′'s four resident matrices (18.9 MB
// at D = 1536) overflow VMEM: it keeps only Y and P resident, streams M from
// HBM in D/4 column tiles for P = Y M, updates P in place by row quarters and
// Y in place by column tiles, one tile after another.  None of that applies
// here: nothing is resident (a 1536^2 bf16 matrix is 4.7 MB, twenty times a
// block's shared memory), and in-place updates would race, since blocks run
// in no order and a tile of P Y reads whole rows of P and columns of Y that
// other blocks are still reading or writing.  So each product is one launch
// of a batched Hopper GEMM (ns_sm90.cuh: [128][256] tiles, two consumer
// warpgroups on wgmma m64n256k16, a producer warp feeding a four-stage TMA
// ring), P goes to its own buffer, Y ping-pongs between two, and the update
// 1.5 Y - 0.5 P Y is the third product's epilogue.  The values do not depend
// on the buffering.  The tile needs D to be a multiple of 256 (the variant
// runs at D % 512 == 0 only, kernels/newton_schulz.py:bf16_streamed_fits);
// the entry refuses any other D.  Mn, the first step, the rescale and the
// GEMM are shared with 5′ (ns_bf16.cuh, ns_sm90.cuh).  3k - 1 launches,
// which the wrapper counts as one.

#include "ns_bf16.cuh"
#include "ns_sm90.cuh"

namespace {

using ns_bf16::bf16;

// steps 2..k; ``cur`` indexes the Y buffer that holds Y
cudaError_t steps(const ns_bf16::Buffers& buf, int Bn, int Dp, int iters, cudaStream_t stream,
                  int* cur) {
  bf16* p = buf.t1;
  bf16* py = buf.t2;
  for (int it = 1; it < iters; ++it) {
    bf16* y = buf.y[*cur];
    // P = Y Mn
    cudaError_t err = ns_sm90::gemm(y, buf.mn, nullptr, p, Bn, Dp, 0.f, 1.f, stream);
    if (err != cudaSuccess) return err;
    // P <- P Y
    err = ns_sm90::gemm(p, y, nullptr, py, Bn, Dp, 0.f, 1.f, stream);
    if (err != cudaSuccess) return err;
    // Y <- 1.5 Y - 0.5 P Y, into the other Y buffer
    err = ns_sm90::gemm(py, y, y, buf.y[*cur ^ 1], Bn, Dp, 1.5f, -0.5f, stream);
    if (err != cudaSuccess) return err;
    *cur ^= 1;
  }
  return cudaSuccess;
}

}  // namespace

// m, out [B, D, D] (dtype); tr: B floats, trace(M) + eps; work: 5 * B * D *
// D bf16 scratch (Mn, Y twice, two products).  D must be a multiple of 256.
// The Python wrapper checks shapes and contiguity first.
extern "C" int newton_schulz_isqrt_bf16_streamed(const void* m, void* out, void* work,
                                                 const void* tr, int B, int D, int iters,
                                                 int dtype, void* stream) {
  if (D % ns_sm90::kCols != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return ns_bf16::entry(m, out, work, tr, B, D, iters, dtype, stream,
                        [&](const ns_bf16::Buffers& buf, int Dp, int* cur) {
                          return steps(buf, B, Dp, iters, s, cur);
                        });
}
