// Coupled Newton–Schulz iteration for M^-1/2 (iSQRT-COV), fp32-accurate.
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
// the symmetric three-product form of the TPU kernel, in its order, each
// elementwise step rounded as the plain version rounds it.  Two products are
// skipped, with the same values: the first step's, whose Y is the identity
// (T = Z and Y T = Z exactly), and the last step's Z update, which nothing
// reads: 3k - 3 products.
//
// What bounds it on an H100: tensor-core operations.  The products are
// fp32-accurate: each is split_sm90.cuh's product from bf16 planes, six bf16
// cross products down to 2^-24 on wgmma, so 3k - 3 products of 2 D^3 each
// run at a sixth of the bf16 rate.  At [64, 768, 768], k = 5: 4.2e12 flops
// over 989 TFLOP/s, 4.22 ms (h100_bench/kernel_work's count); the same
// products as fp32 on the CUDA cores would take 10.4 ms at their 67 TFLOP/s
// peak; the bytes (M read, the result written, the planes of each iterate
// ~3.5 MB an image) take far less.
//
// Design.  A 768^2 fp32 matrix is 2.36 MB, ten times the 227 KB of shared
// memory a block can use, so the iterates live in a device scratch as three
// bf16 planes each (hi + mid + lo is the fp32 value exactly) and every product
// is one launch of ns_gemm over the images of a pass: split_sm90.cuh's block
// on a [128][128] tile of C (768 is 6 x 128; a 64-row warpgroup that holds no
// row of C skips its products), two consumer warpgroups on m64n128 and a
// producer warp keeping a four-stage TMA ring of every plane of both operands
// in flight.  The split is made where a matrix is made: ns_init writes Z's and
// the first step's Y's planes (Y1 = 1.5 I - 0.5 Z, from Y0 = I), and each
// product's epilogue writes its result's, so the main loop only loads boxes.
// A source whose rows are C's rows (Z in Z Y, Y in Y T) is read K-major; the
// right operands, and T^T and Z^T on the left, MN-major, so T^T is read by
// addressing and never transposed in memory.  The epilogues form the updates
// (1.5 X - 0.5 v, X's planes read back at C's place) and the last Y update
// divides by sqrt(tr) and writes the output in M's type.  A tile of
// Y <- 1.5 Y - 0.5 Y T reads whole rows of Y that other blocks still read, so
// four matrices rotate: T, Y, Z and a free one; Y' goes to the free one, Z'
// to Y's old place.  The batch runs in passes of at most a fixed number of
// images (kernels/newton_schulz.py:fp32_geometry), so the scratch is four
// matrices' planes for one pass, rows padded to 8 elements (the 16 bytes a
// TMA row pitch needs; the tensor maps end at D).  Launches: the traces, then
// a pass's init and its 3k - 3 products (27 at batch 64, k = 5), which the
// wrapper counts as one.  At [64, 768, 768] bf16, k = 5, on an H100 80GB HBM3
// at 700 W: 9.33-9.35 ms (the products 8.73, the inits 0.21), 45 % of the
// 4.22 ms bound, against the CUDA-core fp32 kernel it replaced, 20.14-20.16,
// and cuBLAS's fp32 iteration, 18.62-18.75; its error against an fp64 witness
// is 0.99x the plain fp32 route's.

#include <algorithm>

#include "split_sm90.cuh"

namespace {

using namespace split_sm90;

constexpr int kCols = 128;  // C columns a block: one m64n128 each
constexpr int kAcc = kCols / 2;

// what the epilogue makes of a value v of C = L R, X the matrix at C's place
enum Epilogue : int {
  kStore = 0,   // C = v (T)
  kUpdate = 1,  // C = 1.5 X - 0.5 v (Y', Z')
  kFinal = 2,   // out = (1.5 X - 0.5 v) / sqrt(tr), in M's type (the last Y)
};

struct Step {
  int d, pitch;      // C is D x D, its planes' rows pitch apart
  int batch;         // the pass's images
  int keep_lo;       // 0 writes no lo planes: the precision control of the card tests
  int epi;
  const float* tr;   // the pass's traces + eps
  const bf16* x;     // X's planes (kUpdate, kFinal)
  void* c;           // C's planes, or the output (kFinal)
  long long plane;   // elements between planes: batch * D * pitch
};

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

// Z = M / tr, and Y1 = 1.5 I - 0.5 Z (the first step's Y: Y0 = I, T = Z exactly),
// as planes for k >= 2; for k <= 1 the output itself, Y / sqrt(tr) with Y = I
// (k = 0) or Y1.  One thread a pair of neighbours in a row (a row's last
// element alone when D is odd).
template <typename T>
__global__ void __launch_bounds__(256)
ns_init(const T* __restrict__ m, const float* __restrict__ tr, bf16* __restrict__ z,
        bf16* __restrict__ y, T* __restrict__ out, int D, int pitch, int images, int iters,
        int keep_lo) {
  const int half = (D + 1) / 2;
  const long long per_image = static_cast<long long>(D) * half;
  const long long pairs = per_image * images;
  const long long plane = static_cast<long long>(images) * D * pitch;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < pairs; i += gridDim.x * 256LL) {
    const int b = static_cast<int>(i / per_image);
    const int r = static_cast<int>(i % per_image / half);
    const int c = static_cast<int>(i % half) * 2;
    const float t = tr[b];
    const long long at = (static_cast<long long>(b) * D + r) * D + c;
    const bool second = c + 1 < D;
    const float z0 = __fdiv_rn(to_f32(m[at]), t);
    const float z1 = second ? __fdiv_rn(to_f32(m[at + 1]), t) : 0.f;
    const float e0 = r == c ? 1.f : 0.f, e1 = r == c + 1 ? 1.f : 0.f;
    if (iters >= 2) {
      const long long p = (static_cast<long long>(b) * D + r) * pitch + c;
      store_split(z, plane, p, z0, z1, keep_lo);
      store_split(y, plane, p, __fsub_rn(1.5f * e0, __fmul_rn(0.5f, z0)),
                  __fsub_rn(1.5f * e1, __fmul_rn(0.5f, z1)), keep_lo);
      continue;
    }
    const float root = __fsqrt_rn(t);
    const float y0 = iters == 1 ? __fsub_rn(1.5f * e0, __fmul_rn(0.5f, z0)) : e0;
    const float y1 = iters == 1 ? __fsub_rn(1.5f * e1, __fmul_rn(0.5f, z1)) : e1;
    out[at] = from_f32<T>(__fdiv_rn(y0, root));
    if (second) out[at + 1] = from_f32<T>(__fdiv_rn(y1, root));
  }
}

// C = L R for the pass's images, one [128][128] tile of C a block, and the
// step's epilogue; grid (column tiles, row tiles, images).  TOut: the
// output's type for kFinal; else C is written as three bf16 planes.
template <class L, class R, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
ns_gemm(const __grid_constant__ CUtensorMap tm_l, const __grid_constant__ CUtensorMap tm_r,
        const Step p) {
  extern __shared__ unsigned char smem_raw[];
  float sum[kAcc];
  if (!product_tile<L, R, kCols>(smem_raw, &tm_l, &tm_r, p.batch, p.d, p.d, sum)) return;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRows + (threadIdx.x >> 7) * 64 +
                   ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = blockIdx.x * kCols + (lane & 3) * 2;

  // The epilogue, a quarter of the tile's columns at a time (halves spilled
  // at the 168 registers a thread): X (where the step reads it) is loaded
  // first, then every value is formed and stored.
  const bool final_out = p.epi == kFinal;
  const float root = final_out ? __fsqrt_rn(p.tr[b]) : 1.f;
  constexpr int kPart = kCols / 32;  // column groups of 8 a quarter
#pragma unroll
  for (int j0 = 0; j0 < kCols / 8; j0 += kPart) {
    float2 x[kPart][2];
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        const int col = col0 + (j0 + j) * 8;
        const long long at = (static_cast<long long>(b) * p.d + row) * p.pitch + col;
        x[j][half] = row < p.d && col < p.d && p.epi != kStore ? load_split(p.x, p.plane, at)
                                                               : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        const int col = col0 + (j0 + j) * 8;
        // a pair's second column past D lies in the pad of a row, which no
        // map reads
        if (row >= p.d || col >= p.d) continue;
        float y0 = sum[4 * (j0 + j) + 2 * half], y1 = sum[4 * (j0 + j) + 2 * half + 1];
        if (p.epi != kStore) {
          y0 = __fsub_rn(__fmul_rn(1.5f, x[j][half].x), __fmul_rn(0.5f, y0));
          y1 = __fsub_rn(__fmul_rn(1.5f, x[j][half].y), __fmul_rn(0.5f, y1));
        }
        if (final_out) {
          TOut* o = static_cast<TOut*>(p.c) + (static_cast<long long>(b) * p.d + row) * p.d + col;
          y0 = __fdiv_rn(y0, root);
          y1 = __fdiv_rn(y1, root);
          if (p.d % 2 == 0) {
            store_pair(o, y0, y1);
          } else {  // odd rows: the pair is not aligned, and the row may end at col
            o[0] = from_f32<TOut>(y0);
            if (col + 1 < p.d) o[1] = from_f32<TOut>(y1);
          }
          continue;
        }
        const long long at = (static_cast<long long>(b) * p.d + row) * p.pitch + col;
        store_split(static_cast<bf16*>(p.c), p.plane, at, y0, y1, p.keep_lo);
      }
    }
  }
}

template <class L, class R, typename TOut>
cudaError_t gemm(const bf16* l, const bf16* r, const Step& p, cudaStream_t stream) {
  CUtensorMap tm_l, tm_r;
  dim3 grid;
  auto kernel = ns_gemm<L, R, TOut>;
  const cudaError_t err = prepare<L, R, kCols>(kernel, &tm_l, &tm_r, Planes{l, p.d, p.d, p.pitch},
                                               Planes{r, p.d, p.d, p.pitch}, p.d, p.d, p.batch,
                                               &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(tm_l, tm_r, p);
  return cudaGetLastError();
}

// One pass: ``images`` matrices from m, their traces tr, into out; buf: the
// four matrices' planes.
template <typename T>
cudaError_t pass(const T* m, T* out, const float* tr, bf16* const* buf, int images, int D,
                 int iters, bool keep_lo, cudaStream_t stream) {
  using RowsK = Side<3, 0, kRows>;   // L whose rows are C's rows: Z in Z Y, Y in Y T
  using RowsMN = Side<3, 1, kRows>;  // L read transposed: Z^T, T^T
  using ColsMN = Side<3, 1, kCols>;  // every R: its rows are the contraction
  const int P = pitch_of(D);
  const long long pairs = static_cast<long long>(images) * D * ((D + 1) / 2);
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((pairs + 255) / 256, 132 * 16));
  ns_init<T><<<blocks, 256, 0, stream>>>(m, tr, buf[0], buf[1], out, D, P, images, iters,
                                         keep_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || iters < 2) return err;

  Step p = {};
  p.d = D;
  p.pitch = P;
  p.batch = images;
  p.keep_lo = keep_lo;
  p.tr = tr;
  p.plane = static_cast<long long>(images) * D * P;
  // Z1 = 1.5 Z - 0.5 Z^T Z (the first step's: T = Z)
  p.epi = kUpdate;
  p.x = buf[0];
  p.c = buf[2];
  err = gemm<RowsMN, ColsMN, bf16>(buf[0], buf[0], p, stream);
  int y = 1, z = 2, t = 3, spare = 0;
  for (int it = 1; it < iters && err == cudaSuccess; ++it) {
    // T = Z Y
    p.epi = kStore;
    p.c = buf[t];
    err = gemm<RowsK, ColsMN, bf16>(buf[z], buf[y], p, stream);
    if (err != cudaSuccess) break;
    // Y <- 1.5 Y - 0.5 Y T; the last one is the output
    p.x = buf[y];
    if (it + 1 == iters) {
      p.epi = kFinal;
      p.c = out;
      err = gemm<RowsK, ColsMN, T>(buf[y], buf[t], p, stream);
      break;
    }
    p.epi = kUpdate;
    p.c = buf[spare];
    err = gemm<RowsK, ColsMN, bf16>(buf[y], buf[t], p, stream);
    if (err != cudaSuccess) break;
    // Z <- 1.5 Z - 0.5 T^T Z, into Y's old place
    p.x = buf[z];
    p.c = buf[y];
    err = gemm<RowsMN, ColsMN, bf16>(buf[t], buf[z], p, stream);
    const int y_old = y;
    y = spare;
    spare = z;
    z = y_old;
  }
  return err;
}

template <typename T>
cudaError_t run(const T* m, T* out, unsigned char* work, int B, int D, int iters, float eps,
                int images, bool keep_lo, cudaStream_t stream) {
  float* tr = reinterpret_cast<float*>(work);
  const long long matrix = 3LL * images * D * pitch_of(D);  // a matrix's planes for a pass
  bf16* planes = reinterpret_cast<bf16*>(work + trace_bytes(B));
  bf16* const buf[4] = {planes, planes + matrix, planes + 2 * matrix, planes + 3 * matrix};
  ns_trace<T><<<B, 256, 0, stream>>>(m, tr, D, eps);
  cudaError_t err = cudaGetLastError();
  const long long dd = static_cast<long long>(D) * D;
  for (int b0 = 0; b0 < B && err == cudaSuccess; b0 += images) {
    err = pass<T>(m + b0 * dd, out + b0 * dd, tr + b0, buf, std::min(images, B - b0), D, iters,
                  keep_lo, stream);
  }
  return err;
}

}  // namespace

// m, out [B, D, D] (dtype), contiguous; work: kernels/newton_schulz.py:
// fp32_geometry(B, D)["scratch_bytes"] bytes, for passes of ``images``
// matrices.  terms: 3, or 2 to drop the lo planes (the card tests' control).
// The Python wrapper checks shapes and contiguity first.
extern "C" int newton_schulz_isqrt(const void* m, void* out, void* work, int B, int D, int iters,
                                   float eps, int dtype, int images, int terms, void* stream) {
  if (B < 1 || D < 1 || iters < 0 || images < 1 || (terms != 2 && terms != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<unsigned char*>(work);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == EMCT_DTYPE_BF16) {
    err = run(static_cast<const bf16*>(m), static_cast<bf16*>(out), w, B, D, iters, eps, images,
              terms == 3, s);
  } else if (dtype == EMCT_DTYPE_F32) {
    err = run(static_cast<const float*>(m), static_cast<float*>(out), w, B, D, iters, eps, images,
              terms == 3, s);
  }
  return static_cast<int>(err);
}
