// The moment head's token-subspace iSQRT-COV where no gradient is wanted
// (serving, evaluation): out = M2^-1/2 for M2 = A^T B, A = centered and
// B = weighted [B, N, D], by the coupled Newton–Schulz iteration in the N-dim
// token subspace, as ops/moments.py:isqrt_cov_subspace computes it.
//
// Replaces no TPU kernel: the JAX package leaves this iteration to XLA
// (ego_moment_cle_vit_tpu/ops/moments.py:336, isqrt_cov_subspace).  It was
// added because the route, run as fp32 products on the CUDA cores, held 30 %
// of the device time of a ViT-L/16 serving call at 448 (N = 784, D = 1024,
// batch 64).
//
// Computes, per image (t, S, G, X, H in fp32; every elementwise step in the
// plain version's order of operations, each rounding an IEEE fp32 one):
//   t = sum(A * B) + eps;  B^ = B / t;  S = B^ A^T  [N, N]
//   G = 0, a = 1; k times:  X = 2a G + G (S G);  H = a^2 I + S X;
//                           G <- 1.5 G - 0.5 (a H + G (S H));  a <- 1.5 a
//   out = (A^T (G B^) + a I) / sqrt(t), in the inputs' dtype.
// Schedule: iteration 1 leaves H = I and G = -I/2 exactly, and no product runs
// for it; in iteration 2 the three products by G = -I/2 are exact scalings
// (S G = -S/2, G (S G) = S/4, G (S H) = -(S H)/2), written into the
// epilogues, so only S X and S H run; iterations 3..k run five products each;
// then G B^ and A^T (G B^).  For k = 1, G B^ = -B^/2 is written without a
// product.  Each element is what the plain iteration computes from the same
// products (kernels/subspace_isqrt.py's plain version runs this schedule and
// its tests hold it to isqrt_cov_subspace bit for bit): 5k - 5 products for
// k >= 2, each fp32-accurate.
//
// What bounds it on an H100: tensor-core operations.  Every product is
// split_sm90.cuh's fp32-accurate product from bf16 planes: six bf16 cross
// products, or three where one side is exactly bf16 (A in the bf16 model), so
// S and A^T (G B^) take three.  At [64, 784, 1024], k = 5: 17 N^3 products of
// six, G B^ of six, S and A^T (.) of three: 7.3e12 flops over 989 TFLOP/s,
// 7.4 ms (kernels/subspace_isqrt.py:bound_flops); the device-memory bytes (A
// and B read, the iterates ~3.7 MB an image each) do not bound it.
//
// Design.  Each product C = L R is one launch of product_kernel over the
// batch: split_sm90.cuh's block on a [128][112] tile of C (N = 784 is 7 x
// 112; a 64-row warpgroup that holds no row of C skips its products), whose
// products run at ~55 % of the bf16 rate, with ~5 TB/s of tiles from L2 over
// the card.  Every elementwise step of the iteration runs in the epilogue of
// the product that feeds it, which writes its result as three bf16 planes;
// split_kernel makes B^'s planes (and A's, for fp32 inputs) from the inputs;
// the last epilogue adds a_k on the diagonal, divides by sqrt(t) and rounds to
// the inputs' dtype.  The planes live in a scratch the wrapper allocates
// (kernels/subspace_isqrt.py:scratch_bytes): t; S, G twice (blocks of one
// product still read G while others write the next), two work matrices,
// whose room G B^ takes at the end; B^ (and A).  For k >= 2, 5k - 3 launches
// (the trace, the split of B^, the products; one more split for fp32 inputs),
// which the wrapper counts as one.  At [64, 784, 1024] bf16, k = 5, on an
// H100 80GB HBM3 at 700 W: 18.2 ms, against the bound's 7.4 ms and the fp32
// CUDA-core route's 51.3 ms.

#include <algorithm>
#include <type_traits>

#include "split_sm90.cuh"

namespace {

using namespace split_sm90;

constexpr int kCols = 112;  // C columns a block: one m64n112 each
constexpr int kAcc = kCols / 2;

// what the epilogue makes of a tile of C = L R (v), given the iteration's a
enum Epilogue : int {
  kStore = 0,  // C = v
  kSX2 = 1,    // C = S = v, and X2 = -1.5 I + S / 4 beside it (iteration 2's X)
  kH = 2,      // H = a^2 I + v
  kX = 3,      // X = 2a G + v
  kG = 4,      // G' = 1.5 G - 0.5 (a H + v)
  kG2 = 5,     // iteration 2's G: as kG with G = -I/2 and v = -(S H)/2
  kFinal = 6,  // out = (v + a I) / sqrt(t), in the output's type
};

struct Product {
  int m, n, k;       // C is [m][n], the contraction k long
  int batch;
  const float* t;    // trace + eps, one an image
  int keep_lo;       // 0 writes no lo terms: the precision control of the card tests
  int epi;
  void* c;           // C: three bf16 planes, or the output (kFinal)
  long long c_image;  // elements between images
  long long c_plane;  // elements between planes
  int c_pitch;
  bf16* x2;          // kSX2: X2's planes, at C's layout
  const bf16* g;     // kX, kG: G's planes, at C's layout
  const bf16* h;     // kG, kG2: H's planes
  float a;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 load4(const bf16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ void values(const float4& v, float* x) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void values(const uint2& v, float* x) {
  const float2 a = unpack(v.x), b = unpack(v.y);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// the epilogue of one value v of C at ``at`` (diag: on C's diagonal); g and
// h are G and H there
__device__ __forceinline__ float epilogue(const Product& p, bool diag, float v, float g, float h) {
  switch (p.epi) {
    case kH:
      return diag ? __fadd_rn(__fmul_rn(p.a, p.a), v) : v;
    case kX:
      return __fadd_rn(__fmul_rn(2.f * p.a, g), v);
    case kG:
      return __fsub_rn(__fmul_rn(1.5f, g), __fmul_rn(0.5f, __fadd_rn(__fmul_rn(p.a, h), v)));
    case kG2:
      return __fsub_rn(__fmul_rn(1.5f, diag ? -0.5f : 0.f),
                       __fmul_rn(0.5f, __fadd_rn(__fmul_rn(p.a, h), __fmul_rn(-0.5f, v))));
    default:  // kStore, kSX2, kFinal (its diagonal and division follow)
      return v;
  }
}

// C = L R over the batch, one [128][112] tile of C a block; grid (column
// tiles, row tiles, batch).  TOut: the output's type for kFinal; else C is
// written as three bf16 planes.
template <class L, class R, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
product_kernel(const __grid_constant__ CUtensorMap tm_l, const __grid_constant__ CUtensorMap tm_r,
               const Product p) {
  extern __shared__ unsigned char smem_raw[];
  float sum[kAcc];
  if (!product_tile<L, R, kCols>(smem_raw, &tm_l, &tm_r, p.batch, p.m, p.k, sum)) return;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * kRows + (threadIdx.x >> 7) * 64 +
                   ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = blockIdx.x * kCols + (lane & 3) * 2;

  // The epilogue, a half of the tile's columns at a time: G and H (where the
  // step reads them) are loaded first, then every value is formed and stored.
  const bool final_out = p.epi == kFinal;
  const float root = final_out ? __fsqrt_rn(p.t[b]) : 1.f;
  const bool reads_g = p.epi == kX || p.epi == kG;
  const bool reads_h = p.epi == kG || p.epi == kG2;
  constexpr int kHalf = kCols / 16;  // column groups of 8 a half
#pragma unroll
  for (int j0 = 0; j0 < kCols / 8; j0 += kHalf) {
    float2 g[kHalf][2], h[kHalf][2];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        const int col = col0 + (j0 + j) * 8;
        const bool in = row < p.m && col < p.n;
        const long long at = static_cast<long long>(b) * p.c_image +
                             static_cast<long long>(row) * p.c_pitch + col;
        g[j][half] = in && reads_g ? load_split(p.g, p.c_plane, at) : make_float2(0.f, 0.f);
        h[j][half] = in && reads_h ? load_split(p.h, p.c_plane, at) : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        const int col = col0 + (j0 + j) * 8;
        // a pair's second column past n lies in the pad of a row, which no
        // map reads
        if (row >= p.m || col >= p.n) continue;
        const long long at = static_cast<long long>(b) * p.c_image +
                             static_cast<long long>(row) * p.c_pitch + col;
        const float v0 = sum[4 * (j0 + j) + 2 * half], v1 = sum[4 * (j0 + j) + 2 * half + 1];
        float y0 = epilogue(p, row == col, v0, g[j][half].x, h[j][half].x);
        float y1 = epilogue(p, row == col + 1, v1, g[j][half].y, h[j][half].y);
        if (final_out) {
          y0 = __fdiv_rn(row == col ? __fadd_rn(y0, p.a) : y0, root);
          y1 = __fdiv_rn(row == col + 1 ? __fadd_rn(y1, p.a) : y1, root);
          store_pair(static_cast<TOut*>(p.c) + at, y0, y1);
          continue;
        }
        store_split(static_cast<bf16*>(p.c), p.c_plane, at, y0, y1, p.keep_lo);
        if (p.epi == kSX2) {
          store_split(p.x2, p.c_plane, at,
                      __fadd_rn(row == col ? -1.5f : 0.f, __fmul_rn(0.25f, v0)),
                      __fadd_rn(row == col + 1 ? -1.5f : 0.f, __fmul_rn(0.25f, v1)),
                      p.keep_lo);
        }
      }
    }
  }
}

// t = sum(A * B) + eps, one block an image, fp32 sums
template <typename T>
__global__ void __launch_bounds__(512) trace_kernel(const T* __restrict__ a,
                                                    const T* __restrict__ b, float* t,
                                                    long long n, float eps) {
  const long long off = static_cast<long long>(blockIdx.x) * n;
  float s = 0.f;
  for (long long i = threadIdx.x * 4LL; i < n; i += 512 * 4) {
    float x[4], y[4];
    values(load4(a + off + i), x);
    values(load4(b + off + i), y);
#pragma unroll
    for (int e = 0; e < 4; ++e) s = fmaf(x[e], y[e], s);
  }
  __shared__ float part[16];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = warp_sum(threadIdx.x < 16 ? part[threadIdx.x] : 0.f);
    if (threadIdx.x == 0) t[blockIdx.x] = __fadd_rn(s, eps);
  }
}

// The three planes of c * x (Divide: c * (x / t)), x an input [B][n] in its
// dtype: B^ (c = 1), -B^/2 (k = 1: G B^ for G = -I/2), A (fp32 inputs).
// Grid (chunks of 4 x 256, B).
template <typename T, bool Divide>
__global__ void __launch_bounds__(256) split_kernel(const T* __restrict__ x,
                                                    const float* __restrict__ t,
                                                    bf16* __restrict__ planes, long long n, int B,
                                                    float c, int keep_lo) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const long long at = static_cast<long long>(blockIdx.y) * n + i;
  const long long plane = static_cast<long long>(B) * n;
  float v[4];
  values(load4(x + at), v);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(Divide ? __fdiv_rn(v[e], t[blockIdx.y]) : v[e], c);
  store_split(planes, plane, at, v[0], v[1], keep_lo);
  store_split(planes, plane, at + 2, v[2], v[3], keep_lo);
}

// k = 0: out = I / sqrt(t).  Grid (chunks of a row, D, B).
template <typename T>
__global__ void __launch_bounds__(256) eye_kernel(T* __restrict__ out,
                                                  const float* __restrict__ t, int D) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= D) return;
  const int row = blockIdx.y;
  const float v = row == col ? __fdiv_rn(1.f, __fsqrt_rn(t[blockIdx.z])) : 0.f;
  out[(static_cast<long long>(blockIdx.z) * D + row) * D + col] = from_f32<T>(v);
}

template <class L, class R, typename TOut>
cudaError_t launch(const Planes& l, const Planes& r, const Product& p, cudaStream_t stream) {
  CUtensorMap tm_l, tm_r;
  dim3 grid;
  auto kernel = product_kernel<L, R, TOut>;
  const cudaError_t err =
      prepare<L, R, kCols>(kernel, &tm_l, &tm_r, l, r, p.m, p.n, p.batch, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(tm_l, tm_r, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* a, const T* b, T* out, unsigned char* work, int B, int N, int D,
                int iters, float eps, bool keep_lo, cudaStream_t stream) {
  constexpr bool kExact = std::is_same<T, bf16>::value;  // A needs no split
  constexpr int kA = kExact ? 1 : 3;
  using SqK = Side<3, 0, kRows>;    // an N x N iterate, rows C's rows
  using SqMN = Side<3, 1, kCols>;   // an iterate (G B^, B^) whose rows are the contraction
  using InK = Side<kA, 0, kCols>;   // A as S's R (A^T)
  using InMN = Side<kA, 1, kRows>;  // A^T as the last product's L
  const int P = pitch_of(N);
  const long long nn = static_cast<long long>(N) * P;
  const long long nd = static_cast<long long>(N) * D;
  float* t = reinterpret_cast<float*>(work);
  bf16* S = reinterpret_cast<bf16*>(work + trace_bytes(B));
  bf16* G[2] = {S + 3 * B * nn, S + 6 * B * nn};
  bf16* W[2] = {S + 9 * B * nn, S + 12 * B * nn};
  bf16* GB = W[0];  // the work matrices' room, or more (scratch_bytes)
  bf16* BH = W[0] + std::max(6 * B * nn, 3 * B * nd);
  const bf16* A = kExact ? reinterpret_cast<const bf16*>(a) : BH + 3 * B * nd;

  trace_kernel<T><<<B, 512, 0, stream>>>(a, b, t, nd, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (iters == 0) {
    eye_kernel<T><<<dim3((D + 255) / 256, D, B), 256, 0, stream>>>(out, t, D);
    return cudaGetLastError();
  }
  const dim3 split_grid(static_cast<unsigned>((nd / 4 + 255) / 256), B);
  // B^, or -B^/2 = G B^ for k = 1
  split_kernel<T, true><<<split_grid, 256, 0, stream>>>(b, t, iters == 1 ? GB : BH, nd, B,
                                                        iters == 1 ? -0.5f : 1.f, keep_lo);
  err = cudaGetLastError();
  if (!kExact && err == cudaSuccess) {
    split_kernel<T, false><<<split_grid, 256, 0, stream>>>(a, t, const_cast<bf16*>(A), nd, B,
                                                           1.f, keep_lo);
    err = cudaGetLastError();
  }

  Product base = {};
  base.batch = B;
  base.t = t;
  base.keep_lo = keep_lo;
  const Planes in_a = {A, N, D, D};
  auto sq = [&](const bf16* m) { return Planes{m, N, N, P}; };
  // an N x N product into ``c``
  auto square = [&](bf16* c, int epi, float a_it) {
    Product q = base;
    q.m = q.n = q.k = N;
    q.epi = epi;
    q.c = c;
    q.c_image = nn;
    q.c_plane = B * nn;
    q.c_pitch = P;
    q.a = a_it;
    return q;
  };
  if (iters >= 2 && err == cudaSuccess) {
    // S = B^ A^T and iteration 2's X
    Product q = square(S, kSX2, 1.f);
    q.k = D;
    q.x2 = W[0];
    err = launch<Side<3, 0, kRows>, InK, bf16>(Planes{BH, N, D, D}, in_a, q, stream);
    // H = 2.25 I + S X
    if (err == cudaSuccess) {
      err = launch<SqK, SqMN, bf16>(sq(S), sq(W[0]), square(W[1], kH, 1.5f), stream);
    }
    // G = 1.5 (-I/2) - 0.5 (1.5 H + (-I/2)(S H))
    q = square(G[0], kG2, 1.5f);
    q.h = W[1];
    if (err == cudaSuccess) err = launch<SqK, SqMN, bf16>(sq(S), sq(W[1]), q, stream);
    int cur = 0;
    float a_it = 1.5f;
    for (int it = 3; it <= iters && err == cudaSuccess; ++it) {
      a_it *= 1.5f;
      // W0 = S G
      err = launch<SqK, SqMN, bf16>(sq(S), sq(G[cur]), square(W[0], kStore, a_it), stream);
      // W1 = X = 2a G + G (S G)
      q = square(W[1], kX, a_it);
      q.g = G[cur];
      if (err == cudaSuccess) err = launch<SqK, SqMN, bf16>(sq(G[cur]), sq(W[0]), q, stream);
      // W0 = H = a^2 I + S X
      if (err == cudaSuccess) {
        err = launch<SqK, SqMN, bf16>(sq(S), sq(W[1]), square(W[0], kH, a_it), stream);
      }
      // W1 = S H
      if (err == cudaSuccess) {
        err = launch<SqK, SqMN, bf16>(sq(S), sq(W[0]), square(W[1], kStore, a_it), stream);
      }
      // G' = 1.5 G - 0.5 (a H + G (S H))
      q = square(G[cur ^ 1], kG, a_it);
      q.g = G[cur];
      q.h = W[0];
      if (err == cudaSuccess) err = launch<SqK, SqMN, bf16>(sq(G[cur]), sq(W[1]), q, stream);
      cur ^= 1;
    }
    // G B^, [N][D]
    q = square(GB, kStore, 1.f);
    q.n = D;
    q.c_image = nd;
    q.c_plane = B * nd;
    q.c_pitch = D;
    if (err == cudaSuccess) {
      err = launch<SqK, SqMN, bf16>(sq(G[cur]), Planes{BH, N, D, D}, q, stream);
    }
  }
  if (err != cudaSuccess) return err;
  // out = (A^T (G B^) + a_k I) / sqrt(t)
  float a_k = 1.f;
  for (int it = 0; it < iters; ++it) a_k *= 1.5f;
  Product q = base;
  q.m = q.n = D;
  q.k = N;
  q.epi = kFinal;
  q.a = a_k;
  q.c = out;
  q.c_image = static_cast<long long>(D) * D;
  q.c_pitch = D;
  return launch<InMN, SqMN, T>(in_a, Planes{GB, N, D, D}, q, stream);
}

}  // namespace

// a, b (centered, weighted): [B, N, D] (dtype), contiguous, D a multiple of 8;
// out [B, D, D] (dtype); work: kernels/subspace_isqrt.py:scratch_bytes(B, N, D,
// dtype) bytes.  terms: 3, or 2 to drop the lo terms (the card tests'
// control).  The Python wrapper checks shapes and contiguity first.
extern "C" int subspace_isqrt(const void* a, const void* b, void* out, void* work, int B, int N,
                              int D, int iters, float eps, int dtype, int terms, void* stream) {
  if (B < 1 || N < 1 || D < 8 || D % 8 != 0 || iters < 0 || (terms != 2 && terms != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<unsigned char*>(work);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == EMCT_DTYPE_BF16) {
    err = run(static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(out), w,
              B, N, D, iters, eps, terms == 3, s);
  } else if (dtype == EMCT_DTYPE_F32) {
    err = run(static_cast<const float*>(a), static_cast<const float*>(b),
              static_cast<float*>(out), w, B, N, D, iters, eps, terms == 3, s);
  }
  return static_cast<int>(err);
}
