// The attention half of a Swin block, fused, forward.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/attn_half.py, _fwd_kernel
//   (called by fused_attn_half_spatial).
//
// Computes, per image b and window w (T = ws*ws <= 64 tokens, d = C/H = 32,
// C in {128, 256}), from the pre-LN map x[B, Hp, Wp, C]:
//   xn  = LayerNorm(x) * ln_g + ln_b           fp32, rounded to the input type
//   qkv = xn Wqkv^T + bqkv                     summed in fp32, rounded
//   om  = softmax(q k^T * scale + bias[h] + mask[w]) v   per head; P rounded
//         before P v as on the TPU, the sum fp32, om rounded
//   y   = x + (om Wproj^T + bproj)             summed in fp32, rounded once
// with Wqkv [3C, C] and Wproj [C, C] in the port's [out, in] layout, which is
// the [n][k] layout the B operand of mma_nt takes, so no weight is transposed.
//
// What bounds it on an H100: at Swin-Base's stage 0 (C = 128) operations and
// bytes about equally (2 M C 4C + 4 M T C flops against x read and y written
// once); at stage 1 (C = 256) operations.
//
// Design.  The TPU kernel holds the [C, 3C] and [C, C] weights in VMEM beside
// a row of windows; at C = 256 they alone are 512 KB in bf16, over the 227 KB
// a Hopper block can have.  One block of four warps owns one window of one
// image: it normalizes the window's rows into shared memory once and walks
// the weights in pieces (bf16: the 96 q, k, v rows of each head, then the
// proj rows 64 at a time; fp32: 32 rows), each arriving by cp.async.  bf16 double
// buffers the pieces, the next one landing under the products of the current
// one; the weights are read by every block and stay in the 50 MB L2.  Each
// warp owns 16 of the window's 64 (padded) rows for every product.  After a
// head's v piece the block attends: S = q k^T and the softmax in registers,
// then P v with P as the A operand straight from the accumulators (bf16) or
// through the warp's strip (fp32), into an om tile [64][C] in shared memory.
// The proj pieces then read om, and the epilogue adds bproj and x (read again,
// from L2) and stores the real rows.  bf16 runs on the tensor cores (mma.sync
// m16n8k16, fp32 accumulate); fp32 runs the same code on the CUDA cores
// (mma_tiles.cuh), so its results carry no bf16 or TF32 rounding.

#include "attn_half.cuh"

using namespace attn_half;

namespace {

// Weight pieces: 32-row groups of Wqkv or Wproj.  bf16 at C = 256 takes a
// head's q, k and v rows as one piece of three groups and Wproj two groups at
// a time, so that each barrier is followed by 12 (or 8) independent
// accumulator tiles per warp (one block per SM fits there anyway); at C = 128
// one group at a time keeps three blocks per SM, which measured faster.
// fp32, whose tiles are twice the bytes, takes one group at a time.
template <typename T, int C>
struct Pieces {
  static constexpr bool kWide = sizeof(T) == 2 && C == 256;
  static constexpr int kQkv = kWide ? 3 : 1;   // groups of a qkv piece
  static constexpr int kProj = kWide ? 2 : 1;  // groups of a proj piece
  static constexpr int kMax = kQkv > kProj ? kQkv : kProj;
};

template <typename T, int C>
struct FwdSmem {
  using L = Ld<T, C>;
  static constexpr int kBuf = sizeof(T) == 2 ? 2 : 1;  // fp32 at C = 256 has room for one piece
  static constexpr int kPiece = Pieces<T, C>::kMax * kHead * L::x;
  // xn and om [kTok][C]; the weight pieces; q, k, v [kTok][d]; fp32: the strips
  static constexpr size_t bytes =
      (2 * static_cast<size_t>(kTok) * L::x + kBuf * kPiece + 3 * kTok * L::d +
       kWarps * 16 * StripElems<T>::per_row) *
      sizeof(T);
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
attn_half_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                     const float* __restrict__ ln_b, const T* __restrict__ wqkv,
                     const T* __restrict__ bqkv, const T* __restrict__ wproj,
                     const T* __restrict__ bproj, const float* __restrict__ bias,
                     const float* __restrict__ mask, T* __restrict__ y, int Hp, int Wp, int H,
                     int ws, float scale, float eps) {
  using S = FwdSmem<T, C>;
  using L = Ld<T, C>;
  constexpr int kQ = Pieces<T, C>::kQkv;
  constexpr int kP = Pieces<T, C>::kProj;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sxn = reinterpret_cast<T*>(smem_raw);
  T* som = sxn + kTok * L::x;
  T* sw = som + kTok * L::x;
  T* sqkv = sw + S::kBuf * S::kPiece;  // q, k, v of one head, each [kTok][d]
  T* strip = sqkv + 3 * kTok * L::d;   // fp32 only: [kWarps][16][per_row]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int nt = ws * ws;
  const int nwx = Wp / ws;
  const int win = blockIdx.x;
  const int b = blockIdx.y;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const float* mask_w = mask ? mask + static_cast<size_t>(win) * nt * nt : nullptr;
  const int row0 = warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  T* strip_w = strip + warp * 16 * StripElems<T>::per_row;

  // qkv pieces first: piece p < n_qkv holds parts (p % (3 / kQ)) kQ .. + kQ of
  // head p / (3 / kQ), part 0 = q, 1 = k, 2 = v, each the 32 rows
  // part C + head 32 .. + 32 of Wqkv; then proj piece j holds rows
  // j kP 32 .. + kP 32 of Wproj
  constexpr int kPerHead = 3 / kQ;
  const int n_qkv = H * kPerHead;
  const int n_pieces = n_qkv + C / (kP * kHead);
  auto stage_piece = [&](int p, T* dst) {
    if (p < n_qkv) {
      const int h = p / kPerHead;
      const int part0 = (p % kPerHead) * kQ;
#pragma unroll
      for (int gi = 0; gi < kQ; ++gi) {
        stage_tile_async<T, kHead, C, kThreads>(
            dst + gi * kHead * L::x,
            wqkv + static_cast<size_t>((part0 + gi) * C + h * kHead) * C, C, 0, kHead, tid);
      }
    } else {
      const T* src = wproj + static_cast<size_t>(p - n_qkv) * kP * kHead * C;
      stage_tile_async<T, kP * kHead, C, kThreads>(dst, src, C, 0, kP * kHead, tid);
    }
    cp_async_commit();
  };
  stage_piece(0, sw);  // lands under the LayerNorm
  layer_norm_window<T, C>(sxn, x, b, Hp, Wp, ws, y0, x0, nt, ln_g, ln_b, eps, warp, lane);

  for (int p = 0; p < n_pieces; ++p) {
    // piece p has landed, xn (first) or om (proj) is complete, and the other
    // buffer's readers are done: the next piece is fetched into it
    cp_async_wait_all();
    __syncthreads();
    if (S::kBuf == 2 && p + 1 < n_pieces) stage_piece(p + 1, sw + ((p + 1) & 1) * S::kPiece);
    const T* w = sw + (S::kBuf == 2 ? (p & 1) : 0) * S::kPiece;
    if (p < n_qkv) {
      const int h = p / kPerHead;
      const int part0 = (p % kPerHead) * kQ;
      float acc[4 * kQ][4];
      zero_acc<4 * kQ>(acc);
      mma_nt<4 * kQ, C>(acc, sxn + warp * 16 * L::x, L::x, w, L::x, g, tg);
#pragma unroll
      for (int gi = 0; gi < kQ; ++gi) {
        T* dst = sqkv + (part0 + gi) * kTok * L::d;
        const T* bq = bqkv + (part0 + gi) * C + h * kHead;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = n * 8 + tg * 2;
          const float b0 = to_f32(bq[col]);
          const float b1 = to_f32(bq[col + 1]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            store_pair(dst + (row0 + half * 8) * L::d + col, acc[gi * 4 + n][half * 2] + b0,
                       acc[gi * 4 + n][half * 2 + 1] + b1);
          }
        }
      }
      if (part0 + kQ == 3) {
        __syncthreads();  // q, k, v of head h are complete
        float s[1][8][4];
        zero_acc<8>(s[0]);
        mma_nt<8, kHead>(s[0], sqkv + warp * 16 * L::d, L::d, sqkv + kTok * L::d, L::d, g, tg);
        window_probs(s[0], bias + static_cast<size_t>(h) * nt * nt, mask_w, nt, scale, row0, tg);
        float o[1][4][4];
        zero_acc<4>(o[0]);
        mma_from_acc<1, 4>(o, s, strip_w, StripElems<T>::per_row, sqkv + 2 * kTok * L::d, L::d,
                           g, tg);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            store_pair(som + (row0 + half * 8) * L::x + h * kHead + n * 8 + tg * 2,
                       o[0][n][half * 2], o[0][n][half * 2 + 1]);
          }
        }
      }
    } else {
      const int j0 = (p - n_qkv) * kP * kHead;  // output columns j0 .. j0 + 32 kP
      float acc[4 * kP][4];
      zero_acc<4 * kP>(acc);
      mma_nt<4 * kP, C>(acc, som + warp * 16 * L::x, L::x, w, L::x, g, tg);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + half * 8;
        if (r < nt) {
          const size_t at = window_pixel(b, Hp, Wp, ws, y0, x0, r) * C + j0;
#pragma unroll
          for (int n = 0; n < 4 * kP; ++n) {
            const int col = n * 8 + tg * 2;
            store_pair(y + at + col,
                       to_f32(x[at + col]) + (acc[n][half * 2] + to_f32(bproj[j0 + col])),
                       to_f32(x[at + col + 1]) +
                           (acc[n][half * 2 + 1] + to_f32(bproj[j0 + col + 1])));
          }
        }
      }
    }
    if (S::kBuf == 1) {
      __syncthreads();  // the one buffer's readers are done
      if (p + 1 < n_pieces) stage_piece(p + 1, sw);
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const float* ln_g, const float* ln_b, const void* wqkv,
                   const void* bqkv, const void* wproj, const void* bproj, const float* bias,
                   const float* mask, void* y, int B, int Hp, int Wp, int H, int ws, float scale,
                   float eps, cudaStream_t stream) {
  auto kernel = attn_half_fwd_kernel<T, C>;
  const size_t smem = FwdSmem<T, C>::bytes;
  cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Hp / ws) * (Wp / ws), B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ln_g, ln_b, static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wproj), static_cast<const T*>(bproj),
      bias, mask, static_cast<T*>(y), Hp, Wp, H, ws, scale, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y [B, Hp, Wp, C], wqkv [3C, C], bqkv [3C], wproj [C, C], bproj [C]
// (dtype); ln_g, ln_b [C] f32; bias [H, T, T] f32; mask [nW, T, T] f32 or
// null.  Requires C in {128, 256}, C / H == 32, ws <= 8, Hp and Wp multiples
// of ws; the Python wrapper checks shapes, contiguity and alignment first.
extern "C" int attn_half_fwd(const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
                             const void* bqkv, const void* wproj, const void* bproj,
                             const void* bias, const void* mask, void* y, int B, int Hp, int Wp,
                             int C, int H, int ws, float scale, float eps, int dtype,
                             void* stream) {
  if (B < 1 || H < 1 || C % H != 0 || C / H != kHead || ws < 1 || ws * ws > kTok ||
      Hp % ws != 0 || Wp % ws != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* bb = static_cast<const float*>(ln_b);
  const float* bias_f = static_cast<const float*>(bias);
  const float* mask_f = static_cast<const float*>(mask);
  cudaError_t err = cudaErrorInvalidValue;
#define EMCT_LAUNCH(TYPE, WIDTH)                                                               \
  err = launch<TYPE, WIDTH>(x, g, bb, wqkv, bqkv, wproj, bproj, bias_f, mask_f, y, B, Hp, Wp, H, \
                            ws, scale, eps, s)
  if (dtype == EMCT_DTYPE_BF16 && C == 128) {
    EMCT_LAUNCH(__nv_bfloat16, 128);
  } else if (dtype == EMCT_DTYPE_BF16 && C == 256) {
    EMCT_LAUNCH(__nv_bfloat16, 256);
  } else if (dtype == EMCT_DTYPE_F32 && C == 128) {
    EMCT_LAUNCH(float, 128);
  } else if (dtype == EMCT_DTYPE_F32 && C == 256) {
    EMCT_LAUNCH(float, 256);
  }
#undef EMCT_LAUNCH
  return static_cast<int>(err);
}
