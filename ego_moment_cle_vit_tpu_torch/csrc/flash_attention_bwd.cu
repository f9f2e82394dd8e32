// q-tiled multi-head self-attention over long token sequences, backward.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/flash_attention.py, _bwd_kernel
//   (the VJP of flash_attention_tiled; the ViT backbone runs it at a 448
//   input, T = 785, 12 heads of 64, batch 128 for the two views of 64).
//
// Computes, per image b and head h (T tokens, d = C/H in {32, 64}), from
// qkv[B, T, 3C], the forward's out[B, T, C] and lse[B, H, T], and
// dout[B, T, C]:
//   P     = exp(q k^T * scale - lse)                        (rebuilt, fp32)
//   delta = rowsum(dout * out)              (= rowsum(dp * P), fp32)
//   dv    = P~^T dout            P~ = P rounded to the input type
//   dp    = dout v^T
//   ds    = P * (dp - delta)                                (fp32)
//   dq    = ds~ k * scale,  dk = ds~^T q * scale            ds~ = ds rounded
// dq, dk, dv go to dqkv[B, T, 3C]; delta goes to a [B, H, T] fp32 scratch.
//
// What bounds it on an H100: the tensor cores at the ViT-448 shape.  The
// minimal work is 10*T^2*d flops per (image, head) (five T x T x d products)
// against reading 4*T*d and writing 3*T*d values: ~560 flops per byte of bf16
// at T = 785, over the ~295 of the tensor cores.
//
// Design.  The TPU kernel recomputes the probabilities per 128-query tile
// and adds dk, dv into resident [T, d] blocks across a sequential grid.  Here
// blocks run in no order and no [T, T] tile fits a block, so the work is cut
// along the axis each result is summed over, and each sum stays inside one
// block (no float atomics: two runs give the same bits):
//   1. dq kernel, one block per 128 query rows of one (image, head).  Each
//      warp first takes delta for its 16 rows from dout and out (the
//      forward's output is kept by autograd anyway, for the proj weight
//      gradient) and writes it to the scratch; then it walks the key tiles
//      once, rebuilds P exactly from the forward's lse, forms ds and adds
//      ds~ k into its dq accumulators.
//   2. dk/dv kernel, one block per 128 keys.  It walks the query tiles,
//      computes S^T = k q^T and dp^T = v dout^T directly with keys as rows,
//      rebuilds P^T and ds^T from lse and delta, and adds P~^T dout and
//      ds~^T q into register accumulators.
// With lse saved there is no statistics pass: 14*T^2*d flops in all (two
// rebuilt products), against the 18 of the packed-attention backward, which
// saves no statistics.  The tile code is the packed-attention kernels'
// (packed_attention.cuh, mma_tiles.cuh): tiles of the walked axis arrive by
// cp.async into two buffers, the next under the products of the current one;
// bf16 products run mma.sync with fp32 sums, P and ds rounded to bf16 as the
// A operand of the second products straight from the accumulator registers;
// fp32 runs the same tiles on the CUDA cores.  Keys past T are zero padding
// masked to -inf; query rows past T are staged as zeros with lse = +inf, so
// they add nothing to dk or dv.

#include "packed_attention.cuh"

namespace {

template <typename T, int D>
struct Tiles {
  static constexpr int LDD = D + TilePad<T>::value;  // [token][d] tiles
  static constexpr int kOwn = kRows * LDD;            // elements of one [128][d] tile
  static constexpr int kWalk = kCols * LDD;           // elements of one [64][d] tile
  // one 16 x 64 strip per warp, fp32 only (bf16 feeds the second product
  // from registers)
  static constexpr int kStrips = kWarps * 16 * StripElems<T>::per_row;
  // dq kernel: q, dout; two buffers of (k, v); the ds strips
  static constexpr size_t dq_bytes = (2 * kOwn + 4 * kWalk + kStrips) * sizeof(T);
  // dk/dv kernel: k, v; two buffers of (q, dout); the strips (P^T, then
  // ds^T); two buffers of the query tile's lse and delta
  static constexpr size_t dkv_bytes =
      (2 * kOwn + 4 * kWalk + kStrips) * sizeof(T) + 4 * kCols * sizeof(float);
};

// sum over d/2 columns of x * y, two rows of d values read with 16-byte loads
template <typename T, int N>
__device__ __forceinline__ float dot_cols(const T* __restrict__ x, const T* __restrict__ y) {
  constexpr int VEC = 16 / sizeof(T);
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < N / VEC; ++v) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + v);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(y) + v);
    const T* ea = reinterpret_cast<const T*>(&a);
    const T* eb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc = fmaf(to_f32(ea[e]), to_f32(eb[e]), acc);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// 1. delta and dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq(const T* __restrict__ qkv, const T* __restrict__ out,
                       const T* __restrict__ dout, const float* __restrict__ lse_in,
                       T* __restrict__ dqkv, float* __restrict__ delta_out, int Tn, int C, int H,
                       float scale, int n_qt) {
  using S = Tiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + S::kOwn;
  T* skv = sdo + S::kOwn;       // two buffers of k [kCols][LDD], v [kCols][LDD]
  T* sds = skv + 4 * S::kWalk;  // fp32 only: [kWarps][16][per_row]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % H;
  const int b = blockIdx.x / (n_qt * H);
  const int q0 = qt * kRows;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * Tn * c3 + h * D;
  const T* dbase = dout + static_cast<size_t>(b) * Tn * C + h * D;
  const T* obase = out + static_cast<size_t>(b) * Tn * C + h * D;
  const size_t stat_row = (static_cast<size_t>(b) * H + h) * Tn;

  // fetches the (k, v) tile at key k0 into buffer ``buf``, to land under the
  // products of the tile before it
  auto fetch_kv = [&](int buf, int k0) {
    T* nk = skv + buf * 2 * S::kWalk;
    stage_tile_async<T, kCols, D, kThreads>(nk, base + C, c3, k0, Tn, tid);
    stage_tile_async<T, kCols, D, kThreads>(nk + S::kWalk, base + 2 * C, c3, k0, Tn, tid);
    cp_async_commit();
  };
  stage_tile_async<T, kRows, D, kThreads>(sq, base, c3, q0, Tn, tid);
  stage_tile_async<T, kRows, D, kThreads>(sdo, dbase, C, q0, Tn, tid);
  fetch_kv(0, 0);

  // delta for the warp's 16 rows while the tiles land: lanes 2i and 2i + 1
  // take half of row i's columns each
  float delta0, delta1;
  {
    const int r = q0 + warp * 16 + (lane >> 1);
    const int c0 = (lane & 1) * (D / 2);
    float part = 0.f;
    if (r < Tn) {
      const size_t off = static_cast<size_t>(r) * C + c0;
      part = dot_cols<T, D / 2>(dbase + off, obase + off);
    }
    const float full = part + __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0 && r < Tn) delta_out[stat_row + r] = full;
    delta0 = __shfl_sync(0xffffffffu, full, 2 * g);       // row g of the warp
    delta1 = __shfl_sync(0xffffffffu, full, 2 * g + 16);  // row g + 8
  }
  const int r0 = q0 + warp * 16 + g;
  // a query past T: P = exp(. - inf) = 0, so its row adds nothing
  const float lse0 = r0 < Tn ? __ldg(lse_in + stat_row + r0) : INFINITY;
  const float lse1 = r0 + 8 < Tn ? __ldg(lse_in + stat_row + r0 + 8) : INFINITY;

  const T* sq_w = sq + warp * 16 * S::LDD;
  const T* sdo_w = sdo + warp * 16 * S::LDD;
  T* sds_w = sds + warp * 16 * StripElems<T>::per_row;
  const int n_kt = (Tn + kCols - 1) / kCols;
  const bool active = q0 + warp * 16 < Tn;  // a warp whose 16 queries all lie past T only stages

  float dq[1][D / 8][4];
  zero_acc<D / 8>(dq[0]);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kCols;
    const T* sk = skv + (kt & 1) * 2 * S::kWalk;
    const T* sv = sk + S::kWalk;
    // this tile has landed and the other buffer's products are done
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kt) fetch_kv((kt + 1) & 1, k0 + kCols);
    if (!active) continue;
    float s[1][8][4], dp[8][4];
    zero_acc<8>(s[0]);
    zero_acc<8>(dp);
    mma_nt<8, D>(s[0], sq_w, S::LDD, sk, S::LDD, g, tg);
    mma_nt<8, D>(dp, sdo_w, S::LDD, sv, S::LDD, g, tg);
    to_logits<false>(s[0], nullptr, nullptr, Tn, scale, r0, k0, tg, k0 + kCols <= Tn);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // s becomes ds
      s[0][n][0] = soft_exp<T>(s[0][n][0] - lse0) * (dp[n][0] - delta0);
      s[0][n][1] = soft_exp<T>(s[0][n][1] - lse0) * (dp[n][1] - delta0);
      s[0][n][2] = soft_exp<T>(s[0][n][2] - lse1) * (dp[n][2] - delta1);
      s[0][n][3] = soft_exp<T>(s[0][n][3] - lse1) * (dp[n][3] - delta1);
    }
    mma_from_acc<1, D / 8>(dq, s, sds_w, StripElems<T>::per_row, sk, S::LDD, g, tg);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < Tn) {
      T* dst = dqkv + (static_cast<size_t>(b) * Tn + r) * c3 + h * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store_pair(dst + dn * 8 + tg * 2, dq[0][dn][half * 2] * scale,
                   dq[0][dn][half * 2 + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv(const T* __restrict__ qkv, const T* __restrict__ dout,
                        const float* __restrict__ lse_in, const float* __restrict__ delta_in,
                        T* __restrict__ dqkv, int Tn, int C, int H, float scale, int n_rt) {
  using S = Tiles<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + S::kOwn;
  T* sqdo = sv + S::kOwn;        // two buffers of q [kCols][LDD], dout [kCols][LDD]
  T* sst = sqdo + 4 * S::kWalk;  // fp32 only: [kWarps][16][per_row], P~^T then ds~^T
  float* sstat = reinterpret_cast<float*>(sst + S::kStrips);  // two buffers of lse, delta [kCols]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int kt = blockIdx.x % n_rt;
  const int h = (blockIdx.x / n_rt) % H;
  const int b = blockIdx.x / (n_rt * H);
  const int k0 = kt * kRows;
  const size_t c3 = 3 * static_cast<size_t>(C);
  const T* base = qkv + static_cast<size_t>(b) * Tn * c3 + h * D;
  const T* dbase = dout + static_cast<size_t>(b) * Tn * C + h * D;
  const size_t stat_row = (static_cast<size_t>(b) * H + h) * Tn;

  // fetches the (q, dout) tile at query q0 and its row statistics into
  // buffer ``buf``, to land under the products of the tile before it
  auto fetch_qdo = [&](int buf, int q0) {
    T* nq = sqdo + buf * 2 * S::kWalk;
    stage_tile_async<T, kCols, D, kThreads>(nq, base, c3, q0, Tn, tid);
    stage_tile_async<T, kCols, D, kThreads>(nq + S::kWalk, dbase, C, q0, Tn, tid);
    cp_async_commit();
    if (tid < kCols) {
      const int i = q0 + tid;
      // a query past T: P = exp(. - inf) = 0
      sstat[buf * 2 * kCols + tid] = i < Tn ? lse_in[stat_row + i] : INFINITY;
      sstat[buf * 2 * kCols + kCols + tid] = i < Tn ? delta_in[stat_row + i] : 0.f;
    }
  };
  stage_tile_async<T, kRows, D, kThreads>(sk, base + C, c3, k0, Tn, tid);
  stage_tile_async<T, kRows, D, kThreads>(sv, base + 2 * C, c3, k0, Tn, tid);
  fetch_qdo(0, 0);

  const T* sk_w = sk + warp * 16 * S::LDD;
  const T* sv_w = sv + warp * 16 * S::LDD;
  T* sst_w = sst + warp * 16 * StripElems<T>::per_row;
  const int r0 = k0 + warp * 16 + g;  // this thread's first key
  float dk[1][D / 8][4], dv[1][D / 8][4];
  zero_acc<D / 8>(dk[0]);
  zero_acc<D / 8>(dv[0]);

  const bool keys_valid = k0 + (warp + 1) * 16 <= Tn;  // this warp's 16 keys
  const bool active = k0 + warp * 16 < Tn;  // a warp whose 16 keys all lie past T only stages
  const int n_qt = (Tn + kCols - 1) / kCols;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kCols;
    const T* sq = sqdo + (qt & 1) * 2 * S::kWalk;
    const T* sdo = sq + S::kWalk;
    const float* slse = sstat + (qt & 1) * 2 * kCols;
    const float* sdelta = slse + kCols;
    // this tile has landed and the other buffer's products are done
    cp_async_wait_all();
    __syncthreads();
    if (qt + 1 < n_qt) fetch_qdo((qt + 1) & 1, q0 + kCols);
    if (!active) continue;

    float st[1][8][4], dpt[1][8][4];  // S^T and dp^T: 16 keys x 64 queries
    zero_acc<8>(st[0]);
    zero_acc<8>(dpt[0]);
    mma_nt<8, D>(st[0], sk_w, S::LDD, sq, S::LDD, g, tg);
    mma_nt<8, D>(dpt[0], sv_w, S::LDD, sdo, S::LDD, g, tg);
    to_logits<true>(st[0], nullptr, nullptr, Tn, scale, r0, q0, tg, keys_valid);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // st becomes P^T, dpt becomes ds^T
      const int c = n * 8 + tg * 2;
      const float lse_a = slse[c], lse_b = slse[c + 1];
      const float del_a = sdelta[c], del_b = sdelta[c + 1];
      st[0][n][0] = soft_exp<T>(st[0][n][0] - lse_a);
      st[0][n][1] = soft_exp<T>(st[0][n][1] - lse_b);
      st[0][n][2] = soft_exp<T>(st[0][n][2] - lse_a);
      st[0][n][3] = soft_exp<T>(st[0][n][3] - lse_b);
      dpt[0][n][0] = st[0][n][0] * (dpt[0][n][0] - del_a);
      dpt[0][n][1] = st[0][n][1] * (dpt[0][n][1] - del_b);
      dpt[0][n][2] = st[0][n][2] * (dpt[0][n][2] - del_a);
      dpt[0][n][3] = st[0][n][3] * (dpt[0][n][3] - del_b);
    }
    mma_from_acc<1, D / 8>(dv, st, sst_w, StripElems<T>::per_row, sdo, S::LDD, g, tg);
    mma_from_acc<1, D / 8>(dk, dpt, sst_w, StripElems<T>::per_row, sq, S::LDD, g, tg);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < Tn) {
      T* dst = dqkv + (static_cast<size_t>(b) * Tn + r) * c3 + h * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store_pair(dst + C + dn * 8 + tg * 2, dk[0][dn][half * 2] * scale,
                   dk[0][dn][half * 2 + 1] * scale);
        store_pair(dst + 2 * C + dn * 8 + tg * 2, dv[0][dn][half * 2], dv[0][dn][half * 2 + 1]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* out, const void* dout, const float* lse,
                   void* dqkv, float* delta, int B, int Tn, int C, int H, float scale,
                   cudaStream_t stream) {
  using S = Tiles<T, D>;
  const T* qkv_t = static_cast<const T*>(qkv);
  const T* dout_t = static_cast<const T*>(dout);
  T* dqkv_t = static_cast<T*>(dqkv);
  const int n_rt = (Tn + kRows - 1) / kRows;  // 128-token tiles of the axis a block owns
  const unsigned blocks = static_cast<unsigned>(B) * H * n_rt;

  auto dq_kernel = flash_attention_bwd_dq<T, D>;
  cudaError_t err = emct_allow_smem(dq_kernel, S::dq_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<blocks, kThreads, S::dq_bytes, stream>>>(qkv_t, static_cast<const T*>(out), dout_t,
                                                       lse, dqkv_t, delta, Tn, C, H, scale, n_rt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv_kernel = flash_attention_bwd_dkv<T, D>;
  err = emct_allow_smem(dkv_kernel, S::dkv_bytes);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<blocks, kThreads, S::dkv_bytes, stream>>>(qkv_t, dout_t, lse, delta, dqkv_t, Tn, C,
                                                         H, scale, n_rt);
  return cudaGetLastError();
}

}  // namespace

// qkv, dqkv [B, T, 3C], out and dout [B, T, C] (dtype); lse [B, H, T] f32
// from the forward; delta: B*H*T f32 scratch.  Requires C / H in {32, 64};
// the Python wrapper checks shapes, contiguity and alignment first.
extern "C" int flash_attention_bwd(const void* qkv, const void* out, const void* dout,
                                   const void* lse, void* dqkv, void* delta, int B, int Tn, int C,
                                   int H, float scale, int dtype, void* stream) {
  if (B < 1 || Tn < 1 || H < 1 || C % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int d = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
#define EMCT_LAUNCH(TYPE, DIM) \
  err = launch<TYPE, DIM>(qkv, out, dout, lse_f, dqkv, delta_f, B, Tn, C, H, scale, s)
  if (dtype == EMCT_DTYPE_BF16 && d == 64) {
    EMCT_LAUNCH(__nv_bfloat16, 64);
  } else if (dtype == EMCT_DTYPE_BF16 && d == 32) {
    EMCT_LAUNCH(__nv_bfloat16, 32);
  } else if (dtype == EMCT_DTYPE_F32 && d == 64) {
    EMCT_LAUNCH(float, 64);
  } else if (dtype == EMCT_DTYPE_F32 && d == 32) {
    EMCT_LAUNCH(float, 32);
  }
#undef EMCT_LAUNCH
  return static_cast<int>(err);
}
