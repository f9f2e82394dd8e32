// Fused Graph Polynomial Fusion, backward: the analytic VJP.
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/gpf.py, _gpf_bwd_kernel (the VJP
//   of fused_gpf_pallas).
//
// Per batch element, from tokens X_a, X_p [N, D], coeffs c [P+1, Q+1] and the
// output cotangent g [N, N] (fp32 inside):
//   R_a, R_p      the two Grams, recomputed (cosine: rows over max(|x|, eps))
//   A_k(R)        = R * max(R, 0)^(k-1), A_0 = 1;  A'_k = k * max(R, 0)^(k-1)
//   F             = sum_pq c[p,q] A_p(R_a) A_q(R_p), symmetrized if asked
//   df            = g * [F > 0], symmetrized if asked
//   dR_a          = df * sum_pq c[p,q] A'_p(R_a) A_q(R_p)      (dR_p alike)
//   dc[p,q]       = sum(df * A_p(R_a) * A_q(R_p))              -> dc [B, P+1, Q+1]
//   dX            = (dR + dR^T) X,  then the cosine normalization's backward
//                   with its |x| > eps gate                    -> dta, dtp [B, N, D]
// The caller sums dc over the batch.
//
// What bounds it on an H100.  One batch element reads 2*N*D token values and
// N*N fp32 cotangents and writes 2*N*D values; two Grams and two [N,N] x
// [N,D] products are 8*N*N*D flops, about N flops per byte of bf16: memory
// bounds a Swin's 49 tokens and a ViT's 196, the tensor cores 784 and 1024
// (0.56 ms at [64, 1024, 1024] x2 and 989 TFLOP/s).  So in bf16 every
// product runs on wgmma (the split dX issues 12 N^2 D flops, not 8).
//
// Design.  The TPU kernel holds six [N, N] work tiles of one batch element on
// chip; at a ViT's 196 tokens that is past one block, and dX needs a sum over
// all N columns of a row before it can be written.  Two kernels, every sum
// inside a block or over ordered partials (no float atomics):
//   1. w kernel, one block per (batch element, 64 x 64 tile): rebuilds its
//      tile of both Grams like the forward, evaluates the polynomial and its
//      derivatives entry by entry, and writes the factor W = S / (m m^T) of
//      each token set to a scratch, with S = dR + dR^T and m the clamped norms
//      (1 for dot).  Because R_a, R_p and F are symmetric, S_ij = (g_ij + g_ji)
//      [F_ij > 0] poly'_ij with or without the symmetrization flag, so a block
//      needs its own tile and the mirrored tile of g and no second pass; both
//      come in coalesced rows through shared memory.  It also writes the
//      tile's part of proj_i = sum_j S_ij R_ij (the cosine backward's row
//      reduction) and of dc.  fp32 tokens: the Grams on the CUDA cores, W in
//      fp32, [B, 2, N, N].  bf16 tokens: the Grams on the tensor cores through
//      wgmma with TMA (gpf_bwd_w_sm90, the same sums as mma.sync), W split in
//      two bf16 terms, W_hi = bf16(W) and W_lo = bf16(W - W_hi), [B, 2, N,
//      pitch] each (pitch = N rounded up to a multiple of 8, for the TMA maps'
//      16-byte row rule): the same 4 bytes an entry.
//   2. dx kernel: dX = W X, then the folded cosine term dx_i -= gate_i proj_i
//      / m_i^2 x_i with proj_i summed over the column tiles in order; its
//      first block per batch element adds the dc partials in order.  bf16:
//      gpf_bwd_sm90.cuh, W_hi X + W_lo X on the tensor cores through wgmma
//      (one bf16 W would cost the gradient three digits; the two terms carry
//      W to ~2^-16).  fp32: gpf_bwd_fp32.cuh, on the CUDA cores.
// The scratch costs 2*N*N*4 bytes written and read per batch element on top
// of the bytes above.  When both token pointers are the same tensor its Gram
// is built once, and the two gradients are still written apart: the caller
// (autograd) adds them.

#include "gpf_bwd_fp32.cuh"
#include "gpf_bwd_sm90.cuh"
#include "gpf_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. the [N, N] factors
// ---------------------------------------------------------------------------

// W entries (i, j) and (i, j + 1) of both token sets (j even, j < N; the
// second is 0 when j + 1 = N).  fp32: W [B, 2, N, N].  bf16: W_hi [B, 2, N,
// pitch], then W_lo [B, 2, N, pitch], W_hi = bf16(W), W_lo = bf16(W - W_hi).
template <typename T>
__device__ __forceinline__ void store_w(void* wmat, int b, int B, int N, int pitch, int i, int j,
                                        float wa0, float wa1, float wp0, float wp1);

template <>
__device__ __forceinline__ void store_w<float>(void* wmat, int b, int B, int N, int pitch, int i,
                                               int j, float wa0, float wa1, float wp0,
                                               float wp1) {
  float* wa = static_cast<float*>(wmat) + (static_cast<size_t>(b) * 2 * N + i) * N + j;
  float* wp = wa + static_cast<size_t>(N) * N;
  wa[0] = wa0;
  wp[0] = wp0;
  if (j + 1 < N) {
    wa[1] = wa1;
    wp[1] = wp1;
  }
}

__device__ __forceinline__ void store_split(__nv_bfloat16* hi, __nv_bfloat16* lo, float w0,
                                            float w1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(w0 - hf.x, w1 - hf.y);
}

template <>
__device__ __forceinline__ void store_w<__nv_bfloat16>(void* wmat, int b, int B, int N, int pitch,
                                                       int i, int j, float wa0, float wa1,
                                                       float wp0, float wp1) {
  const size_t plane = static_cast<size_t>(N) * pitch;
  __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(wmat) + (static_cast<size_t>(b) * 2 * N + i) * pitch + j;
  __nv_bfloat16* lo = hi + static_cast<size_t>(B) * 2 * plane;
  store_split(hi, lo, wa0, wa1);
  store_split(hi + plane, lo + plane, wp0, wp1);
}

// The part of a w kernel after its Gram tiles, shared by the fp32 kernel
// below and the bf16 one (gpf_bwd_w_sm90): the clamped norms, the cotangent
// tiles, the per-entry polynomial, W, and the tile's proj and dc partials,
// each in the same order whichever kernel built the Gram.  acc_a / acc_p:
// this thread's entries of the two Gram tiles in the mma_nt layout (warp w
// of the block's first four: rows 16w + g and 16w + g + 8); nsq_a / nsq_p:
// the squared norms of row token tid (tid < 64) or column token tid - 64;
// gsm: 4 * 64 * 65 floats of shared memory the Gram no longer needs; sync():
// a barrier of the block's 128 threads that run this.
template <typename T, typename Sync>
__device__ __forceinline__ void w_finish(const float (*acc_a)[4], const float (*acc_p)[4],
                                         float nsq_a, float nsq_p, const float* sc, float* gsm,
                                         const float* __restrict__ gout, void* __restrict__ wmat,
                                         int pitch, float* __restrict__ proj_part,
                                         float* __restrict__ norms, float* __restrict__ dc_part,
                                         int N, int P, int Q, int cosine, float eps,
                                         int symmetric, int same, Sync sync) {
  __shared__ float m_a[2 * kTile], m_p[2 * kTile];  // clamped norms: rows, then columns
  __shared__ float red[kWarps][kMaxCoef];
  const int b = blockIdx.z;
  const int it = blockIdx.y;
  const int jt = blockIdx.x;
  const int tiles = gridDim.x;
  const int i0 = it * kTile;
  const int j0 = jt * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;

  const float norm_a = sqrtf(nsq_a);
  const float norm_p = sqrtf(same ? nsq_a : nsq_p);
  m_a[tid] = cosine ? fmaxf(norm_a, eps) : 1.f;
  m_p[tid] = cosine ? fmaxf(norm_p, eps) : 1.f;
  // norms[b][set][0: clamped norm, 1: gate][N], written once per row tile
  if (jt == 0 && tid < kTile && i0 + tid < N) {
    float* nb = norms + static_cast<size_t>(b) * 4 * N;
    nb[0 * N + i0 + tid] = m_a[tid];
    nb[1 * N + i0 + tid] = (!cosine || norm_a > eps) ? 1.f : 0.f;
    nb[2 * N + i0 + tid] = m_p[tid];
    nb[3 * N + i0 + tid] = (!cosine || norm_p > eps) ? 1.f : 0.f;
  }
  sync();

  // the cotangent's tile g[i0.., j0..] and its mirror g[j0.., i0..], each read
  // in coalesced rows, and the Gram tiles, into shared memory the Gram no
  // longer needs: the entries below walk them in a loop, whose one copy of
  // the per-entry code stays in the instruction cache (32 unrolled copies
  // did not)
  constexpr int LG = kTile + 1;
  float* g_ij = gsm;
  float* g_ji = g_ij + kTile * LG;
  float* r_a = g_ji + kTile * LG;
  float* r_p = same ? r_a : r_a + kTile * LG;
  const float* gb = gout + static_cast<size_t>(b) * N * N;
#pragma unroll 8
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile;
    const int c = e % kTile;
    g_ij[r * LG + c] = (i0 + r < N && j0 + c < N) ? gb[static_cast<size_t>(i0 + r) * N + j0 + c] : 0.f;
    g_ji[r * LG + c] = (j0 + r < N && i0 + c < N) ? gb[static_cast<size_t>(j0 + r) * N + i0 + c] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (warp * 16 + g + (e >> 1) * 8) * LG + n * 8 + tg * 2 + (e & 1);
      r_a[at] = acc_a[n][e];
      if (!same) r_p[at] = acc_p[n][e];
    }
  }
  sync();

  float dc_acc[kMaxCoef], cf[kMaxCoef];
#pragma unroll
  for (int k = 0; k < kMaxCoef; ++k) {
    dc_acc[k] = 0.f;
    cf[k] = sc[k];
  }
  float proj_a0 = 0.f, proj_a1 = 0.f, proj_p0 = 0.f, proj_p1 = 0.f;  // rows g and g + 8

  // this thread's entries in the mma_nt order, n then e, a pair of
  // neighbouring columns at a time (their chains interleave; their sums into
  // dc and proj stay in order)
#pragma unroll 1
  for (int k = 0; k < 16; ++k) {
    const int n = k >> 1;
    const int half = k & 1;
    const int li = warp * 16 + g + half * 8;
    const int i = i0 + li;
    float w_a[2], w_p[2];  // 0 past N
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int lj = n * 8 + tg * 2 + e;
      const int j = j0 + lj;
      w_a[e] = 0.f;
      w_p[e] = 0.f;
      if (i < N && j < N) {
        // dot: m = 1, and x / 1 = x exactly
        const float mm_a = m_a[li] * m_a[kTile + lj];
        const float mmp = m_p[li] * m_p[kTile + lj];
        const float ra = cosine ? r_a[li * LG + lj] / mm_a : r_a[li * LG + lj];
        const float rp = cosine ? r_p[li * LG + lj] / mmp : r_p[li * LG + lj];
        float av[kMaxDeg + 1], ag[kMaxDeg + 1], bv[kMaxDeg + 1], bg[kMaxDeg + 1];
        powers(ra, av, ag);
        powers(rp, bv, bg);
        float fused = 0.f, da = 0.f, dp = 0.f;
#pragma unroll
        for (int p = 0; p <= kMaxDeg; ++p) {
#pragma unroll
          for (int q = 0; q <= kMaxDeg; ++q) {
            // unused degrees are skipped, not multiplied by zero: their powers may overflow
            if (p <= P && q <= Q) {
              const float c = cf[p * (kMaxDeg + 1) + q];
              fused = fmaf(c, av[p] * bv[q], fused);
              da = fmaf(c, ag[p] * bv[q], da);
              dp = fmaf(c, av[p] * bg[q], dp);
            }
          }
        }
        const float gij = g_ij[li * LG + lj];
        const float gji = g_ji[lj * LG + li];
        const bool pos = fused > 0.f;
        const float gs = pos ? gij + gji : 0.f;
        const float df = symmetric ? 0.5f * gs : (pos ? gij : 0.f);
#pragma unroll
        for (int p = 0; p <= kMaxDeg; ++p) {
#pragma unroll
          for (int q = 0; q <= kMaxDeg; ++q) {
            if (p <= P && q <= Q) {
              dc_acc[p * (kMaxDeg + 1) + q] = fmaf(df, av[p] * bv[q], dc_acc[p * (kMaxDeg + 1) + q]);
            }
          }
        }
        const float s_a = gs * da;
        const float s_p = gs * dp;
        w_a[e] = cosine ? s_a / mm_a : s_a;
        w_p[e] = cosine ? s_p / mmp : s_p;
        // proj of row half, kept in registers (a runtime index would not be)
        const float pa = fmaf(s_a, ra, half ? proj_a1 : proj_a0);
        const float pp = fmaf(s_p, rp, half ? proj_p1 : proj_p0);
        if (half) {
          proj_a1 = pa;
          proj_p1 = pp;
        } else {
          proj_a0 = pa;
          proj_p0 = pp;
        }
      }
    }
    const int j = j0 + n * 8 + tg * 2;
    if (i < N && j < N) store_w<T>(wmat, b, gridDim.z, N, pitch, i, j, w_a[0], w_a[1], w_p[0], w_p[1]);
  }
  const float proj_a[2] = {proj_a0, proj_a1}, proj_p[2] = {proj_p0, proj_p1};

  // proj_part[b][set][jt][N]: this tile's share of each row's reduction
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float pa = quad_sum(proj_a[half]);
    const float pp = quad_sum(proj_p[half]);
    const int i = i0 + warp * 16 + g + half * 8;
    if (tg == 0 && i < N) {
      float* pb = proj_part + static_cast<size_t>(b) * 2 * tiles * N;
      pb[static_cast<size_t>(jt) * N + i] = pa;
      pb[(static_cast<size_t>(tiles) + jt) * N + i] = pp;
    }
  }

  // dc_part[b][tile][kMaxCoef]
#pragma unroll
  for (int k = 0; k < kMaxCoef; ++k) {
    const float v = warp_sum(dc_acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  sync();
  if (tid < kMaxCoef) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi][tid];
    dc_part[(static_cast<size_t>(b) * tiles * tiles + it * tiles + jt) * kMaxCoef + tid] = v;
  }
}

// fp32 tokens: the Gram tiles on the CUDA cores (gpf_tiles.cuh), W in fp32.
__global__ void __launch_bounds__(kThreads)
gpf_bwd_w_kernel(const float* __restrict__ ta, const float* __restrict__ tp,
                 const float* __restrict__ coeffs, const float* __restrict__ gout,
                 float* __restrict__ wmat, float* __restrict__ proj_part,
                 float* __restrict__ norms, float* __restrict__ dc_part, int N, int D, int P,
                 int Q, int cosine, float eps, int symmetric, int same, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* panels = reinterpret_cast<float*>(smem_raw);
  __shared__ float sc[kMaxCoef];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const float* xa = ta + static_cast<size_t>(b) * N * D;
  const float* xp = tp + static_cast<size_t>(b) * N * D;

  if (tid < kMaxCoef) {
    const int p = tid / (kMaxDeg + 1);
    const int q = tid % (kMaxDeg + 1);
    sc[tid] = (p <= P && q <= Q) ? coeffs[p * (Q + 1) + q] : 0.f;
  }

  float acc_a[8][4], acc_p[8][4], nsq_a, nsq_p;
  gram_tiles<float>(xa, xp, N, D, i0, j0, same != 0, vec_ok != 0, panels, acc_a, acc_p, nsq_a,
                    nsq_p);
  w_finish<float>(acc_a, acc_p, nsq_a, nsq_p, sc, panels, gout, wmat, N, proj_part, norms,
                  dc_part, N, P, Q, cosine, eps, symmetric, same, [] { __syncthreads(); });
}

// bf16 tokens: the Gram tiles on the tensor cores through wgmma, fed by TMA.
// One consumer warpgroup computes the block's 64 x 64 tile of each Gram
// (m64n64k16, the contraction over the features in stages of 64: the row and
// column token tiles of each set, four [64][64] boxes at the 128-byte swizzle
// a stage, both read K-major), and one producer warp keeps the ring full.
// wgmma m64n64 leaves warp w of the warpgroup rows 16w + g and 16w + g + 8,
// columns 8n + 2 tg + {0, 1}: the mma_nt layout, so each thread holds the
// entries it held when the tile was built with mma.sync, and each k16 step's
// fp32 sum is the same (as the attention forward's scores are), so the Grams,
// and everything w_finish derives from them, keep their bits.  The
// squared norms are summed from the same stage tiles while the products run,
// in the same order.  Token rows that break TMA's 16-byte rule are staged by
// the producer's 32 lanes into the same swizzled layout.  Two blocks an SM.
namespace w_sm90 {

using namespace sm90;

constexpr int kConsumers = 128;
constexpr int kBlockThreads = kConsumers + 32;
constexpr int kStages = 3;
constexpr int kBox = 64 * 64 * 2;           // one [64 tokens][64 features] box
constexpr int kStageBytes = 4 * kBox;       // row and column tiles of both sets
constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kStageBytes) * kStages + 16 * kStages;

__global__ void __launch_bounds__(kBlockThreads, 2)
gpf_bwd_w_sm90(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_p,
               const bf16* __restrict__ ta, const bf16* __restrict__ tp,
               const float* __restrict__ coeffs, const float* __restrict__ gout,
               bf16* __restrict__ wmat, int pitch, float* __restrict__ proj_part,
               float* __restrict__ norms, float* __restrict__ dc_part, int N, int D, int P, int Q,
               int cosine, float eps, int symmetric, int same, int x_tma) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float sc[kMaxCoef];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  auto tile = [&](int s, int k) { return reinterpret_cast<bf16*>(base + s * kStageBytes + k * kBox); };

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int n_k = (D + 63) / 64;
  if (tid < kMaxCoef) {
    const int p = tid / (kMaxDeg + 1);
    const int q = tid % (kMaxDeg + 1);
    sc[tid] = (p <= P && q <= Q) ? coeffs[p * (Q + 1) + q] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = same ? 2 : 4;  // anchor rows, anchor columns, positive rows, positive columns
  if (tid >= kConsumers) {  // the producer warp
    const int lane = tid - kConsumers;
    const bf16* xa = ta + static_cast<size_t>(b) * N * D;
    const bf16* xp = tp + static_cast<size_t>(b) * N * D;
    for (int kc = 0; kc < n_k; ++kc) {
      const int s = kc % kStages;
      bar_wait(empty + s, ((kc / kStages) & 1) ^ 1);
      if (x_tma) {
        if (lane == 0) {
          bar_arrive_tx(full + s, n_tiles * kBox);
          for (int k = 0; k < n_tiles; ++k) {
            tma_load(tile(s, k), k < 2 ? &tm_a : &tm_p, full + s, kc * 64, (k & 1) ? j0 : i0, b);
          }
        }
      } else {
        for (int k = 0; k < n_tiles; ++k) {
          gemm_sm90::stage_box(tile(s, k), k < 2 ? xa : xp, N, D, (k & 1) ? j0 : i0, kc * 64,
                               lane);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        __syncwarp();
        if (lane == 0) bar_arrive(full + s);
      }
    }
    return;
  }

  float acc_a[8][4], acc_p[8][4];
  zero_acc<8>(acc_a);
  zero_acc<8>(acc_p);
  float nsq_a = 0.f, nsq_p = 0.f;
  const int row = tid & (kTile - 1);
  const int own = tid < kTile ? 0 : 1;  // the row tile's token or the column tile's
  for (int kc = 0; kc < n_k; ++kc) {
    const int s = kc % kStages;
    bar_wait(full + s, (kc / kStages) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<64>::ss(&acc_a[0][0], desc_k<64>(tile(s, 0), ks), desc_k<64>(tile(s, 1), ks), 1);
    }
    if (!same) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wgmma<64>::ss(&acc_p[0][0], desc_k<64>(tile(s, 2), ks), desc_k<64>(tile(s, 3), ks), 1);
      }
    }
    wg_commit();
    // the squared norms under the products, features in order, 16 bytes (8
    // features) a load
    const unsigned char* na = reinterpret_cast<const unsigned char*>(tile(s, own)) + row * 128;
    const unsigned char* np = reinterpret_cast<const unsigned char*>(tile(s, 2 + own)) + row * 128;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int at = (cc ^ (row & 7)) * 16;
      const uint4 va = *reinterpret_cast<const uint4*>(na + at);
      const uint4 vp = same ? va : *reinterpret_cast<const uint4*>(np + at);
      const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
      const uint32_t wp[4] = {vp.x, vp.y, vp.z, vp.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[h]));
        nsq_a = fmaf(fa.x, fa.x, nsq_a);
        nsq_a = fmaf(fa.y, fa.y, nsq_a);
        if (!same) {
          const float2 fp = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wp[h]));
          nsq_p = fmaf(fp.x, fp.x, nsq_p);
          nsq_p = fmaf(fp.y, fp.y, nsq_p);
        }
      }
    }
    wg_wait<0>();
    fence_regs<32>(&acc_a[0][0]);
    fence_regs<32>(&acc_p[0][0]);
    bar_arrive(empty + s);
  }
  // the ring is spent once every consumer is past its first barrier there
  // (every copy consumed, every product done): its first 66 KB take the
  // cotangent and Gram tiles
  w_finish<bf16>(acc_a, acc_p, nsq_a, nsq_p, sc, reinterpret_cast<float*>(base), gout, wmat,
                 pitch, proj_part, norms, dc_part, N, P, Q, cosine, eps, symmetric, same,
                 [] { asm volatile("bar.sync 1, 128;\n" ::: "memory"); });
}

}  // namespace w_sm90

// ---------------------------------------------------------------------------
// 2. dX = W X and the folded cosine term: gpf_bwd_fp32.cuh, gpf_bwd_sm90.cuh
// ---------------------------------------------------------------------------

// The scratch, carved: W (fp32 [B,2,N,N], or bf16 W_hi then W_lo [B,2,N,pitch]:
// the same 4 bytes an entry), proj_part [B,2,tiles,N], norms [B,4,N],
// dc_part [B,tiles^2,16].
struct Scratch {
  void* w;
  float* proj_part;
  float* norms;
  float* dc_part;
  Scratch(float* base, int B, int N, int pitch, int tiles) {
    w = base;
    proj_part = base + static_cast<size_t>(B) * 2 * N * pitch;
    norms = proj_part + static_cast<size_t>(B) * 2 * tiles * N;
    dc_part = norms + static_cast<size_t>(B) * 4 * N;
  }
};

cudaError_t launch_f32(const void* ta, const void* tp, const void* coeffs, const void* g,
                       void* dta, void* dtp, void* dc, float* scratch, int B, int N, int D, int P,
                       int Q, int cosine, float eps, int symmetric, cudaStream_t stream) {
  const int tiles = (N + kTile - 1) / kTile;
  const Scratch sc(scratch, B, N, N, tiles);
  const size_t smem = 4 * static_cast<size_t>(GramSmem<float>::kPanel) * sizeof(float);
  cudaError_t err = emct_allow_smem(gpf_bwd_w_kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec_ok = (D % 4 == 0 && reinterpret_cast<uintptr_t>(ta) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(tp) % 16 == 0)
                         ? 1
                         : 0;
  gpf_bwd_w_kernel<<<dim3(tiles, tiles, B), kThreads, smem, stream>>>(
      static_cast<const float*>(ta), static_cast<const float*>(tp),
      static_cast<const float*>(coeffs), static_cast<const float*>(g),
      static_cast<float*>(sc.w), sc.proj_part, sc.norms, sc.dc_part, N, D, P, Q, cosine, eps,
      symmetric, ta == tp ? 1 : 0, vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gpf_fp32::dx_kernel<<<dim3((D + kTile - 1) / kTile, tiles, B), kThreads, 0, stream>>>(
      static_cast<const float*>(ta), static_cast<const float*>(tp),
      static_cast<const float*>(sc.w), sc.proj_part, sc.norms, sc.dc_part,
      static_cast<float*>(dta), static_cast<float*>(dtp), static_cast<float*>(dc), N, D, P, Q,
      cosine, tiles);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* ta, const void* tp, const void* coeffs, const void* g,
                        void* dta, void* dtp, void* dc, float* scratch, int B, int N, int D,
                        int P, int Q, int cosine, float eps, int symmetric, int pitch, int stages,
                        size_t smem, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (pitch != (N + 7) / 8 * 8) return cudaErrorInvalidValue;
  const int tiles = (N + kTile - 1) / kTile;
  const Scratch sc(scratch, B, N, pitch, tiles);
  const bf16* xa = static_cast<const bf16*>(ta);
  const bf16* xp = static_cast<const bf16*>(tp);
  // the token tensor maps, shared by both kernels; rows that break TMA's
  // 16-byte rule are staged by hand
  const bool x_tma = D % 8 == 0 && reinterpret_cast<uintptr_t>(ta) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(tp) % 16 == 0;
  CUtensorMap tm_xa{}, tm_xp{};
  if (x_tma && (!gemm_sm90::encode_tiles(&tm_xa, ta, D, N, B, D, 64) ||
                !gemm_sm90::encode_tiles(&tm_xp, tp, D, N, B, D, 64))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = emct_allow_smem(w_sm90::gpf_bwd_w_sm90, w_sm90::kSmemBytes);
  if (err != cudaSuccess) return err;
  bf16* whi = static_cast<bf16*>(sc.w);
  w_sm90::gpf_bwd_w_sm90<<<dim3(tiles, tiles, B), w_sm90::kBlockThreads, w_sm90::kSmemBytes,
                           stream>>>(
      tm_xa, tm_xp, xa, xp, static_cast<const float*>(coeffs), static_cast<const float*>(g), whi,
      pitch, sc.proj_part, sc.norms, sc.dc_part, N, D, P, Q, cosine, eps, symmetric,
      ta == tp ? 1 : 0, x_tma ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const gpf_sm90::Params p{xa, xp, sc.proj_part, sc.norms, sc.dc_part, static_cast<bf16*>(dta),
                           static_cast<bf16*>(dtp), static_cast<float*>(dc), N, D, P, Q, cosine,
                           tiles, x_tma ? 1 : 0};
  return gpf_sm90::launch(p, tm_xa, tm_xp, whi, whi + static_cast<size_t>(B) * 2 * N * pitch, B,
                          pitch, stages, smem, stream);
}

}  // namespace

// tokens_a, tokens_p, dta, dtp [B, N, D] (dtype); coeffs [P+1, Q+1] f32;
// g [B, N, N] f32; dc [B, P+1, Q+1] f32; scratch: f32, at least
// B * (2*N*pitch + 2*tiles*N + 4*N + 16*tiles*tiles) values with
// tiles = ceil(N / 64).  The geometry comes from the Python wrapper
// (kernels/gpf.py:bwd_geometry) and is checked: fp32 pitch = N (stages and
// smem unused); bf16 pitch = N rounded up to a multiple of 8, and the dX
// kernel's stages and shared memory.  Requires P, Q <= 3; the wrapper checks
// shapes first.  dta and dtp must be two buffers even when tokens_a and
// tokens_p are one.
extern "C" int gpf_bwd(const void* tokens_a, const void* tokens_p, const void* coeffs,
                       const void* g, void* dta, void* dtp, void* dc, void* scratch, int B, int N,
                       int D, int P, int Q, int cosine, float eps, int symmetric, int dtype,
                       int pitch, int stages, long long smem, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || D < 1 || P < 0 || Q < 0 || P > kMaxDeg || Q > kMaxDeg ||
      dta == dtp || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch_f = static_cast<float*>(scratch);
  cudaError_t err;
  if (dtype == EMCT_DTYPE_F32) {
    err = pitch != N ? cudaErrorInvalidValue
                     : launch_f32(tokens_a, tokens_p, coeffs, g, dta, dtp, dc, scratch_f, B, N, D,
                                  P, Q, cosine, eps, symmetric, s);
  } else if (dtype == EMCT_DTYPE_BF16) {
    err = launch_bf16(tokens_a, tokens_p, coeffs, g, dta, dtp, dc, scratch_f, B, N, D, P, Q,
                      cosine, eps, symmetric, pitch, stages, static_cast<size_t>(smem), s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
