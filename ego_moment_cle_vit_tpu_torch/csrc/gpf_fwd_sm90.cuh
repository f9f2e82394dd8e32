// The bf16 fused GPF forward on Hopper (sm_90a): kernel 2 (gpf_fwd.cu)
// launches it for bf16 tokens.
//
// Per batch element, from tokens X_a, X_p [N, D] bf16 and coeffs [P+1, Q+1]:
//   R = X X^T of each set (cosine: over the clamped row norms), then
//   out = max(0, sum_pq c[p, q] A_p(R_a) * A_q(R_p)), [N, N] fp32
// (see gpf_fwd.cu; the output is symmetric, so symmetrization is the
// identity).
//
// What bounds it on an H100.  At [64, 1600, 1536] one Gram is 2 N^2 D = 503
// Gflop over the batch, 0.51 ms at 989 TFLOP/s, against 0.29 ms of bytes
// (tokens in, the fp32 output out); its upper triangle is half the flops, so
// bytes and operations weigh about the same.  At a Swin's 49 tokens or a
// ViT's 196 the bytes bound it and a call is a few microseconds.
//
// What held the mma.sync kernel it replaces at 64 TFLOP/s there: (a) its
// products ran on mma.sync from panels that every thread copied with
// cp.async, not on wgmma from a TMA ring; (b) it built both triangles of a
// symmetric output, twice the Gram work and twice the tiles; (c) its 64 x 64
// tiles re-read each token panel N / 64 times.
//
// Design.  Blocks own only tiles (it, jt) with it <= jt, row-major over the
// upper triangle (gpf.py:fwd_tile_pairs is the same walk): a block writes its
// tile and, off the diagonal, the mirrored tile, so each entry is built once
// and each output byte written once.  A tile is kTile = 64 WG tokens square:
// WG consumer warpgroups each own 64 rows and keep one m64n(kTile) Gram
// accumulator per token set; a producer warp keeps a ring of ``stages``
// stages full, a stage being the 64 features of the row and the column token
// tiles of each set, [kTile][64] TMA boxes at the 128-byte swizzle read
// K-major by wgmma (token rows that break TMA's 16-byte rule are staged by
// the producer's lanes into the same layout, gemm_sm90::stage_box).  WG = 2
// (128-token tiles) past 256 tokens: m64n128 holds 64 fp32 a thread a set,
// two sets 128, the most that fits beside the epilogue's registers.  A
// 256-token tile would need m64n256 accumulators, 128 registers a set: two
// sets (training) would need 256 and spill, and one set four warpgroups (one
// block an SM, nothing to run under its epilogue).  WG = 1 (64-token tiles)
// up to 256 tokens, where 128-token tiles would leave most SMs idle (a ViT's
// 196 tokens: 3 tiles a batch element against 10).
//
// Bits.  wgmma's k16 sums are mma.sync's (gpf_bwd.cu's w kernel holds the
// same), the squared norms are summed from the stage tiles feature by
// feature in order as the old kernel did, and the epilogue repeats its
// per-entry arithmetic (norm products, division, the polynomial's loop), so
// each entry is meant to keep its bits; both Grams are symmetric entry for
// entry (each sum takes the same products in the same order), so the
// mirrored entry is the one the old kernel computed at (j, i).
//
// Epilogue.  Once every consumer is past the last stage, the ring takes the
// Gram tiles in fp32 ([kTile][kTile + 1] a set); the polynomial runs entry by
// entry in a loop over them (one copy of its code), the tile going out row
// by row as it is made and, off the diagonal, its mirror column by column
// after: a warp's 32 lanes always store 32 neighbouring floats of one output
// row.  The loop was the kernel's largest cost at 1600 tokens (~150
// instructions an entry with the degrees read at run time and two IEEE
// divisions); the flagship's 2 x 2 degrees now unroll with the coefficients
// in registers, and dot Grams skip their exact division by 1.
#pragma once

#include "gemm_sm90.cuh"

namespace gpf_fwd90 {

using namespace sm90;

constexpr int kK = 64;  // features a stage: one 128-byte box row
constexpr int kMaxStages = 4;

template <int WG, bool kSame>
struct Shape {
  static constexpr int kTile = 64 * WG;              // output rows and columns a block
  static constexpr int kConsumers = 128 * WG;        // one warpgroup per 64 rows
  static constexpr int kThreads = kConsumers + 32;   // and a producer warp
  static constexpr int kSets = kSame ? 1 : 2;
  static constexpr int kTokBytes = kTile * kK * 2;   // one [kTile tokens][64 features] box
  static constexpr int kStageBytes = 2 * kSets * kTokBytes;  // row and column tokens a set
  static constexpr int kAcc = kTile / 2;             // fp32 accumulators a thread a set
  static constexpr int kLd = kTile + 1;              // row stride of the epilogue's tiles
  // blocks an SM: three 64-token tiles of one set, two of two sets (their
  // shared memory); two 128-token tiles of one set (<= 112 registers), one of
  // two (128 accumulators a thread)
  static constexpr int kMinBlocks = WG == 1 ? (kSame ? 3 : 2) : (kSame ? 2 : 1);
  // 1024 bytes of alignment slack, the stages, a full and an empty barrier a
  // stage.  kernels/gpf.py:fwd_geometry computes the same.
  static constexpr size_t bytes(int stages) {
    return 1024 + static_cast<size_t>(kStageBytes) * stages + 16 * static_cast<size_t>(stages);
  }
};

// m64n(64 WG)k16 from shared memory, both operands K-major, added to acc
template <int WG>
__device__ __forceinline__ void gram_step(float* acc, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void gram_step<1>(float* acc, uint64_t a, uint64_t b) {
  Wgmma<64>::ss(acc, a, b, 1);
}

template <>
__device__ __forceinline__ void gram_step<2>(float* acc, uint64_t a, uint64_t b) {
  Wgmma<128>::ss_t<0, 0>(acc, a, b, 1);
}

__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// sum_pq c[p, q] A_p(ra) A_q(rp), A_0 = 1, A_1 = r, A_k = A_(k-1) max(r, 0):
// the old kernel's loop, step for step.  Poly<P, Q> holds fixed degrees'
// coefficients in registers and unrolls; Poly<-1, -1> reads the degrees at
// run time and the coefficients from memory.  Both add the same products in
// the same order (a power of 1 is exact), so both give the same bits.
template <int kP, int kQ>
struct Poly {
  float c[kP + 1][kQ + 1];
  __device__ Poly(const float* __restrict__ coeffs, int, int) {
#pragma unroll
    for (int p = 0; p <= kP; ++p) {
#pragma unroll
      for (int q = 0; q <= kQ; ++q) c[p][q] = __ldg(coeffs + p * (kQ + 1) + q);
    }
  }
  __device__ __forceinline__ float operator()(float ra, float rp) const {
    const float rac = fmaxf(ra, 0.f);
    const float rpc = fmaxf(rp, 0.f);
    float fused = 0.f;
    float ra_pow = 1.f;
#pragma unroll
    for (int p = 0; p <= kP; ++p) {
      float rp_pow = 1.f;
#pragma unroll
      for (int q = 0; q <= kQ; ++q) {
        fused += c[p][q] * (ra_pow * rp_pow);
        rp_pow *= (q == 0 ? rp : rpc);
      }
      ra_pow *= (p == 0 ? ra : rac);
    }
    return fused;
  }
};

template <>
struct Poly<-1, -1> {
  const float* coeffs;
  int P, Q;
  __device__ Poly(const float* __restrict__ c, int p, int q) : coeffs(c), P(p), Q(q) {}
  __device__ __forceinline__ float operator()(float ra, float rp) const {
    const float rac = fmaxf(ra, 0.f);
    const float rpc = fmaxf(rp, 0.f);
    float fused = 0.f;
    float ra_pow = 1.f;
    for (int p = 0; p <= P; ++p) {
      float rp_pow = 1.f;
      for (int q = 0; q <= Q; ++q) {
        fused += __ldg(coeffs + p * (Q + 1) + q) * (ra_pow * rp_pow);
        rp_pow *= (q == 0 ? rp : rpc);
      }
      ra_pow *= (p == 0 ? ra : rac);
    }
    return fused;
  }
};

// A block's output tile in the epilogue: the Gram tiles in shared memory
// ([kT][kT + 1] fp32, gp == ga for one set), the clamped norms of its row and
// column tokens, and where the tile lies in the batch element's output.
struct Tile {
  float* ga;
  const float* gp;
  const float* m_a;
  const float* m_p;
  float* o;
  int N, i0, j0;
};

// Every entry of the tile: R over the norms (cosine; the dot Grams' norms
// are 1 and a division by 1 is exact, so it is skipped), the polynomial, the
// clamp; to the output row by row (a warp's lanes on 32 neighbouring floats)
// and back over the anchor Gram for the mirror.
template <int kT, int kThreads, bool kCosine, typename PolyT>
__device__ __forceinline__ void fuse_tile(const Tile& t, const PolyT& poly) {
  constexpr int kLd = kT + 1;
  for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
    const int li = idx / kT;
    const int lj = idx % kT;
    const int i = t.i0 + li;
    const int j = t.j0 + lj;
    if (i < t.N && j < t.N) {
      float ra = t.ga[li * kLd + lj];
      float rp = t.gp[li * kLd + lj];
      if constexpr (kCosine) {
        ra = ra / (t.m_a[li] * t.m_a[kT + lj]);
        rp = rp / (t.m_p[li] * t.m_p[kT + lj]);
      }
      const float v = fmaxf(poly(ra, rp), 0.f);
      t.ga[li * kLd + lj] = v;
      t.o[static_cast<size_t>(i) * t.N + j] = v;
    }
  }
}

template <int WG, bool kSame>
__global__ void __launch_bounds__(Shape<WG, kSame>::kThreads, Shape<WG, kSame>::kMinBlocks)
gpf_fwd_sm90(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_p,
             const bf16* __restrict__ ta, const bf16* __restrict__ tp,
             const float* __restrict__ coeffs, float* __restrict__ out, int N, int D, int P,
             int Q, int cosine, float eps, int x_tma, int stages) {
  using S = Shape<WG, kSame>;
  constexpr int kT = S::kTile;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float m_a[2 * kT], m_p[2 * kT];  // clamped norms: row tokens, then column tokens
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * S::kStageBytes);
  uint64_t* empty = full + stages;
  // tile k of stage s: anchor rows, anchor columns, positive rows, positive columns
  auto tile = [&](int s, int k) {
    return reinterpret_cast<bf16*>(base + s * S::kStageBytes + k * S::kTokBytes);
  };

  // this block's tile of the upper triangle
  const int b = blockIdx.y;
  const int tiles = (N + kT - 1) / kT;
  int it = 0, rem = blockIdx.x;
  while (rem >= tiles - it) {
    rem -= tiles - it;
    ++it;
  }
  const int jt = it + rem;
  const int i0 = it * kT;
  const int j0 = jt * kT;
  const int tid = threadIdx.x;
  const int n_k = (D + kK - 1) / kK;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, S::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  constexpr int n_tiles = 2 * S::kSets;
  if (tid >= S::kConsumers) {  // the producer warp
    const int lane = tid - S::kConsumers;
    const bf16* xa = ta + static_cast<size_t>(b) * N * D;
    const bf16* xp = tp + static_cast<size_t>(b) * N * D;
    for (int kc = 0; kc < n_k; ++kc) {
      const int s = kc % stages;
      bar_wait(empty + s, ((kc / stages) & 1) ^ 1);
      if (x_tma) {
        if (lane == 0) {
          bar_arrive_tx(full + s, n_tiles * S::kTokBytes);
          for (int k = 0; k < n_tiles; ++k) {
            tma_load(tile(s, k), k < 2 ? &tm_a : &tm_p, full + s, kc * kK, (k & 1) ? j0 : i0, b);
          }
        }
      } else {
        for (int k = 0; k < n_tiles; ++k) {
          for (int sub = 0; sub < WG; ++sub) {
            gemm_sm90::stage_box(tile(s, k) + sub * 64 * kK, k < 2 ? xa : xp, N, D,
                                 ((k & 1) ? j0 : i0) + 64 * sub, kc * kK, lane);
          }
        }
        fence_proxy_async();  // for wgmma's reads
        __syncwarp();
        if (lane == 0) bar_arrive(full + s);
      }
    }
    return;
  }

  const int wg = tid >> 7;
  float acc_a[S::kAcc], acc_p[kSame ? 1 : S::kAcc];
#pragma unroll
  for (int e = 0; e < S::kAcc; ++e) acc_a[e] = 0.f;
  if constexpr (!kSame) {
#pragma unroll
    for (int e = 0; e < S::kAcc; ++e) acc_p[e] = 0.f;
  }
  float nsq_a = 0.f, nsq_p = 0.f;
  const int row = tid & (kT - 1);
  const int own = tid < kT ? 0 : 1;  // this thread's token: the row tile's or the column tile's
  for (int kc = 0; kc < n_k; ++kc) {
    const int s = kc % stages;
    bar_wait(full + s, (kc / stages) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      gram_step<WG>(acc_a, desc_k<64>(tile(s, 0) + wg * 64 * kK, ks), desc_k<64>(tile(s, 1), ks));
    }
    if constexpr (!kSame) {
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        gram_step<WG>(acc_p, desc_k<64>(tile(s, 2) + wg * 64 * kK, ks),
                      desc_k<64>(tile(s, 3), ks));
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
      const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[h]));
        nsq_a = fmaf(fa.x, fa.x, nsq_a);
        nsq_a = fmaf(fa.y, fa.y, nsq_a);
      }
      if constexpr (!kSame) {
        const uint4 vp = *reinterpret_cast<const uint4*>(np + at);
        const uint32_t wp[4] = {vp.x, vp.y, vp.z, vp.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 fp = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wp[h]));
          nsq_p = fmaf(fp.x, fp.x, nsq_p);
          nsq_p = fmaf(fp.y, fp.y, nsq_p);
        }
      }
    }
    wg_wait<1>();  // the previous stage's products are done: release it
    if (kc > 0) bar_arrive(empty + (kc - 1) % stages);
  }
  wg_wait<0>();
  fence_regs<S::kAcc>(acc_a);
  if constexpr (!kSame) fence_regs<S::kAcc>(acc_p);

  m_a[tid] = cosine ? fmaxf(sqrtf(nsq_a), eps) : 1.f;
  m_p[tid] = cosine ? fmaxf(sqrtf(kSame ? nsq_a : nsq_p), eps) : 1.f;
  // every consumer is past its last product and every copy has landed: the
  // ring takes the Gram tiles
  consumers_sync(S::kConsumers);
  float* ga = reinterpret_cast<float*>(base);
  float* gp = kSame ? ga : ga + kT * S::kLd;
  {
    const int warp = (tid >> 5) & 3;
    const int g = (tid & 31) >> 2;
    const int tg = tid & 3;
#pragma unroll
    for (int e = 0; e < S::kAcc; ++e) {
      const int li = wg * 64 + warp * 16 + g + ((e >> 1) & 1) * 8;
      const int lj = (e >> 2) * 8 + tg * 2 + (e & 1);
      ga[li * S::kLd + lj] = acc_a[e];
      if constexpr (!kSame) gp[li * S::kLd + lj] = acc_p[e];
    }
  }
  consumers_sync(S::kConsumers);

  // the polynomial, entry by entry, to the output by rows and in place over
  // the anchor Gram tile; then (off the diagonal) the mirror by columns
  float* o = out + static_cast<size_t>(b) * N * N;
  const Tile t{ga, gp, m_a, m_p, o, N, i0, j0};
  constexpr int kC = S::kConsumers;
  if (P == 2 && Q == 2) {  // the flagship's degrees, unrolled; the same steps
    const Poly<2, 2> poly(coeffs, P, Q);
    if (cosine) {
      fuse_tile<kT, kC, true>(t, poly);
    } else {
      fuse_tile<kT, kC, false>(t, poly);
    }
  } else {
    const Poly<-1, -1> poly(coeffs, P, Q);
    if (cosine) {
      fuse_tile<kT, kC, true>(t, poly);
    } else {
      fuse_tile<kT, kC, false>(t, poly);
    }
  }
  consumers_sync(S::kConsumers);
  if (it != jt) {
    for (int idx = tid; idx < kT * kT; idx += S::kConsumers) {
      const int lj = idx / kT;
      const int li = idx % kT;
      if (i0 + li < N && j0 + lj < N) {
        o[static_cast<size_t>(j0 + lj) * N + i0 + li] = ga[li * S::kLd + lj];
      }
    }
  }
}

// One launch: the blocks of the upper triangle of every batch element.  The
// geometry (tile, stages, shared memory) comes from the Python wrapper
// (kernels/gpf.py:fwd_geometry) and is checked here.
template <int WG, bool kSame>
cudaError_t launch(const bf16* ta, const bf16* tp, const float* coeffs, float* out, int B, int N,
                   int D, int P, int Q, int cosine, float eps, int stages, size_t smem,
                   cudaStream_t stream) {
  using S = Shape<WG, kSame>;
  // the epilogue's fp32 tiles must fit in the ring
  if (stages < 2 || stages > kMaxStages || smem != S::bytes(stages) || smem > kMaxSmem ||
      static_cast<size_t>(S::kSets) * S::kTile * S::kLd * 4 >
          static_cast<size_t>(stages) * S::kStageBytes) {
    return cudaErrorInvalidValue;
  }
  // rows that break TMA's 16-byte rule are staged by hand
  const bool x_tma = D % 8 == 0 && reinterpret_cast<uintptr_t>(ta) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(tp) % 16 == 0;
  CUtensorMap tm_a{}, tm_p{};
  if (x_tma && (!gemm_sm90::encode_tiles(&tm_a, ta, D, N, B, D, S::kTile) ||
                !gemm_sm90::encode_tiles(&tm_p, tp, D, N, B, D, S::kTile))) {
    return cudaErrorInvalidValue;
  }
  auto kernel = gpf_fwd_sm90<WG, kSame>;
  const cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (N + S::kTile - 1) / S::kTile;
  kernel<<<dim3(tiles * (tiles + 1) / 2, B), S::kThreads, smem, stream>>>(
      tm_a, tm_p, ta, tp, coeffs, out, N, D, P, Q, cosine, eps, x_tma ? 1 : 0, stages);
  return cudaGetLastError();
}

}  // namespace gpf_fwd90
