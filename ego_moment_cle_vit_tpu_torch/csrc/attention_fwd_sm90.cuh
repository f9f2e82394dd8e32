// The attention forward for bf16 on Hopper (sm_90a): kernels 3
// (packed_attention_fwd.cu) and 6 (flash_attention_fwd.cu) both launch it;
// with one group per image and neither bias nor mask, the q-tiled layout
// [B, T, 3C] is the packed layout [B, W, T, 3C].
//
// Replaces: ego_moment_cle_vit_tpu/ops/pallas/window_attention.py:133,
//   _fwd_kernel (called at :240), and ego_moment_cle_vit_tpu/ops/pallas/
//   flash_attention.py:75, _fwd_kernel (called at :152).
//
// Per (image-group bw, head h), from qkv[BW, T, 3C] (head h in columns h*d ..
// (h+1)*d of each third) and, where given, bias[Hb, T, T] and mask[Wm, T, T]:
//   P   = softmax(q k^T * scale + bias[h % Hb] + mask[w % Wm])       (fp32)
//   out = P~ v / l     P~ = the unnormalized probabilities rounded to bf16,
//                      l = their fp32 row sum
//   lse = log(sum_j exp(logit_j)) per query row, fp32 [BW, H, T], when asked
// out goes to [BW, T, C].  The backward (attention_bwd_sm90.cuh) rebuilds P
// from lse.
//
// What bounds it on an H100.  Per (image, head) it reads 3*T*d and writes T*d
// bf16 values and does 4*T^2*d flops: ~100 flops per byte at T = 197, under
// the card's ~295, so memory bounds the ViT-Base/224 call; ~390 at T = 785
// and ~510 at 1025, where the tensor cores do.  At d = 64 the exponentials
// weigh about as much as the products: a 64 x 64 tile's two products are
// 1.05 Mflop, ~140 ns of an SM's share of the 989 TFLOP/s, and its 4096
// exponentials ~256 cycles of the SM's 16 special-function lanes.  So the
// design keeps both units busy at once.
//
// Design, and what it does about the five limits of the mma.sync forward it
// replaced:
//  1. Products on wgmma.  S = q k^T is a warpgroup wgmma m64nNk16 with both
//     tiles in shared memory, K-major, as TMA wrote them.  O += P~ v takes P~
//     from registers (the fp32 S accumulators rounded in place are already
//     its A fragments) and reads the v tile MN-major.  Nothing goes through
//     ldmatrix.
//  2. Each k and v tile is read once per 64 query rows.  A block is two
//     consumer warpgroups of 64 query rows each (128 rows), and both read
//     every k and v tile from the same shared-memory stage.
//  3. Copies off the compute path.  TMA brings the k and v tiles (3-D tensor
//     maps over [group, token, column], 64 x d boxes, swizzled as the
//     descriptors read them) into a ring of up to four stages, each with a
//     "full" mbarrier that its copies complete.  No thread copies data and no
//     __syncthreads runs in the loop.  The last warp to finish with a stage
//     refills it: each consumer warp counts its release with one
//     acquire-release atomic in shared memory, and the warp whose count
//     completes the stage issues the next tile's TMA.  A producer warp would
//     have needed a warpgroup of its own, to keep two blocks' warps evenly
//     spread over an SM's four schedulers, and setmaxnreg to hand its
//     registers on: the consumers would get 104 registers a thread, not 128.
//     Inside a warpgroup one tile's product runs under the next tile's
//     exponentials: S_j is issued, then P~_{j-1} v_{j-1}; the softmax of S_j
//     runs while that second product is in flight, and O is rescaled once it
//     has landed.  Two blocks share an SM, so four warpgroups take turns on
//     the tensor cores.  The loop runs full tiles only; the last tile (16 to
//     64 keys) is an instantiation of its own whose accumulators have its
//     width.  With one S array shared by the four widths, ptxas serialized
//     every wgmma of the kernel (its warning C7511, "insufficient register
//     resources for the wgmma pipeline", even with 255 registers allowed),
//     and the kernel ran behind SDPA on an H100 instead of ahead.
//  4. Padding.  Query rows come in 64s (wgmma's M), and a warpgroup whose 64
//     rows all lie past T does nothing.  Keys come in tiles of 64, and the
//     last tile is read only to the next multiple of 16 past T (wgmma's N and
//     k-step).  T = 785 computes 832 rows x 800 keys (the mma.sync kernel 896
//     x 832), T = 197 256 x 208 (256 x 256), T = 1025 1088 x 1040.
//  5. Short sequences (kernel 3, T <= 256).  The ring holds four tiles, so
//     all of a head's k and v (208 x 64 x 2 tiles x 2 bytes = 53 KB at T =
//     197) is requested at once, before the first product, and stays
//     resident: no refill, one wait per tile.  A head's two 128-row blocks
//     are neighbours in launch order and share those reads through L2, so
//     device memory sees each k and v byte about once.  One block per head
//     holding every query row would need four consumer warpgroups, 512
//     threads at 128 registers: one block an SM, with nothing to run under
//     each block's loads.  Two blocks of 128 rows an SM overlap one block's
//     loads with the other's products.  (A persistent variant, two blocks an
//     SM walking the (group, head, rows) items with the ring and a
//     double-buffered q running on from one item into the next, gave the
//     same bits but ran slower on an H100, so a block is one item.)
// The softmax repeats the mma.sync forward's fp32 arithmetic step for step
// (see Softmax below), and wgmma's k16 sums equal mma.sync's, so out and lse
// are that kernel's bits: the rewrite changes how, not what.  Keys past T
// are masked to -inf; query rows past T (zeros from TMA) are computed but not
// stored.
//
// Registers and occupancy: __launch_bounds__(256, 2) caps a thread at 128
// registers, and a block takes 83 KB of shared memory at d = 64 (four
// stages), so two blocks share an SM.  A consumer thread holds O (d/2 fp32),
// S (32 fp32) and P~ (16 registers of bf16 pairs) at once; ptxas gives the
// main path's instantiation (d = 64, neither bias nor mask) 106 registers
// and the one with bias or mask 116, without spills.  occupancy() reports
// them on the card.
//
// The launch geometry (row blocks, last tile, stages, shared memory) is
// computed by the Python wrapper (kernels/packed_attention.py, fwd_geometry)
// and checked here.
#pragma once

#include "packed_attention.cuh"
#include "sm90.cuh"

namespace sm90_fwd {

using namespace sm90;

constexpr int kRowsWG = 64;                     // query rows of one consumer warpgroup (wgmma M)
constexpr int kGroups = 2;                      // consumer warpgroups a block
constexpr int kRowsOwned = kRowsWG * kGroups;   // query rows a block owns
constexpr int kWalk = 64;                       // keys per walked tile
constexpr int kBlockThreads = 128 * kGroups;
constexpr int kMinBlocks = 2;                   // blocks an SM: <= 128 registers a thread
constexpr int kMaxStages = 4;

template <int D>
struct Layout {
  static constexpr int kTileBytes = kWalk * D * 2;  // one [64][d] bf16 tile
  // 1024 bytes of alignment slack (the swizzled tiles start on 1024-byte
  // boundaries), a q tile per warpgroup, a k and a v tile per stage, the
  // barriers (q, then one per stage), a release count per stage.
  // kernels/packed_attention.py:fwd_geometry computes the same.
  static constexpr size_t bytes(int stages) {
    return 1024 + static_cast<size_t>(kTileBytes) * (kGroups + 2 * stages) + 8 * (1 + stages) +
           4 * stages;
  }
};

struct Params {
  bf16* out;          // [BW, T, C]
  float* lse;         // [BW, H, T] or null
  const float* bias;  // [Hb, T, T] or null
  const float* mask;  // [Wm, T, T] or null
  int W, Tn, C, H, Hb, Wm;
  float scale;
  int pow2;    // scale is a power of two
  int n_rt;    // blocks of 128 query rows per (group, head)
  int n_walk;  // key tiles
  int last;    // columns the products take of the last key tile
  int stages;  // key tiles in flight
};

// The running softmax of one thread's two query rows, r0 and r0 + 8: maxima
// m of the logits, and the thread's partial sums l of the unnormalized
// probabilities (its quad holds the rest).  The arithmetic is the mma.sync
// forward's, step for step: logit = s * scale (+ bias + mask), m = the
// running row maximum, P = 2^((logit - m) * log2(e)), the rescale 2^((m_old -
// m_new) * log2(e)), l scaled, then summed in the same order.  With the
// products' bits equal too (wgmma's k16 sums are mma.sync's), out and lse
// come out as that kernel's bits.
template <bool EXTRAS>
struct Softmax {
  const float* bias_h;
  const float* mask_w;
  int Tn, r0, tg;
  float scale, inv_scale;
  bool pow2;  // scale is a power of two, so inv_scale is exact
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // S of one tile (N keys from k0) becomes the unnormalized P in place; corr
  // are the factors that carry what was summed before to the new maxima.
  template <int N>
  __device__ __forceinline__ void tile(float (*s)[4], int k0, float& corr0, float& corr1) {
    constexpr int NC = N / 8;
    const bool keys_valid = k0 + N <= Tn;
    // A full tile without bias or mask and a power-of-two scale skips the
    // multiply: scaling by 2^k commutes with rounding, so the maximum of the
    // products times the scale, and each difference (s - m / scale) times
    // scale * log2(e), round exactly as the logits' would.
    const bool raw = !EXTRAS && keys_valid && pow2;
    if (!raw) {
      to_logits<false, NC>(s, EXTRAS ? bias_h : nullptr, EXTRAS ? mask_w : nullptr, Tn, scale, r0,
                           k0, tg, keys_valid);
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // every tile holds a key below T, so the new maxima are finite
    const float unit = raw ? scale : 1.f;
    const float mn0 = fmaxf(m0, quad_max(mx0) * unit);
    const float mn1 = fmaxf(m1, quad_max(mx1) * unit);
    corr0 = exp2_approx((m0 - mn0) * kLog2e);
    corr1 = exp2_approx((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    l0 *= corr0;
    l1 *= corr1;
    const float inv_unit = raw ? inv_scale : 1.f;
    const float off0 = mn0 * inv_unit, off1 = mn1 * inv_unit;
    const float mul = unit * kLog2e;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      s[n][0] = exp2_approx((s[n][0] - off0) * mul);
      s[n][1] = exp2_approx((s[n][1] - off0) * mul);
      s[n][2] = exp2_approx((s[n][2] - off1) * mul);
      s[n][3] = exp2_approx((s[n][3] - off1) * mul);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
  }
};

// The ring of k and v tiles: stage s holds k at kv(s, 0) and v at kv(s, 1).
// Tile ``it`` lies in stage it % 4: with fewer than four tiles the ring holds
// them all and never wraps.  Each consumer warp releases a stage once it is
// done with it, and the last of the block's ``releases`` warps to do so
// refills it with the tile ``stages`` further on.
template <int D>
struct Ring {
  static_assert((kMaxStages & (kMaxStages - 1)) == 0, "a stage index is a mask of the tile's");
  const CUtensorMap* map;
  bf16* base;
  uint64_t* full;
  uint32_t* released;
  int stages, n_walk, kcol, vcol, bw;
  uint32_t releases;

  __device__ __forceinline__ bf16* kv(int it, int i) const {
    return base + (2 * (it & (kMaxStages - 1)) + i) * kWalk * D;
  }
  __device__ __forceinline__ void load(int it) const {
    uint64_t* bar = full + (it & (kMaxStages - 1));
    bar_arrive_tx(bar, 2 * Layout<D>::kTileBytes);
    tma_load(kv(it, 0), map, bar, kcol, it * kWalk, bw);
    tma_load(kv(it, 1), map, bar, vcol, it * kWalk, bw);
  }
  __device__ __forceinline__ void wait(int it) const {
    bar_wait(full + (it & (kMaxStages - 1)), (it / kMaxStages) & 1);
  }
  // tile ``it``'s stage is free for this warp (its products have landed)
  __device__ __forceinline__ void release(int it, int lane) const {
    if (lane != 0 || it + stages >= n_walk) return;
    uint32_t old;
    asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "r"(smem_u32(released + (it & (kMaxStages - 1))))
                 : "memory");
    if (old % releases == releases - 1) load(it + stages);
  }
};

// S = q k^T over the tile's N keys (the first k-step overwrites s)
template <int D, int N>
__device__ __forceinline__ void issue_s(float (*s)[4], const bf16* sq, const bf16* sk) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    Wgmma<N>::ss(&s[0][0], desc_k<D>(sq, ks), desc_k<D>(sk, ks), ks);
  }
  wg_commit();
}

// O += P~ v over the tile's N keys, P~ from registers
template <int D, int N>
__device__ __forceinline__ void issue_pv(float (*o)[4], uint32_t (*pf)[4], const bf16* sv) {
  fence_regs<D / 2>(&o[0][0]);
  fence_frags<N / 4>(&pf[0][0]);
  wg_fence();
#pragma unroll
  for (int t = 0; t < N / 16; ++t) Wgmma<D>::rs(&o[0][0], pf[t], desc_mn<D>(sv, t));
  wg_commit();
}

// O's rows times their factors; a warp whose factors are all 1 (no row's
// maximum moved, the common case after the first tiles) skips it, which
// changes no bit.
template <int D>
__device__ __forceinline__ void rescale(float (*o)[4], float corr0, float corr1) {
  if (!__any_sync(0xffffffffu, corr0 != 1.f || corr1 != 1.f)) return;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    o[dn][0] *= corr0;
    o[dn][1] *= corr0;
    o[dn][2] *= corr1;
    o[dn][3] *= corr1;
  }
}

// The first of several tiles: S alone, then its P~ into pf.
template <int D, bool EXTRAS>
__device__ __forceinline__ void first_tile(Softmax<EXTRAS>& sm, const Ring<D>& ring,
                                           uint32_t (*pf)[4], const bf16* sq) {
  float s[kWalk / 8][4];
  issue_s<D, kWalk>(s, sq, ring.kv(0, 0));
  wg_wait<0>();
  fence_regs<kWalk / 2>(&s[0][0]);
  float corr0, corr1;
  sm.template tile<kWalk>(s, 0, corr0, corr1);
  to_fragments<kWalk / 8>(pf, s);
}

// A full tile ``it`` after a full tile: S_it is issued, then the product of
// tile it - 1 (its P~ in pf); the softmax of S_it runs under that product,
// which then releases its stage and is rescaled to the new maxima.
template <int D, bool EXTRAS>
__device__ __forceinline__ void next_tile(Softmax<EXTRAS>& sm, const Ring<D>& ring, float (*o)[4],
                                          uint32_t (*pf)[4], const bf16* sq, int it, int lane) {
  float s[kWalk / 8][4];
  issue_s<D, kWalk>(s, sq, ring.kv(it, 0));
  issue_pv<D, kWalk>(o, pf, ring.kv(it - 1, 1));
  wg_wait<1>();
  fence_regs<kWalk / 2>(&s[0][0]);
  float corr0, corr1;
  sm.template tile<kWalk>(s, it * kWalk, corr0, corr1);
  wg_wait<0>();
  fence_regs<D / 2>(&o[0][0]);
  fence_frags<16>(&pf[0][0]);
  ring.release(it - 1, lane);
  rescale<D>(o, corr0, corr1);
  to_fragments<kWalk / 8>(pf, s);
}

// The last tile ``it`` (N keys), after a full tile when it > 0: as next_tile,
// then its own product.  Nothing refills its stage.
template <int D, int N, bool EXTRAS>
__device__ __forceinline__ void last_tile(Softmax<EXTRAS>& sm, const Ring<D>& ring, float (*o)[4],
                                          uint32_t (*pf)[4], const bf16* sq, int it, int lane) {
  float s[N / 8][4];
  issue_s<D, N>(s, sq, ring.kv(it, 0));
  if (it > 0) issue_pv<D, kWalk>(o, pf, ring.kv(it - 1, 1));
  wg_wait<0>();
  fence_regs<N / 2>(&s[0][0]);
  fence_regs<D / 2>(&o[0][0]);
  fence_frags<16>(&pf[0][0]);
  if (it > 0) ring.release(it - 1, lane);
  float corr0, corr1;
  sm.template tile<N>(s, it * kWalk, corr0, corr1);
  rescale<D>(o, corr0, corr1);
  uint32_t pl[N / 16][4];
  to_fragments<N / 8>(pl, s);
  issue_pv<D, N>(o, pl, ring.kv(it, 1));
  wg_wait<0>();
  fence_regs<D / 2>(&o[0][0]);
  fence_frags<N / 4>(&pl[0][0]);
}

template <int D, bool EXTRAS>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
attention_fwd_sm90(const __grid_constant__ CUtensorMap tm_qkv, const Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sq = reinterpret_cast<bf16*>(base);  // [kGroups][64][d]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + (kGroups + 2 * p.stages) * L::kTileBytes);
  const int tid = threadIdx.x;
  const int rt = blockIdx.x % p.n_rt;
  const int h = (blockIdx.x / p.n_rt) % p.H;
  const int bw = blockIdx.x / (p.n_rt * p.H);
  const int row0 = rt * kRowsOwned;
  // warpgroups with a query row below T; the other does nothing
  const int busy = min(kGroups, (p.Tn - row0 + kRowsWG - 1) / kRowsWG);
  const Ring<D> ring{&tm_qkv, sq + kGroups * kRowsWG * D, q_full + 1,
                     reinterpret_cast<uint32_t*>(q_full + 1 + p.stages), p.stages, p.n_walk,
                     p.C + h * D, 2 * p.C + h * D, bw, static_cast<uint32_t>(4 * busy)};
  if (tid == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      bar_init(ring.full + s, 1);
      ring.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // q of the busy warpgroups, then the first stages (stages <= n_walk)
    bar_arrive_tx(q_full, busy * L::kTileBytes);
    for (int w = 0; w < busy; ++w) {
      tma_load(sq + w * kRowsWG * D, &tm_qkv, q_full, h * D, row0 + w * kRowsWG, bw);
    }
    for (int it = 0; it < p.stages; ++it) ring.load(it);
  }
  const int wg = tid >> 7;
  if (wg >= busy) return;

  const int lane = tid & 31;
  const int tg = lane & 3;
  const int r0 = row0 + wg * kRowsWG + 16 * ((tid >> 5) & 3) + (lane >> 2);  // this thread's first row
  const bf16* sq_w = sq + wg * kRowsWG * D;
  Softmax<EXTRAS> sm{p.bias ? p.bias + static_cast<size_t>(h % p.Hb) * p.Tn * p.Tn : nullptr,
                     p.mask ? p.mask + static_cast<size_t>((bw % p.W) % p.Wm) * p.Tn * p.Tn
                            : nullptr,
                     p.Tn, r0, tg, p.scale, 1.f / p.scale, p.pow2 != 0};
  float o[D / 8][4];
  zero_acc<D / 8>(o);
  uint32_t pf[kWalk / 16][4];  // P~ of the last full tile

  bar_wait(q_full, 0);
  const int last = p.n_walk - 1;
  ring.wait(0);
  if (last > 0) first_tile<D, EXTRAS>(sm, ring, pf, sq_w);
  for (int it = 1; it < last; ++it) {
    ring.wait(it);
    next_tile<D, EXTRAS>(sm, ring, o, pf, sq_w, it, lane);
  }
  if (last > 0) ring.wait(last);
#define EMCT_LAST(N) last_tile<D, N, EXTRAS>(sm, ring, o, pf, sq_w, last, lane)
  if (p.last == 64) {
    EMCT_LAST(64);
  } else if (p.last == 48) {
    EMCT_LAST(48);
  } else if (p.last == 32) {
    EMCT_LAST(32);
  } else {
    EMCT_LAST(16);
  }
#undef EMCT_LAST

  const float l0 = quad_sum(sm.l0);
  const float l1 = quad_sum(sm.l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < p.Tn) {
      const float l = half ? l1 : l0;
      const float inv = 1.f / l;
      bf16* dst = p.out + (static_cast<size_t>(bw) * p.Tn + r) * p.C + h * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store_pair(dst + dn * 8 + tg * 2, o[dn][half * 2] * inv, o[dn][half * 2 + 1] * inv);
      }
      if (p.lse && tg == 0) {
        p.lse[(static_cast<size_t>(bw) * p.H + h) * p.Tn + r] = (half ? sm.m1 : sm.m0) + logf(l);
      }
    }
  }
}

// The geometry comes from the Python wrapper and must be the one this code
// expects.
template <int D>
cudaError_t launch(const void* qkv, const float* bias, const float* mask, void* out, float* lse,
                   int BW, int W, int Tn, int C, int H, int Hb, int Wm, float scale,
                   int row_blocks, int last, int stages, size_t smem, cudaStream_t stream) {
  const int n_rt = (Tn + kRowsOwned - 1) / kRowsOwned;
  const int n_walk = (Tn + kWalk - 1) / kWalk;
  const int rest = Tn - (n_walk - 1) * kWalk;
  if (row_blocks != n_rt || last != (rest + 15) / 16 * 16 ||
      stages != (n_walk < kMaxStages ? n_walk : kMaxStages) || smem != Layout<D>::bytes(stages) ||
      smem > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap tm_qkv;
  if (!encode_map(&tm_qkv, qkv, 3 * C, Tn, BW, D)) return cudaErrorInvalidValue;
  int exponent;
  const int pow2 = std::frexp(scale, &exponent) == 0.5f;
  const Params p{static_cast<bf16*>(out), lse, bias, mask, W, Tn, C, H, Hb, Wm, scale, pow2, n_rt,
                 n_walk, last, stages};
  auto kernel = bias || mask ? attention_fwd_sm90<D, true> : attention_fwd_sm90<D, false>;
  cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(BW) * H * n_rt;
  kernel<<<blocks, kBlockThreads, smem, stream>>>(tm_qkv, p);
  return cudaGetLastError();
}

// Registers a thread, and blocks an SM holds, of the kernel at d = 64 with
// ``smem`` bytes of shared memory: {registers, blocks}.  For reports; nothing
// calls it on the main path.
inline cudaError_t occupancy(size_t smem, int* out) {
  auto kernel = attention_fwd_sm90<64, false>;
  cudaFuncAttributes attr;
  cudaError_t err = emct_allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) out[0] = attr.numRegs;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, kernel, kBlockThreads, smem);
  }
  return err;
}

}  // namespace sm90_fwd
