// The attention backward for bf16 on Hopper (sm_90a): kernels 3b
// (packed_attention_bwd.cu) and 6b (flash_attention_bwd.cu) both launch it;
// with one group per image and neither bias nor mask, the q-tiled layout
// [B, T, 3C] is the packed layout [B, W, T, 3C].
//
// Per (image-group bw, head h), from qkv[BW, T, 3C], the forward's out[BW, T,
// C] and lse[BW, H, T] (each row's log-sum-exp), dout[BW, T, C], and where
// given bias[Hb, T, T] and mask[Wm, T, T]:
//   P     = exp(q k^T * scale + bias[h % Hb] + mask[w % Wm] - lse)   (fp32)
//   delta = rowsum(dout * out)                                        (fp32)
//   dv    = P~^T dout                  P~ = P rounded to bf16
//   dp    = dout v^T,  ds = P * (dp - delta)                          (fp32)
//   dq    = ds~ k * scale,  dk = ds~^T q * scale                      ds~ = ds rounded
// dq, dk, dv go to dqkv[BW, T, 3C], in qkv's layout.
//
// What bounds it on an H100.  The two kernels do seven T x T x d products
// per (image, head), 14*T^2*d flops, against reading 4*T*d and writing 3*T*d
// bf16 values: ~140 flops per byte at T = 197, under the card's ~295, so
// memory bounds the ViT-Base/224 call, and ~560 at T = 785 and ~730 at 1025,
// where the tensor cores do: the design feeds the tensor cores through wgmma
// (the only route to their full rate), pads T only to wgmma's granularity,
// and starts from the forward's log-sum-exp (no statistics pass).
//
// Design.  The work is cut along the axis each result is summed over, so every
// sum stays inside one block and no float atomics are needed (two runs give
// the same bits):
//   1. dq kernel: a block owns 64 query rows of one (group, head).  Its
//      warpgroup takes delta for those rows from dout and out (written to a
//      scratch for kernel 2) and lse from the forward, then walks the keys:
//      S = q k^T and dP = dout v^T, ds from P rebuilt exactly, dq += ds~ k.
//   2. dk/dv kernel: a block owns 64 keys and walks the queries with keys as
//      rows: S^T = k q^T, dP^T = v dout^T, P^T and ds^T from the tile's lse
//      and delta, dv += P~^T dout, dk += ds~^T q.
// Every product is a warpgroup wgmma (m64nNk16, bf16 in, fp32 sums in
// registers).  The first two of a tile read both operands from shared memory;
// the second two take their A operand from registers: the fp32 accumulators of
// S (or S^T) and ds, rounded to bf16 in place, are already the A fragments of
// the next product, and B is the same shared tile read with its rows as the
// contraction (the descriptor's transposed, MN-major form).  A block is one
// consumer warpgroup and one producer warp: the producer's first lane keeps a
// ring of ``stages`` walked tiles in flight with TMA (3-D tensor maps over
// [group, token, column], 64 x d boxes, the 128-byte swizzle at d = 64 and the
// 64-byte one at d = 32 that the wgmma descriptors name) and mbarriers: one
// "full" barrier per stage that the copies complete, one "empty" barrier that
// the consumers release.  In the dk/dv kernel the producer lanes also put the
// tile's lse and delta beside it.  Two blocks share an SM (<= 168 registers
// a thread), so one block's products run under the other's exponentials, and
// inside a block the exponentials of P run under the dP product and ds under
// the dV product.
//
// Tiles.  The owned axis comes in blocks of 64 rows (wgmma's M).  The walked
// axis comes in tiles of 64, and its last tile is read only as far as the
// next multiple of 16 past T (wgmma's N and k-steps: 16, 32, 48 or 64), so
// T = 197 walks 208 columns, not 256, and T = 785 walks 800.  The launch
// geometry (row blocks, last tile, stages, shared memory) is computed by the
// Python wrapper (kernels/packed_attention.py, bwd_geometry) and checked here.
//
// Padding stays exact.  TMA fills rows past T with zeros.  Keys past T are
// masked to -inf wherever a tile holds one (with neither bias nor mask a
// zero key row would give dq nothing anyway: its k and v are zero); query rows
// past T get lse = +inf and delta = 0, so their P and ds are zero and they add
// nothing to dk or dv.  Rows past T of a block's own axis are computed but
// never stored.  The mbarriers, TMA loads, wgmma wrappers and descriptors
// are sm90.cuh's, shared with the forward (attention_fwd_sm90.cuh).
#pragma once

#include "packed_attention.cuh"
#include "sm90.cuh"

namespace sm90_bwd {

using namespace sm90;

constexpr int kRowsOwned = 64;                  // rows a block owns: one warpgroup's wgmma M
constexpr int kWalk = 64;                       // tokens per tile of the walked axis
constexpr int kConsumers = 128;                 // one consumer warpgroup
constexpr int kBlockThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxStages = 8;

template <int D>
struct Layout {
  static constexpr int kTileBytes = kWalk * D * 2;  // one [64][d] bf16 tile, owned or walked
  static constexpr int kStatBytes = 2 * kWalk * 4;  // a walked tile's lse and delta (fp32)
  // 1024 bytes of alignment slack (the swizzled tiles start on 1024-byte
  // boundaries), the two owned tiles, two walked tiles and their statistics
  // per stage, then the barriers: one for the owned tiles, a full and an empty
  // one per stage.  kernels/packed_attention.py:bwd_geometry computes the same.
  static constexpr size_t bytes(int stages) {
    return 1024 + static_cast<size_t>(kTileBytes) * (2 + 2 * stages) +
           static_cast<size_t>(kStatBytes) * stages + 8 * (1 + 2 * stages);
  }
};

struct Params {
  const bf16* out;     // [BW, T, C], the forward's output
  const bf16* dout;    // [BW, T, C]
  const float* lse;    // [BW, H, T], the forward's
  float* delta;        // [BW, H, T] scratch: written by the dq kernel, read by the dk/dv kernel
  bf16* dqkv;          // [BW, T, 3C]
  const float* bias;   // [Hb, T, T] or null
  const float* mask;   // [Wm, T, T] or null
  int W, Tn, C, H, Hb, Wm;
  float scale;
  int n_rt;    // blocks of the owned axis per (group, head)
  int n_walk;  // tiles of the walked axis
  int last;    // columns the products take of the last walked tile
  int stages;  // walked tiles in flight
};

// The smem_raw of a block, carved as Layout says.
template <int D>
struct Block {
  using L = Layout<D>;
  unsigned char* base;
  int stages;
  __device__ Block(unsigned char* raw, int n_stages) : stages(n_stages) {
    base = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
  }
  __device__ bf16* own(int i) const { return reinterpret_cast<bf16*>(base + i * L::kTileBytes); }
  __device__ bf16* walk(int s, int i) const {
    return reinterpret_cast<bf16*>(base + (2 + 2 * s + i) * L::kTileBytes);
  }
  __device__ float* stats(int s) const {  // lse * log2(e) [64], then delta [64]
    return reinterpret_cast<float*>(base + (2 + 2 * stages) * L::kTileBytes + s * L::kStatBytes);
  }
  __device__ uint64_t* bars() const {  // owned, full [stages], empty [stages]
    return reinterpret_cast<uint64_t*>(base + (2 + 2 * stages) * L::kTileBytes +
                                       stages * L::kStatBytes);
  }
};

// One walked tile of N keys in the dq kernel.  sq, sdo: the block's 64 query
// rows; sk, sv: the tile.  r0: this thread's first query row; k0: the tile's
// first key; lse2_*: its rows' lse * log2(e), delta_*: their delta.
template <int D, int N>
__device__ __forceinline__ void dq_tile(float (*dq)[4], const bf16* sq, const bf16* sdo,
                                        const bf16* sk, const bf16* sv, const float* bias_h,
                                        const float* mask_w, int Tn, float scale, int r0, int k0,
                                        int tg, float lse2_0, float lse2_1, float delta0,
                                        float delta1) {
  constexpr int NC = N / 8;
  float s[NC][4], dp[NC][4];
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    Wgmma<N>::ss(&s[0][0], desc_k<D>(sq, ks), desc_k<D>(sk, ks), ks);
  }
  wg_commit();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    Wgmma<N>::ss(&dp[0][0], desc_k<D>(sdo, ks), desc_k<D>(sv, ks), ks);
  }
  wg_commit();
  wg_wait<1>();  // S has landed; P is formed under the dP product
  fence_regs<NC * 4>(&s[0][0]);
  // s becomes P = 2^((logit - lse) * log2(e))
  if (!bias_h && !mask_w && k0 + N <= Tn) {
    const float mul = scale * kLog2e;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(fmaf(s[n][e], mul, -(e < 2 ? lse2_0 : lse2_1)));
      }
    }
  } else {
    to_logits<false, NC>(s, bias_h, mask_w, Tn, scale, r0, k0, tg, false);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(fmaf(s[n][e], kLog2e, -(e < 2 ? lse2_0 : lse2_1)));
      }
    }
  }
  wg_wait<0>();
  fence_regs<NC * 4>(&dp[0][0]);
#pragma unroll
  for (int n = 0; n < NC; ++n) {  // s becomes ds
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - (e < 2 ? delta0 : delta1);
  }
  uint32_t a[NC / 2][4];
  to_fragments<NC>(a, s);
  fence_regs<D / 2>(&dq[0][0]);
  wg_fence();
#pragma unroll
  for (int t = 0; t < NC / 2; ++t) Wgmma<D>::rs(&dq[0][0], a[t], desc_mn<D>(sk, t));
  wg_commit();
  wg_wait<0>();
  fence_regs<D / 2>(&dq[0][0]);
}

// One walked tile of N queries in the dk/dv kernel.  sk, sv: the block's 64
// keys; sq, sdo: the tile, with its queries' lse * log2(e) and delta.  r0:
// this thread's first key; q0: the tile's first query; keys_valid: every key
// of this warp's 16 lies below T.
template <int D, int N>
__device__ __forceinline__ void dkv_tile(float (*dk)[4], float (*dv)[4], const bf16* sk,
                                         const bf16* sv, const bf16* sq, const bf16* sdo,
                                         const float* slse2, const float* sdelta,
                                         const float* bias_h, const float* mask_w, int Tn,
                                         float scale, int r0, int q0, int tg, bool keys_valid) {
  constexpr int NC = N / 8;
  float st[NC][4], dpt[NC][4];  // S^T and dP^T: 64 keys x N queries
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    Wgmma<N>::ss(&st[0][0], desc_k<D>(sk, ks), desc_k<D>(sq, ks), ks);
  }
  wg_commit();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    Wgmma<N>::ss(&dpt[0][0], desc_k<D>(sv, ks), desc_k<D>(sdo, ks), ks);
  }
  wg_commit();
  wg_wait<1>();  // S^T has landed; P^T is formed under the dP^T product
  fence_regs<NC * 4>(&st[0][0]);
  const bool fast = !bias_h && !mask_w && keys_valid;
  if (!fast) to_logits<true, NC>(st, bias_h, mask_w, Tn, scale, r0, q0, tg, keys_valid);
  const float mul = fast ? scale * kLog2e : kLog2e;
#pragma unroll
  for (int n = 0; n < NC; ++n) {  // st becomes P^T
    const float2 lse2 = *reinterpret_cast<const float2*>(slse2 + n * 8 + tg * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st[n][e] = exp2_approx(fmaf(st[n][e], mul, -(e & 1 ? lse2.y : lse2.x)));
    }
  }
  uint32_t ap[NC / 2][4];
  to_fragments<NC>(ap, st);
  fence_regs<D / 2>(&dv[0][0]);
  wg_fence();
#pragma unroll
  for (int t = 0; t < NC / 2; ++t) Wgmma<D>::rs(&dv[0][0], ap[t], desc_mn<D>(sdo, t));
  wg_commit();
  wg_wait<1>();  // dP^T has landed; ds^T is formed under the dV product
  fence_regs<NC * 4>(&dpt[0][0]);
#pragma unroll
  for (int n = 0; n < NC; ++n) {  // dpt becomes ds^T
    const float2 del = *reinterpret_cast<const float2*>(sdelta + n * 8 + tg * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) dpt[n][e] = st[n][e] * (dpt[n][e] - (e & 1 ? del.y : del.x));
  }
  uint32_t as[NC / 2][4];
  to_fragments<NC>(as, dpt);
  fence_regs<D / 2>(&dk[0][0]);
  wg_fence();
#pragma unroll
  for (int t = 0; t < NC / 2; ++t) Wgmma<D>::rs(&dk[0][0], as[t], desc_mn<D>(sq, t));
  wg_commit();
  wg_wait<0>();
  fence_regs<D / 2>(&dk[0][0]);
  fence_regs<D / 2>(&dv[0][0]);
}

// Barriers: one thread initializes them, then the block may use them.  Every
// consumer thread releases each stage.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int stages, uint32_t full_count) {
  if (threadIdx.x == 0) {
    bar_init(bars, 1);
    for (int s = 0; s < stages; ++s) {
      bar_init(bars + 1 + s, full_count);
      bar_init(bars + 1 + stages + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Registers a thread may use.  An SM's registers are split among its four
// schedulers: two blocks of five warps put three warps on some scheduler, so
// they share an SM only at <= 168 registers a thread (the dk/dv kernel wants
// ~186, at which one block ran an SM; the spill at 168 costs less).
constexpr int kMaxRegs = 168;

// Four bf16 rows of an accumulator strip to dqkv: rows r0 and r0 + 8 below T,
// the head's d columns at ``col`` (a third of 3C), times ``mul``.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dqkv, float (*acc)[4], int bw, int Tn, int C,
                                           int r0, int col, int tg, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < Tn) {
      bf16* dst = dqkv + (static_cast<size_t>(bw) * Tn + r) * 3 * C + col;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store_pair(dst + dn * 8 + tg * 2, acc[dn][half * 2] * mul, acc[dn][half * 2 + 1] * mul);
      }
    }
  }
}

template <int D>
__global__ void __maxnreg__(kMaxRegs)
attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_qkv,
                      const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const Block<D> blk(smem_raw, p.stages);
  uint64_t* own_bar = blk.bars();
  uint64_t* full = own_bar + 1;
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x;
  const int rt = blockIdx.x % p.n_rt;
  const int h = (blockIdx.x / p.n_rt) % p.H;
  const int bw = blockIdx.x / (p.n_rt * p.H);
  const int row0 = rt * kRowsOwned;
  init_barriers(own_bar, p.stages, 1);

  if (tid >= kConsumers) {  // the producer warp: its first lane issues every copy
    if (tid == kConsumers) {
      bar_arrive_tx(own_bar, 2 * L::kTileBytes);
      tma_load(blk.own(0), &tm_qkv, own_bar, h * D, row0, bw);  // q
      tma_load(blk.own(1), &tm_do, own_bar, h * D, row0, bw);   // dout
      for (int it = 0; it < p.n_walk; ++it) {
        const int s = it % p.stages;
        bar_wait(empty + s, ((it / p.stages) & 1) ^ 1);
        bar_arrive_tx(full + s, 2 * L::kTileBytes);
        tma_load(blk.walk(s, 0), &tm_qkv, full + s, p.C + h * D, it * kWalk, bw);      // k
        tma_load(blk.walk(s, 1), &tm_qkv, full + s, 2 * p.C + h * D, it * kWalk, bw);  // v
      }
    }
    return;
  }

  const int wi = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const size_t stat_row = (static_cast<size_t>(bw) * p.H + h) * p.Tn;
  const size_t head = static_cast<size_t>(bw) * p.Tn * p.C + h * D;
  const float* bias_h = p.bias ? p.bias + static_cast<size_t>(h % p.Hb) * p.Tn * p.Tn : nullptr;
  const float* mask_w =
      p.mask ? p.mask + static_cast<size_t>((bw % p.W) % p.Wm) * p.Tn * p.Tn : nullptr;
  // delta of the warp's 16 rows while the copies land
  float delta0, delta1;
  warp_row_delta<bf16, D>(p.dout + head, p.out + head, p.C, p.Tn, row0 + 16 * wi, lane,
                          p.delta + stat_row, delta0, delta1);
  const int r0 = row0 + 16 * wi + g;
  // a query past T: P = 2^(. - inf) = 0, so its row adds nothing
  const float lse2_0 = r0 < p.Tn ? __ldg(p.lse + stat_row + r0) * kLog2e : INFINITY;
  const float lse2_1 = r0 + 8 < p.Tn ? __ldg(p.lse + stat_row + r0 + 8) * kLog2e : INFINITY;

  float dq[D / 8][4];
  zero_acc<D / 8>(dq);
  const bf16* sq = blk.own(0);
  const bf16* sdo = blk.own(1);
  bar_wait(own_bar, 0);
  for (int it = 0; it < p.n_walk; ++it) {
    const int s = it % p.stages;
    bar_wait(full + s, (it / p.stages) & 1);
    const bf16* sk = blk.walk(s, 0);
    const bf16* sv = blk.walk(s, 1);
    const int k0 = it * kWalk;
    const int n = it + 1 < p.n_walk ? kWalk : p.last;
#define EMCT_DQ_TILE(N)                                                                       \
  dq_tile<D, N>(dq, sq, sdo, sk, sv, bias_h, mask_w, p.Tn, p.scale, r0, k0, tg, lse2_0, lse2_1, \
                delta0, delta1)
    if (n == 64) {
      EMCT_DQ_TILE(64);
    } else if (n == 48) {
      EMCT_DQ_TILE(48);
    } else if (n == 32) {
      EMCT_DQ_TILE(32);
    } else {
      EMCT_DQ_TILE(16);
    }
#undef EMCT_DQ_TILE
    bar_arrive(empty + s);
  }
  store_rows<D>(p.dqkv, dq, bw, p.Tn, p.C, r0, h * D, tg, p.scale);
}

template <int D>
__global__ void __maxnreg__(kMaxRegs)
attention_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_qkv,
                       const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const Block<D> blk(smem_raw, p.stages);
  uint64_t* own_bar = blk.bars();
  uint64_t* full = own_bar + 1;
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x;
  const int rt = blockIdx.x % p.n_rt;
  const int h = (blockIdx.x / p.n_rt) % p.H;
  const int bw = blockIdx.x / (p.n_rt * p.H);
  const int row0 = rt * kRowsOwned;
  const size_t stat_row = (static_cast<size_t>(bw) * p.H + h) * p.Tn;
  init_barriers(own_bar, p.stages, 32);

  if (tid >= kConsumers) {  // the producer warp: statistics from every lane, copies from the first
    const int lane = tid - kConsumers;
    if (lane == 0) {
      bar_arrive_tx(own_bar, 2 * L::kTileBytes);
      tma_load(blk.own(0), &tm_qkv, own_bar, p.C + h * D, row0, bw);      // k
      tma_load(blk.own(1), &tm_qkv, own_bar, 2 * p.C + h * D, row0, bw);  // v
    }
    for (int it = 0; it < p.n_walk; ++it) {
      const int s = it % p.stages;
      bar_wait(empty + s, ((it / p.stages) & 1) ^ 1);
      float* st = blk.stats(s);
      for (int i = lane; i < kWalk; i += 32) {
        const int q = it * kWalk + i;
        // lse * log2(e); a query past T: P = 2^(. - inf) = 0
        st[i] = q < p.Tn ? __ldg(p.lse + stat_row + q) * kLog2e : INFINITY;
        st[kWalk + i] = q < p.Tn ? p.delta[stat_row + q] : 0.f;
      }
      if (lane == 0) {
        bar_arrive_tx(full + s, 2 * L::kTileBytes);
        tma_load(blk.walk(s, 0), &tm_qkv, full + s, h * D, it * kWalk, bw);  // q
        tma_load(blk.walk(s, 1), &tm_do, full + s, h * D, it * kWalk, bw);   // dout
      } else {
        bar_arrive(full + s);
      }
    }
    return;
  }

  const int wi = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const float* bias_h = p.bias ? p.bias + static_cast<size_t>(h % p.Hb) * p.Tn * p.Tn : nullptr;
  const float* mask_w =
      p.mask ? p.mask + static_cast<size_t>((bw % p.W) % p.Wm) * p.Tn * p.Tn : nullptr;
  const int r0 = row0 + 16 * wi + g;  // this thread's first key
  const bool keys_valid = row0 + 16 * (wi + 1) <= p.Tn;

  float dk[D / 8][4], dv[D / 8][4];
  zero_acc<D / 8>(dk);
  zero_acc<D / 8>(dv);
  const bf16* sk = blk.own(0);
  const bf16* sv = blk.own(1);
  bar_wait(own_bar, 0);
  for (int it = 0; it < p.n_walk; ++it) {
    const int s = it % p.stages;
    bar_wait(full + s, (it / p.stages) & 1);
    const bf16* sq = blk.walk(s, 0);
    const bf16* sdo = blk.walk(s, 1);
    const float* slse2 = blk.stats(s);
    const int q0 = it * kWalk;
    const int n = it + 1 < p.n_walk ? kWalk : p.last;
#define EMCT_DKV_TILE(N)                                                                          \
  dkv_tile<D, N>(dk, dv, sk, sv, sq, sdo, slse2, slse2 + kWalk, bias_h, mask_w, p.Tn, p.scale, r0, \
                 q0, tg, keys_valid)
    if (n == 64) {
      EMCT_DKV_TILE(64);
    } else if (n == 48) {
      EMCT_DKV_TILE(48);
    } else if (n == 32) {
      EMCT_DKV_TILE(32);
    } else {
      EMCT_DKV_TILE(16);
    }
#undef EMCT_DKV_TILE
    bar_arrive(empty + s);
  }
  store_rows<D>(p.dqkv, dk, bw, p.Tn, p.C, r0, p.C + h * D, tg, p.scale);
  store_rows<D>(p.dqkv, dv, bw, p.Tn, p.C, r0, 2 * p.C + h * D, tg, 1.f);
}

// dq (and delta), then dk / dv.  The geometry (row blocks, the last walked
// tile, stages, shared memory) comes from the Python wrapper and must be the
// one this code expects.
template <int D>
cudaError_t launch(const void* qkv, const float* bias, const float* mask, const void* out,
                   const void* dout, const float* lse, void* dqkv, float* delta, int BW, int W,
                   int Tn, int C, int H, int Hb, int Wm, float scale, int row_blocks, int last,
                   int stages, size_t smem, cudaStream_t stream) {
  const int n_rt = (Tn + kRowsOwned - 1) / kRowsOwned;
  const int n_walk = (Tn + kWalk - 1) / kWalk;
  const int rest = Tn - (n_walk - 1) * kWalk;
  if (row_blocks != n_rt || last != (rest + 15) / 16 * 16 || stages < 2 || stages > kMaxStages ||
      smem != Layout<D>::bytes(stages) || smem > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap tm_qkv, tm_do;
  if (!encode_map(&tm_qkv, qkv, 3 * C, Tn, BW, D) || !encode_map(&tm_do, dout, C, Tn, BW, D)) {
    return cudaErrorInvalidValue;
  }
  const Params p{static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse, delta,
                 static_cast<bf16*>(dqkv), bias, mask, W, Tn, C, H, Hb, Wm, scale, n_rt, n_walk,
                 last, stages};
  const unsigned blocks = static_cast<unsigned>(BW) * H * n_rt;
  auto dq_kernel = attention_bwd_dq_sm90<D>;
  cudaError_t err = emct_allow_smem(dq_kernel, smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<blocks, kBlockThreads, smem, stream>>>(tm_qkv, tm_do, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkv_kernel = attention_bwd_dkv_sm90<D>;
  err = emct_allow_smem(dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<blocks, kBlockThreads, smem, stream>>>(tm_qkv, tm_do, p);
  return cudaGetLastError();
}

// Registers, and blocks an SM holds, of the four bf16 kernels at d = 64 with
// ``smem`` bytes of shared memory: {dq regs, dq blocks, dk/dv regs, dk/dv
// blocks}.  For reports; nothing calls it on the main path.
inline cudaError_t occupancy(size_t smem, int* out) {
  auto dq_kernel = attention_bwd_dq_sm90<64>;
  auto dkv_kernel = attention_bwd_dkv_sm90<64>;
  cudaFuncAttributes attr;
  cudaError_t err = emct_allow_smem(dq_kernel, smem);
  if (err == cudaSuccess) err = emct_allow_smem(dkv_kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, dq_kernel);
  if (err == cudaSuccess) out[0] = attr.numRegs;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, dq_kernel, kBlockThreads, smem);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, dkv_kernel);
  if (err == cudaSuccess) out[2] = attr.numRegs;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, dkv_kernel, kBlockThreads, smem);
  }
  return err;
}

}  // namespace sm90_bwd
