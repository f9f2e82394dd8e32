// The bf16 fused attention-half forward on Hopper (sm_90a): kernel 4
// (attn_half_fwd.cu launches it).
//
// Per image b and window w (T = ws*ws <= 64 tokens, d = 32, C in {128, 256},
// H = C / 32 heads), from the pre-LN map x[B, Hp, Wp, C]:
//   xn  = LayerNorm(x) * ln_g + ln_b           fp32, rounded to bf16
//   qkv = xn Wqkv^T + bqkv                     summed in fp32, rounded
//   om  = softmax(q k^T * scale + bias[h] + mask[w]) v   per head, P rounded
//   y   = x + (om Wproj^T + bproj)             summed in fp32, rounded once
// with Wqkv [3C, C] and Wproj [C, C] in the port's [out, in] layout, which is
// the K-major B operand of wgmma as it stands: no weight is transposed.
//
// What bounds it on an H100: operations (8 M C^2 + 4 M T C flops on M
// tokens, most in the two weight products) about as much as bytes (x read,
// y written); at Swin-Base's stage 0 batch 64 ~0.032 ms either way.
//
// What held the mma.sync kernel it replaces at 21x that: a block of four
// warps owned one window and walked the weights in 32-row pieces, each behind
// a cp.async wait and a block barrier, fetched one piece ahead; every block
// streamed all the weights again from L2 (~0.5 GB a launch) and every warp
// read each piece through ldmatrix for its 16 rows.
//
// Design.  A block is a group of windows, one consumer warpgroup each (an
// m64 accumulator is one window's 64 padded rows), and a producer warpgroup,
// one block an SM.  The producer hands its registers on (setmaxnreg; held to
// the 168 that 384 threads get evenly, ptxas spilled and serialized the
// wgmma at C = 256), and one thread of it issues every copy.  Blocks walk
// groups of windows persistently (about one wave of blocks), and the
// producer streams the weights through a ring of TMA stages that every
// warpgroup of the block reads: the weights cross from L2 once a group.  A
// stage is 64 steps of the contraction: for a head's q, k, v the three
// [32][64] boxes of its Wqkv rows, side by side one 96-row B operand; for
// proj a [128][64] box of Wproj rows (C / 128 passes of 128 output columns).
// Per window:
//   1. LayerNorm in fp32, in the mma.sync kernel's order (attn_half.cuh), xn
//      written in bf16 to shared memory as the K-major A operand: C / 64
//      [64][64] boxes at the 128-byte swizzle.
//   2. Per head: q, k, v = xn Wqkv_h^T on wgmma m64n96k16; the epilogue adds
//      bqkv, rounds, and writes q, k, v as [64][32] tiles at the 64-byte
//      swizzle, the layout TMA gives kernel 1.  Then kernel 1's core
//      (window_sm90.cuh): S = q k^T (m64n64k16), the softmax with the
//      forward's rounding (softmax_rows_with<true>; the bias-plus-mask terms
//      read from L2 into registers a head ahead), O = P~ v with P~ rounded in
//      registers (m64n32k16 rs), rounded into om's columns (om [64][C], the
//      same boxes as xn).
//   3. proj = om Wproj^T on wgmma m64n128k16 per pass; the epilogue adds
//      bproj and x (both read under the product), rounds once and stores the
//      real rows only.
// The width picks the block (Traits), from turns on an H100 at Swin-Base's
// stages: at C = 128 three windows a block (consumers at 160 registers),
// 4-10 % faster than two; at C = 256 two (three do not fit shared memory),
// with the next head's q, k, v product issued under this head's softmax and
// the biases and x read ahead, 0.81x the time without; at C = 128 that
// overlap, its accumulators live at 160 registers, took 12-17 % longer.
// No qkv or om goes to device memory: x is read, y written, weights read
// from L2.  Sums run over the contraction in 16-wide steps in order, as
// mma.sync's did; the LayerNorm and softmax repeat the old kernel's fp32
// steps, so the outputs are the old kernel's bits.  Padded rows (T..63) are
// zero in xn, stay finite through qkv (= bqkv), are masked as keys (-inf) and
// never stored; a warpgroup with no window (the last group of a count that
// does not divide) runs on zeros and stores nothing, so every warpgroup
// consumes every stage.
#pragma once

#include <type_traits>

#include "attn_half.cuh"
#include "gemm_sm90.cuh"
#include "window_sm90.cuh"

namespace ah_fwd90 {

using namespace sm90;
using gemm_sm90::encode_tiles;
using gemm_sm90::swizzled;

constexpr int kTok = 64;                     // window rows, padded to wgmma's M
constexpr int kD = 32;                       // head width
constexpr int kK = 64;                       // contraction a stage: one 128-byte row
constexpr int kBox = kTok * kK * 2;          // one [64][64] bf16 box of xn or om
constexpr int kPiece = kD * kK * 2;          // one [32][64] box of Wqkv rows
constexpr int kQkvBytes = 3 * kPiece;        // a qkv stage: q, k, v rows of a head
constexpr int kProjCols = 128;               // output columns a proj pass
constexpr int kStageBytes = kProjCols * kK * 2;  // a proj stage [128][64]; qkv takes 12 KB
constexpr int kHeadTile = kTok * kD * 2;     // q, k or v [64][32], 64-byte swizzle

// A block at width C: kWindows consumer warpgroups (a window each) and a
// producer warpgroup, which hands its registers on (setmaxnreg); kOverlap:
// the next head's q, k, v product is issued under this head's softmax (the
// design note above says why each width takes what it takes).
// Shared memory: 1024 bytes of alignment slack, each warpgroup's xn, om, q,
// k, v, the ring of four stages, a full and an empty barrier a stage.
// kernels/attn_half.py:fwd_geometry computes the same.
template <int C>
struct Traits {
  static constexpr int kWindows = C == 128 ? 3 : 2;
  static constexpr bool kOverlap = C != 128;
  static constexpr int kConsumers = 128 * kWindows;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kProducerRegs = kWindows == 2 ? 40 : 24;  // a thread after setmaxnreg
  static constexpr int kConsumerRegs = kWindows == 2 ? 232 : 160;
  static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "register file");
  static constexpr int kStages = 4;
  static constexpr int kXn = kTok * C * 2;
  static constexpr int kWindowBytes = 2 * kXn + 3 * kHeadTile;
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kWindows) * kWindowBytes + kStages * kStageBytes + 16 * kStages;
};

// Byte offset of element (row, col) of a [64][32] bf16 tile at the 64-byte
// swizzle, as TMA lays it down: the 16-byte chunk col / 8 of row r lands in
// chunk (col / 8) ^ (r / 2 % 4) of that row.
__device__ __forceinline__ int swizzled64(int row, int col) {
  return row * 64 + ((((col >> 3) ^ (row >> 1)) & 3) << 4) + (col & 7) * 2;
}

// The 128 threads of warpgroup ``wg`` meet (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

struct Params {
  const bf16* x;
  const float *ln_g, *ln_b;
  const bf16 *bqkv, *bproj;
  const float *bias, *mask;  // [H, T, T], [nW, T, T] or null
  bf16* y;
  int B, Hp, Wp, ws;
  float scale, eps;
};

template <int C>
__global__ void __launch_bounds__(Traits<C>::kThreads, 1)
attn_half_fwd_sm90(const __grid_constant__ CUtensorMap tm_wqkv,
                   const __grid_constant__ CUtensorMap tm_wproj, const Params p) {
  constexpr int H = C / kD;
  constexpr int n_k = C / kK;                 // stages a product
  constexpr int n_pass = C / kProjCols;        // proj passes
  using S = Traits<C>;
  constexpr int kStages = S::kStages;
  constexpr int kWindows = S::kWindows;
  constexpr int kConsumers = S::kConsumers;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = base + kWindows * S::kWindowBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ws = p.ws;
  const int nt = ws * ws;
  const int nwx = p.Wp / ws;
  const int n_win = nwx * (p.Hp / ws);
  const int n_windows = p.B * n_win;
  const int n_groups = (n_windows + kWindows - 1) / kWindows;

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int it = 0;
      auto produce = [&](uint32_t bytes) {
        const int s = it % kStages;
        bar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        bar_arrive_tx(full + s, bytes);
        ++it;
        return s;
      };
      for (int group = blockIdx.x; group < n_groups; group += gridDim.x) {
        for (int h = 0; h < H; ++h) {
          for (int kc = 0; kc < n_k; ++kc) {
            const int s = produce(kQkvBytes);
            unsigned char* st = ring + s * kStageBytes;
#pragma unroll
            for (int part = 0; part < 3; ++part) {  // rows part C + h d .. + d of Wqkv
              tma_load(st + part * kPiece, &tm_wqkv, full + s, kc * kK, part * C + h * kD, 0);
            }
          }
        }
        for (int pass = 0; pass < n_pass; ++pass) {
          for (int kc = 0; kc < n_k; ++kc) {
            const int s = produce(kStageBytes);
            tma_load(ring + s * kStageBytes, &tm_wproj, full + s, kc * kK, pass * kProjCols, 0);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));

  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tg = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  unsigned char* mine = base + wg * S::kWindowBytes;
  unsigned char* xn = mine;           // C / 64 boxes [64][64]
  unsigned char* om = mine + S::kXn;  // likewise
  unsigned char* sq = om + S::kXn;    // q, k, v [64][32]
  unsigned char* sk = sq + kHeadTile;
  unsigned char* sv = sk + kHeadTile;
  const bf16* xn_h = reinterpret_cast<const bf16*>(xn);
  const bf16* om_h = reinterpret_cast<const bf16*>(om);

  // The ring is read in the order the producer fills it: ``it`` counts the
  // stages taken.  issue(mma) waits for the next n_k stages and issues each
  // one's four k-steps (``mma(stage, kc)``) as one group, without waiting
  // for it; release(first) hands those stages back once their products are
  // done.
  int it = 0;
  auto issue = [&](auto mma) {
    wg_fence();
    for (int kc = 0; kc < n_k; ++kc) {
      const int s = (it + kc) % kStages;
      bar_wait(full + s, ((it + kc) / kStages) & 1);
      mma(ring + s * kStageBytes, kc);
    }
    wg_commit();
    it += n_k;
    return it - n_k;
  };
  auto release = [&](int first) {
    for (int kc = 0; kc < n_k; ++kc) bar_arrive(empty + (first + kc) % kStages);
  };

  float acc[48];  // q, k, v of one head: an m64n96 accumulator
  auto issue_qkv = [&](int h) {
    return issue([&](const unsigned char* st, int kc) {
      const bf16* a = xn_h + kc * kTok * kK;
      const bf16* w = reinterpret_cast<const bf16*>(st);
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        Wgmma<96>::ss(acc, desc_k<64>(a, ks), desc_k<64>(w, ks), kc > 0 || ks > 0);
      }
    });
  };
  // this thread's bqkv pairs of head h: part j / 4 (q, k, v), columns
  // 8 (j % 4) + 2 tg
  auto load_bqkv = [&](int h, __nv_bfloat162* bq) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      bq[j] = *reinterpret_cast<const __nv_bfloat162*>(p.bqkv + (j >> 2) * C + h * kD +
                                                       8 * (j & 3) + 2 * tg);
    }
  };
  // q, k, v + bqkv, rounded, into their tiles; then the warpgroup meets
  auto write_qkv = [&](const __nv_bfloat162* bq) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float2 b2 = __bfloat1622float2(bq[j]);
      unsigned char* tile = sq + (j >> 2) * kHeadTile;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<__nv_bfloat162*>(tile + swizzled64(r0 + 8 * half, 8 * (j & 3) + 2 * tg)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] + b2.x, acc[4 * j + 2 * half + 1] + b2.y);
      }
    }
    fence_proxy_async();
    wg_sync(wg);
  };
  // this head's logit terms (bias + mask, -inf for a padded key)
  auto load_terms = [&](int h, const float* mask_w, float4* terms) {
    const float* bias_h = p.bias + static_cast<size_t>(h) * nt * nt;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      terms[n] = 8 * n < nt ? wa_sm90::logit_terms(bias_h, mask_w, nt, r0, tg, n)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  for (int group = blockIdx.x; group < n_groups; group += gridDim.x) {
    const int w_all = group * kWindows + wg;
    const bool valid = w_all < n_windows;
    const int b = valid ? w_all / n_win : 0;
    const int win = valid ? w_all % n_win : 0;
    const int y0 = (win / nwx) * ws;
    const int x0 = (win % nwx) * ws;
    const float* mask_w = p.mask ? p.mask + static_cast<size_t>(win) * nt * nt : nullptr;
    wg_sync(wg);  // the warpgroup is done with the last window's tiles

    // 1. xn, rows past T (and every row of a missing window) zero
    attn_half::layer_norm_window_to<bf16, C>(
        [&](int t, int c, bf16 v) {
          *reinterpret_cast<bf16*>(xn + (c >> 6) * kBox + swizzled(t, c & 63)) = v;
        },
        p.x, b, p.Hp, p.Wp, ws, y0, x0, valid ? nt : 0, p.ln_g, p.ln_b, p.eps, warp, lane);
    fence_proxy_async();
    wg_sync(wg);

    // 2. head 0's q, k, v; then per head h the attention and head h + 1's
    // q, k, v product (issued under the softmax where S::kOverlap)
    float4 terms[8];
    __nv_bfloat162 bq[12];
    load_terms(0, mask_w, terms);
    load_bqkv(0, bq);
    int taken = issue_qkv(0);
    wg_wait<0>();
    fence_regs<48>(acc);
    release(taken);
    write_qkv(bq);
    // head h; kNext: head h + 1 follows.  The last head is its own
    // instantiation, so no wgmma is issued under a run-time condition (ptxas
    // serialized every wgmma of the kernel, its warning C7520, when the next
    // head's product sat in a branch).
    auto attend = [&](int h, auto next) {
      constexpr bool kNext = decltype(next)::value;
      // S = q k^T
      float sc[8][4];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        Wgmma<64>::ss(&sc[0][0], desc_k<kD>(reinterpret_cast<const bf16*>(sq), ks),
                      desc_k<kD>(reinterpret_cast<const bf16*>(sk), ks), ks);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(&sc[0][0]);
      if constexpr (S::kOverlap && kNext) taken = issue_qkv(h + 1);  // under the softmax
      float inv0, inv1;
      wa_sm90::softmax_rows_with<true>(
          sc, [&](int n) { return terms[n]; }, p.scale, nt, inv0, inv1);
      if constexpr (kNext) {  // head h + 1's terms and biases, in flight under P~ v
        load_terms(h + 1, mask_w, terms);
        load_bqkv(h + 1, bq);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sc[n][0] *= inv0;
        sc[n][1] *= inv0;
        sc[n][2] *= inv1;
        sc[n][3] *= inv1;
      }
      // O = P~ v, P~ rounded in registers
      uint32_t ap[4][4];
      to_fragments<8>(ap, sc);
      float o[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = 0.f;  // the rs form adds to its accumulator
      wg_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        Wgmma<32>::rs(o, ap[t], desc_mn<kD>(reinterpret_cast<const bf16*>(sv), t));
      }
      wg_commit();
      wg_wait<0>();  // P~ v (and head h + 1's q, k, v before it)
      fence_frags<16>(&ap[0][0]);
      fence_regs<16>(o);
      if constexpr (S::kOverlap && kNext) {
        fence_regs<48>(acc);
        release(taken);
      }
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {  // om columns h d + 8 dn + 2 tg
        const int col = h * kD + 8 * dn + 2 * tg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<__nv_bfloat162*>(om + (col >> 6) * kBox +
                                             swizzled(r0 + 8 * half, col & 63)) =
              __floats2bfloat162_rn(o[4 * dn + 2 * half], o[4 * dn + 2 * half + 1]);
        }
      }
      if constexpr (kNext) {
        if constexpr (!S::kOverlap) {
          taken = issue_qkv(h + 1);
          wg_wait<0>();
          fence_regs<48>(acc);
          release(taken);
        }
        wg_sync(wg);  // the warpgroup is done with head h's q, k, v
        write_qkv(bq);
      }
    };
#pragma unroll 1
    for (int h = 0; h < H - 1; ++h) attend(h, std::true_type{});
    attend(H - 1, std::false_type{});
    fence_proxy_async();
    wg_sync(wg);

    // 3. y = x + (om Wproj^T + bproj), one pass of 128 output columns at a
    // time, x and bproj in flight under the product
    size_t at[2];  // this thread's two rows of x and y
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      at[half] = attn_half::window_pixel(b, p.Hp, p.Wp, ws, y0, x0,
                                         min(r0 + 8 * half, nt - 1)) * C;
    }
#pragma unroll 1
    for (int pass = 0; pass < n_pass; ++pass) {
      float pacc[64];
      taken = issue([&](const unsigned char* st, int kc) {
        const bf16* a = om_h + kc * kTok * kK;
        const bf16* w = reinterpret_cast<const bf16*>(st);
#pragma unroll
        for (int ks = 0; ks < kK / 16; ++ks) {
          Wgmma<128>::ss_t<0, 0>(pacc, desc_k<64>(a, ks), desc_k<64>(w, ks), kc > 0 || ks > 0);
        }
      });
      __nv_bfloat162 xr[2][16], bp[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = pass * kProjCols + 8 * j + 2 * tg;
        bp[j] = *reinterpret_cast<const __nv_bfloat162*>(p.bproj + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          xr[half][j] = *reinterpret_cast<const __nv_bfloat162*>(p.x + at[half] + col);
        }
      }
      wg_wait<0>();
      fence_regs<64>(pacc);
      release(taken);
      if (!valid) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (r0 + 8 * half >= nt) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = pass * kProjCols + 8 * j + 2 * tg;
          const float2 b2 = __bfloat1622float2(bp[j]);
          const float2 xv = __bfloat1622float2(xr[half][j]);
          *reinterpret_cast<__nv_bfloat162*>(p.y + at[half] + col) = __floats2bfloat162_rn(
              xv.x + (pacc[4 * j + 2 * half] + b2.x), xv.y + (pacc[4 * j + 2 * half + 1] + b2.y));
        }
      }
    }
  }
}

// The grid (``n_blocks``, about one wave of one block an SM) and the shared
// memory come from the Python wrapper (kernels/attn_half.py:fwd_geometry)
// and must be the ones this code expects.
template <int C>
cudaError_t launch(const Params& p, const bf16* wqkv, const bf16* wproj, int n_blocks,
                   size_t smem, cudaStream_t stream) {
  if (smem != Traits<C>::kSmem || smem > kMaxSmem || n_blocks < 1) return cudaErrorInvalidValue;
  CUtensorMap tm_wqkv, tm_wproj;
  if (!encode_tiles(&tm_wqkv, wqkv, C, 3 * C, 1, C, kD) ||
      !encode_tiles(&tm_wproj, wproj, C, C, 1, C, kProjCols)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = emct_allow_smem(attn_half_fwd_sm90<C>, smem);
  if (err != cudaSuccess) return err;
  attn_half_fwd_sm90<C><<<n_blocks, Traits<C>::kThreads, smem, stream>>>(tm_wqkv, tm_wproj, p);
  return cudaGetLastError();
}

}  // namespace ah_fwd90
