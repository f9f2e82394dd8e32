// The bf16 fused attention-half backward on Hopper (sm_90a), kernel 4b's
// products (attn_half_bwd.cu runs them after its LayerNorm pass and before
// its ordered sums).  M = B Hp Wp tokens, C in {128, 256}, weights [out, in].
//
//   1. qkv = xn Wqkv^T + bqkv and do = dy Wproj, rounded to bf16, into
//      scratch ([M, 3C] and [M, C]) in [128][128] output tiles that blocks
//      walk persistently, one an SM.
//   2. The window-attention backward core of kernel 1b
//      (window_attention_bwd_sm90.cuh) on that qkv and do, which also forms
//      om = P~ v; dqkv overwrites qkv and om overwrites do in place (a block
//      reads a (window, head, image)'s columns by TMA before it writes the
//      same columns, and no other block touches them), so the scratch holds
//      xn, qkv / dqkv and do / om: 5C values a token, as before.
//   3. dxn = dqkv Wqkv, then the LayerNorm backward in the epilogue: a block
//      owns whole rows ([128][128] or [64][256] tiles) and walks row tiles
//      persistently, so its running dln_g / dln_b partial is one per block.
//   4. dwqkv = dqkv^T xn, dwproj = dy^T om over chunks of tokens, one fp32
//      partial per (output tile, chunk); dbqkv and dbproj come out of the
//      same tiles as one more product against a tile of ones.
//
// What bounds it on an H100: memory, about 0.8 ms of traffic at stage 0
// (x, dy, dx, and the scratch written and read back: 0.3-0.4 ms of it), with
// the products (22 M C^2 + 12 M T C flops) well under that at the
// tensor-core rate.  So every product is a wgmma fed by a TMA ring that a
// producer warp keeps full, and the weights stay in L2.
//
// Shape of a block in 1, 3 and 4: two consumer warpgroups and one producer
// warp.  A stage of the ring is 64 steps of the contraction, every operand in
// [64][64] TMA boxes at the 128-byte swizzle (gemm_sm90.cuh's tensor maps and
// B descriptor): A read K-major (1, 3) or MN-major (4: the token axis is the
// contraction), B read K-major (Wqkv in 1) or MN-major.  Sums run over the contraction in 16-wide steps in order, and
// every sum over tokens is a per-block partial added in a fixed order: no
// float atomics, the same bits every run.
#pragma once

#include "gemm_sm90.cuh"
#include "window_attention_bwd_sm90.cuh"

namespace ah_bwd90 {

using namespace sm90;
using gemm_sm90::desc_b;
using gemm_sm90::encode_tiles;

constexpr int kK = 64;                     // contraction a stage
constexpr int kBM = 128;                   // output rows a block: two warpgroups
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBox = 64 * 64 * 2;          // one [64][64] bf16 box
constexpr int kABytes = 2 * kBox;          // an A stage of 1 and 4: two [64][64] boxes
constexpr int kOnesBytes = 1024;           // [8][64] bf16 ones (4)
constexpr int kProducer = kConsumers;      // the producer's issuing thread
// Ring stages.  1: four, a tile's whole contraction at C = 128, one block an
// SM (10 % faster at C = 256 than two stages at two blocks an SM).  4:
// three, two blocks an SM.  3: DxShape's, one block an SM, its loads ahead
// of the epilogue.
constexpr int kQkvStages = 4;
constexpr int kWgradStages = 3;

// The smem of a block: 1024 bytes of alignment slack, a head region of
// ``head`` bytes (1024-byte multiple), the stages, a full and an empty
// barrier a stage.  kernels/attn_half.py:bwd_geometry computes the same.
inline constexpr size_t smem_bytes(int head, int stage_bytes, int stages) {
  return 1024 + static_cast<size_t>(head) + static_cast<size_t>(stage_bytes) * stages +
         16 * static_cast<size_t>(stages);
}

struct Ring {
  unsigned char* base;  // the head region, then the stages
  int head, stage_bytes, stages;
  __device__ Ring(unsigned char* raw, int head_bytes, int bytes, int n)
      : head(head_bytes), stage_bytes(bytes), stages(n) {
    base = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
  }
  __device__ unsigned char* stage(int s) const { return base + head + s * stage_bytes; }
  __device__ uint64_t* full() const {
    return reinterpret_cast<uint64_t*>(base + head + stages * stage_bytes);
  }
  __device__ uint64_t* empty() const { return full() + stages; }
  // one thread initializes the barriers; the caller then syncs the block
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        bar_init(full() + s, 1);
        bar_init(empty() + s, kConsumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  // producer: the stage of iteration ``it`` once its consumers have released
  // it, announced for ``bytes`` of copies
  __device__ int produce(int it, uint32_t bytes) const {
    const int s = it % stages;
    bar_wait(empty() + s, ((it / stages) & 1) ^ 1);
    bar_arrive_tx(full() + s, bytes);
    return s;
  }
  __device__ int consume(int it) const {
    const int s = it % stages;
    bar_wait(full() + s, (it / stages) & 1);
    return s;
  }
  __device__ void release(int it) const { bar_arrive(empty() + it % stages); }
};

// The consumers' loop over one output tile: ``n_k`` stages from iteration
// ``it``; ``mma(s, first)`` issues the stage's products (``first``: the
// tile's first stage, whose first k-step overwrites the accumulators).  Each
// stage is released once the next one's products are issued and its own are
// done.
template <class Mma>
__device__ __forceinline__ void consume_tile(const Ring& ring, int it, int n_k, Mma mma) {
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = ring.consume(it + kt);
    wg_fence();
    mma(s, kt == 0);
    wg_commit();
    wg_wait<1>();
    if (kt > 0) ring.release(it + kt - 1);
  }
  wg_wait<0>();
  ring.release(it + n_k - 1);
}

// Rows r0 and r0 + 8 of a warpgroup's strip, columns 8j + 2tg + {0, 1}: the
// accumulator layout of every m64nN product (sm90.cuh).
struct Frag {
  int r0, tg;
  __device__ Frag(int wg) {
    const int lane = threadIdx.x & 31;
    r0 = wg * 64 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    tg = lane & 3;
  }
};

// ---------------------------------------------------------------------------
// 1. qkv = xn Wqkv^T + bqkv and do = dy Wproj
// ---------------------------------------------------------------------------

struct QkvParams {
  const bf16* bqkv;
  bf16* qkv;  // [M, 3C]
  bf16* dout;  // [M, C]
  int M, C;
};

constexpr int kQkvStage = kABytes + 2 * kBox;  // A [128][64], B 128 columns: four boxes

__global__ void __launch_bounds__(kThreads)
ah_bwd_qkv_do(const __grid_constant__ CUtensorMap tm_xn, const __grid_constant__ CUtensorMap tm_dy,
              const __grid_constant__ CUtensorMap tm_wqkv,
              const __grid_constant__ CUtensorMap tm_wproj, const QkvParams p, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring(smem_raw, 0, kQkvStage, stages);
  ring.init();
  __syncthreads();
  // tile t: rows (t / nc) 128 .., output columns (t % nc) 128 .. of [qkv | do];
  // a block walks tiles blockIdx.x, + gridDim.x, ..., so the blocks at work
  // at once share their A rows (in L2) and the ring runs on across tiles
  const int nc = 4 * p.C / 128;
  const int n_qkv = 3 * p.C / 128;  // column tiles of qkv, then C / 128 of do
  const int n_tiles = (p.M + kBM - 1) / kBM * nc;
  const int n_k = p.C / kK;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kProducer) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int mt = t / nc;
        const bool is_qkv = t % nc < n_qkv;
        const int n0 = (is_qkv ? t % nc : t % nc - n_qkv) * 128;
        const CUtensorMap* a_map = is_qkv ? &tm_xn : &tm_dy;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = ring.produce(it, kQkvStage);
          unsigned char* st = ring.stage(s);
          uint64_t* bar = ring.full() + s;
          tma_load(st, a_map, bar, kt * kK, mt * kBM, 0);  // A: 128 rows, two boxes
          tma_load(st + kBox, a_map, bar, kt * kK, mt * kBM + 64, 0);
          if (is_qkv) {  // Wqkv rows n0 .. n0 + 127, K-major
            tma_load(st + kABytes, &tm_wqkv, bar, kt * kK, n0, 0);
            tma_load(st + kABytes + kBox, &tm_wqkv, bar, kt * kK, n0 + 64, 0);
          } else {  // Wproj [k][n], MN-major
            tma_load(st + kABytes, &tm_wproj, bar, n0, kt * kK, 0);
            tma_load(st + kABytes + kBox, &tm_wproj, bar, n0 + 64, kt * kK, 0);
          }
        }
      }
    }
    return;
  }
  const int wg = threadIdx.x >> 7;
  const Frag f(wg);
  float acc[64];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, it += n_k) {
    const int mt = t / nc;
    const bool is_qkv = t % nc < n_qkv;
    const int n0 = (is_qkv ? t % nc : t % nc - n_qkv) * 128;
    consume_tile(ring, it, n_k, [&](int s, bool first) {
      const bf16* a = reinterpret_cast<const bf16*>(ring.stage(s)) + wg * 64 * kK;
      const bf16* b = reinterpret_cast<const bf16*>(ring.stage(s) + kABytes);
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        const int accumulate = !(first && ks == 0);
        if (is_qkv) {
          Wgmma<128>::ss_t<0, 0>(acc, desc_k<64>(a, ks), desc_k<64>(b, ks), accumulate);
        } else {
          Wgmma<128>::ss_t<0, 1>(acc, desc_k<64>(a, ks), desc_b(b, ks), accumulate);
        }
      }
    });
    fence_regs<64>(acc);
    float bias[32];  // this thread's columns of bqkv (qkv tiles)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * f.tg;
      const float2 b2 = is_qkv ? __bfloat1622float2(
                                     *reinterpret_cast<const __nv_bfloat162*>(p.bqkv + n))
                               : make_float2(0.f, 0.f);
      bias[2 * j] = b2.x;
      bias[2 * j + 1] = b2.y;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * kBM + f.r0 + 8 * half;
      if (m >= p.M) continue;
      bf16* dst = is_qkv ? p.qkv + static_cast<size_t>(m) * 3 * p.C
                         : p.dout + static_cast<size_t>(m) * p.C;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * f.tg;
        // qkv: the sum plus the bias, rounded once; do: the sum, rounded
        const float v0 = acc[4 * j + 2 * half] + bias[2 * j];
        const float v1 = acc[4 * j + 2 * half + 1] + bias[2 * j + 1];
        *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dxn = dqkv Wqkv and the LayerNorm backward
// ---------------------------------------------------------------------------

struct DxParams {
  const bf16* x;        // [M, C]
  const bf16* dy;       // [M, C]
  const float* ln_g;    // [C]
  const float2* stats;  // [M] (mean, rstd) from the LayerNorm pass
  bf16* dx;             // [M, C]
  float* partial;       // [gridDim.x, 2C]: dln_g, then dln_b
  int M;
};

// A block's tile is kBM rows by all C columns, so the LayerNorm backward's
// row sums stay in the block.  C = 128: each warpgroup owns 64 of 128 rows
// and every column.  C = 256: each owns 128 of the columns of 64 rows (one
// m64n256 accumulator a thread would leave the epilogue no registers), and
// the two halves' row sums meet in shared memory.  Either way a thread holds
// 64 accumulators, one m64n128 product a k-step.
template <int C>
struct DxShape {
  static constexpr bool kSplit = C == 256;                      // warpgroups split the columns
  static constexpr int kBM = kSplit ? 64 : 128;                  // rows a tile
  static constexpr int kStage = kBM * kK * 2 + (C / 64) * kBox;  // A [kBM][64], B C/64 boxes
  static constexpr int kRed = 8 * 2 * C * 4;  // [8 warps][2][C] column sums
  static constexpr int kHead = kRed + 2048;   // and [2][64][2] row sums, ln_g [C]
  static constexpr int kStages = 4;
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
ah_bwd_dx(const __grid_constant__ CUtensorMap tm_dqkv, const __grid_constant__ CUtensorMap tm_wqkv,
          const DxParams p, int stages) {
  using S = DxShape<C>;
  constexpr int kBM = S::kBM;
  extern __shared__ unsigned char smem_raw[];
  const Ring ring(smem_raw, S::kHead, S::kStage, stages);
  ring.init();
  __syncthreads();
  const int n_mt = (p.M + kBM - 1) / kBM;
  constexpr int n_k = 3 * C / kK;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kProducer) {
      int it = 0;
      for (int mt = blockIdx.x; mt < n_mt; mt += gridDim.x) {
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = ring.produce(it, S::kStage);
          unsigned char* st = ring.stage(s);
          uint64_t* bar = ring.full() + s;
#pragma unroll
          for (int i = 0; i < kBM / 64; ++i) {
            tma_load(st + i * kBox, &tm_dqkv, bar, kt * kK, mt * kBM + 64 * i, 0);
          }
#pragma unroll
          for (int i = 0; i < C / 64; ++i) {
            tma_load(st + kBM * kK * 2 + i * kBox, &tm_wqkv, bar, 64 * i, kt * kK, 0);
          }
        }
      }
    }
    return;
  }
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5;  // 0..7
  const int lane = tid & 31;
  const int lane_g = lane >> 2;
  const int tg = lane & 3;
  // this thread's rows r0, r0 + 8 of the tile and its first column
  const int r0 = (S::kSplit ? 0 : wg * 64) + 16 * (warp & 3) + lane_g;
  const int c0 = S::kSplit ? wg * 128 : 0;
  float* red = reinterpret_cast<float*>(ring.base);             // [8][2][C]
  float* rows = reinterpret_cast<float*>(ring.base + S::kRed);  // [2][64][2] (split)
  float* gains = rows + 256;                                     // ln_g [C]
  for (int c = tid; c < C; c += kConsumers) gains[c] = p.ln_g[c];
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float run[2] = {0.f, 0.f};  // this thread's entries tid, tid + 256 of the block's [2][C] partial
  float acc[64];
  int it = 0;
  for (int mt = blockIdx.x; mt < n_mt; mt += gridDim.x, it += n_k) {
    consume_tile(ring, it, n_k, [&](int s, bool first) {
      const bf16* a = reinterpret_cast<const bf16*>(ring.stage(s)) + (S::kSplit ? 0 : wg * 64 * kK);
      const bf16* b = reinterpret_cast<const bf16*>(ring.stage(s) + kBM * kK * 2) + c0 * kK;
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        Wgmma<128>::ss_t<0, 1>(acc, desc_k<64>(a, ks), desc_b(b, ks), !(first && ks == 0));
      }
    });
    fence_regs<64>(acc);

    // the LayerNorm backward of rows m (half 0) and m + 8 (half 1)
    float mu[2], rstd[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    bool in[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * kBM + r0 + 8 * half;
      in[half] = m < p.M;
      const float2 st = in[half] ? p.stats[m] : make_float2(0.f, 0.f);
      mu[half] = st.x;
      rstd[half] = st.y;
    }
    // this thread's x, all loads in flight together
    __nv_bfloat162 xr[2][16];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bf16* xrow = p.x + static_cast<size_t>(mt * kBM + r0 + 8 * half) * C + c0 + 2 * tg;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        xr[half][j] = in[half] ? *reinterpret_cast<const __nv_bfloat162*>(xrow + 8 * j)
                               : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    // column sums of dxn xhat and dxn over the tile's rows, and each row's
    // sums of dxh = dxn g and dxh xhat over this thread's columns
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = c0 + 8 * j + 2 * tg + u;
        const float gc = gains[c];
        float col_g = 0.f, col_b = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!in[half]) continue;
          const float xv = __bfloat162float(u ? xr[half][j].y : xr[half][j].x);
          const float xhat = (xv - mu[half]) * rstd[half];
          const float dn = acc[4 * j + 2 * half + u];
          const float dxh = dn * gc;
          s1[half] += dxh;
          s2[half] += dxh * xhat;
          col_g += dn * xhat;
          col_b += dn;
        }
        // over the warp's 8 row pairs (lanes of one tg)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          col_g += __shfl_xor_sync(0xffffffffu, col_g, o);
          col_b += __shfl_xor_sync(0xffffffffu, col_b, o);
        }
        if (lane < 4) {
          red[(warp * 2) * C + c] = col_g;
          red[(warp * 2 + 1) * C + c] = col_b;
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      s1[half] = quad_sum(s1[half]);
      s2[half] = quad_sum(s2[half]);
    }
    if constexpr (S::kSplit) {  // the row sums of both column halves, added in a fixed order
      if (tg == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          rows[(wg * 64 + r0 + 8 * half) * 2] = s1[half];
          rows[(wg * 64 + r0 + 8 * half) * 2 + 1] = s2[half];
        }
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if constexpr (S::kSplit) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        s1[half] = rows[r * 2] + rows[(64 + r) * 2];
        s2[half] = rows[r * 2 + 1] + rows[(64 + r) * 2 + 1];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!in[half]) continue;
      const int m = mt * kBM + r0 + 8 * half;
      const float mean1 = s1[half] / C;
      const float mean2 = s2[half] / C;
      const size_t row = static_cast<size_t>(m) * C;
      __nv_bfloat162 dyr[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dyr[j] = *reinterpret_cast<const __nv_bfloat162*>(p.dy + row + c0 + 8 * j + 2 * tg);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j + 2 * tg;
        float out[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float xv = __bfloat162float(u ? xr[half][j].y : xr[half][j].x);
          const float xhat = (xv - mu[half]) * rstd[half];
          const float dxh = acc[4 * j + 2 * half + u] * gains[c + u];
          out[u] = __bfloat162float(u ? dyr[j].y : dyr[j].x) +
                   rstd[half] * (dxh - mean1 - xhat * mean2);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.dx + row + c) = __floats2bfloat162_rn(out[0], out[1]);
      }
    }
    // the warps' column sums, added in a fixed order into the running
    // partial: a column's rows lie with all 8 warps, or (split) with the 4
    // warps of the warpgroup that owns it
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = tid + e * kConsumers;  // (kind, column) = (idx / C, idx % C)
      if (idx < 2 * C) {
        const int col = idx % C;
        const int w0 = S::kSplit ? 4 * (col / 128) : 0;
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < (S::kSplit ? 4 : 8); ++w) a += red[((w0 + w) * 2 + idx / C) * C + col];
        run[e] += a;
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // red and rows are free for the next tile
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int idx = tid + e * kConsumers;
    if (idx < 2 * C) p.partial[static_cast<size_t>(blockIdx.x) * 2 * C + idx] = run[e];
  }
}

// ---------------------------------------------------------------------------
// 4. dwqkv = dqkv^T xn, dwproj = dy^T om, and their bias gradients
// ---------------------------------------------------------------------------

struct WgradParams {
  float* partial_w;    // [n_w, 4 C C]: dwqkv [3C][C], then dwproj [C][C]
  float* partial_col;  // [n_w, 4C]: dbqkv [3C], then dbproj [C]
  int M, C, per_chunk;  // per_chunk: tokens a chunk, a multiple of 64
};

constexpr int kWgradStage = kABytes + 2 * kBox;  // X two [64][64] boxes, Y two

__global__ void __launch_bounds__(kThreads)
ah_bwd_wgrad(const __grid_constant__ CUtensorMap tm_dqkv, const __grid_constant__ CUtensorMap tm_xn,
             const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_om,
             const WgradParams p, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring(smem_raw, kOnesBytes, kWgradStage, stages);
  const int tid = threadIdx.x;
  // the ones tile: any layout of ones reads as ones
  for (int i = tid; i < kOnesBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(ring.base)[i] = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                                                         0x3F803F80u);
  }
  fence_proxy_async();
  ring.init();
  __syncthreads();
  const int cn = p.C / 128;  // output column tiles of either gradient
  const int n_qkv = 3 * cn * cn;
  const bool is_qkv = blockIdx.x < n_qkv;
  const int tile = is_qkv ? blockIdx.x : blockIdx.x - n_qkv;
  const int mt = tile / cn;  // output rows mt 128 .. (columns of X)
  const int nt = tile % cn;  // output columns nt 128 .. (columns of Y)
  const int chunk = blockIdx.y;
  const int t0 = chunk * p.per_chunk;
  const int n_k = (min(p.M, t0 + p.per_chunk) - t0 + kK - 1) / kK;
  const bool sums = nt == 0;  // the first column of tiles also sums X's columns

  if (tid >= kConsumers) {
    if (tid == kProducer) {
      const CUtensorMap* mx = is_qkv ? &tm_dqkv : &tm_dy;
      const CUtensorMap* my = is_qkv ? &tm_xn : &tm_om;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = ring.produce(kt, kWgradStage);
        unsigned char* st = ring.stage(s);
        uint64_t* bar = ring.full() + s;
        const int row = t0 + kt * kK;
        tma_load(st, mx, bar, mt * 128, row, 0);
        tma_load(st + kBox, mx, bar, mt * 128 + 64, row, 0);
        tma_load(st + kABytes, my, bar, nt * 128, row, 0);
        tma_load(st + kABytes + kBox, my, bar, nt * 128 + 64, row, 0);
      }
    }
    return;
  }
  const int wg = tid >> 7;
  const bf16* ones = reinterpret_cast<const bf16*>(ring.base);
  float acc[64], colsum[4] = {0.f, 0.f, 0.f, 0.f};
  consume_tile(ring, 0, n_k, [&](int s, bool first) {
    const bf16* a = reinterpret_cast<const bf16*>(ring.stage(s) + wg * kBox);  // X^T, MN-major
    const bf16* b = reinterpret_cast<const bf16*>(ring.stage(s) + kABytes);
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      const int accumulate = !(first && ks == 0);
      Wgmma<128>::ss_t<1, 1>(acc, desc_mn<64>(a, ks), desc_b(b, ks), accumulate);
      if (sums) Wgmma<8>::ss_t<1>(colsum, desc_mn<64>(a, ks), desc_k<64>(ones, ks), accumulate);
    }
  });
  fence_regs<64>(acc);
  fence_regs<4>(colsum);
  const Frag f(wg);
  float* out = p.partial_w + static_cast<size_t>(chunk) * 4 * p.C * p.C +
               (is_qkv ? 0 : static_cast<size_t>(3) * p.C * p.C);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = mt * 128 + f.r0 + 8 * half;
    float* dst = out + static_cast<size_t>(r) * p.C + nt * 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * f.tg) =
          make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
    if (sums && f.tg == 0) {
      p.partial_col[static_cast<size_t>(chunk) * 4 * p.C + (is_qkv ? 0 : 3 * p.C) + r] =
          colsum[2 * half];
    }
  }
}

// ---------------------------------------------------------------------------
// the launches
// ---------------------------------------------------------------------------

struct Launch {
  const bf16 *x, *xn, *dy, *wqkv, *bqkv, *wproj;
  const float *ln_g, *bias, *mask;
  const float2* stats;
  bf16 *dx, *qkv, *dout;  // qkv / dqkv [M, 3C] and do / om [M, C] scratch
  float *p_bias, *p_w, *p_col, *p_ln;
  int B, Hp, Wp, C, H, ws;
  float scale;
  int n_attn, attn_stages;
  size_t attn_smem;
  int n_w, n_dx, n_qkv, qkv_stages, dx_stages, w_stages;
};

template <int C>
cudaError_t launch(const Launch& a, cudaStream_t stream) {
  const int M = a.B * a.Hp * a.Wp;
  // every operand in [64][64] boxes at the 128-byte swizzle; a tile of 128
  // rows is two boxes
  CUtensorMap tm_xn, tm_dy, tm_qkv, tm_om, tm_wqkv, tm_wproj;
  if (!encode_tiles(&tm_xn, a.xn, C, M, 1, C, 64) || !encode_tiles(&tm_dy, a.dy, C, M, 1, C, 64) ||
      !encode_tiles(&tm_qkv, a.qkv, 3 * C, M, 1, 3 * C, 64) ||
      !encode_tiles(&tm_om, a.dout, C, M, 1, C, 64) ||
      !encode_tiles(&tm_wqkv, a.wqkv, C, 3 * C, 1, C, 64) ||
      !encode_tiles(&tm_wproj, a.wproj, C, C, 1, C, 64)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;

  // 1. qkv and do
  const size_t qkv_smem = smem_bytes(0, kQkvStage, a.qkv_stages);
  if ((err = emct_allow_smem(ah_bwd_qkv_do, qkv_smem)) != cudaSuccess) return err;
  ah_bwd_qkv_do<<<a.n_qkv, kThreads, qkv_smem, stream>>>(
      tm_xn, tm_dy, tm_wqkv, tm_wproj, QkvParams{a.bqkv, a.qkv, a.dout, M, C}, a.qkv_stages);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 2. the attention backward, in place: dqkv over qkv, om over do
  err = wa_bwd90::launch(a.qkv, a.dout, a.bias, a.mask, a.qkv, a.dout, a.p_bias, a.B, a.Hp, a.Wp,
                         C, a.H, a.ws, a.scale, a.n_attn, a.attn_stages, a.attn_smem, stream);
  if (err != cudaSuccess) return err;

  // 3. dx and the LayerNorm partials
  const size_t dx_smem = smem_bytes(DxShape<C>::kHead, DxShape<C>::kStage, a.dx_stages);
  if ((err = emct_allow_smem(ah_bwd_dx<C>, dx_smem)) != cudaSuccess) return err;
  ah_bwd_dx<C><<<a.n_dx, kThreads, dx_smem, stream>>>(
      tm_qkv, tm_wqkv, DxParams{a.x, a.dy, a.ln_g, a.stats, a.dx, a.p_ln, M}, a.dx_stages);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 4. weight and bias gradients, one partial per (tile, chunk)
  const int n_rt = (M + kK - 1) / kK;
  const int per_chunk = (n_rt + a.n_w - 1) / a.n_w * kK;
  const size_t w_smem = smem_bytes(kOnesBytes, kWgradStage, a.w_stages);
  if ((err = emct_allow_smem(ah_bwd_wgrad, w_smem)) != cudaSuccess) return err;
  const int tiles = 4 * (C / 128) * (C / 128);
  ah_bwd_wgrad<<<dim3(tiles, a.n_w), kThreads, w_smem, stream>>>(
      tm_qkv, tm_xn, tm_dy, tm_om, WgradParams{a.p_w, a.p_col, M, C, per_chunk}, a.w_stages);
  return cudaGetLastError();
}

}  // namespace ah_bwd90
