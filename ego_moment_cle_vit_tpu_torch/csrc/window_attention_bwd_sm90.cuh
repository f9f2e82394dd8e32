// The bf16 window-attention backward on Hopper (sm_90a): kernel 1b
// (window_attention_bwd.cu) launches it on the saved qkv, and the fused
// attention half's backward (kernel 4b, attn_half_bwd.cu) on the q, k, v and
// do it recomputed, where it also forms om = P~ v.
//
// Per image b, window w and head h (T = ws*ws <= 64 tokens, d = 32), from
// qkv[B, Hp, Wp, 3C], bias[H, T, T], mask[nW, T, T] and dout[B, Hp, Wp, C]:
//   P  = softmax(q k^T * scale + bias[h] + mask[w])        (recomputed, fp32)
//   dv = P~^T do            P~ = P rounded to bf16
//   dp = do v^T
//   ds = P * (dp - rowsum(dp * P))                         (fp32)
//   dq = ds~ k * scale,  dk = ds~^T q * scale              ds~ = ds rounded
//   dbias[h] = sum over images and windows of ds
//   (4b only) om = P~ v
// dq, dk, dv go to dqkv[B, Hp, Wp, 3C] at the window's spatial rows.
//
// What bounds it on an H100: memory.  Per token and head it reads 4d values
// and writes 3d, against 10 T d flops: ~35 flops a byte in bf16, far under
// the ~295 at which the tensor cores would be the limit.  So the design keeps
// loads in flight and does the products in their shadow.
//
// Design.  A block is one warpgroup and owns one (window position, head)
// pair: it walks a chunk of images, so the head's bias, the window's mask and
// the [T, T] bias-gradient sum stay on chip, and it writes one dbias partial
// (a second kernel adds the partials in a fixed order: no float atomics, the
// same bits every run).  Each image's q, k, v and do arrive by TMA in a ring
// of ``stages`` images: a 4-D tensor map over [B, Hp, Wp, cols] with a box
// of (32 columns, ws, ws, 1 image) lands one head's window as T contiguous
// 64-byte rows, at the 64-byte swizzle the wgmma descriptors read; the box
// does the window gather that a per-thread load loop did before.  Rows T..63
// of every tile are zeroed once and never written by TMA, so padded keys have
// k = v = 0 (and are masked to -inf) and padded queries have q = do = 0
// (their ds is zero, they add nothing to dk, dv or dbias).  Thread 0 refills
// a stage once the whole warpgroup is past the image that used it.
//
// Products, all wgmma (bf16 in, fp32 sums): S = q k^T and dP = do v^T with
// both operands from shared memory (K-major); dq = ds~ k (and om = P~ v) with
// ds~ (P~) rounded in registers as the A operand and k (v) read MN-major; dv
// = P~^T do and dk = ds~^T q with P~ and ds~ written once to shared memory
// ([query][key] at the 128-byte swizzle) and read as a transposed A operand,
// do and q MN-major.  Every product sums over its contraction in 16-wide
// steps in order, as the mma.sync kernel before it did.
//
// The softmax is exact in one pass (a window is one tile).  Each thread's 32
// logit terms (bias plus mask, or -inf for a padded key) are the same for
// every image of the block, so they are summed once into shared memory, laid
// out so that each thread reads its own with 16-byte loads.  Adding the two
// tables first rounds differently from adding them one at a time only where
// the mask is not zero; Swin's masks hold 0 or -100, and a -100 entry's
// probability (~e^-100) rounds to 0 in P~ either way.
//
// Occupancy: 128 threads, <= 168 registers and ~65 KB of shared memory (a
// ring of two images) let three blocks share an SM (two for 4b, whose om
// product needs more registers); the per-image chain of products, softmax
// and barriers is latency-bound, so more blocks in flight is what speeds it.
#pragma once

#include "window_sm90.cuh"

namespace wa_bwd90 {

using namespace wa_sm90;

constexpr int kImageBytes = 4 * kTileBytes;          // q, k, v, do of one image
constexpr int kPBytes = kTok * kTok * 2;             // P~ or ds~ [64][64] bf16, 128-byte swizzle
constexpr int kMaxStages = 4;
// blocks an SM: 3 for 1b (registers <= 168); 2 with om, whose registers
// would spill at 3
template <bool kOm>
constexpr int kMinBlocks = kOm ? 2 : 3;

// 1024 bytes of alignment slack, the ring, P~ and ds~, the logit terms, a
// full barrier a stage.  kernels/window_attention.py:bwd_geometry computes
// the same.
inline constexpr size_t smem_bytes(int stages) {
  return 1024 + static_cast<size_t>(stages) * kImageBytes + 2 * kPBytes + kTermBytes +
         8 * static_cast<size_t>(stages);
}

struct Params {
  const float* bias;   // [H, T, T]
  const float* mask;   // [nW, T, T] or null
  bf16* dqkv;          // [B, Hp, Wp, 3C]; may be qkv itself (4b)
  bf16* om;            // [B, Hp, Wp, C] or null; may be dout itself (4b)
  float* partial;      // [n_chunks, nW, H, T, T]
  int B, Hp, Wp, C, H, ws, per_block, stages;
  float scale;
};

// Byte offset of element (row, col) of a [64][64] bf16 tile at the 128-byte
// swizzle: the 16-byte chunk col / 8 of row r lies at chunk (col / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
}

// The four bf16 A fragments of an m64n64 accumulator strip (to_fragments'
// output) into a [64][64] tile at the 128-byte swizzle: fragment t holds
// columns 16t + 2tg (+8) of rows r0 and r0 + 8.
__device__ __forceinline__ void store_fragments(unsigned char* tile, const uint32_t (*a)[4], int r0,
                                                int tg) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = 16 * t + 2 * tg;
    *reinterpret_cast<uint32_t*>(tile + swz128(r0, c)) = a[t][0];
    *reinterpret_cast<uint32_t*>(tile + swz128(r0 + 8, c)) = a[t][1];
    *reinterpret_cast<uint32_t*>(tile + swz128(r0, c + 8)) = a[t][2];
    *reinterpret_cast<uint32_t*>(tile + swz128(r0 + 8, c + 8)) = a[t][3];
  }
}

template <bool kOm>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kOm>)
window_attention_bwd_sm90(const __grid_constant__ CUtensorMap tm_qkv,
                          const __grid_constant__ CUtensorMap tm_do, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = base;
  unsigned char* sp = ring + p.stages * kImageBytes;  // P~ [query][key]
  unsigned char* sds = sp + kPBytes;                   // ds~ [query][key]
  float4* terms = reinterpret_cast<float4*>(sds + kPBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(sds + kPBytes + kTermBytes);
  auto tile = [&](int s, int i) {
    return reinterpret_cast<bf16*>(ring + s * kImageBytes + i * kTileBytes);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows: r0 and r0 + 8
  const int ws = p.ws;
  const int nt = ws * ws;
  const int nwx = p.Wp / ws;
  const int win = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int y0 = (win / nwx) * ws;
  const int x0 = (win % nwx) * ws;
  const int b_begin = blockIdx.y * p.per_block;
  const int n_img = min(p.B, b_begin + p.per_block) - b_begin;
  const uint32_t image_bytes = 4u * nt * kD * 2;  // what the four boxes deliver

  // zero the ring once (rows past T stay zero), then the barriers
  for (int i = tid; i < p.stages * kImageBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) bar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {  // image b_begin + i into stage i % stages
    const int s = i % p.stages;
    const int b = b_begin + i;
    bar_arrive_tx(full + s, image_bytes);
    tma_load_4d(tile(s, 0), &tm_qkv, full + s, h * kD, x0, y0, b);            // q
    tma_load_4d(tile(s, 1), &tm_qkv, full + s, p.C + h * kD, x0, y0, b);      // k
    tma_load_4d(tile(s, 2), &tm_qkv, full + s, 2 * p.C + h * kD, x0, y0, b);  // v
    tma_load_4d(tile(s, 3), &tm_do, full + s, h * kD, x0, y0, b);             // do
  };
  if (tid == 0) {
    for (int i = 0; i < min(p.stages, n_img); ++i) issue(i);
  }

  fill_terms(terms, p.bias, p.mask, nt, h, win, r0, tg, tid);

  float dbias_acc[8][4];
  zero_acc<8>(dbias_acc);
  for (int i = 0; i < n_img; ++i) {
    const int s = i % p.stages;
    const int b = b_begin + i;
    const bf16* sq = tile(s, 0);
    const bf16* sk = tile(s, 1);
    const bf16* sv = tile(s, 2);
    const bf16* sdo = tile(s, 3);
    bar_wait(full + s, (i / p.stages) & 1);

    // S = q k^T and dP = do v^T, query rows of this warp, all 64 keys
    float sc[8][4], dp[8][4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      Wgmma<64>::ss(&sc[0][0], desc_k<kD>(sq, ks), desc_k<kD>(sk, ks), ks);
    }
    wg_commit();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      Wgmma<64>::ss(&dp[0][0], desc_k<kD>(sdo, ks), desc_k<kD>(sv, ks), ks);
    }
    wg_commit();
    wg_wait<1>();  // S has landed; the softmax runs under the dP product
    fence_regs<32>(&sc[0][0]);

    // logits in fp32 (scale, then bias and mask), then the softmax over the
    // quad that holds a row
    float inv0, inv1;
    softmax_rows<false>(sc, terms, p.scale, tid, nt, inv0, inv1);
    wg_wait<0>();
    fence_regs<32>(&dp[0][0]);

    // P; delta_i = sum_j dp_ij P_ij; ds = P (dp - delta), in dp's registers
    float delta0 = 0.f, delta1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] *= inv0;
      sc[n][1] *= inv0;
      sc[n][2] *= inv1;
      sc[n][3] *= inv1;
      delta0 += dp[n][0] * sc[n][0] + dp[n][1] * sc[n][1];
      delta1 += dp[n][2] * sc[n][2] + dp[n][3] * sc[n][3];
    }
    delta0 = quad_sum(delta0);
    delta1 = quad_sum(delta1);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[n][e] = sc[n][e] * (dp[n][e] - (e < 2 ? delta0 : delta1));
        dbias_acc[n][e] += dp[n][e];
      }
    }

    // P~ and ds~ as bf16 A fragments; dq = ds~ k (and om = P~ v) from them
    uint32_t ap[4][4], as[4][4];
    to_fragments<8>(ap, sc);
    to_fragments<8>(as, dp);
    float dq[16], om[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) dq[e] = om[e] = 0.f;  // the rs form adds to its accumulator
    wg_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) Wgmma<32>::rs(dq, as[t], desc_mn<kD>(sk, t));
    if constexpr (kOm) {
#pragma unroll
      for (int t = 0; t < 4; ++t) Wgmma<32>::rs(om, ap[t], desc_mn<kD>(sv, t));
    }
    wg_commit();
    // P~ and ds~ once to shared memory for the products over queries
    store_fragments(sp, ap, r0, tg);
    store_fragments(sds, as, r0, tg);
    fence_proxy_async();
    __syncthreads();  // every warp's rows of P~ and ds~ are written

    // dv = P~^T do and dk = ds~^T q, key rows of this warp
    float dv[16], dk[16];
#pragma unroll
    for (int ks = 0; ks < kTok / 16; ++ks) {
      Wgmma<32>::ss_tt(dv, desc_mn<64>(reinterpret_cast<bf16*>(sp), ks), desc_mn<kD>(sdo, ks), ks);
    }
#pragma unroll
    for (int ks = 0; ks < kTok / 16; ++ks) {
      Wgmma<32>::ss_tt(dk, desc_mn<64>(reinterpret_cast<bf16*>(sds), ks), desc_mn<kD>(sq, ks), ks);
    }
    wg_commit();
    wg_wait<0>();
    fence_frags<16>(&ap[0][0]);
    fence_frags<16>(&as[0][0]);
    fence_regs<16>(dq);
    fence_regs<16>(dv);
    fence_regs<16>(dk);
    if constexpr (kOm) fence_regs<16>(om);

    store_strip(p.dqkv, dq, b, p.Hp, p.Wp, ws, y0, x0, r0, 3 * p.C, h * kD, tg, p.scale);
    store_strip(p.dqkv, dk, b, p.Hp, p.Wp, ws, y0, x0, r0, 3 * p.C, p.C + h * kD, tg, p.scale);
    store_strip(p.dqkv, dv, b, p.Hp, p.Wp, ws, y0, x0, r0, 3 * p.C, 2 * p.C + h * kD, tg, 1.f);
    if constexpr (kOm) store_strip(p.om, om, b, p.Hp, p.Wp, ws, y0, x0, r0, p.C, h * kD, tg, 1.f);
    __syncthreads();  // the warpgroup is done with stage s, P~ and ds~
    if (tid == 0 && i + p.stages < n_img) issue(i + p.stages);
  }

  // one [T, T] partial per block: partial[chunk][win][h][T*T]
  float* out = p.partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * nt * nt;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + 8 * (e >> 1);
      const int j = 8 * n + 2 * tg + (e & 1);
      if (i < nt && j < nt) out[i * nt + j] = dbias_acc[n][e];
    }
  }
}

// The per-block part (the partials then go to the ordered reduction).  The
// geometry (image chunks, stages, shared memory) comes from the Python
// wrapper (kernels/window_attention.py:bwd_geometry) and must be the one
// this code expects.  ``qkv`` and ``dout`` are read through tensor maps only,
// so ``dqkv`` and ``om`` may be the same buffers.
inline cudaError_t launch(const void* qkv, const void* dout, const float* bias, const float* mask,
                          void* dqkv, void* om, float* partial, int B, int Hp, int Wp, int C,
                          int H, int ws, float scale, int n_chunks, int stages, size_t smem,
                          cudaStream_t stream) {
  const int per_block = (B + n_chunks - 1) / n_chunks;
  if (stages < 1 || stages > kMaxStages || smem != smem_bytes(stages) || smem > kMaxSmem ||
      n_chunks < 1 || (n_chunks - 1) * per_block >= B) {  // no chunk may be empty
    return cudaErrorInvalidValue;
  }
  CUtensorMap tm_qkv, tm_do;
  if (!encode_window_map(&tm_qkv, qkv, 3 * C, B, Hp, Wp, ws) ||
      !encode_window_map(&tm_do, dout, C, B, Hp, Wp, ws)) {
    return cudaErrorInvalidValue;
  }
  const Params p{bias, mask, static_cast<bf16*>(dqkv), static_cast<bf16*>(om), partial,
                 B, Hp, Wp, C, H, ws, per_block, stages, scale};
  const dim3 grid((Hp / ws) * (Wp / ws) * H, n_chunks);
  auto kernel = om ? window_attention_bwd_sm90<true> : window_attention_bwd_sm90<false>;
  const cudaError_t err = emct_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(tm_qkv, tm_do, p);
  return cudaGetLastError();
}

}  // namespace wa_bwd90
