// The bf16 window-attention forward on Hopper (sm_90a): kernel 1
// (window_attention_fwd.cu) launches it.
//
// Per image b, window w and head h (T = ws*ws <= 64 tokens, d = 32), from
// qkv[B, Hp, Wp, 3C], bias[H, T, T] and mask[nW, T, T] (or none):
//   out[w, :, h] = P~ v,  P~ = softmax(q k^T * scale + bias[h] + mask[w])
//                              rounded to bf16 (fp32 softmax)
// with out[B, Hp, Wp, C] written at the window's spatial rows.
//
// What bounds it on an H100: memory.  Per token and head it reads 3d and
// writes d bf16 values against 4 T d flops, ~25 flops a byte, far under the
// ~295 at which the tensor cores would be the limit.  So the design keeps the
// loads in flight and does the rest in their shadow.
//
// What held the mma.sync kernel it replaces at 3.4-3.6x its bytes: (a) each
// block, one (image, window, head), read the head's bias and the window's
// mask from L2 with scalar loads, twice the bytes of the qkv it needed; (b)
// it transposed v into shared memory with 2-byte stores; (c) each block was
// one dependent chain (gather, barrier, products, softmax, store) with no
// load in flight for the next window.
//
// Design.  The backward's (window_attention_bwd_sm90.cuh), with two of its
// products: one warpgroup a block owns one (window position, head) pair and
// walks a chunk of images, so the logit terms (bias[h] + mask[w],
// -inf for a padded key) are summed once into shared memory for all of them
// (window_sm90.cuh, fill_terms).  Each image's q, k and v arrive by TMA in a
// ring of ``stages`` images: a 4-D tensor map over [B, Hp, Wp, 3C] with a box
// of (32 columns, ws, ws, 1 image) lands one head's window as T rows of 64
// bytes at the 64-byte swizzle, three boxes an image, and the box does the
// window gather.  Rows T..63 of every tile are zeroed once and never written
// by TMA (padded keys have k = v = 0 and are masked to -inf).  Thread 0
// refills a stage once the whole warpgroup is past the image that used it,
// so the loads of the next images run under this one's products.
//
// Products on wgmma: S = q k^T (m64n64k16, both tiles K-major from shared
// memory) and O = P~ v (m64n32k16, P~ rounded in registers as the A operand,
// the S accumulators being its fragments, v read MN-major: no transpose; the
// backward's om product).  wgmma's accumulators hold the entries mma.sync's
// did and its k16 sums are mma.sync's, and the softmax repeats the old
// kernel's fp32 steps (softmax_rows<true>: multiply by the scale and round,
// add the terms, exp(x - max), sum, 1 / sum, multiply, round), so the
// outputs keep its bits; with the scale fused into the add, as the backward
// has it, they did not.  The output rows go out as the old kernel wrote them:
// four lanes a 16-byte chunk of a row, every 32-byte sector written whole by
// one warp; a thread's two rows' offsets are computed once a block.  (Staged
// through shared memory and stored as 16-byte pieces of whole 64-byte rows,
// they ran no faster on an H100.)
//
// Occupancy and cutting the work: 128 threads, <= 102 registers, ~42 KB of
// shared memory (a ring of two images and the terms) let five blocks share
// an SM, so five chains of products and softmax interleave on it while up to
// ten images' loads are in flight.  Each block's set-up (the ring's zeros,
// the terms, the first loads) is paid once for its chunk of images, so the
// grid is cut to about one wave (fwd_geometry): all blocks resident, each
// walking as many images as that leaves it.
#pragma once

#include "window_sm90.cuh"

namespace wa_fwd90 {

using namespace wa_sm90;

constexpr int kImageBytes = 3 * kTileBytes;  // q, k, v of one image
constexpr int kMaxStages = 4;
constexpr int kMinBlocks = 5;  // blocks an SM: <= 102 registers a thread

// 1024 bytes of alignment slack, the ring, the logit terms, a full barrier a
// stage.  kernels/window_attention.py:fwd_geometry computes the same.
inline constexpr size_t smem_bytes(int stages) {
  return 1024 + static_cast<size_t>(stages) * kImageBytes + kTermBytes +
         8 * static_cast<size_t>(stages);
}

struct Params {
  const float* bias;  // [H, T, T]
  const float* mask;  // [nW, T, T] or null
  bf16* out;          // [B, Hp, Wp, C]
  int B, Hp, Wp, C, H, ws, per_block, stages;
  float scale;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_attention_fwd_sm90(const __grid_constant__ CUtensorMap tm_qkv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = base;
  float4* terms = reinterpret_cast<float4*>(ring + p.stages * kImageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kImageBytes + kTermBytes);
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
  const uint32_t image_bytes = 3u * nt * kD * 2;  // what the three boxes deliver

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
  };
  if (tid == 0) {
    for (int i = 0; i < min(p.stages, n_img); ++i) issue(i);
  }

  fill_terms(terms, p.bias, p.mask, nt, h, win, r0, tg, tid);  // each thread reads its own
  // this thread's two output rows within an image (rows past T are not stored)
  const size_t image_stride = static_cast<size_t>(p.Hp) * p.Wp * p.C;
  size_t row_off[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = min(r0 + 8 * half, nt - 1);
    row_off[half] = (static_cast<size_t>(y0 + r / ws) * p.Wp + (x0 + r % ws)) * p.C + h * kD +
                    2 * tg;
  }

  for (int i = 0; i < n_img; ++i) {
    const int s = i % p.stages;
    const bf16* sq = tile(s, 0);
    const bf16* sk = tile(s, 1);
    const bf16* sv = tile(s, 2);
    bar_wait(full + s, (i / p.stages) & 1);

    // S = q k^T, query rows of this warp, all 64 keys
    float sc[8][4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      Wgmma<64>::ss(&sc[0][0], desc_k<kD>(sq, ks), desc_k<kD>(sk, ks), ks);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs<32>(&sc[0][0]);

    float inv0, inv1;
    softmax_rows<true>(sc, terms, p.scale, tid, nt, inv0, inv1);
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
    for (int t = 0; t < 4; ++t) Wgmma<32>::rs(o, ap[t], desc_mn<kD>(sv, t));
    wg_commit();
    wg_wait<0>();
    fence_frags<16>(&ap[0][0]);
    fence_regs<16>(o);

    __syncthreads();  // the warpgroup is done with stage s
    if (tid == 0 && i + p.stages < n_img) issue(i + p.stages);
    bf16* img = p.out + (b_begin + i) * image_stride;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (r0 + 8 * half < nt) {
#pragma unroll
        for (int dn = 0; dn < 4; ++dn) {
          *reinterpret_cast<__nv_bfloat162*>(img + row_off[half] + dn * 8) =
              __floats2bfloat162_rn(o[4 * dn + 2 * half], o[4 * dn + 2 * half + 1]);
        }
      }
    }
  }
}

// The geometry (image chunks, stages, shared memory) comes from the Python
// wrapper (kernels/window_attention.py:fwd_geometry) and must be the one this
// code expects.
inline cudaError_t launch(const void* qkv, const float* bias, const float* mask, void* out, int B,
                          int Hp, int Wp, int C, int H, int ws, float scale, int n_chunks,
                          int stages, size_t smem, cudaStream_t stream) {
  const int per_block = (B + n_chunks - 1) / n_chunks;
  if (stages < 1 || stages > kMaxStages || smem != smem_bytes(stages) || smem > kMaxSmem ||
      n_chunks < 1 || (n_chunks - 1) * per_block >= B) {  // no chunk may be empty
    return cudaErrorInvalidValue;
  }
  CUtensorMap tm_qkv;
  if (!encode_window_map(&tm_qkv, qkv, 3 * C, B, Hp, Wp, ws)) return cudaErrorInvalidValue;
  const Params p{bias, mask, static_cast<bf16*>(out), B, Hp, Wp, C, H, ws, per_block, stages,
                 scale};
  const dim3 grid((Hp / ws) * (Wp / ws) * H, n_chunks);
  const cudaError_t err = emct_allow_smem(window_attention_fwd_sm90, smem);
  if (err != cudaSuccess) return err;
  window_attention_fwd_sm90<<<grid, kThreads, smem, stream>>>(tm_qkv, p);
  return cudaGetLastError();
}

}  // namespace wa_fwd90
