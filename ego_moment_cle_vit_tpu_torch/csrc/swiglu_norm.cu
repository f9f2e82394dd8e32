// EVA-02's SwiGLU glue between fc1 and fc2, where no gradient is wanted
// (serving, evaluation): for each row of g = fc1_g(x) and u = fc1_x(x),
// [rows, P] bf16 with the hidden width W <= P padded to a multiple of 8,
//   h = bf16(bf16(silu(g)) * u)                        (columns < W)
//   out = bf16((h - mean) * rsqrt(var + eps) * w + b)  (columns < W)
//   out = 0                                            (columns W..P-1)
// mean and the biased var of h over the W true columns in fp32, w and b the
// hidden LayerNorm's fp32 parameters: F.pad(LayerNorm(silu(g) * u)[..., :W],
// (0, P - W)) as models/eva.py's SwiGLU composes it, SiLU and the product in
// fp32, each rounded to bf16 where the bf16 tensors round them, so h has the
// composition's bits.  Only the order in which the statistics are summed
// differs.  fc2's padded product takes out as it is.
//
// Replaces no TPU kernel: the JAX package has no EVA backbone.  It was added
// because the composition (SiLU, the product, the fp32 round trip of the port
// LayerNorm over a strided slice, PyTorch's non-vectorised LayerNorm at a
// width of 2730, the pad) took ~2.9 ms of every EVA-02-L block at
// [64 x 1025, 2736] on an H100, ~70 ms of a 243 ms serving call.
//
// What bounds it on an H100: device-memory bytes.  g and u are read once and
// out written once, 3 x rows x P x 2 bytes: at [65600, 2736] 1.077 GB, 0.321 ms
// at 3.35 TB/s.
//
// Design.  A warp owns a row at a time and holds it in registers: lane l
// holds the 16-byte chunks c = l + 32 k (k < CH <= 12, rows up to 3072 wide),
// so neighbouring lanes read and write neighbouring addresses and the row is
// read from device memory once.  The row arrives in four parts of ceil(CH / 4)
// chunks, h formed and its sum taken as each part lands; the first part of the
// warp's next row is loaded under this row's statistics and output.  (All of a
// row's loads in flight at once held 88 registers a lane and spilled at the
// 128 a thread that sixteen warps an SM leave; so did two parts.)  The
// variance is a second pass over the row in registers, reduced like the sum
// with warp shuffles; no shared-memory step is needed.  SiLU costs no
// arithmetic in the loop: its input is bf16, so each block first tabulates
// SiLU in shared memory for all 65536 bf16 values (x / (1 + expf(-x)) in fp32
// rounded to bf16, the function PyTorch's F.silu computes on a bf16 tensor),
// and the product of two bf16 values, exact in fp32, is rounded once by a
// bf16x2 multiply.  Computing SiLU per element (an accurate expf and an IEEE
// division) issued ~46 instructions an element and took 0.73 ms at
// [65600, 2736]; the table leaves ~15.  w and b are staged once a block
// beside the table, laid out so that a warp's 16-byte reads of them fall on
// consecutive addresses.  The 128 KB table takes the SM's shared memory, so
// a block of sixteen warps runs on each SM and walks rows with a stride of
// the grid.  Loads and stores are streaming (evict-first): nothing here is
// read twice.  At [65600, 2736] on an H100 80GB HBM3 at 700 W: 0.408 ms,
// 79 % of the bytes bound.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;      // rows in flight a block, one a warp; a block an SM
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 12;  // 16-byte chunks a lane holds: rows up to 3072 wide
constexpr int kParts = 4;       // a row is loaded in this many parts
constexpr int kTableBytes = 65536 * 2;  // the bf16 SiLU of every bf16 value

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Keeps the compiler from holding a row's unpacked values from one pass to
// the next (8 floats a chunk live in place of 4 words, which spilled): each
// pass unpacks the row again, at an instruction an element.
__device__ __forceinline__ void opaque(uint4& v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
}

// h = bf16(silu(g) u) for two bf16 pairs: SiLU from the table, then one
// bf16x2 multiply (the product of two bf16 values is exact in fp32 above its
// subnormal range, so its one rounding is the fp32 product's rounding to bf16)
__device__ __forceinline__ uint32_t silu_times(const unsigned short* table, uint32_t g,
                                               uint32_t u) {
  const uint32_t s = table[g & 0xffffu] | (static_cast<uint32_t>(table[g >> 16]) << 16);
  const __nv_bfloat162 h = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&s),
                                   *reinterpret_cast<const __nv_bfloat162*>(&u));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A lane's chunks k0 .. k0 + PART - 1 of g and u (those inside the row).
template <int PART>
__device__ __forceinline__ void load_part(uint4 (&gv)[PART], uint4 (&uv)[PART],
                                          const uint4* __restrict__ g,
                                          const uint4* __restrict__ u, size_t base, int k0,
                                          int lane, int chunks) {
#pragma unroll
  for (int i = 0; i < PART; ++i) {
    if (lane + 32 * (k0 + i) < chunks) {
      gv[i] = __ldcs(g + base + lane + 32 * (k0 + i));
      uv[i] = __ldcs(u + base + lane + 32 * (k0 + i));
    }
  }
}

// h of those chunks, and its sum over the true columns into acc (four
// partial sums); only the chunk that holds the width's end is masked.
template <int CH, int PART>
__device__ __forceinline__ void silu_part(uint4 (&h)[CH], const uint4 (&gv)[PART],
                                          const uint4 (&uv)[PART], const unsigned short* table,
                                          int k0, int lane, int chunks, int width,
                                          float (&acc)[4]) {
#pragma unroll
  for (int i = 0; i < PART; ++i) {
    if (k0 + i >= CH) continue;
    const int c = lane + 32 * (k0 + i);
    h[k0 + i] = make_uint4(0, 0, 0, 0);
    if (c >= chunks) continue;
    h[k0 + i].x = silu_times(table, gv[i].x, uv[i].x);
    h[k0 + i].y = silu_times(table, gv[i].y, uv[i].y);
    h[k0 + i].z = silu_times(table, gv[i].z, uv[i].z);
    h[k0 + i].w = silu_times(table, gv[i].w, uv[i].w);
    float hf[8];
    unpack8(h[k0 + i], hf);
    if (8 * c + 8 <= width) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j & 3] += hf[j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j & 3] += 8 * c + j < width ? hf[j] : 0.0f;
    }
  }
}

// One warp a row; CH = the chunks a lane holds, ceil(chunks / 32).
template <int CH>
__global__ void __launch_bounds__(kThreads, 1)
    swiglu_norm_kernel(const uint4* __restrict__ g, const uint4* __restrict__ u,
                       const float* __restrict__ w, const float* __restrict__ b,
                       uint4* __restrict__ out, int rows, int width, int chunks, float eps) {
  // the SiLU table, then w and b by chunk, each chunk's halves apart (lo[c] =
  // columns 8c..8c+3, hi[c] = 8c+4..8c+7), 0 past the width
  extern __shared__ float4 smem[];
  unsigned short* table = reinterpret_cast<unsigned short*>(smem);
  const float4* w_lo = smem + kTableBytes / 16;
  const float4* w_hi = w_lo + chunks;
  const float4* b_lo = w_lo + 2 * chunks;
  const float4* b_hi = w_lo + 3 * chunks;
  for (int i = threadIdx.x; i < 65536; i += kThreads) {
    // F.silu on bf16: x / (1 + exp(-x)) in fp32, rounded to bf16
    const float x = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(i)));
    table[i] = __bfloat16_as_ushort(__float2bfloat16(x / (1.0f + expf(-x))));
  }
  float* flat = reinterpret_cast<float*>(smem + kTableBytes / 16);
  for (int i = threadIdx.x; i < 8 * chunks; i += kThreads) {
    const int c = i >> 3, j = i & 7;
    const int at = 4 * ((j >> 2) * chunks + c) + (j & 3);
    const bool in = i < width;
    flat[at] = in ? w[i] : 0.0f;
    flat[at + 8 * chunks] = in ? b[i] : 0.0f;
  }
  __syncthreads();

  constexpr int PART = (CH + kParts - 1) / kParts;
  const int lane = threadIdx.x & 31;
  const float n = static_cast<float>(width);
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  uint4 ga[PART], ua[PART];  // the first part of the row
  if (row < rows) load_part(ga, ua, g, u, static_cast<size_t>(row) * chunks, 0, lane, chunks);
  for (; row < rows; row += stride) {
    const size_t base = static_cast<size_t>(row) * chunks;
    uint4 h[CH];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    silu_part(h, ga, ua, table, 0, lane, chunks, width, acc);
#pragma unroll
    for (int p = 1; p < kParts; ++p) {
      if (p * PART < CH) {
        uint4 gv[PART], uv[PART];
        load_part(gv, uv, g, u, base, p * PART, lane, chunks);
        silu_part(h, gv, uv, table, p * PART, lane, chunks, width, acc);
      }
    }
    if (row + stride < rows) {  // the next row's first part, under this row's passes
      load_part(ga, ua, g, u, base + static_cast<size_t>(stride) * chunks, 0, lane, chunks);
    }
    const float mean = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3])) / n;

#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = lane + 32 * k;
      if (c >= chunks) continue;
      float hf[8];
      opaque(h[k]);
      unpack8(h[k], hf);
      if (8 * c + 8 <= width) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = hf[j] - mean;
          acc[j & 3] += d * d;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = 8 * c + j < width ? hf[j] - mean : 0.0f;
          acc[j & 3] += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3])) / n + eps);

#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = lane + 32 * k;
      if (c >= chunks) continue;
      float hf[8];
      opaque(h[k]);
      unpack8(h[k], hf);
      const float4 wl = w_lo[c], wh = w_hi[c], bl = b_lo[c], bh = b_hi[c];
      const float wv[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
      const float bv[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
      if (8 * c + 8 <= width) {
#pragma unroll
        for (int j = 0; j < 8; ++j) hf[j] = (hf[j] - mean) * rstd * wv[j] + bv[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          hf[j] = 8 * c + j < width ? (hf[j] - mean) * rstd * wv[j] + bv[j] : 0.0f;
        }
      }
      __stcs(out + base + c, pack8(hf));
    }
  }
}

template <int CH>
cudaError_t launch(int ch, const uint4* g, const uint4* u, const float* w, const float* b,
                   uint4* out, int rows, int width, int chunks, float eps, cudaStream_t s) {
  if constexpr (CH < kMaxChunks) {
    if (ch > CH) return launch<CH + 1>(ch, g, u, w, b, out, rows, width, chunks, eps, s);
  }
  const size_t smem = kTableBytes + 4 * sizeof(float4) * static_cast<size_t>(chunks);
  int device = 0, sms = 0;
  cudaError_t err = emct_allow_smem(swiglu_norm_kernel<CH>, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int blocks = std::min((rows + kWarps - 1) / kWarps, sms);
  swiglu_norm_kernel<CH><<<blocks, kThreads, smem, s>>>(g, u, w, b, out, rows, width, chunks, eps);
  return cudaGetLastError();
}

}  // namespace

// g, u, out: [rows, padded] bf16, rows 16-byte aligned; w, b: [width] fp32.
extern "C" int swiglu_norm(const void* g, const void* u, const void* w, const void* b, void* out,
                           int rows, int width, int padded, float eps, void* stream) {
  const int chunks = padded / 8;
  if (rows < 1 || width < 1 || width > padded || padded % 8 != 0 ||
      chunks > 32 * kMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<1>(
      (chunks + 31) / 32, static_cast<const uint4*>(g), static_cast<const uint4*>(u),
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<uint4*>(out), rows,
      width, chunks, eps, static_cast<cudaStream_t>(stream)));
}
