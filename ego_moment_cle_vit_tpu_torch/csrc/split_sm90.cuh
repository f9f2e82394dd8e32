// A Hopper (sm_90a) fp32-accurate batched product from bf16 planes, shared by
// the fp32 Newton–Schulz iSQRT (newton_schulz.cu, kernel 5) and the
// token-subspace iSQRT (subspace_isqrt.cu, kernel 7): a block computes one
// [128][N] fp32 tile of C = L R for one matrix of the batch and hands it to its
// kernel's epilogue in registers.
//
// The split.  An fp32 value x is held as three bf16 planes, hi + mid + lo = x
// exactly (8 significant bits each, 24 in all), and a product's six cross
// products down to 2^-24 (lo hi, mid mid, hi lo, mid hi, hi mid, hi hi) run as
// bf16 wgmma with fp32 sums; an operand that is exactly bf16 has its hi plane
// alone, and takes three.  The split is made once, where a matrix is made:
// each kernel's epilogue writes its result as three planes (store_split), so
// the products' loads are plain TMA boxes that cost the SM nothing; splitting
// in the main loop instead, every tile of a row or column once for each block
// that reads it, took a loader warpgroup's registers and instruction slots
// and ran the products at a quarter of the tensor cores' rate.
//
// Shape of a block.  Two consumer warpgroups each hold one m64nN accumulator,
// and a producer warp keeps a four-stage TMA ring of 32-deep contraction
// slices in flight, every plane of both operands a slice (48 KB a stage; two
// stages of 64 ran 2 % slower at N = 112).  A source whose rows are C's rows
// is read K-major; one whose rows are the contraction MN-major (wgmma reads
// it transposed), so no matrix is ever transposed in memory.  Precision:
// wgmma's fp32 sums do not round to nearest, so each stage's products go into
// a fresh accumulator, the small cross products first and hi hi last (the
// small ones round against their own size), and each stage's sum is added to
// a register sum with one IEEE fp32 addition: without that the subspace
// iSQRT's error against an fp64 witness read 2.4-3.1x the fp32 CUDA-core
// route's, with it 1.0-1.7x.  A stage waits for its own products before the
// next one starts: a second accumulator to overlap them spilled at the 168
// registers a thread that three warpgroups' worth of threads leave (at N =
// 128, 720 bytes of spills and 1.6x the time), and issuing the two consumers'
// stages in turns gained nothing (N = 112).  Rows and columns past a tensor
// map's ends arrive as zeros, so the planes' rows are padded to 8 elements
// (the 16 bytes a TMA row pitch needs) and the pad is never read.
//
// The mbarriers, TMA loads, wgmma fences and descriptors are sm90.cuh's.
#pragma once

#include "gemm_sm90.cuh"

namespace split_sm90 {

using namespace sm90;
using gemm_sm90::encode_tiles;

constexpr int kRows = 128;                 // C rows a block: two warpgroups of 64
constexpr int kK = 32;                     // contraction a stage: 64 bytes of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBoxBytes = 64 * kK * 2;     // 64 of C's side x kK: 4 KB
constexpr int kTermBytes = 2 * kBoxBytes;  // a plane's slot of a stage: 128 of C's side x kK
constexpr int kStageBytes = 2 * 3 * kTermBytes;  // L's and R's three planes: 48 KB
constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kStages) * kStageBytes + 16 * kStages;

// the row pitch of a matrix's planes: n rounded up to 8 bf16 values; a
// scratch's fp32 traces, one an image, take this much room ahead of its planes
// (kernels/subspace_isqrt.py:pitch and scratch_bytes, kernels/newton_schulz.py:
// fp32_geometry compute the same)
inline int pitch_of(int n) { return (n + 7) / 8 * 8; }
inline size_t trace_bytes(int b) { return (static_cast<size_t>(b) * 4 + 255) / 256 * 256; }

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = u;
  return __bfloat1622float2(h);
}

// Two neighbours x0, x1 as bf16 pairs hi, mid, lo with x = hi + mid + lo
// exactly (normal numbers): each term the nearest bf16 to what the terms
// before it leave; the subtractions are exact.  keep_lo = 0 writes no lo: the
// precision control of the card tests.
struct Split2 {
  uint32_t hi, mid, lo;
};
__device__ __forceinline__ Split2 split2(float x0, float x1, bool keep_lo) {
  Split2 s;
  s.hi = pack_bf16(x0, x1);
  float2 f = unpack(s.hi);
  x0 = __fsub_rn(x0, f.x);
  x1 = __fsub_rn(x1, f.y);
  s.mid = pack_bf16(x0, x1);
  f = unpack(s.mid);
  s.lo = keep_lo ? pack_bf16(__fsub_rn(x0, f.x), __fsub_rn(x1, f.y)) : 0u;
  return s;
}

// the fp32 pair at ``at`` of a matrix held as three planes ``plane`` apart
// (read-only while a kernel reads it, so the loads may pass its stores)
__device__ __forceinline__ float2 load_split(const bf16* m, long long plane, long long at) {
  const float2 hi = unpack(__ldg(reinterpret_cast<const unsigned int*>(m + at)));
  const float2 mid = unpack(__ldg(reinterpret_cast<const unsigned int*>(m + plane + at)));
  const float2 lo = unpack(__ldg(reinterpret_cast<const unsigned int*>(m + 2 * plane + at)));
  return make_float2(__fadd_rn(__fadd_rn(hi.x, mid.x), lo.x),
                     __fadd_rn(__fadd_rn(hi.y, mid.y), lo.y));
}

__device__ __forceinline__ void store_split(bf16* m, long long plane, long long at, float x0,
                                            float x1, bool keep_lo) {
  const Split2 s = split2(x0, x1, keep_lo);
  *reinterpret_cast<uint32_t*>(m + at) = s.hi;
  *reinterpret_cast<uint32_t*>(m + plane + at) = s.mid;
  *reinterpret_cast<uint32_t*>(m + 2 * plane + at) = s.lo;
}

// One operand of a product: Terms planes (1: an exactly bf16 input; 3: hi,
// mid, lo), read through a tensor map over [groups = planes x batch][rows]
// [cols].  Trans = 0: the source's rows are C's rows (Rows of them a tile),
// the contraction runs along them: one box [Rows][kK] a plane, K-major
// (64-byte rows, 64-byte swizzle).  Trans = 1: the source's rows are the
// contraction: two boxes [kK][64] side by side a plane, MN-major (128-byte
// rows and swizzle), which wgmma reads transposed.
template <int Terms, int Trans, int Rows>
struct Side {
  static_assert(Rows <= kRows, "a plane's slot holds 128 of C's side");
  static constexpr int kTerms = Terms;
  static constexpr int kTrans = Trans;
  static constexpr int kBytes = Trans ? 2 * kBoxBytes : Rows * kK * 2;  // a plane's boxes

  static __device__ __forceinline__ void load(unsigned char* dst, const CUtensorMap* map,
                                              uint64_t* bar, int r0, int k0, int group) {
    if (Trans) {
      tma_load(dst, map, bar, r0, k0, group);
      tma_load(dst + kBoxBytes, map, bar, r0 + 64, k0, group);
    } else {
      tma_load(dst, map, bar, k0, r0, group);
    }
  }
};

// A plane's tile as a wgmma operand at k-step ks: K-major, 16 columns 32
// bytes into each 2 kK-byte row, 8-row groups 16 kK bytes apart; MN-major,
// rows 16 ks .. 16 ks + 15 of its boxes, boxes a box apart, 8-row groups 1024
// bytes apart.
template <int Trans>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int ks) {
  if (Trans) return descriptor<64>(tile + ks * 16 * 128, kBoxBytes, 8 * 128);
  return descriptor<kK>(tile + ks * 32, 16, 8 * kK * 2);
}

// One stage's products at width N: every pair of planes (i, j) with
// i + j <= 2, the smallest first, over the stage's k-steps; accumulate = 0
// starts the accumulator afresh.  A contraction that ends inside the stage
// reads the zeros TMA filled past it: a k-step skipped at run time would put
// the products on a divergent path, where ptxas serializes every wgmma
// (C7520).
template <class L, class R, int N>
__device__ __forceinline__ void stage_products(float* acc, uint32_t l, uint32_t r,
                                               int accumulate) {
#pragma unroll
  for (int order = 2; order >= 0; --order) {
#pragma unroll
    for (int i = order; i >= 0; --i) {
      const int j = order - i;
      if (i < L::kTerms && j < R::kTerms) {
#pragma unroll
        for (int ks = 0; ks < kK / 16; ++ks) {
          Wgmma<N>::template ss_t<L::kTrans, R::kTrans>(
              acc, desc<L::kTrans>(l + i * kTermBytes, ks), desc<R::kTrans>(r + j * kTermBytes, ks),
              accumulate);
          accumulate = 1;
        }
      }
    }
  }
}

// The block's [128][N] tile of C = L R for matrix blockIdx.z, C's rows from
// blockIdx.y * 128 and columns from blockIdx.x * N, C m rows deep and the
// contraction k long, the operands' planes read through tm_l and tm_r at
// groups plane * batch + matrix.  Every thread of the kThreads calls it.  The
// producer warp's first lane streams the ring; a consumer warpgroup that
// holds no row of C (m0 + 64 wg >= m) keeps the ring turning.  Returns true
// where the thread holds C's values: ``sum`` (N / 2 of them) in the
// accumulator layout of its warpgroup's 64 rows (d[4j .. 4j + 3]: columns
// 8j + 2(lane % 4) + {0, 1} of rows 16w + lane / 4 and 8 below, warp w).
template <class L, class R, int N>
__device__ __forceinline__ bool product_tile(unsigned char* smem_raw, const CUtensorMap* tm_l,
                                             const CUtensorMap* tm_r, int batch, int m, int k,
                                             float* sum) {
  static_assert(N <= kRows && N % 16 == 0, "one m64nN accumulator a warpgroup");
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
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

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kRows;
  const int n0 = blockIdx.x * N;
  const int n_k = (k + kK - 1) / kK;

  if (threadIdx.x >= kConsumers) {  // the producer warp: its first lane starts every copy
    if (threadIdx.x == kConsumers) {
      constexpr uint32_t kBytes = L::kTerms * L::kBytes + R::kTerms * R::kBytes;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        unsigned char* stage = ring + s * kStageBytes;
        bar_wait(empty + s, ((kt / kStages) & 1) ^ 1);
        bar_arrive_tx(full + s, kBytes);
#pragma unroll
        for (int i = 0; i < L::kTerms; ++i) {
          L::load(stage + i * kTermBytes, tm_l, full + s, m0, kt * kK, i * batch + b);
        }
#pragma unroll
        for (int j = 0; j < R::kTerms; ++j) {
          R::load(stage + (3 + j) * kTermBytes, tm_r, full + s, n0, kt * kK, j * batch + b);
        }
      }
    }
    return false;
  }

  const int wg = threadIdx.x >> 7;
  if (m0 + wg * 64 >= m) {  // no row of C here: keep the ring turning
    for (int kt = 0; kt < n_k; ++kt) {
      bar_wait(full + kt % kStages, (kt / kStages) & 1);
      bar_arrive(empty + kt % kStages);
    }
    return false;
  }
  constexpr int kAcc = N / 2;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) sum[i] = acc[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    bar_wait(full + s, (kt / kStages) & 1);
    const uint32_t stage = smem_u32(ring + s * kStageBytes);
    wg_fence();
    stage_products<L, R, N>(acc, stage + wg * kBoxBytes, stage + 3 * kTermBytes, 0);
    wg_commit();
    wg_wait<0>();
    fence_regs<kAcc>(acc);
    bar_arrive(empty + s);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
  }
  return true;
}

// A matrix held as bf16 planes in device memory, as a product's operand:
// [planes x batch][rows][cols] with rows ``pitch`` elements apart.
struct Planes {
  const bf16* ptr;
  int rows, cols, pitch;
};

// The tensor map of an operand's ``terms`` planes: MN-major, boxes of 64 of
// C's side x kK contraction rows (gemm_sm90.cuh's, 128-byte swizzle);
// K-major, boxes of kK contraction columns x ``rows`` of C's side, swizzled
// as the wgmma descriptors read them.
template <int Trans>
bool encode(CUtensorMap* map, const Planes& m, int terms, int batch, int rows) {
  if (Trans) return encode_tiles(map, m.ptr, m.cols, m.rows, terms * batch, m.pitch, kK);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(m.cols), static_cast<cuuint64_t>(m.rows),
                              static_cast<cuuint64_t>(terms) * batch};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(m.pitch) * 2,
                                 static_cast<cuuint64_t>(m.pitch) * 2 * m.rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kK), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(m.ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                kK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Both operands' maps for a [m][n] tile grid of N-wide tiles (L's boxes 128
// of C's rows, R's N of its columns), the kernel allowed its shared memory,
// and the launch grid (column tiles, row tiles, batch).
template <class L, class R, int N, typename Kernel>
cudaError_t prepare(Kernel kernel, CUtensorMap* tm_l, CUtensorMap* tm_r, const Planes& l,
                    const Planes& r, int m, int n, int batch, dim3* grid) {
  if (!encode<L::kTrans>(tm_l, l, L::kTerms, batch, kRows) ||
      !encode<R::kTrans>(tm_r, r, R::kTerms, batch, N)) {
    return cudaErrorInvalidValue;
  }
  *grid = dim3((n + N - 1) / N, (m + kRows - 1) / kRows, batch);
  return emct_allow_smem(kernel, kSmemBytes);
}

}  // namespace split_sm90
