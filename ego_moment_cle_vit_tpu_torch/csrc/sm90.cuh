// Hopper (sm_90a) pieces shared by the bf16 Hopper kernels (the attention
// forward and backward, the window-attention and attention-half backwards,
// the GEMM tiles): mbarriers, TMA loads through 3-D and 4-D tensor maps,
// warpgroup wgmma products on those tiles, the 2^x of the softmax, and the
// bf16 A fragments taken from fp32 accumulators.
#pragma once

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled (the library links -lcuda)

#include "mma_tiles.cuh"

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBoxRows = 64;         // tokens of one TMA box (and of one wgmma M)
constexpr size_t kMaxSmem = 232448;  // what a block may use on an H100
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit, what __expf runs after its multiply by
// log2(e): the kernels fold that multiply, the scale and the row's offset
// (lse or running maximum) into one fmaf.  ex2 of -inf is +0, so masked keys
// and query rows past T (lse = +inf) give P = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrives and announces ``bytes`` of copies that complete on this phase
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity ``parity`` has completed.  A barrier that
// never completes is a fault of this code: after 2^26 polls (each of which
// waits a while in the hardware) the kernel traps, which the wrapper reports
// as an error, instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// one [64][d] box of a 3-D tensor map at (column, token, group); rows past T
// arrive as zeros, and the copy completes on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int group) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(group), "r"(smem_u32(bar))
      : "memory");
}

// one box of a 4-D tensor map at (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads by
// the async proxy (wgmma operands, TMA stores); a barrier then publishes
// them to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A 3-D tensor map over a [groups, T, cols] bf16 array: boxes of d columns x
// 64 tokens x 1 group, swizzled as the descriptors below read them, rows past
// T filled with zeros.
inline bool encode_map(CUtensorMap* map, const void* ptr, int cols, int Tn, int groups, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(Tn),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * 2 * Tn};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup's products are
// still running (groups complete in the order they were committed)
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (the wgmma statements name them as
// outputs, but the values land only at the wg_wait that covers them).
template <int K>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for bf16 A fragments in registers, which a product reads until
// the wg_wait that covers it.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a [rows][d] bf16 tile whose rows of 2d
// bytes are swizzled in 8-row atoms (128-byte swizzle at d = 64, 64-byte at
// d = 32), as TMA lays it down.
template <int D>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead, uint32_t stride) {
  constexpr uint64_t kSwizzle = D == 64 ? 1 : 2;  // layout type: 1 = 128-byte, 2 = 64-byte
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (kSwizzle << 62);
}

// The tile as a K-major operand (contraction over d): k-step ks is the 16
// columns that start 32 bytes into each row; 8-row groups lie 16d bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int ks) {
  return descriptor<D>(smem_u32(tile) + ks * 32, 16, 8 * D * 2);
}

// The tile as an MN-major operand (contraction over its rows, N = d): k-step
// ks is rows 16 ks .. 16 ks + 15.  N is one swizzle atom wide, so only the
// stride between 8-row groups matters; both offsets carry it.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int ks) {
  return descriptor<D>(smem_u32(tile) + ks * 16 * D * 2, 8 * D * 2, 8 * D * 2);
}

// d[N/2] += A B^T over one k-step of 16, m64nNk16, fp32 sums.  ss: A and B
// from shared memory, both K-major; acc = 0 overwrites d instead.  rs: A
// from registers (four bf16 pairs in the mma.m16n8k16 A-fragment layout, per
// warp rows 16w .. 16w + 15), B MN-major.  The accumulators of warp w hold rows 16w + g and 16w + g + 8
// (g = lane / 4), columns 8j + 2(lane % 4) + {0, 1} in d[4j .. 4j + 3].
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  // A MN-major (TA = 1) or K-major, B K-major
  template <int TA>
  static __device__ __forceinline__ void ss_t(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, %7, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(acc), "n"(TA));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  // both operands MN-major (read transposed) from shared memory
  static __device__ __forceinline__ void ss_tt(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// m64n128k16 from shared memory, A MN-major when TA = 1 (else K-major), B
// MN-major when TB = 1 (else K-major)
template <>
struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss_t(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
};

// bf16 A fragments of k-step t from the fp32 accumulators of an m64nN
// product: column chunks 2t and 2t + 1 are the k-step's 16 columns.
template <int NC>
__device__ __forceinline__ void to_fragments(uint32_t (*a)[4], float (*acc)[4]) {
#pragma unroll
  for (int t = 0; t < NC / 2; ++t) {
    a[t][0] = pack_bf16(acc[2 * t][0], acc[2 * t][1]);
    a[t][1] = pack_bf16(acc[2 * t][2], acc[2 * t][3]);
    a[t][2] = pack_bf16(acc[2 * t + 1][0], acc[2 * t + 1][1]);
    a[t][3] = pack_bf16(acc[2 * t + 1][2], acc[2 * t + 1][3]);
  }
}

}  // namespace sm90
