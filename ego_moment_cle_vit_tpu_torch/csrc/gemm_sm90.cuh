// A Hopper (sm_90a) tile product shared by the bf16 GPF backward's dX
// (gpf_bwd_sm90.cuh, kernel 2b) and the streamed bf16 Newton–Schulz
// iteration's products (ns_sm90.cuh, kernel 5″): a block computes one
// [128][256] fp32 tile of C = sum_a A_a B, with every A_a row-major [M][K]
// and B row-major [K][N], both bf16, and hands the tile to its kernel's
// epilogue in registers.
//
// Shape of a block.  Two consumer warpgroups each own 64 rows of the tile and
// one m64n256 accumulator (128 fp32 registers a thread), and one producer warp
// keeps a ring of stages in flight: a stage is the tiles of 64 steps of the
// contraction, each A_a tile [128][64] one TMA box read K-major by wgmma, and
// the B tile [64][256] four [64][64] boxes side by side read MN-major (B's
// rows are the contraction), all at the 128-byte swizzle.  Per stage a
// warpgroup issues 4 k-steps of m64n256k16 for each A_a into its
// accumulator, commits them as one group and waits for the previous stage's
// group before releasing that stage, so one stage's products always run
// while the next one's copies land.  Sums stay in the accumulator in
// k-order; there is no split of the contraction, so two runs give the same
// bits.  One block an SM (the ring takes ~193 KB); 288 threads leave a
// thread up to 224 registers.
//
// The mbarriers, TMA loads, wgmma fences and descriptors are sm90.cuh's.
#pragma once

#include "sm90.cuh"

namespace gemm_sm90 {

using namespace sm90;

constexpr int kRows = 128;                 // C rows a block: two warpgroups of 64
constexpr int kCols = 256;                 // C columns a block: one m64n256 accumulator
constexpr int kK = 64;                     // contraction a stage: one 128-byte row of bf16
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kAcc = kCols / 2;            // fp32 accumulators a thread
constexpr int kABytes = kRows * kK * 2;    // one A tile [128][64]: one TMA box
constexpr int kBoxBytes = kK * 64 * 2;     // one [64][64] box of a B tile
constexpr int kBBytes = 4 * kBoxBytes;     // one B tile [64][256]: four boxes side by side

// 1024 bytes of alignment slack (swizzled tiles start on 1024-byte
// boundaries), the stages, then a full and an empty barrier a stage.
// kernels/gpf.py:bwd_geometry and kernels/newton_schulz.py:
// streamed_gemm_geometry compute the same.
template <int NA>
struct Layout {
  static constexpr int kStageBytes = NA * kABytes + kBBytes;
  static constexpr size_t bytes(int stages) {
    return 1024 + static_cast<size_t>(kStageBytes) * stages + 16 * static_cast<size_t>(stages);
  }
};

// The smem_raw of a block, carved as Layout says.
template <int NA>
struct Ring {
  using L = Layout<NA>;
  unsigned char* base;
  int stages;
  __device__ Ring(unsigned char* raw, int n_stages) : stages(n_stages) {
    base = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
  }
  __device__ bf16* a(int s, int i) const {
    return reinterpret_cast<bf16*>(base + s * L::kStageBytes + i * kABytes);
  }
  __device__ bf16* b(int s) const {
    return reinterpret_cast<bf16*>(base + s * L::kStageBytes + NA * kABytes);
  }
  __device__ uint64_t* full() const {
    return reinterpret_cast<uint64_t*>(base + stages * L::kStageBytes);
  }
  __device__ uint64_t* empty() const { return full() + stages; }

  // One thread initializes the barriers, then the block may use them: a full
  // barrier completes on the producer's one arrival and its copies' bytes, an
  // empty one when every consumer thread has released the stage.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        bar_init(full() + s, 1);
        bar_init(empty() + s, kConsumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// A 3-D tensor map over a [groups, rows, cols] bf16 array whose rows lie
// ``pitch`` elements apart (pitch * 2 a multiple of 16): boxes of 64 columns x
// ``box_rows`` rows x 1 group at the 128-byte swizzle; rows past ``rows`` and
// columns past ``cols`` arrive as zeros.
inline bool encode_tiles(CUtensorMap* map, const void* ptr, int cols, int rows, int groups,
                         int pitch, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch) * 2,
                                 static_cast<cuuint64_t>(pitch) * 2 * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Byte offset of element (row, col) of a [rows][64] bf16 box at the 128-byte
// swizzle, as TMA lays it down: the 16-byte chunk col / 8 of row r lands in
// chunk (col / 8) ^ (r % 8) of that row.  For kernels that fill a box by hand.
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// One [64 rows][64 columns] box at (row r0, column c0) of a row-major [rows,
// cols] bf16 matrix into ``dst`` in TMA's swizzled layout, zeros past the
// ends, by the 32 lanes of one warp with ordinary loads: for rows TMA cannot
// take (a row stride or a start off the 16-byte grain).  The caller then
// fences the writes for the async proxy before wgmma reads them.
__device__ __forceinline__ void stage_box(bf16* dst, const bf16* x, int rows, int cols, int r0,
                                          int c0, int lane) {
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
  for (int q = lane; q < 64 * 8; q += 32) {  // chunks of 8 columns: row q / 8, chunk q % 8
    const int r = q >> 3;
    const int c = c0 + (q & 7) * 8;
    alignas(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = (r0 + r < rows && c + e < cols) ? x[static_cast<size_t>(r0 + r) * cols + c + e]
                                             : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(base + swizzled(r, (q & 7) * 8)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// k-step ks of a B tile as the MN-major operand of m64n256k16: rows 16 ks ..
// 16 ks + 15 of its four boxes, whose 8-row groups lie 1024 bytes apart (the
// stride offset) and whose 64-column swizzle atoms lie a box apart (the
// leading offset).
__device__ __forceinline__ uint64_t desc_b(const bf16* tile, int ks) {
  return descriptor<64>(smem_u32(tile) + ks * 16 * 128, kBoxBytes, 8 * 128);
}

// m64n256k16, A K-major and B MN-major, both from shared memory; fp32 sums
// added to d[128] (acc = 0 overwrites d instead).  d[4j .. 4j + 3] hold
// columns 8j + 2(lane % 4) + {0, 1} of rows 16w + g and 16w + g + 8 of the
// warpgroup's 64 (warp w, g = lane / 4), as for sm90.cuh's narrower shapes.
struct Wgmma256 {
  static __device__ __forceinline__ void ss_mn(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// The consumers' main loop: ``acc`` (kAcc registers) becomes warpgroup
// ``wg``'s 64 rows of sum_a A_a B over ``n_k`` stages.
template <int NA>
__device__ __forceinline__ void consume(float* acc, const Ring<NA>& ring, int n_k, int wg) {
  uint64_t* full = ring.full();
  uint64_t* empty = ring.empty();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % ring.stages;
    bar_wait(full + s, (kt / ring.stages) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      const uint64_t db = desc_b(ring.b(s), ks);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        Wgmma256::ss_mn(acc, desc_k<64>(ring.a(s, i) + wg * 64 * kK, ks), db, 1);
      }
    }
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0) bar_arrive(empty + (kt - 1) % ring.stages);
  }
  wg_wait<0>();
  fence_regs<kAcc>(acc);
}

}  // namespace gemm_sm90
