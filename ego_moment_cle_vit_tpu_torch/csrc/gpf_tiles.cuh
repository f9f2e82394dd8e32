// Shared by the fused GPF kernels (forward and backward): one 64 x 64 tile of
// both token Grams, and the polynomial's powers.
#pragma once

#include "mma_tiles.cuh"

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // output rows and columns per block
constexpr int kChunk = 64;  // token features per staged chunk

template <typename T>
struct GramSmem {
  static constexpr int LD = kChunk + TilePad<T>::value;
  static constexpr int kPanel = kTile * LD;  // elements of one [64 tokens][64 features] panel
};

// Rows [r0, r0 + 64) x features [k0, k0 + 64) of tokens [N, D] into a panel;
// rows past N and features past D read as zero.  16-byte loads when every row
// of the matrix is 16-byte aligned, element loads otherwise.
template <typename T>
__device__ __forceinline__ void stage_panel(T* s, const T* x, int N, int D, int r0, int k0,
                                            bool vec_ok, int tid) {
  constexpr int LD = GramSmem<T>::LD;
  if (vec_ok && k0 + kChunk <= D) {
    stage_tile<T, kTile, kChunk, kThreads>(s, x + k0, static_cast<size_t>(D), r0, N, tid);
    return;
  }
  for (int e = tid; e < kTile * kChunk; e += kThreads) {
    const int r = e / kChunk;
    const int c = e % kChunk;
    const bool in = r0 + r < N && k0 + c < D;
    s[r * LD + c] = in ? x[static_cast<size_t>(r0 + r) * D + k0 + c] : from_f32<T>(0.f);
  }
}

// One block's 64 x 64 tile of the anchor and positive Grams in the mma_nt
// accumulator layout (this warp's 16 rows), and the squared norms of the
// tile's row tokens (threads 0..63) and column tokens (threads 64..127).
// ``panels`` holds four panels: anchor rows, anchor columns, positive rows,
// positive columns.  With ``same`` the positive set is the anchor set and its
// outputs are left untouched.
template <typename T>
__device__ __forceinline__ void gram_tiles(const T* xa, const T* xp, int N, int D, int i0, int j0,
                                           bool same, bool vec_ok, T* panels, float (*acc_a)[4],
                                           float (*acc_p)[4], float& nsq_a, float& nsq_p) {
  using S = GramSmem<T>;
  T* ar = panels;
  T* ac = ar + S::kPanel;
  T* pr = ac + S::kPanel;
  T* pc = pr + S::kPanel;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int tg = tid & 3;
  zero_acc<8>(acc_a);
  zero_acc<8>(acc_p);
  nsq_a = 0.f;
  nsq_p = 0.f;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    __syncthreads();
    stage_panel<T>(ar, xa, N, D, i0, k0, vec_ok, tid);
    stage_panel<T>(ac, xa, N, D, j0, k0, vec_ok, tid);
    if (!same) {
      stage_panel<T>(pr, xp, N, D, i0, k0, vec_ok, tid);
      stage_panel<T>(pc, xp, N, D, j0, k0, vec_ok, tid);
    }
    __syncthreads();
    mma_nt<8, kChunk>(acc_a, ar + warp * 16 * S::LD, S::LD, ac, S::LD, g, tg);
    if (!same) mma_nt<8, kChunk>(acc_p, pr + warp * 16 * S::LD, S::LD, pc, S::LD, g, tg);
    const int row = (tid & (kTile - 1)) * S::LD;
    const T* na = (tid < kTile ? ar : ac) + row;
    const T* np = (tid < kTile ? pr : pc) + row;
    for (int c = 0; c < kChunk; ++c) {
      const float va = to_f32(na[c]);
      nsq_a = fmaf(va, va, nsq_a);
      if (!same) {
        const float vp = to_f32(np[c]);
        nsq_p = fmaf(vp, vp, nsq_p);
      }
    }
  }
}

constexpr int kMaxDeg = 3;  // the backward's compiled polynomial degree limit
constexpr int kMaxCoef = (kMaxDeg + 1) * (kMaxDeg + 1);

// values[k] = A_k(r) = r max(r, 0)^(k-1) (A_0 = 1), grads[k] = A'_k(r)
__device__ __forceinline__ void powers(float r, float* values, float* grads) {
  const float rc = fmaxf(r, 0.f);
  values[0] = 1.f;
  grads[0] = 0.f;
  float rc_pow = 1.f;  // rc^(k-1)
#pragma unroll
  for (int k = 1; k <= kMaxDeg; ++k) {
    values[k] = r * rc_pow;
    grads[k] = static_cast<float>(k) * rc_pow;
    rc_pow *= rc;
  }
}
