// Warp-level primitives shared by the float 128-column DP kernels
// (ssw.cu, profile.cu).
//
// One warp owns one DP row of 128 columns; lane t holds columns
// 4t .. 4t+3 in registers.  The two in-row dependencies of the affine
// recurrences are a one-column shift and an exclusive prefix-max (the
// closed form of lazy-F), both built from warp shuffles.  All values are
// float32 holding integers below 2^24, or the NEG sentinel, so max, add
// and subtract are exact and the kernels reproduce the JAX package's DP
// bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fslr {

constexpr float NEG = -1e30f;          // fslr_tpu.ops.ssw.NEG
constexpr unsigned FULL = 0xffffffffu;
constexpr int COLS = 128;              // DP columns per row
constexpr int ROWS_PER_BLOCK = 4;      // one warp per row

struct Scores {
  float match, mismatch, fg, ext;        // fg: cost of a gap's first base
};

// y[j] = x[j-1]; column 0 takes `fill`.
__device__ __forceinline__ void shift_right(const float (&x)[4], float (&y)[4],
                                            float fill, int lane) {
  float up = __shfl_up_sync(FULL, x[3], 1);
  y[3] = x[2];
  y[2] = x[1];
  y[1] = x[0];
  y[0] = lane == 0 ? fill : up;
}

// y[j] = x[j+1]; column 127 takes NEG (outside the band).
__device__ __forceinline__ void shift_left(const float (&x)[4], float (&y)[4],
                                           int lane) {
  float dn = __shfl_down_sync(FULL, x[0], 1);
  y[0] = x[1];
  y[1] = x[2];
  y[2] = x[3];
  y[3] = lane == 31 ? NEG : dn;
}

// y[j] = max_{k<j} x[k]; NEG at j == 0.
__device__ __forceinline__ void cummax_exclusive(const float (&x)[4],
                                                 float (&y)[4], int lane) {
  float p1 = fmaxf(x[0], x[1]);
  float p2 = fmaxf(p1, x[2]);
  float tot = fmaxf(p2, x[3]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float u = __shfl_up_sync(FULL, tot, d);
    if (lane >= d) tot = fmaxf(tot, u);
  }
  float before = __shfl_up_sync(FULL, tot, 1);
  if (lane == 0) before = NEG;
  y[0] = before;
  y[1] = fmaxf(before, x[0]);
  y[2] = fmaxf(before, p1);
  y[3] = fmaxf(before, p2);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// The end reduction of fslr_tpu.ops.ssw._finalize and the banded kernel:
// score = max over kept columns; `col` = smallest column at the maximum;
// `at` = smallest best-row over ALL columns at the maximum, taken apart
// from `col`.  A score <= 0 reports both ends as 0.
__device__ __forceinline__ void finalize_row(const float (&best)[4],
                                             const float (&best_i)[4],
                                             const bool (&keep)[4], int lane,
                                             float* score, int* at, int* col) {
  float bh[4];
  float m = NEG;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bh[k] = keep[k] ? best[k] : NEG;
    m = fmaxf(m, bh[k]);
  }
  m = warp_max(m);
  float c = 1e9f, a = 1e9f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (bh[k] == m) {
      c = fminf(c, (float)(4 * lane + k));
      a = fminf(a, best_i[k]);
    }
  }
  c = warp_min(c);
  a = warp_min(a);
  if (lane == 0) {
    float s = fmaxf(m, 0.f);
    bool none = s <= 0.f;
    *score = s;
    *at = none ? 0 : (int)a;
    *col = none ? 0 : (int)c;
  }
}

}  // namespace fslr
