// Banded affine DP of a read against a column-merged POA profile, with
// traceback codes, on Hopper.
//
// Replaces fslr_tpu/ops/profile_align.py:_prof_kernel (launcher
// _prof_pallas): lanes l = 0..127 are band offsets, query steps i are
// scanned, cell (i, l) covers profile column i + l.  Per column the
// profile gives a packed int32 score word sp (byte b = x16 fixed-point
// score of read base b, sign-extended) and a cumulative deletion cost g,
// so the lazy-F closed form is an exclusive prefix-max of C = Hno + g:
//   F[l] = max_{k<l} C[k] - openF - g[l].
// Codes are tb_kernel's (banded.cu): bits 0-1 the H source (0 start,
// 1 diagonal, 2 E, 3 F; ties F > diagonal > E), bit 2 E extends E, bit 3
// F extends F; 8 steps a word, code << 4 * (i % 8), into bits
// (N, Lq / 8, 128).  walk_kernel (traceback.cu) reads them back.
//
// Layout: one warp per row, 4 band lanes per thread (dp_warp.cuh).  The
// sliding window keeps two values per lane, the score word and g; both
// advance one column a step with one shuffle each, and the column that
// enters at lane 127 (i + 128) is streamed 32 steps at a time, as is the
// read.
//
// Exactness: s is a multiple of 1/16 and g a float32 cut from a float64
// cumsum, so the values are not integers and bit-equality with the plain
// version rests on the operation order.  Every addition and subtraction
// is an explicit round-to-nearest intrinsic, which nvcc never contracts
// into a multiply-add; s = v * 0.0625 is exact.
//
// What bounds it: per cell about 25 float operations (score extraction,
// the E/H/C updates, the code) plus 11 shuffles per step for the two
// shifts, the 5-step prefix-max scan, C's right shift and the window; the
// step is a serial chain, so the kernel is latency-bound like tb_kernel,
// and rows in flight hide the latency.  Bytes: q, sp and g are read once
// (9 B per column of a row), the codes written once (64 B per query
// step of a row).  A row stops at the end of the word holding step
// qlen - 1 and writes zeros to the words after it.
#include "dp_warp.cuh"

using namespace fslr;

namespace {

struct ProfScores {
  float fg, ext, openF;
};

// Substitution score of read base qc against a packed column word
// (fslr_tpu.ops.profile_align._extract_score).
__device__ __forceinline__ float extract_score(int word, int qc) {
  if (qc >= 4) return -8.0f;
  int v = (int)(int8_t)((word >> (8 * qc)) & 0xFF);
  return __fmul_rn((float)v, 0.0625f);
}

// One query row (fslr_tpu.ops.profile_align._prof_tb_step).
__device__ __forceinline__ void prof_step(float (&H)[4], float (&E)[4],
                                          const float (&s)[4],
                                          const float (&g)[4], int lane,
                                          const ProfScores& sc,
                                          uint32_t (&code)[4]) {
  float Hup[4], Eup[4], diag[4], Hno[4], C[4], Cm[4], Cprev[4];
  bool e_ext[4];
  shift_left(H, Hup, lane);
  shift_left(E, Eup, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float eo = __fsub_rn(Eup[k], sc.ext), ho = __fsub_rn(Hup[k], sc.fg);
    e_ext[k] = eo >= ho;
    E[k] = fmaxf(eo, ho);
    diag[k] = __fadd_rn(H[k], s[k]);
    Hno[k] = fmaxf(fmaxf(diag[k], E[k]), 0.f);
    C[k] = __fadd_rn(Hno[k], g[k]);
  }
  cummax_exclusive(C, Cm, lane);
  shift_right(C, Cprev, NEG, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float F = __fsub_rn(__fsub_rn(Cm[k], sc.openF), g[k]);
    bool pos = Hno[k] > 0.f;
    uint32_t src = F > Hno[k] ? 3u
                   : (diag[k] == Hno[k] && pos) ? 1u
                   : (E[k] == Hno[k] && pos)    ? 2u
                                                : 0u;
    code[k] = src | (e_ext[k] ? 4u : 0u) | (Cm[k] > Cprev[k] ? 8u : 0u);
    H[k] = fmaxf(Hno[k], F);
  }
}

__global__ void prof_dp(const uint8_t* __restrict__ q,
                        const int* __restrict__ sp,
                        const float* __restrict__ g,
                        const int* __restrict__ qlens, int N, int Lq,
                        ProfScores sc, float* score, int* qend,
                        int* lane_of_best, uint4* bits) {
  int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= N) return;
  int lane = threadIdx.x & 31;
  const uint8_t* qr = q + (size_t)row * Lq;
  const int* spr = sp + (size_t)row * (Lq + 256);
  const float* gr = g + (size_t)row * (Lq + 256);
  // row r of the codes: 128 words = 32 uint4, lane t owns uint4 t
  uint4* br = bits + (size_t)row * (Lq / 8) * 32 + lane;
  int wsp[4];
  float wg[4], H[4], E[4], bH[4], bI[4];
  bool keep[4];
  uint32_t code[4], pk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wsp[k] = spr[4 * lane + k];
    wg[k] = gr[4 * lane + k];
    H[k] = 0.f;
    E[k] = NEG;
    bH[k] = NEG;
    bI[k] = 0.f;
    keep[k] = true;
    pk[k] = 0u;
  }
  int qlen = qlens[row];
  // run on to the end of the last partial word of codes
  int n = min((qlen + 7) & ~7, Lq);
  for (int base = 0; base < n; base += 32) {
    int qv = qr[base + lane];
    int in_sp = spr[base + 128 + lane];   // columns entering lane 127
    float in_g = gr[base + 128 + lane];
    int cnt = min(32, n - base);
    for (int s = 0; s < cnt; ++s) {
      int qc = __shfl_sync(FULL, qv, s);
      float sv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = extract_score(wsp[k], qc);
      prof_step(H, E, sv, wg, lane, sc, code);
      int i = base + s;
      float i_f = (float)i;
      bool in_q = i < qlen;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (H[k] > bH[k] && in_q) {
          bH[k] = H[k];
          bI[k] = i_f;
        }
      }
      int sh = 4 * (i & 7);
#pragma unroll
      for (int k = 0; k < 4; ++k) pk[k] = (sh ? pk[k] : 0u) | (code[k] << sh);
      if ((i & 7) == 7) {
        br[(size_t)(i >> 3) * 32] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
      // advance the window: lane l now reads column i + 1 + l
      int nsp = __shfl_down_sync(FULL, wsp[0], 1);
      float ng = __shfl_down_sync(FULL, wg[0], 1);
      int e_sp = __shfl_sync(FULL, in_sp, s);
      float e_g = __shfl_sync(FULL, in_g, s);
      wsp[0] = wsp[1];
      wsp[1] = wsp[2];
      wsp[2] = wsp[3];
      wsp[3] = lane == 31 ? e_sp : nsp;
      wg[0] = wg[1];
      wg[1] = wg[2];
      wg[2] = wg[3];
      wg[3] = lane == 31 ? e_g : ng;
    }
  }
  for (int r = n >> 3; r < Lq >> 3; ++r) {
    br[(size_t)r * 32] = make_uint4(0u, 0u, 0u, 0u);
  }
  finalize_row(bH, bI, keep, lane, score + row, qend + row,
               lane_of_best + row);
}

}  // namespace

// q (N, Lq) uint8, Lq a multiple of 128; sp (N, Lq + 256) int32; g
// (N, Lq + 256) float32; bits (N, Lq / 8, 128) int32, 16-byte aligned.
extern "C" int fslr_prof(const void* q, const void* sp, const void* g,
                         const void* qlens, int N, int Lq, float fg,
                         float ext, float openF, void* score, void* qend,
                         void* lane, void* bits, void* stream) {
  if (N > 0) {
    int grid = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    prof_dp<<<grid, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const int*)sp, (const float*)g,
        (const int*)qlens, N, Lq, ProfScores{fg, ext, openF},
        (float*)score, (int*)qend, (int*)lane, (uint4*)bits);
  }
  return (int)cudaGetLastError();
}
