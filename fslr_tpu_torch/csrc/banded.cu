// Banded affine Smith-Waterman on Hopper: the score pass and its traceback
// variant.
//
// Replaces two Pallas kernels of the JAX package:
//   * banded_kernel <- fslr_tpu/ops/banded.py:_banded_kernel (launcher
//     _banded_pallas): 128 band offsets l, query steps i scanned, cell
//     (i, l) compares query base i with window base i + l.  Outputs the
//     best score, its query end i* and band lane l* (ties: smallest lane
//     at the maximum, then smallest best-row, taken apart).  align runs it
//     twice per candidate: forward for ends, then on reversed prefixes for
//     begins.
//   * tb_kernel <- fslr_tpu/ops/traceback.py:_tb_kernel (launcher
//     _tb_pallas): the same DP plus each cell's 4-bit traceback code
//     (bits 0-1 the H source: 0 start, 1 diagonal, 2 E, 3 F; bit 2 E
//     extends E; bit 3 F extends F), 8 query steps per int32 word,
//     code << 4 * (i % 8), into bits (N, Lq / 8, 128).  align runs it on
//     the selection winners only; walk_kernel (traceback.cu) reads the
//     codes back.
//
// Layout: one warp per candidate row, the 128 band lanes in registers (4
// per lane).  The sliding window w[i .. i+127] lives in the same
// registers and advances one base per step with one shuffle; the query
// and the window's incoming base are streamed 32 bytes at a time.
//
// What bounds them: the step is a serial chain (shift-left of H and E,
// then a shuffle scan for the exclusive prefix-max), so both kernels are
// latency-bound; independent rows in flight hide it.  A row stops at its
// own query length.  tb_kernel also writes Lq * 64 bytes of codes per
// row.  Each thread ORs its 4 columns' codes into 4 registers and stores
// them every 8 steps as one 16-byte vector, so a warp writes 512
// contiguous bytes at a time and the stores never stall the chain.  It
// runs on to the end of the last partial word (steps past qlen only fill
// codes; the best is masked there) and writes zeros to the words after
// it, so every word of bits is defined.
#include "dp_warp.cuh"

using namespace fslr;

namespace {

// One query row (fslr_tpu.ops.banded._banded_step; with TB also
// fslr_tpu.ops.traceback._tb_step's codes).
template <bool TB>
__device__ __forceinline__ void banded_step(float (&H)[4], float (&E)[4],
                                            const float (&s)[4], int lane,
                                            const Scores& sc,
                                            uint32_t (&code)[4]) {
  float Hup[4], Eup[4], diag[4], Hno[4], x[4], cm[4];
  bool e_ext[4];
  shift_left(H, Hup, lane);
  shift_left(E, Eup, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float eo = Eup[k] - sc.ext, ho = Hup[k] - sc.fg;
    e_ext[k] = eo >= ho;
    E[k] = fmaxf(eo, ho);
    diag[k] = H[k] + s[k];
    Hno[k] = fmaxf(fmaxf(diag[k], E[k]), 0.f);
    x[k] = Hno[k] + (float)(4 * lane + k) * sc.ext;
  }
  cummax_exclusive(x, cm, lane);
  float xprev[4];
  if constexpr (TB) shift_right(x, xprev, NEG, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float l = (float)(4 * lane + k);
    float F = cm[k] - sc.fg - (l - 1.f) * sc.ext;
    if constexpr (TB) {
      // tie order of the source: F (strictly above Hno), diagonal, E
      bool pos = Hno[k] > 0.f;
      uint32_t src = F > Hno[k] ? 3u
                     : (diag[k] == Hno[k] && pos) ? 1u
                     : (E[k] == Hno[k] && pos)    ? 2u
                                                  : 0u;
      // F extends F iff the prefix max comes from before column l - 1
      code[k] = src | (e_ext[k] ? 4u : 0u) | (cm[k] > xprev[k] ? 8u : 0u);
    }
    H[k] = fmaxf(Hno[k], F);
  }
}

template <bool TB>
__global__ void banded_dp(const uint8_t* __restrict__ q,
                          const uint8_t* __restrict__ w,
                          const int* __restrict__ qlens, int N, int Lq,
                          Scores sc, float* score, int* qend,
                          int* lane_of_best, uint4* bits) {
  int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= N) return;
  int lane = threadIdx.x & 31;
  const uint8_t* qr = q + (size_t)row * Lq;
  const uint8_t* wr = w + (size_t)row * (Lq + 256);
  // row r of the codes: 128 words = 32 uint4, lane t owns uint4 t
  uint4* br = TB ? bits + (size_t)row * (Lq / 8) * 32 + lane : nullptr;
  int wv[4];
  float H[4], E[4], bH[4], bI[4];
  bool keep[4];
  uint32_t code[4], pk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wv[k] = wr[4 * lane + k];
    H[k] = 0.f;
    E[k] = NEG;
    bH[k] = NEG;
    bI[k] = 0.f;
    keep[k] = true;
    pk[k] = 0u;
  }
  int qlen = qlens[row];
  // tb: run on to the end of the last partial word of codes
  int n = TB ? min((qlen + 7) & ~7, Lq) : min(qlen, Lq);
  for (int base = 0; base < n; base += 32) {
    int qv = base + lane < Lq ? qr[base + lane] : 4;
    int inc = wr[base + 128 + lane];      // window base entering lane 127
    int cnt = min(32, n - base);
    for (int s = 0; s < cnt; ++s) {
      int qc = __shfl_sync(FULL, qv, s);
      float sv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bool eq = wv[k] == qc && qc < 4 && wv[k] < 4;
        sv[k] = eq ? sc.match : sc.mismatch;
      }
      banded_step<TB>(H, E, sv, lane, sc, code);
      int i = base + s;
      float i_f = (float)i;
      bool in_q = !TB || i < qlen;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (H[k] > bH[k] && in_q) {
          bH[k] = H[k];
          bI[k] = i_f;
        }
      }
      if constexpr (TB) {
        int sh = 4 * (i & 7);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pk[k] = (sh ? pk[k] : 0u) | (code[k] << sh);
        }
        if ((i & 7) == 7) {
          br[(size_t)(i >> 3) * 32] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        }
      }
      // advance the window: lane l now reads w[i + 1 + l]
      int nxt = __shfl_down_sync(FULL, wv[0], 1);
      int in_s = __shfl_sync(FULL, inc, s);
      wv[0] = wv[1];
      wv[1] = wv[2];
      wv[2] = wv[3];
      wv[3] = lane == 31 ? in_s : nxt;
    }
  }
  if constexpr (TB) {
    for (int r = n >> 3; r < Lq >> 3; ++r) {
      br[(size_t)r * 32] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  finalize_row(bH, bI, keep, lane, score + row, qend + row,
               lane_of_best + row);
}

template <bool TB>
int launch(const void* q, const void* w, const void* qlens, int N, int Lq,
           float match, float mismatch, float fg, float ext, void* score,
           void* qend, void* lane, void* bits, void* stream) {
  if (N > 0) {
    int grid = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    banded_dp<TB><<<grid, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)w, (const int*)qlens, N, Lq,
        Scores{match, mismatch, fg, ext}, (float*)score, (int*)qend,
        (int*)lane, (uint4*)bits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fslr_banded(const void* q, const void* w, const void* qlens,
                           int N, int Lq, float match, float mismatch,
                           float fg, float ext, void* score, void* qend,
                           void* lane, void* stream) {
  return launch<false>(q, w, qlens, N, Lq, match, mismatch, fg, ext, score,
                       qend, lane, nullptr, stream);
}

// bits: (N, Lq / 8, 128) int32, 16-byte aligned; Lq a multiple of 8.
extern "C" int fslr_tb(const void* q, const void* w, const void* qlens,
                       int N, int Lq, float match, float mismatch, float fg,
                       float ext, void* score, void* qend, void* lane,
                       void* bits, void* stream) {
  return launch<true>(q, w, qlens, N, Lq, match, mismatch, fg, ext, score,
                      qend, lane, bits, stream);
}
