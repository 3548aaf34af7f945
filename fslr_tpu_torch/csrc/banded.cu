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
// What bounds them: a step of a row is a serial chain (the lazy-F prefix
// max runs across all 128 columns), and the DP's integer instructions
// issue at half the float rate.  With few rows a launch is bound by the
// latency of one step, with many by instruction issue.  The design cuts
// both:
//
// * Integer DP.  Every DP value is an integer below 2^24 (scores are
//   integers), so int32 is exact and Hopper's DPX instructions fuse the
//   recurrences: E = __viaddmax_s32(E', -ext, H' - fg), the score pass's
//   Hno = __viaddmax_s32_relu(H, s, E) = max(H + s, E, 0), H =
//   __viaddmax_s32(cm, -(fg + (l-1) ext), Hno); the traceback pass takes
//   E and Hno with __vibmax_s32, whose predicate is the code's
//   E-extension bit and "the diagonal is at the maximum".  The float
//   sentinel -1e30 absorbed subtractions (NEG - ext == NEG); the int
//   sentinel NEG_I does not, so the one comparison that saw two
//   sentinels, E's extension bit at band column 127, is set as the float
//   DP sets it (true), and E there is NEG_I.  Column 0's F stays far
//   below any H, as it did.
// * LPR = 128 / CPL lanes per row, CPL consecutive band columns per lane,
//   32 / LPR rows per warp.  A column's up-neighbour is the next column
//   of the same lane except at the lane's last column, so one shuffle
//   (the next lane's E contribution, packed with its extension bit)
//   replaces the shifts of H and E, and the lazy-F prefix max is an
//   in-thread scan plus a log2(LPR)-level shuffle scan.  The window
//   w[i .. i+127] lives in CPL / 4 packed words per lane and advances one
//   base a step with funnel shifts and one shuffle; a step's query base
//   and entering window base come with one shuffle from the lane that
//   loaded them; the scores are one __vcmpeq4 and one select per 4
//   columns, taken apart with a sign-extending prmt.  All of that for the
//   next step is done while the current step's scan is in flight.
// * The best: each column keeps its best H, each lane its best and the
//   first step one of its columns reached it, which gives the reference's
//   ends (smallest column at the maximum; smallest best step over all
//   columns at it) with one max a cell instead of a compare and two
//   selects.
// * Rows of one warp run together, so the wrapper hands the kernel the
//   rows by descending query length (`order`, a device argsort): a warp's
//   rows end together, the longest rows start first, and a row's steps
//   past its query end are masked only after the warp's shortest row has
//   ended.  Results go to the row's own place.
// * Two layouts an instantiation, the wrapper's choice per launch
//   (ops/banded.py:_layout): 16 columns a lane (4 rows a warp, the fewest
//   instructions a cell) from 32 rows an SM, where issue decides; below
//   that the step's latency decides, and a narrower layout (shorter
//   chains) wins: 8 columns for the score pass, 4 for the traceback
//   pass, whose step is longer.  chip_smoke.sweep_layouts times both on
//   the main path's own launches.
//
// tb_kernel shifts each column's codes into a register (a funnel shift a
// step; after 8 steps step i's code sits at bits 4 * (i % 8)) and stores
// every 8 steps CPL words (CPL / 4 16-byte vectors) per lane, so a row's
// lanes write 512 contiguous bytes.  Each row writes its words up to the
// end of its last partial word (steps past qlen only fill codes; the best
// is masked there) and zeros to the words after it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BAND = 128;             // band columns per row
constexpr int WARPS = 4;              // warps per block
constexpr int NEG_I = -(1 << 29);     // integer sentinel (outside the band)

struct IScores {
  int match, mismatch, fg, ext;       // fg: cost of a gap's first base
};

// Byte k of x, sign-extended (prmt with the sign-replicate selector).
__device__ __forceinline__ int sbyte(uint32_t x, int k) {
  int r;
  uint32_t sel = k | ((8 | k) << 4) | ((8 | k) << 8) | ((8 | k) << 12);
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(x), "r"(sel));
  return r;
}

// A step's kind: Masked<true> after the warp's shortest row has ended,
// when each row keeps its best only up to its own query length.
template <bool B>
struct Masked {
  static constexpr bool value = B;
};

template <bool TB, int CPL>
__global__ void __launch_bounds__(32 * WARPS)
banded_dp(const uint8_t* __restrict__ q, const uint8_t* __restrict__ w,
          const int* __restrict__ qlens, const int* __restrict__ order, int N,
          int Lq, IScores sc, float* __restrict__ score,
          int* __restrict__ qend, int* __restrict__ lane_of_best,
          uint4* __restrict__ bits) {
  constexpr int LPR = BAND / CPL;     // lanes per row
  constexpr int RPW = 32 / LPR;       // rows per warp
  constexpr int NW = CPL / 4;         // packed window words per lane
  constexpr int S = 32 / LPR;         // steps a lane loads per 32 steps
  const int lane = threadIdx.x & 31, g = lane % LPR;
  const int first = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * RPW;
  if (first >= N) return;             // whole warp idle
  const int slot = first + lane / LPR;
  const bool valid = slot < N;
  const int row = order[valid ? slot : N - 1];
  const uint8_t* qr = q + (size_t)row * Lq;
  const uint8_t* wr = w + (size_t)row * (Lq + 2 * BAND);
  const int qlen = valid ? min(qlens[row], Lq) : 0;
  // tb: run on to the end of the last partial word of codes
  const int n = TB ? min((qlen + 7) & ~7, Lq) : qlen;
  const int nmax = (int)__reduce_max_sync(FULL, (unsigned)n);
  // steps below every row's qlen need no mask on the best update
  const int nmin = (int)__reduce_min_sync(FULL, (unsigned)qlen);
  // the mismatch score in every byte, and its xor with the match score's
  const uint32_t mis4 = (uint32_t)(sc.mismatch & 0xff) * 0x01010101u;
  const uint32_t dif4 = mis4 ^ (uint32_t)(sc.match & 0xff) * 0x01010101u;

  // bH: each column's best H; (lbest, li): the lane's best H and the first
  // step at which one of its columns reached it
  int H[CPL], E[CPL], bH[CPL], lext[CPL], nfgl[CPL];
  int lbest = NEG_I, li = 0;
  uint32_t W[NW], pk[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    H[k] = 0;
    E[k] = NEG_I;
    bH[k] = NEG_I;
    pk[k] = 0u;
    lext[k] = (CPL * g + k) * sc.ext;
    nfgl[k] = sc.ext - sc.fg - lext[k];      // F = cm - fg - (l - 1) ext
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint8_t* p = wr + CPL * g + 4 * j;
    W[j] = p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
  }
  uint4* br = TB ? bits + (size_t)row * (Lq / 8) * (BAND / 4) + g * NW
                 : nullptr;

  // The query bases and the window bases entering column 127 of 32 steps:
  // lane g of a row loads steps g * S .. g * S + S - 1, and a step's pair
  // comes with one shuffle (query base in byte 0, window base in byte 1).
  auto load = [&](int base, uint32_t& qpk, uint32_t& ipk) {
    qpk = ipk = 0u;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      int idx = base + g * S + t;
      qpk |= (uint32_t)(idx < Lq ? qr[idx] : 4) << (8 * t);
      ipk |= (uint32_t)wr[idx + BAND] << (8 * t);
    }
  };
  auto fetch = [&](uint32_t qpk, uint32_t ipk, int s) -> uint32_t {
    const int t = s % S;
    return __shfl_sync(FULL, __byte_perm(qpk, ipk, t | ((t + 4) << 4)),
                       s / S, LPR);
  };
  // a step's scores as bytes: match where the window base equals the
  // query base (__vcmpeq4 gives 0xff per equal byte), else mismatch
  auto scores = [&](uint32_t qi, uint32_t (&sc4)[NW]) {
    const uint32_t qc = qi & 0xffu;
    const uint32_t qrep = qc < 4 ? qc * 0x01010101u : 0xffffffffu;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      sc4[j] = mis4 ^ (__vcmpeq4(W[j], qrep) & dif4);
  };

  uint32_t qpk, ipk, nqpk, nipk;
  load(0, qpk, ipk);
  uint32_t qi = fetch(qpk, ipk, 0);
  uint32_t sc4[NW];
  scores(qi, sc4);

  // One query step on sc4; leaves qi and sc4 holding the next step's.
  auto step = [&](int i, int s, auto masked) {
    // E contribution of this lane's column 0 to the previous lane's last
    // column, with its extension bit; the group's last lane is column 127
    bool f0;
    int m0 = __vibmax_s32(E[0] - sc.ext, H[0] - sc.fg, &f0);
    int up = __shfl_down_sync(FULL, 2 * m0 + f0, 1, LPR);
    if (g == LPR - 1) up = 2 * NEG_I + 1;

    int Hno[CPL], x[CPL], En[CPL];
    bool e_ext[CPL], dge[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      if (k < CPL - 1) {
        if constexpr (TB)
          En[k] = __vibmax_s32(E[k + 1] - sc.ext, H[k + 1] - sc.fg,
                               &e_ext[k]);
        else
          En[k] = __viaddmax_s32(E[k + 1], -sc.ext, H[k + 1] - sc.fg);
      } else {
        En[k] = up >> 1;
        e_ext[k] = up & 1;
      }
      int sv = sbyte(sc4[k / 4], k % 4);
      if constexpr (TB) {
        // Hno = max(diag, E, 0); dge: the diagonal is at the maximum
        Hno[k] = max(__vibmax_s32(H[k] + sv, En[k], &dge[k]), 0);
      } else {
        Hno[k] = __viaddmax_s32_relu(H[k], sv, En[k]);
      }
      x[k] = Hno[k] + lext[k];
    }
    // exclusive prefix max of x over the row's 128 columns (a lane below
    // the shuffle distance gets its own value back, which max ignores)
    int pre[CPL];
    pre[0] = NEG_I;
#pragma unroll
    for (int k = 1; k < CPL; ++k) pre[k] = max(pre[k - 1], x[k - 1]);
    int tot = max(pre[CPL - 1], x[CPL - 1]);
#pragma unroll
    for (int d = 1; d < LPR; d <<= 1)
      tot = max(tot, __shfl_up_sync(FULL, tot, d, LPR));
    int before = __shfl_up_sync(FULL, tot, 1, LPR);
    if (g == 0) before = NEG_I;
    int xlast = 0;
    if constexpr (TB) {
      xlast = __shfl_up_sync(FULL, x[CPL - 1], 1, LPR);
      if (g == 0) xlast = NEG_I;
    }

    // the next step's query base and scores, off the DP's chain: advance
    // the window (column l now reads w[i + 1 + l]), fetch, compare
    uint32_t nb = __shfl_down_sync(FULL, W[0], 1, LPR);
    if (g == LPR - 1) nb = (qi >> 8) & 0xffu;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      W[j] = __funnelshift_r(W[j], j + 1 < NW ? W[j + 1] : nb, 8);
    const bool wrap = s == 31;
    qi = fetch(wrap ? nqpk : qpk, wrap ? nipk : ipk, (s + 1) & 31);
    scores(qi, sc4);

#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      int cm = max(before, pre[k]);
      int F = cm + nfgl[k];
      if constexpr (TB) {
        // tie order of the source: F (strictly above Hno), diagonal, E;
        // with Hno > 0 it is the diagonal or E, whichever is larger
        uint32_t src = Hno[k] > 0 ? 2u - dge[k] : 0u;
        src = F > Hno[k] ? 3u : src;
        int xprev = k ? x[k - 1] : xlast;
        // F extends F iff the prefix max comes from before column l - 1
        uint32_t code = src | ((uint32_t)e_ext[k] << 2)
                        | ((uint32_t)(cm > xprev) << 3);
        // after 8 steps, step i's code sits at bits 4 * (i % 8)
        pk[k] = __funnelshift_r(pk[k], code, 4);
      }
      H[k] = __viaddmax_s32(cm, nfgl[k], Hno[k]);    // max(Hno, F)
      E[k] = En[k];
    }
    if (!decltype(masked)::value || i < qlen) {
      int lmax = H[0];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        bH[k] = max(bH[k], H[k]);
        if (k) lmax = max(lmax, H[k]);
      }
      if (lmax > lbest) {
        lbest = lmax;
        li = i;
      }
    }
    if constexpr (TB) {
      if ((i & 7) == 7 && i < n) {
        uint4* dst = br + (size_t)(i >> 3) * (BAND / 4);
#pragma unroll
        for (int v = 0; v < NW; ++v)
          dst[v] = make_uint4(pk[4 * v], pk[4 * v + 1], pk[4 * v + 2],
                              pk[4 * v + 3]);
      }
    }
  };

  for (int base = 0; base < nmax; base += 32) {
    load(base + 32, nqpk, nipk);        // the next 32 steps, early
    const int cnt = min(32, nmax - base);
    for (int s = 0; s < cnt; ++s) {
      if (base + s < nmin)
        step(base + s, s, Masked<false>());
      else
        step(base + s, s, Masked<true>());
    }
    qpk = nqpk;
    ipk = nipk;
  }
  if constexpr (TB) {
    for (int r = valid ? n >> 3 : Lq >> 3; r < Lq >> 3; ++r) {
#pragma unroll
      for (int v = 0; v < NW; ++v)
        br[(size_t)r * (BAND / 4) + v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the end reduction of fslr_tpu.ops.banded: score = max over columns;
  // lane = smallest column at the maximum; qend = smallest best-row over
  // all columns at the maximum (the first step at which any column
  // reached it), taken apart; a score <= 0 reports 0, 0
  int m = lbest;
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
  int c = 1 << 30, a = lbest == m ? li : 1 << 30;
#pragma unroll
  for (int k = CPL - 1; k >= 0; --k)
    if (bH[k] == m) c = CPL * g + k;
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
    c = min(c, __shfl_xor_sync(FULL, c, o));
    a = min(a, __shfl_xor_sync(FULL, a, o));
  }
  if (valid && g == 0) {
    int s = max(m, 0);
    bool none = s <= 0;
    score[row] = (float)s;
    qend[row] = none ? 0 : a;
    lane_of_best[row] = none ? 0 : c;
  }
}

template <bool TB, int CPL>
int launch(const void* q, const void* w, const void* qlens, const void* order,
           int N, int Lq, IScores sc, void* score, void* qend, void* lane,
           void* bits, cudaStream_t stream) {
  constexpr int rows_per_block = WARPS * CPL / 4;
  banded_dp<TB, CPL><<<(N + rows_per_block - 1) / rows_per_block,
                       32 * WARPS, 0, stream>>>(
      (const uint8_t*)q, (const uint8_t*)w, (const int*)qlens,
      (const int*)order, N, Lq, sc, (float*)score, (int*)qend, (int*)lane,
      (uint4*)bits);
  return (int)cudaGetLastError();
}

// Each instantiation has two layouts: 16 columns a lane for wide launches
// and a narrow one (banded 8, tb 4) for the rest.
template <bool TB>
int dispatch(const void* q, const void* w, const void* qlens,
             const void* order, int N, int Lq, IScores sc, void* score,
             void* qend, void* lane, void* bits, int cpl, void* stream) {
  constexpr int NARROW = TB ? 4 : 8;
  if (cpl != NARROW && cpl != 16) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (cpl == 16)
    return launch<TB, 16>(q, w, qlens, order, N, Lq, sc, score, qend, lane,
                          bits, s);
  return launch<TB, NARROW>(q, w, qlens, order, N, Lq, sc, score, qend, lane,
                            bits, s);
}

}  // namespace

// order: (N,) int32, the rows by descending query length (rows of one warp
// run together, and a block's rows end together); cpl: band columns per
// lane (8 or 16 here, 4 or 16 for fslr_tb).
extern "C" int fslr_banded(const void* q, const void* w, const void* qlens,
                           const void* order, int N, int Lq, int match,
                           int mismatch, int fg, int ext, void* score,
                           void* qend, void* lane, int cpl, void* stream) {
  return dispatch<false>(q, w, qlens, order, N, Lq,
                         IScores{match, mismatch, fg, ext}, score, qend, lane,
                         nullptr, cpl, stream);
}

// bits: (N, Lq / 8, 128) int32, 16-byte aligned; Lq a multiple of 16.
extern "C" int fslr_tb(const void* q, const void* w, const void* qlens,
                       const void* order, int N, int Lq, int match,
                       int mismatch, int fg, int ext, void* score, void* qend,
                       void* lane, void* bits, int cpl, void* stream) {
  return dispatch<true>(q, w, qlens, order, N, Lq,
                        IScores{match, mismatch, fg, ext}, score, qend, lane,
                        bits, cpl, stream);
}
