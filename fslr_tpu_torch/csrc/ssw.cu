// Batched local affine Smith-Waterman on Hopper.
//
// Replaces two Pallas kernels of the JAX package, as two instantiations of
// one template, sw_dp<PACKED>:
//   * sw_kernel        <- fslr_tpu/ops/ssw.py:_sw_kernel (launcher _sw_pallas):
//     one query of <= 128 bases per row against a target window; outputs
//     score, target end and query end (primer location, run twice by
//     sw_locate);
//   * sw_packed_kernel <- fslr_tpu/ops/ssw.py:_sw_packed_kernel (launcher
//     _sw_packed_pallas): up to 128/stride primers packed at fixed column
//     strides in one row, kept apart by the SEG_BIG offset of the lazy-F
//     prefix max; outputs the row-global score, target end and column
//     (concatemer scan).
//
// Query columns j are the DP lanes, target positions i are scanned; the
// in-row dependency (lazy F) is the closed form of
// fslr_tpu_torch/ops/ssw.py:_sw_step, an exclusive prefix max over the
// columns.  A step of a row is a serial chain through that prefix max, and
// the DP's integer instructions issue at half the float rate, so the
// kernel is bound by instruction issue on wide launches and by the step's
// latency on narrow ones.  The design cuts both:
//
// * Integer DP with DPX.  Scores are integers, so every DP value is an
//   integer: E = __viaddmax_s32(E, -ext, H - fg), Hno =
//   __viaddmax_s32_relu(diag, s, E) = max(diag + s, E, 0), H =
//   __viaddmax_s32(cm, c[j], Hno) with c[j] = -segoff[j] - fg - (j - 1) ext
//   one constant a column.  The packed kernel keeps the reference's
//   SEG_BIG offsets (3e6 + 2^24 + 254 < 2^31 leaves room), so no
//   segmented scan is needed.  The float sentinel -1e30 met only maxima
//   with values >= 0 (the relu, H = max(Hno, F) where F is -1e30 at column
//   0), and the integer sentinel NEG_I takes the same maxima; every other
//   value is an exact integer below 2^24 in both.
// * A query profile (SSW's, per thread): each thread keeps its columns'
//   int32 scores against each target code in shared memory, so a step's
//   scores are CPL / 4 16-byte loads and no instruction a cell.  A column
//   that is not kept (sw: j >= qlen; packed: query code >= 4) holds the
//   reference's -1e30 score as s + NEG_I there.  (Scores computed each
//   step with __vcmpeq4 cost 5 instructions a word plus a prmt a column:
//   sm_90 has no native vcmpeq4.)
// * CPL = 16 columns a lane, LPR = 8 lanes a row, 4 rows a warp (the
//   8-column layout, 2 rows a warp, was slower on the main path's own
//   launches: PERF.md).
//   A column's diagonal is the previous column of the same lane, except at
//   the lane's first column (one shuffle; 0 where a segment starts), and
//   the exclusive prefix max is an in-thread scan plus log2(LPR) shuffle
//   levels.  A step's target base comes with one shuffle from the lane of
//   the row that loaded it, 32 steps at a time, and the next step's base
//   and scores are fetched while the current step's scan is in flight.
//   sw_kernel's warps whose queries all fit in 72 columns run 9 columns a
//   lane (the main path's primer targets have 67-68 bases).
// * The best: each column keeps its best H, each lane its best and the
//   first step one of its columns reached it, which gives the reference's
//   ends (smallest column at the maximum; smallest best row over all
//   columns at it, taken apart) with 1.5 maxima a cell.  A column that is
//   not kept needs no mask there: its H stays at or below max(0, M - 1),
//   M the kept columns' best so far, when fg >= 1 and ext >= 0 (the
//   wrappers refuse other scores).
// * Rows of one warp run together, so they are taken by descending target
//   length (`order`, a counting sort on the device, order_rows, launched
//   with the DP: a torch.argsort of 8,192 rows costs a dozen small
//   launches): a warp's rows end together, and a row's steps past its own
//   target length are masked only after the warp's shortest row has
//   ended.  Results go to the row's own place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int QP = 128;               // query bytes per row
constexpr int WARPS = 4;              // warps per block
constexpr int NEG_I = -(1 << 29);     // integer sentinel
constexpr int SEG_BIG = 1000000;      // fslr_tpu.ops.ssw.SEG_BIG
constexpr int NT = 32 * WARPS;        // threads per block
constexpr int CODES = 5;              // target codes 0-3, and 4 for any other
constexpr int CPL = 16;               // query columns a lane
constexpr int LPR = QP / CPL;         // lanes a row
constexpr int NWT = CPL / 4;          // int4 profile words a thread and code

struct IScores {
  int match, mismatch, fg, ext;       // fg: cost of a gap's first base
};

// A step's kind: Masked<true> after the warp's shortest row has ended,
// when each row keeps its best only up to its own target length.
template <bool B>
struct Masked {
  static constexpr bool value = B;
};

// One warp's rows: C of the row's query columns a lane (CPL, or fewer in
// a warp of sw_kernel whose queries fit), LPR lanes a row.
// prof: the block's query profile.
template <bool PACKED, int C>
__device__ __forceinline__ void sw_rows(
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ t, int row,
    bool valid, int qlen, int n, int nmax, int nmin, int T, int stride,
    const IScores& sc, int4* __restrict__ prof, float* __restrict__ score,
    int* __restrict__ tend, int* __restrict__ col_of_best) {
  constexpr int NW = (C + 3) / 4;     // int4 profile words a lane and code
  constexpr int S = 32 / LPR;         // steps a lane loads per 32 steps
  const int tid = threadIdx.x, g = tid % LPR;

  // The query profile: this lane's scores of its C columns against each
  // target code, int4 words of consecutive threads side by side (a quarter
  // warp reads 128 contiguous bytes).  A column that is not kept (sw: j >=
  // qlen; packed: a query code >= 4) takes the reference's -1e30 score.
  const uint8_t* qr = q + (size_t)row * QP + C * g;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    int e[CODES][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * w + b;
      const int qc = k < C ? qr[k] : 4;
      const bool keep = PACKED ? qc < 4 : C * g + k < qlen;
#pragma unroll
      for (int c = 0; c < CODES; ++c)
        e[c][b] = (c < 4 && qc == c ? sc.match : sc.mismatch)
                  + (keep ? 0 : NEG_I);
    }
#pragma unroll
    for (int c = 0; c < CODES; ++c)
      prof[(c * NWT + w) * NT + tid] =
          make_int4(e[c][0], e[c][1], e[c][2], e[c][3]);
  }
  auto scores = [&](uint32_t tc, int (&sv)[C]) {
    const int4* p = prof + min(tc, 4u) * NWT * NT + tid;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int4 v = p[w * NT];
      const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * w + b < C) sv[4 * w + b] = e[b];
    }
  };

  // bH: each column's best H; (lbest, li): the lane's best H and the first
  // step at which one of its columns reached it
  int H[C], E[C], bH[C], lext[C], nfgl[C];
  int lbest = NEG_I, li = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = C * g + k;
    lext[k] = j * sc.ext + (PACKED ? j / stride * SEG_BIG : 0);
    nfgl[k] = sc.ext - sc.fg - lext[k];      // F = cm - segoff - fg - (j-1) ext
    H[k] = 0;
    E[k] = NEG_I;
    bH[k] = NEG_I;
  }
  // the lane's first column starts a segment: its diagonal is 0
  const bool zdiag = (C * g) % (PACKED ? stride : QP) == 0;

  // The target bases of 32 steps: lane g of a row loads steps g * S ..
  // g * S + S - 1, and a step's base comes with one shuffle.
  const uint8_t* tr = t + (size_t)row * T;
  auto load = [&](int base) -> uint32_t {
    uint32_t v = 0u;
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int idx = base + g * S + u;
      v |= (uint32_t)(idx < n ? tr[idx] : 4) << (8 * u);
    }
    return v;
  };
  auto fetch = [&](uint32_t tpk, int s) -> uint32_t {
    return (__shfl_sync(FULL, tpk, s / S, LPR) >> (8 * (s % S))) & 0xffu;
  };

  uint32_t tpk = load(0), ntpk = 0u;
  int sv[C];
  scores(fetch(tpk, 0), sv);

  // One target step on sv; leaves sv holding the next step's scores.
  auto step = [&](int i, int s, auto masked) {
    int up = __shfl_up_sync(FULL, H[C - 1], 1, LPR);
    if (zdiag) up = 0;
    int Hno[C], x[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      E[k] = __viaddmax_s32(E[k], -sc.ext, H[k] - sc.fg);
      Hno[k] = __viaddmax_s32_relu(k ? H[k - 1] : up, sv[k], E[k]);
      x[k] = Hno[k] + lext[k];
    }
    // exclusive prefix max of x over the row's columns (a lane below the
    // shuffle distance gets its own value back, which max ignores)
    int pre[C];
    pre[0] = NEG_I;
#pragma unroll
    for (int k = 1; k < C; ++k) pre[k] = max(pre[k - 1], x[k - 1]);
    int tot = max(pre[C - 1], x[C - 1]);
#pragma unroll
    for (int d = 1; d < LPR; d <<= 1)
      tot = max(tot, __shfl_up_sync(FULL, tot, d, LPR));
    int before = __shfl_up_sync(FULL, tot, 1, LPR);
    if (g == 0) before = NEG_I;

    // the next step's target base and scores, off the DP's chain
    const bool wrap = s == 31;
    scores(fetch(wrap ? ntpk : tpk, (s + 1) & 31), sv);

#pragma unroll
    for (int k = 0; k < C; ++k)
      H[k] = __viaddmax_s32(max(before, pre[k]), nfgl[k], Hno[k]);
    // a column that is not kept stays at or below max(0, M - 1), M the
    // kept columns' best so far (fg >= 1, ext >= 0), so it never sets a
    // positive maximum: the best needs no mask
    if (!decltype(masked)::value || i < n) {
      int lmax = H[0];
#pragma unroll
      for (int k = 1; k + 1 < C; k += 2)
        lmax = __vimax3_s32(lmax, H[k], H[k + 1]);
      if (C % 2 == 0) lmax = max(lmax, H[C - 1]);
#pragma unroll
      for (int k = 0; k < C; ++k) bH[k] = max(bH[k], H[k]);
      if (lmax > lbest) {
        lbest = lmax;
        li = i;
      }
    }
  };

  for (int base = 0; base < nmax; base += 32) {
    ntpk = load(base + 32);             // the next 32 steps, early
    const int cnt = min(32, nmax - base);
    for (int s = 0; s < cnt; ++s) {
      if (base + s < nmin)
        step(base + s, s, Masked<false>());
      else
        step(base + s, s, Masked<true>());
    }
    tpk = ntpk;
  }

  // the end reduction of fslr_tpu.ops.ssw._finalize: score = max over kept
  // columns; col = smallest column at the maximum; tend = smallest best row
  // over all columns at the maximum (the first step at which any column
  // reached it), taken apart; a score <= 0 reports 0, 0
  int m = lbest;
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
  int c = 1 << 30, a = lbest == m ? li : 1 << 30;
#pragma unroll
  for (int k = C - 1; k >= 0; --k)
    if (bH[k] == m) c = C * g + k;
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) {
    c = min(c, __shfl_xor_sync(FULL, c, o));
    a = min(a, __shfl_xor_sync(FULL, a, o));
  }
  if (valid && g == 0) {
    const int sco = max(m, 0);
    const bool none = sco <= 0;
    score[row] = (float)sco;
    tend[row] = none ? 0 : a;
    col_of_best[row] = none ? 0 : c;
  }
}

// The kernel: 32 / LPR rows a warp, taken from `order`.  In sw_kernel a
// warp runs 9 columns a lane if its longest query has at most 72 bases (the
// main path's primer targets have 67-68), else 16: a column never feeds
// one to its left, so the columns past the longest query cannot change a
// kept column.
template <bool PACKED>
__global__ void __launch_bounds__(NT)
sw_dp(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
      const int* __restrict__ qlens, const int* __restrict__ tlens,
      const int* __restrict__ order, int B, int T, int stride, IScores sc,
      float* __restrict__ score, int* __restrict__ tend,
      int* __restrict__ col_of_best) {
  constexpr int RPW = 32 / LPR;       // rows per warp
  __shared__ int4 prof[CODES * NWT * NT];
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * RPW;
  if (first >= B) return;             // whole warp idle
  const int slot = first + lane / LPR;
  const bool valid = slot < B;
  const int row = order[valid ? slot : B - 1];
  const int n = valid ? max(0, min(tlens[row], T)) : 0;
  const int nmax = (int)__reduce_max_sync(FULL, (unsigned)n);
  // steps below every row's target length need no mask on the best
  const int nmin = (int)__reduce_min_sync(FULL, (unsigned)n);
  const int qlen = PACKED || !valid ? 0 : max(qlens[row], 0);
  if constexpr (!PACKED) {
    const int qmax = (int)__reduce_max_sync(FULL, (unsigned)qlen);
    if (qmax <= 9 * LPR) {
      sw_rows<PACKED, 9>(q, t, row, valid, qlen, n, nmax, nmin, T, stride,
                         sc, prof, score, tend, col_of_best);
      return;
    }
  }
  sw_rows<PACKED, CPL>(q, t, row, valid, qlen, n, nmax, nmin, T, stride, sc,
                       prof, score, tend, col_of_best);
}

// The rows by descending target length (clamped to T and to ORDER_BINS -
// 1): a counting sort in one block, rows of equal length in any order
// (each row's result does not depend on the rows beside it).
constexpr int ORDER_BINS = 4096;
constexpr int ORDER_NT = 1024;

__global__ void __launch_bounds__(ORDER_NT)
order_rows(const int* __restrict__ tlens, int B, int T,
           int* __restrict__ order) {
  __shared__ int bin[ORDER_BINS];
  __shared__ int wsum[ORDER_NT / 32];
  constexpr int PER = ORDER_BINS / ORDER_NT;    // bins a thread scans
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto key = [&](int r) {               // longest first
    return ORDER_BINS - 1 - min(max(0, min(tlens[r], T)), ORDER_BINS - 1);
  };
  for (int b = tid; b < ORDER_BINS; b += ORDER_NT) bin[b] = 0;
  __syncthreads();
  for (int r = tid; r < B; r += ORDER_NT) atomicAdd(&bin[key(r)], 1);
  __syncthreads();
  // exclusive scan of the bins: PER consecutive bins a thread, then the
  // threads' sums across the block
  int v[PER], sum = 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    v[u] = bin[PER * tid + u];
    sum += v[u];
  }
  int inc = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane], wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, wi, d);
      if (lane >= d) wi += o;
    }
    wsum[lane] = wi - w;
  }
  __syncthreads();
  int off = wsum[warp] + inc - sum;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    bin[PER * tid + u] = off;
    off += v[u];
  }
  __syncthreads();
  for (int r = tid; r < B; r += ORDER_NT) order[atomicAdd(&bin[key(r)], 1)] = r;
}

template <bool PACKED>
int launch(const void* q, const void* t, const void* qlens, const void* tlens,
           const void* order, int B, int T, int stride, IScores sc,
           void* score, void* tend, void* col, void* stream) {
  if (PACKED && (stride <= 0 || stride % CPL))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  order_rows<<<1, ORDER_NT, 0, (cudaStream_t)stream>>>(
      (const int*)tlens, B, T, (int*)order);
  constexpr int rows_per_block = WARPS * (32 / LPR);
  sw_dp<PACKED><<<(B + rows_per_block - 1) / rows_per_block, NT, 0,
                  (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const uint8_t*)t, (const int*)qlens,
      (const int*)tlens, (const int*)order, B, T, stride, sc, (float*)score,
      (int*)tend, (int*)col);
  return (int)cudaGetLastError();
}

}  // namespace

// order: (B,) int32 scratch, filled with the rows by descending target
// length before the DP runs; fg >= 1 and ext >= 0.
extern "C" int fslr_sw(const void* q, const void* t, const void* qlens,
                       const void* tlens, const void* order, int B, int T,
                       int match, int mismatch, int fg, int ext, void* score,
                       void* tend, void* qend, void* stream) {
  return launch<false>(q, t, qlens, tlens, order, B, T, QP,
                       IScores{match, mismatch, fg, ext}, score, tend, qend,
                       stream);
}

// stride: a multiple of 16 (the columns a lane); any other stride is
// refused with cudaErrorInvalidValue before a launch.
extern "C" int fslr_sw_packed(const void* q, const void* t, const void* tlens,
                              const void* order, int B, int T, int stride,
                              int match, int mismatch, int fg, int ext,
                              void* score, void* tend, void* lane,
                              void* stream) {
  return launch<true>(q, t, nullptr, tlens, order, B, T, stride,
                      IScores{match, mismatch, fg, ext}, score, tend, lane,
                      stream);
}
