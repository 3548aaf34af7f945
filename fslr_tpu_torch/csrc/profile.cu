// Banded affine DP of a read against a column-merged POA profile, with
// traceback codes, on Hopper.
//
// Replaces fslr_tpu/ops/profile_align.py:_prof_kernel (launcher
// _prof_pallas): band lanes l = 0..127, query steps i, cell (i, l) covers
// profile column c = i + l.  Per column the profile gives a packed int32
// score word sp (byte b = x16 fixed-point score of read base b,
// sign-extended; a read base >= 4 scores -8) and a cumulative deletion
// cost g, so the lazy-F closed form is an exclusive prefix max of
// C = Hno + g:  F[l] = max_{k<l} C[k] - openF - g[l].  Codes are
// tb_kernel's (banded.cu): bits 0-1 the H source (0 start, 1 diagonal,
// 2 E, 3 F; ties F > diagonal > E), bit 2 E extends E, bit 3 F extends F;
// 8 steps a word, code << 4 * (i % 8), into bits (N, Lq / 8, 128).
// walk_kernel (traceback.cu) reads them back.
//
// Exactness: s is a multiple of 1/16 and g a float32 cut from a float64
// cumsum, so the values are not integers; bit-equality with the plain
// version rests on the operation order of every rounded operation
// (fslr_tpu.ops.profile_align._prof_tb_step), each an explicit
// round-to-nearest intrinsic that nvcc never contracts.  A max is exact,
// so the prefix max may be formed in any order.
//
// What bounds it: a launch holds one read per cluster (~350 rows on the
// consensus run), fewer warps than the card has schedulers, so a step's
// latency decides, not the card's issue rate, and a step that waits on a
// shuffle scan across the band (the exclusive prefix max) is mostly
// waiting.  So the DP runs as a skewed wavefront: cell (i, l) is
// computed at half-tick 2i + l.  Its three inputs, (i - 1, l)
// (diagonal), (i - 1, l + 1) (E) and (i, l - 1) (the prefix-max carry),
// come from half-ticks 2 and 1 before, so no step waits on a scan.
//
// Layout: one warp a row, one row a block (4 rows a block ran 25% slower
// at every launch width from 33 to 512 rows).  Lane j owns band lanes
// 4j .. 4j + 3; at tick tau (pair m = tau - 2j) its even half does band
// lanes 0 and 2 at steps m and m - 1, its odd half band lanes 1 and 3 at
// steps m and m - 1.  Between the halves two shuffles cross lanes:
//   * up (j - 1 -> j), before the even half: band lane 4j - 1's carry
//     max(Cm, C) at step m with its F-extension bit, and the selector of
//     read base m (the read flows up the lanes with the carry);
//   * down (j + 1 -> j), before the odd half: band lane 4j + 4's E
//     contribution max(E - ext, H - fg) at step m - 2 with its extension
//     bit, and that cell's profile column (the profile flows down).
// The shuffles wrap: lane 31's up values go to lane 0, which takes them
// as band lane 0's boundary (carry -1e30, bit 0) and the read base
// entering the band; lane 0's down values go to lane 31 as band lane
// 127's boundary (E -1e30, extension bit 1, the plain version's shift
// fill) and the profile column entering the band.  Lanes 0 and 31 read
// those two streams 8 ticks at a time, a group ahead.  Lane 31 starts 62
// ticks after lane 0: ticks where a lane's step is below 0 (and where a
// row's step passes its qlen) run a guarded tick that keeps the state
// and the best; the others run without a mask.
//
// Per cell: the score (one prmt that also yields -8 for base 4, an
// integer add into a float's mantissa and one subtraction), E, H, C, F,
// the carry and the code (funnel-shifted into a register); per set of
// two band lanes, the best as banded.cu keeps it (each column's best H as
// a plain max; per set its best and the first step at which it reached
// it, which gives the reference's ends).  A lane writes 8 bytes of codes
// when a set finishes a word; a row stops at the end of the word holding
// step qlen - 1 and writes zeros to the words after it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;          // fslr_tpu.ops.ssw.NEG
constexpr unsigned FULL = 0xffffffffu;
constexpr int BAND = 128;
constexpr int SKEW = 63;               // ticks until lane 31's first step
constexpr int GROUP = 8;               // ticks per stream load

struct ProfScores {
  float fg, ext, openF;
};

// prmt selector of read base qc: byte qc of the score word (byte 4, from
// 0x80808080, for a pad base), sign-extended.
__device__ __forceinline__ int base_sel(int qc) {
  return min(qc, 4) * 0x1111 + 0x8880;
}

// The substitution score (fslr_tpu.ops.profile_align._extract_score): the
// selected byte, sign-extended, added into the mantissa of 1.5 * 2^19
// (whose unit in the last place is 1/16) and the offset taken away: v / 16
// exactly.
__device__ __forceinline__ float prof_score(int word, int sel) {
  int v;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(v) : "r"(word), "r"(0x80808080),
      "r"(sel));
  return __fsub_rn(__int_as_float(0x49400000 + v), 786432.0f);
}

template <bool B>
struct Guard {
  static constexpr bool value = B;
};

template <int K>
struct Band {
  static constexpr int value = K;
};

__global__ void __launch_bounds__(32)
prof_dp(const uint8_t* __restrict__ q, const int* __restrict__ sp,
        const float* __restrict__ g, const int* __restrict__ qlens, int Lq,
        ProfScores sc, float* __restrict__ score, int* __restrict__ qend,
        int* __restrict__ lane_of_best, uint32_t* __restrict__ bits) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const uint8_t* qr = q + (size_t)row * Lq;
  const int* spr = sp + (size_t)row * (Lq + 2 * BAND);
  const float* gr = g + (size_t)row * (Lq + 2 * BAND);
  uint32_t* br = bits + (size_t)row * (Lq / 8) * BAND;
  const int below = (lane + 31) & 31, above = (lane + 1) & 31;
  const int qlen = min(max(qlens[row], 0), Lq);
  const int n = min((qlen + 7) & ~7, Lq);   // steps run: whole code words

  // per band lane k: H, the E contribution to band lane k - 1 with its
  // extension bit, the column (score word, g) of its last step, the carry
  // to band lane k + 1 with its bit, and its codes
  float H[4], Eu[4], cg[4], cmx[3];
  bool eb[4], fb[3];
  int cs[4];
  uint32_t pk[4];
  // the best: each band lane's best H; per set (0: band lanes 0-1,
  // 1: band lanes 2-3) its best and the first step that reached it
  float bH[4], lb[2] = {NEG, NEG};
  int li[2] = {0, 0};
  {
    const float eo = __fsub_rn(NEG, sc.ext), ho = __fsub_rn(0.f, sc.fg);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      H[k] = 0.f;
      Eu[k] = fmaxf(eo, ho);
      eb[k] = eo >= ho;
      bH[k] = NEG;
      pk[k] = 0u;
      cs[k] = 0;
      cg[k] = 0.f;
      if (k < 3) {
        cmx[k] = NEG;
        fb[k] = false;
      }
    }
  }
  // before tick 0 lane j is at pair -2j: band lane 1's last column is 2j,
  // band lane 3's 2j + 1
  cs[1] = spr[2 * lane];
  cg[1] = gr[2 * lane];
  cs[3] = spr[2 * lane + 1];
  cg[3] = gr[2 * lane + 1];
  int selA = base_sel(4), selB = base_sel(4);
  // lane 31's up values before tick 0: base 0 for lane 0
  float up_c = NEG;
  int up_s = lane == 31 && Lq > 0 ? base_sel(qr[0]) : base_sel(4);

  // The streams of a group of ticks from t0: columns t0 + 64 .. t0 + 71
  // entering band lane 127 (lane 0 hands them down) and read bases
  // t0 + 1 .. t0 + 8 entering band lane 0 (lane 31 hands them up).  Every
  // lane loads the same addresses (one request a load).
  int csp[GROUP], nsp[GROUP];
  float cgg[GROUP], ngg[GROUP];
  uint2 cq, nq;
  auto load = [&](int t0, int (&s)[GROUP], float (&gg)[GROUP], uint2& qq) {
    const int4* s4 = reinterpret_cast<const int4*>(spr + t0 + 64);
    const float4* g4 = reinterpret_cast<const float4*>(gr + t0 + 64);
    int4 a = s4[0], b = s4[1];
    float4 c = g4[0], d = g4[1];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    gg[0] = c.x; gg[1] = c.y; gg[2] = c.z; gg[3] = c.w;
    gg[4] = d.x; gg[5] = d.y; gg[6] = d.z; gg[7] = d.w;
    qq = t0 < Lq ? *reinterpret_cast<const uint2*>(qr + t0)
                 : make_uint2(0x04040404u, 0x04040404u);
  };

  // One cell of band lane k: the column (w, gc), the read base's selector,
  // the E contribution from band lane k + 1 at the step before (En, ee)
  // and the carry from band lane k - 1 (Cm, fin).  `act`: the step is >= 0
  // (a guarded tick keeps the state of a cell that has not started).
  auto cell = [&](auto K, int w, float gc, int sel, float En, bool ee,
                  float Cm, bool fin, bool act, auto guard) {
    constexpr int k = decltype(K)::value;
    const float s = prof_score(w, sel);
    const float diag = __fadd_rn(H[k], s);
    const float Hno = fmaxf(fmaxf(diag, En), 0.f);
    const float C = __fadd_rn(Hno, gc);
    const float F = __fsub_rn(__fsub_rn(Cm, sc.openF), gc);
    // tie order of the source: F (strictly above Hno), diagonal, E; with
    // Hno > 0 it is the diagonal or E, whichever is larger
    uint32_t src = Hno > 0.f ? (diag == Hno ? 1u : 2u) : 0u;
    src = F > Hno ? 3u : src;
    const uint32_t code = src | (ee ? 4u : 0u) | (fin ? 8u : 0u);
    // after 8 steps, step i's code sits at bits 4 * (i % 8)
    pk[k] = __funnelshift_r(pk[k], code, 4);
    if constexpr (k < 3) {
      cmx[k] = fmaxf(Cm, C);     // the exclusive prefix max at band lane k+1
      fb[k] = Cm > C;            // ... exceeds C[k]: F there extends F
    }
    if (!decltype(guard)::value || act) {
      const float Hn = fmaxf(Hno, F);
      const float eo = __fsub_rn(En, sc.ext), ho = __fsub_rn(Hn, sc.fg);
      H[k] = Hn;
      Eu[k] = fmaxf(eo, ho);
      eb[k] = eo >= ho;
    }
    return C;
  };

  // One tick at position s of its group.
  auto tick = [&](int tau, int s, auto guard) {
    constexpr bool G = decltype(guard)::value;
    const int m = tau - 2 * lane;
    // even half: band lane 0 at step m, band lane 2 at step m - 1
    const float cin = __shfl_sync(FULL, up_c, below);
    const int upv = __shfl_sync(FULL, up_s, below);
    selB = selA;
    selA = upv & 0xffff;
    cs[0] = cs[1];
    cg[0] = cg[1];
    cell(Band<0>(), cs[0], cg[0], selA, Eu[1], eb[1], cin, (upv >> 16) & 1,
         m >= 0, guard);
    cs[2] = cs[3];
    cg[2] = cg[3];
    cell(Band<2>(), cs[2], cg[2], selB, Eu[3], eb[3], cmx[1], fb[1], m >= 1,
         guard);
    // down: band lane 0's E contribution and column; lane 0 sends band
    // lane 127's boundary and the column entering it
    const bool first = lane == 0;
    const float rEu = __shfl_sync(FULL, first ? NEG : Eu[0], above);
    const int rEb = __shfl_sync(FULL, first ? 1 : (int)eb[0], above);
    const int rsp = __shfl_sync(FULL, first ? csp[s] : cs[0], above);
    const float rg = __shfl_sync(FULL, first ? cgg[s] : cg[0], above);
    // odd half: band lane 1 at step m, band lane 3 at step m - 1
    cs[1] = cs[2];
    cg[1] = cg[2];
    cell(Band<1>(), cs[1], cg[1], selA, Eu[2], eb[2], cmx[0], fb[0], m >= 0,
         guard);
    cs[3] = rsp;
    cg[3] = rg;
    const float C3 = cell(Band<3>(), cs[3], cg[3], selB, rEu, rEb != 0,
                          cmx[2], fb[2], m >= 1, guard);
    // up: band lane 3's carry and read base m - 1; lane 31 sends band lane
    // 0's boundary and the read base entering it (base tau + 1)
    const int qn = (int)(((s + 1 < 4 ? cq.x : s + 1 < 8 ? cq.y : nq.x)
                          >> (8 * ((s + 1) & 3))) & 0xffu);
    up_c = lane == 31 ? NEG : fmaxf(cmx[2], C3);
    up_s = lane == 31 ? base_sel(qn)
                      : (selB | (cmx[2] > C3 ? 1 << 16 : 0));
    // the best, per set, only at steps below qlen
    if (!G || (m >= 0 && m < qlen)) {
      bH[0] = fmaxf(bH[0], H[0]);
      bH[1] = fmaxf(bH[1], H[1]);
      const float mx = fmaxf(H[0], H[1]);
      if (mx > lb[0]) {
        lb[0] = mx;
        li[0] = m;
      }
    }
    if (!G || (m >= 1 && m - 1 < qlen)) {
      bH[2] = fmaxf(bH[2], H[2]);
      bH[3] = fmaxf(bH[3], H[3]);
      const float mx = fmaxf(H[2], H[3]);
      if (mx > lb[1]) {
        lb[1] = mx;
        li[1] = m - 1;
      }
    }
    // a set that finished a word stores it (8 bytes)
    if ((m & 7) == 7 && (!G || (m >= 0 && m < n)))
      *reinterpret_cast<uint2*>(br + (size_t)(m >> 3) * BAND + 4 * lane) =
          make_uint2(pk[0], pk[1]);
    if (((m - 1) & 7) == 7 && (!G || (m >= 1 && m - 1 < n)))
      *reinterpret_cast<uint2*>(br + (size_t)((m - 1) >> 3) * BAND +
                                4 * lane + 2) = make_uint2(pk[2], pk[3]);
  };

  if (n > 0) {
    load(0, csp, cgg, cq);
    for (int t0 = 0; t0 < n + SKEW; t0 += GROUP) {
      load(t0 + GROUP, nsp, ngg, nq);     // the next group, early
      if (t0 > SKEW && t0 + GROUP <= qlen) {
#pragma unroll
        for (int s = 0; s < GROUP; ++s) tick(t0 + s, s, Guard<false>());
      } else {
#pragma unroll
        for (int s = 0; s < GROUP; ++s) tick(t0 + s, s, Guard<true>());
      }
#pragma unroll
      for (int s = 0; s < GROUP; ++s) {
        csp[s] = nsp[s];
        cgg[s] = ngg[s];
      }
      cq = nq;
    }
  }
  for (int r = n >> 3; r < Lq >> 3; ++r)
    *reinterpret_cast<uint4*>(br + (size_t)r * BAND + 4 * lane) =
        make_uint4(0u, 0u, 0u, 0u);

  // the end reduction of fslr_tpu.ops.profile_align: score = max over
  // band lanes; lane = smallest band lane at the maximum; qend = smallest
  // best step over all band lanes at the maximum (the first step at which
  // any reached it), taken apart; a score <= 0 reports 0, 0
  float mx = fmaxf(fmaxf(bH[0], bH[1]), fmaxf(bH[2], bH[3]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  int c = 1 << 30;
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (bH[k] == mx) c = 4 * lane + k;
  int a = min(lb[0] == mx ? li[0] : 1 << 30, lb[1] == mx ? li[1] : 1 << 30);
  c = (int)__reduce_min_sync(FULL, (unsigned)c);
  a = (int)__reduce_min_sync(FULL, (unsigned)a);
  if (lane == 0) {
    const float s = fmaxf(mx, 0.f);
    const bool none = s <= 0.f;
    score[row] = s;
    qend[row] = none ? 0 : a;
    lane_of_best[row] = none ? 0 : c;
  }
}

}  // namespace

// q (N, Lq) uint8, Lq a multiple of 128; sp (N, Lq + 256) int32; g
// (N, Lq + 256) float32; bits (N, Lq / 8, 128) int32; all 16-byte
// aligned.
extern "C" int fslr_prof(const void* q, const void* sp, const void* g,
                         const void* qlens, int N, int Lq, float fg,
                         float ext, float openF, void* score, void* qend,
                         void* lane, void* bits, void* stream) {
  if (N > 0) {
    prof_dp<<<N, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const int*)sp, (const float*)g,
        (const int*)qlens, Lq, ProfScores{fg, ext, openF}, (float*)score,
        (int*)qend, (int*)lane, (uint32_t*)bits);
  }
  return (int)cudaGetLastError();
}
