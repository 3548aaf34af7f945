// Tandem-repeat mask (tantan-style forward-backward HMM) on Hopper.
//
// Replaces fslr_tpu/ops/tantan.py:_mask_kernel (launcher _mask_pallas).
// States: a background state b and repeat states r_d for periods
// d = 1..P (P <= 128); a position is masked when its posterior
// P(repeat) >= thresh; the kernel writes the posterior.  The recurrences
// are those of the scan reference fslr_tpu.ops.tantan._mask_impl; sums run
// in another order and the scale differs per position, so posteriors
// differ from the plain version by ~1e-6 (chip_smoke.py checks decisions).
//
// What bounds it: each position is a serial chain (the next background
// state needs the sum of all repeat states), so the kernel is bound by
// the latency of one step, not by operations or bytes; a launch holds
// only a few hundred reads, a handful of chains per SM.  The design
// shortens the step and keeps every per-position state on chip:
//
// * One warp per read, lane g owning periods 32 k + g + 1 (k < 4), so a
//   state sum is an in-thread sum plus five xor shuffles, with no block
//   barrier in the step (an 8-lanes-a-read layout, 16 periods a lane,
//   measured 2.6x slower: its in-thread work is serial).  The read sits in
//   shared memory behind 128 bytes of "no base yet", so the emission's
//   window base seq[i - d] is one shared load with no bounds test, and its
//   likelihood ratio one more, from a table of the 6 x 5 cases.
// * Normalisation is deferred as in _mask_kernel: the posterior is a
//   ratio of same-position forward x backward products, so a common
//   scale cancels.  The states are rescaled after every RESCALE positions
//   (the f32 range guard of fslr_tpu/ops/tantan.py:_RESCALE), which takes
//   the sum of the new repeat states and both divides out of the step.
//   The forward step's one sum (of the old repeat states, for the new
//   background) and the backward step's one sum (of start_d * w) are the
//   only reductions on the chain, and each step computes the states that
//   do not need its own sum first, so the next step's sum can start while
//   this one is in flight; the posterior's numerator is off the chain.
// * The TPU kernel's memory plan: the forward pass keeps only a
//   checkpoint of (fb, fr) every C positions in a small device buffer
//   (ceil(L / C) x 129 floats per read, 12.7 MB at 512 x 3072).  The
//   backward pass walks the chunks from last to first; for each it
//   re-derives the C forward states from the checkpoint into shared
//   memory (same operations, same order, so the same values) and
//   consumes them in reverse.  No per-position state touches device
//   memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAXP = 128;              // period slots per read
constexpr int K = MAXP / 32;           // slots per lane
constexpr int C = 64;                  // checkpoint interval (positions)
constexpr int RESCALE = 16;            // positions between rescales
constexpr int CK = MAXP + 1;           // checkpoint floats: fr slots, fb

struct Hmm {
  int L, P;
  float stay_b, stay_r, end_p, match_ratio, mismatch_ratio;
};

// Likelihood ratio of a repeat state: window base `win` (4 = N, 5 =
// before the read) against base x.  The kernel tabulates it once in
// shared memory (LUT[8 x + win]), so a state's ratio is one load.
__device__ __forceinline__ float emission(int win, int x, const Hmm& h) {
  if (win == 5) return 0.f;              // no base yet: period not started
  if (x == 4 || win == 4) return 1.f;    // N: likelihood ratio 1
  return win == x ? h.match_ratio : h.mismatch_ratio;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float slot_sum(const float (&v)[K]) {
  return (v[0] + v[1]) + (v[2] + v[3]);
}

// ss points at the read; ss[-MAXP .. -1] hold 5 ("no base yet").
struct Read {
  const uint8_t* ss;
  const float* lut;                      // emission ratios, LUT[8 x + win]
  float sd[K];
  int g;
};

// Forward step at position i: (fb, fr) hold the state after i - 1 and
// leave holding the state after i.  The new repeat states come first:
// they do not need this step's sum, so the next step's sum can start
// while this one is in flight.
__device__ __forceinline__ void fwd_step(float& fb, float (&fr)[K], int i,
                                         const Read& rd, const Hmm& h) {
  const float* er = rd.lut + 8 * rd.ss[i];
  float frn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int win = rd.ss[i - (32 * k + rd.g + 1)];
    frn[k] = (fr[k] * h.stay_r + fb * rd.sd[k]) * er[win];
  }
  float S = warp_sum(slot_sum(fr));
  fb = fb * h.stay_b + S * h.end_p;
#pragma unroll
  for (int k = 0; k < K; ++k) fr[k] = frn[k];
}

// The f32 range guard: scale (b, r) so that b + sum(r) = 1 (a common
// scale cancels in the posterior, so the reciprocal may be approximate).
__device__ __forceinline__ void rescale(float& b, float (&r)[K]) {
  float f = __fdividef(1.f, fmaxf(b + warp_sum(slot_sum(r)), 1e-30f));
  b *= f;
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] *= f;
}

// Forward steps i0 .. i1-1 in groups of RESCALE, each followed by a
// rescale; with `keep`, each state is stored in the chunk's shared rows.
template <bool KEEP>
__device__ __forceinline__ void fwd_span(float& fb, float (&fr)[K], int i0,
                                         int i1, const Read& rd,
                                         const Hmm& h, float* s_fr,
                                         float* s_fb) {
  auto one = [&](int i) {
    fwd_step(fb, fr, i, rd, h);
    if (KEEP) {
      float* row = s_fr + (i - i0) * MAXP;
#pragma unroll
      for (int k = 0; k < K; ++k) row[32 * k + rd.g] = fr[k];
      s_fb[i - i0] = fb;       // every lane writes (and reads) its own copy
    }
  };
  for (int s0 = i0; s0 < i1; s0 += RESCALE) {
    if (s0 + RESCALE <= i1) {
#pragma unroll
      for (int t = 0; t < RESCALE; ++t) one(s0 + t);
    } else {
      for (int i = s0; i < i1; ++i) one(i);
    }
    rescale(fb, fr);
  }
}

// One warp per read, lane g owns periods 32 k + g + 1.  Shared memory
// per block: C forward states (C x MAXP floats, then C fb floats), the
// emission table (64 floats), then MAXP bytes of 5 and the read (L bytes,
// padded to 16).
__global__ void __launch_bounds__(32)
mask_kernel(const uint8_t* __restrict__ seq, const float* __restrict__ start_d,
            Hmm h, float* __restrict__ ck, float* __restrict__ post) {
  extern __shared__ float smem[];
  const int g = threadIdx.x, b = blockIdx.x;
  const int L = h.L, nchunk = (L + C - 1) / C;
  float* s_fr = smem;
  float* s_fb = s_fr + C * MAXP;
  float* s_lut = s_fb + C;
  uint8_t* ssp = reinterpret_cast<uint8_t*>(s_lut + 64);
  const uint8_t* sr = seq + (size_t)b * L;
  for (int i = g; i < 64; i += 32) s_lut[i] = emission(i % 8, i / 8, h);
  for (int i = g; i < MAXP; i += 32) ssp[i] = 5;
  for (int i = g; i < L; i += 32) ssp[MAXP + i] = sr[i];
  __syncwarp();

  Read rd;
  rd.ss = ssp + MAXP;
  rd.lut = s_lut;
  rd.g = g;
  float livef[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int d = 32 * k + g + 1;
    livef[k] = d <= h.P ? 1.f : 0.f;
    rd.sd[k] = d <= h.P ? start_d[d - 1] : 0.f;   // dead periods stay 0
  }
  float* ckr = ck + (size_t)b * nchunk * CK;

  // ---- forward: carry only, a checkpoint before every chunk ----------
  // (the last chunk is re-derived by the backward pass, so it is skipped)
  float fb = 1.f, fr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) fr[k] = 0.f;
  for (int j = 0; j < nchunk; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) ckr[j * CK + 32 * k + g] = fr[k];
    if (g == 0) ckr[j * CK + MAXP] = fb;
    if (j == nchunk - 1) break;
    fwd_span<false>(fb, fr, j * C, (j + 1) * C, rd, h, s_fr, s_fb);
  }
  __syncwarp();

  // ---- backward: per chunk, re-derive the forward states, walk back ---
  float bb = 1.f, br[K];
#pragma unroll
  for (int k = 0; k < K; ++k) br[k] = livef[k];
  for (int j = nchunk - 1; j >= 0; --j) {
    const int i0 = j * C, i1 = min(L, i0 + C);
    fb = ckr[j * CK + MAXP];     // written by lane 0 (__syncwarp above)
#pragma unroll
    for (int k = 0; k < K; ++k) fr[k] = ckr[j * CK + 32 * k + g];
    fwd_span<true>(fb, fr, i0, i1, rd, h, s_fr, s_fb);

    // the beta step at p: emit the posterior from the incoming carry;
    // the next carry's repeat states come before this step's sums
    auto step = [&](int p) {
      const float* row = s_fr + (p - i0) * MAXP;
      const float* er = rd.lut + 8 * rd.ss[p];
      float a[K], num[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        int win = rd.ss[p - (32 * k + g + 1)];
        float w = er[win] * br[k];
        a[k] = rd.sd[k] * w;
        num[k] = row[32 * k + g] * br[k];
        br[k] = (h.stay_r * w + h.end_p * bb) * livef[k];
      }
      float A = warp_sum(slot_sum(a));
      float N = warp_sum(slot_sum(num));
      float v = __fdividef(N, fmaxf(N + s_fb[p - i0] * bb, 1e-30f));
      if (g == 0) post[(size_t)b * L + p] = v;
      bb = h.stay_b * bb + A;
    };
    // groups of RESCALE from the top, a partial one first
    const int r = (i1 - i0) % RESCALE;
    for (int p = i1 - 1; p >= i1 - r; --p) step(p);
    if (r) rescale(bb, br);
    for (int s0 = i1 - r - RESCALE; s0 >= i0; s0 -= RESCALE) {
#pragma unroll
      for (int t = RESCALE - 1; t >= 0; --t) step(s0 + t);
      rescale(bb, br);
    }
  }
}

}  // namespace

// Floats of checkpoint scratch fslr_mask needs per read of length L.
extern "C" int fslr_mask_scratch(int L) { return (L + C - 1) / C * CK; }

// ck: B x fslr_mask_scratch(L) floats.  Refuses P above 128, and a read
// (with one chunk of forward states) that does not fit shared memory.
extern "C" int fslr_mask(const void* seq, int B, int L, int P,
                         const void* start_d, float stay_b, float stay_r,
                         float end_p, float match_ratio, float mismatch_ratio,
                         void* ck, void* post, void* stream) {
  if (P < 1 || P > MAXP) return (int)cudaErrorInvalidValue;
  if (B <= 0 || L <= 0) return (int)cudaGetLastError();
  Hmm h{L, P, stay_b, stay_r, end_p, match_ratio, mismatch_ratio};
  size_t smem = (C * (MAXP + 1) + 64) * 4 + (MAXP + L + 15) / 16 * 16;
  cudaError_t e = cudaFuncSetAttribute(
      mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();     // the refusal must not fail the next launch
    return (int)e;
  }
  mask_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (const float*)start_d, h, (float*)ck,
      (float*)post);
  return (int)cudaGetLastError();
}
