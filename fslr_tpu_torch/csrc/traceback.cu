// Traceback path walk on Hopper.
//
// The JAX package walks the paths in fslr_tpu/ops/traceback.py:_walk_device,
// a lax.scan of T = Lq + 128 steps over all alignments at once (not a
// Pallas kernel).  Here each alignment is followed from its end cell
// (qend, lane) through the 4-bit codes that tb_kernel (banded.cu) or
// prof_kernel (profile.cu) wrote: in state H the source bits pick diagonal
// (emit M, i - 1), E (enter the query-gap state), F (enter the
// reference-gap state) or stop; in state E every step emits I (i - 1,
// l + 1) and in state F emits D (l - 1), until the consumed cell's extend
// bit says the gap opened there.
//
// Output, written directly in the JAX package's transfer layout:
//   packed (6, N) int32: score, qend, lane, i_fin + 1 (the query begin),
//     l_fin (the lane at the begin), n_ops;
//   emits (N, T / 4) uint8: the emit of step t (0/1/2 = M/I/D, 3 = none)
//     in bits 2 * (t % 4) of byte t / 4, end -> start.
//
// What bounds it: a path is a serial chain of up to T steps, each a read
// of one code word at an address that the step before decides, so a
// word read from device memory puts its latency on every step.  A row
// gets a warp and a block, so that a small launch (~350 rows on the
// consensus run) spreads over the card, and the design takes device
// memory off the chain: the path crosses the word rows (i >> 3, 128
// words = 512 bytes) downward and spends at least 8 steps in each, so the
// warp keeps a ring of RING word rows in shared memory, filled by
// cp.async (16 bytes a lane) RING - 1 rows ahead of the path, and a step
// reads its word from there.  A run of diagonal steps
// in one word (up to 8) is taken in one turn: the next step's code is the
// next lower nibble of the same word.  Every lane runs the state machine
// on the same word (a shared-memory broadcast), so the warp never
// diverges; lane (w % 32) keeps emit word w, and the warp stores 32 of
// them (128 bytes) at once.  After the path ends, the rest of the row's
// emits are filled with "none" by all lanes.  Bytes: the word rows the
// path crosses (512 B each, at most what the DP wrote), the emits and
// the packed scalars.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BW = 128;          // band lanes per word row
constexpr int RING = 8;          // word rows a warp keeps in shared memory

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every group but the newest RING - 1 has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(RING - 1) : "memory");
}

__global__ void __launch_bounds__(32)
walk_kernel(const int* __restrict__ bits, const float* __restrict__ score,
            const int* __restrict__ qend, const int* __restrict__ lane_of,
            int N, int Lq, int* __restrict__ packed,
            uint32_t* __restrict__ emits) {
  __shared__ __align__(16) int ring[RING][BW];
  const int row = blockIdx.x, lane = threadIdx.x;
  const int T = Lq + BW, TW = T / 16;
  const int* b = bits + (size_t)row * (Lq / 8) * BW;
  uint32_t* e = emits + (size_t)row * TW;
  int i = qend[row], l = lane_of[row], st = 0, n_ops = 0;

  // word row r into its slot, one group a row (an empty group below 0)
  auto request = [&](int r) {
    if (r >= 0)
      cp_async16(&ring[r & (RING - 1)][4 * lane],
                 b + (size_t)r * BW + 4 * lane);
    cp_async_commit();
  };
  // the path enters word row r: the slot of row r + 1 takes row
  // r - RING + 1, and row r must have landed
  auto enter = [&](int r) {
    __syncwarp();
    request(r - RING + 1);
    cp_async_wait_ring();
    __syncwarp();
  };
  int cur = min(max(i, 0), Lq - 1) >> 3;
  for (int k = 0; k < RING - 1; ++k) request(cur - k);
  enter(cur);

  // a step's word: one 32-bit shared load at a byte address kept as an
  // integer (the shared window's base is taken once)
  const unsigned ring_base = (unsigned)__cvta_generic_to_shared(&ring[0][0]);
  bool active = true;
  uint32_t word = 0, mine = 0xffffffffu;
  int t = 0;
  while (t < T && active) {
    const int ii = min(max(i, 0), Lq - 1);
    const int ll = min(max(l, 0), BW - 1);
    if ((ii >> 3) != cur) {          // i falls one step at a time
      cur = ii >> 3;
      enter(cur);
    }
    uint32_t w;
    asm volatile("ld.shared.u32 %0, [%1];"
                 : "=r"(w)
                 : "r"(ring_base + (((cur & (RING - 1)) * BW + ll) << 2)));
    const int p = ii & 7;
    const int code = (w >> (4 * p)) & 15;
    const int src = code & 3;
    const bool e_ext = code & 4, f_ext = code & 8;
    uint32_t em = 3;
    int k = 1;                       // steps taken this turn
    if (st == 0 && src == 1) {
      // a diagonal run: the codes of steps ii, ii - 1, .. sit in nibbles
      // p, p - 1, .. of the same word; take every one whose source is the
      // diagonal at once (each emits M, which is 0 in the emit bits)
      const uint32_t x = ((w ^ 0x11111111u) & 0x33333333u) << (4 * (7 - p));
      k = min(min(__clz(x) >> 2, p + 1), T - t);
      k = i == ii ? k : 1;           // a row clamped at Lq - 1 steps singly
      em = 0;
      i -= k;
    } else if (st == 0) {
      if (src == 0)
        active = false;
      else
        st = src == 2 ? 1 : 2;
    } else if (st == 1) {
      em = 1;
      i -= 1;
      l += 1;
      if (!e_ext) st = 0;
    } else {
      em = 2;
      l -= 1;
      if (!f_ext) st = 0;
    }
    n_ops += em != 3 ? k : 0;
    if (i < 0) active = false;
    word |= em << (2 * (t & 15));
    const int tn = t + k;            // k <= 8: at most one word completes
    if ((tn >> 4) != (t >> 4)) {
      const int wi = t >> 4;
      if (lane == (wi & 31)) mine = word;
      word = 0;
      if ((wi & 31) == 31) {         // 32 emit words: one store a lane
        e[wi - 31 + lane] = mine;
        mine = 0xffffffffu;
      }
    }
    t = tn;
  }
  // the path has ended: the partial word is completed with "none", and
  // every later word is "none"
  const int full = t >> 4, stored = full & ~31;
  if (t & 15) {
    if (lane == (full & 31)) mine = word | (0xffffffffu << (2 * (t & 15)));
  }
  for (int w = stored + lane; w < TW; w += 32)
    e[w] = w < stored + 32 ? mine : 0xffffffffu;
  if (lane == 0) {
    packed[row] = (int)score[row];
    packed[N + row] = qend[row];
    packed[2 * N + row] = lane_of[row];
    packed[3 * N + row] = i + 1;
    packed[4 * N + row] = l;
    packed[5 * N + row] = n_ops;
  }
  // no cp.async may still be writing this block's shared memory at exit
  asm volatile("cp.async.wait_all;" ::: "memory");
}

}  // namespace

// bits (N, Lq / 8, 128) int32 from tb_kernel or prof_kernel, 16-byte
// aligned; Lq a multiple of 16, so that a row of emits is a whole number
// of 32-bit words.
extern "C" int fslr_walk(const void* bits, const void* score,
                         const void* qend, const void* lane, int N, int Lq,
                         void* packed, void* emits, void* stream) {
  if (N > 0) {
    walk_kernel<<<N, 32, 0, (cudaStream_t)stream>>>(
        (const int*)bits, (const float*)score, (const int*)qend,
        (const int*)lane, N, Lq, (int*)packed, (uint32_t*)emits);
  }
  return (int)cudaGetLastError();
}
