// Traceback path walk on Hopper.
//
// The JAX package walks the paths in fslr_tpu/ops/traceback.py:_walk_device,
// a lax.scan of T = Lq + 128 steps over all alignments at once (not a
// Pallas kernel).  Here one thread follows one alignment from its end cell
// (qend, lane) through the 4-bit codes that tb_kernel (banded.cu) wrote:
// in state H the source bits pick diagonal (emit M, i - 1), E (enter the
// query-gap state), F (enter the reference-gap state) or stop; in state E
// every step emits I (i - 1, l + 1) and in state F emits D (l - 1), until
// the consumed cell's extend bit says the gap opened there.
//
// Output, written directly in the JAX package's transfer layout:
//   packed (6, N) int32: score, qend, lane, i_fin + 1 (the query begin),
//     l_fin (the lane at the begin), n_ops;
//   emits (N, T / 4) uint8: the emit of step t (0/1/2 = M/I/D, 3 = none)
//     in bits 2 * (t % 4) of byte t / 4, end -> start.
//
// What bounds it: T dependent steps per thread, each one 4-byte load from
// the row's codes at a data-dependent address, so the walk is bound by
// load latency, not by bytes.  One thread per row keeps the step loop free
// of any cross-thread traffic; emits are gathered 16 to a register and
// stored as one word, and a thread whose path has ended fills the rest of
// its row without reading the codes again.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BW = 128;          // band lanes per word row
constexpr int THREADS = 128;

__global__ void walk_kernel(const int* __restrict__ bits,
                            const float* __restrict__ score,
                            const int* __restrict__ qend,
                            const int* __restrict__ lane, int N, int Lq,
                            int* __restrict__ packed,
                            uint32_t* __restrict__ emits) {
  int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;
  int T = Lq + BW;
  const int* b = bits + (size_t)row * (Lq / 8) * BW;
  uint32_t* e = emits + (size_t)row * (T / 16);
  int i = qend[row], l = lane[row], st = 0, n_ops = 0;
  bool active = true;
  uint32_t word = 0;
  int t = 0;
  for (; t < T && active; ++t) {
    int ii = min(max(i, 0), Lq - 1);
    int ll = min(max(l, 0), BW - 1);
    int code = (b[(ii >> 3) * BW + ll] >> ((ii & 7) * 4)) & 15;
    int src = code & 3;
    bool e_ext = code & 4, f_ext = code & 8;
    uint32_t em = 3;
    if (st == 0) {
      if (src == 0) {
        active = false;
      } else if (src == 1) {
        em = 0;
        i -= 1;
      } else {
        st = src == 2 ? 1 : 2;
      }
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
    n_ops += em != 3;
    if (i < 0) active = false;
    word |= em << (2 * (t & 15));
    if ((t & 15) == 15) {
      e[t >> 4] = word;
      word = 0;
    }
  }
  // the path has ended: every later step emits none
  if (t & 15) {
    e[t >> 4] = word | (0xffffffffu << (2 * (t & 15)));
    t = (t | 15) + 1;
  }
  for (; t < T; t += 16) e[t >> 4] = 0xffffffffu;
  packed[row] = (int)score[row];
  packed[N + row] = qend[row];
  packed[2 * N + row] = lane[row];
  packed[3 * N + row] = i + 1;
  packed[4 * N + row] = l;
  packed[5 * N + row] = n_ops;
}

}  // namespace

// bits (N, Lq / 8, 128) int32 from tb_kernel; Lq a multiple of 16, so
// that a row of emits is a whole number of 32-bit words.
extern "C" int fslr_walk(const void* bits, const void* score,
                         const void* qend, const void* lane, int N, int Lq,
                         void* packed, void* emits, void* stream) {
  if (N > 0) {
    int grid = (N + THREADS - 1) / THREADS;
    walk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)bits, (const float*)score, (const int*)qend,
        (const int*)lane, N, Lq, (int*)packed, (uint32_t*)emits);
  }
  return (int)cudaGetLastError();
}
