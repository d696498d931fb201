// Envelope-banded max-plus (Viterbi) wavefront fill of ONE pair, for Hopper
// (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/viterbi_kernel.py::
// _viterbi_banded_kernel. The recurrence and the cell update are those of
// viterbi_common.cuh; only the addressing differs. Diagonal d keeps the
// cells i in [base_d, base_d + Wb) at window index w = i - base_d, of which
// [lo_d, hi_d) lie in the band; base_d never falls and rises by at most one
// per diagonal (band_windows on the host). The neighbours of window index w
// are therefore plain index arithmetic on the bases: up (i, o-1) at
// w + (base_d - base_{d-1}) of diagonal d-1, left (i-1, o) one below that,
// diag (i-1, o-1) at w + (base_d - base_{d-2}) - 1 of diagonal d-2; an index
// off the window is a missing neighbour. The TPU kernel selected between
// three static lane rolls by a streamed scalar for the same purpose.
//
// The diagonals depend on each other, so ONE block walks all of them with a
// barrier between two, and writes each (Wb, S) window to the lattice, where
// it stays for the lattice walk. The output is (n_diags, Wb, S). The block
// reads the two previous windows from three rotating slots of shared memory
// (one step is latency, and a shared load is shorter than one from L2). A
// window wider than the slots can hold, 3 * Wb * S floats over 227 KB, is
// read back from the lattice instead: 65 states from a window of 298 cells,
// 132 states from 147 cells.
//
// What bounds it on this card: neither bytes nor operations but the
// Li + Lo + 1 dependent steps of one block; each is a few dozen cells wide.

#include "viterbi_common.cuh"

namespace {

using namespace viterbi;

constexpr int THREADS = 512;
// Largest dynamic shared memory a block may ask for (227 KB on sm_90).
constexpr int MAX_SMEM_BYTES = 232448;

struct Args {
  const int* in_toks;   // (Li,)
  const int* out_toks;  // (Lo,)
  const int* meta;      // (n_diags, 3): lo_d, hi_d, base_d
  const float* c0;      // (S,)
  const float* up;      // (To, S, SP) or null
  const float* left;    // (Ti, S, SP) or null
  const float* diag;    // (Ti * To, S, SP) or null
  float* lat;           // (n_diags, Wb, S)
  int Li, Lo, Wb, S, SP, Ti, To;
  int smem;             // 1: three (Wb, S) diagonal slots in shared memory
};

__global__ void __launch_bounds__(THREADS)
viterbi_banded_wavefront_kernel(Args a) {
  extern __shared__ float s_diag[];
  const int tid = threadIdx.x;
  const int S = a.S, SP = a.SP, Wb = a.Wb;
  const int n_dg = SP / TD;
  const int n_diags = a.Li + a.Lo + 1;
  const int n_items = Wb * n_dg;
  const size_t blk_sz = (size_t)S * SP;
  const size_t slab = (size_t)Wb * S;
  for (int d = 0; d < n_diags; ++d) {
    const int lo = __ldg(a.meta + 3 * d);
    const int hi = __ldg(a.meta + 3 * d + 1);
    const int base = __ldg(a.meta + 3 * d + 2);
    const int s1 = d >= 1 ? base - __ldg(a.meta + 3 * (d - 1) + 2) : 0;
    const int s2 = d >= 2 ? base - __ldg(a.meta + 3 * (d - 2) + 2) : 0;
    float* cur = a.lat + (size_t)d * slab;
    float* s_cur = s_diag + (size_t)(d % 3) * slab;
    const float* p1 = a.smem ? s_diag + (size_t)((d + 2) % 3) * slab
                             : cur - slab;
    const float* p2 = a.smem ? s_diag + (size_t)((d + 1) % 3) * slab
                             : cur - 2 * slab;
    for (int item = tid; item < n_items; item += THREADS) {
      const int w = item / n_dg, dg = item - w * n_dg;
      const int i = base + w, o = d - i;
      float4 acc = neg4();
      if (i >= lo && i < hi && i <= a.Li && o >= 0 && o <= a.Lo) {
        if (d == 0) {
          acc = start4(a.c0, dg, S);
        } else {
          const int x = i >= 1 ? __ldg(a.in_toks + i - 1) : -1;
          const int y = o >= 1 ? __ldg(a.out_toks + o - 1) : -1;
          const bool x_ok = x >= 0 && x < a.Ti;
          const bool y_ok = y >= 0 && y < a.To;
          const int wu = w + s1, wl = w + s1 - 1, wd = w + s2 - 1;
          if (a.up && y_ok && wu >= 0 && wu < Wb)
            class_max(acc, a.up + y * blk_sz + dg * TD, p1 + (size_t)wu * S,
                      S, SP);
          if (a.left && x_ok && wl >= 0 && wl < Wb)
            class_max(acc, a.left + x * blk_sz + dg * TD, p1 + (size_t)wl * S,
                      S, SP);
          if (a.diag && d >= 2 && x_ok && y_ok && wd >= 0 && wd < Wb)
            class_max(acc, a.diag + ((size_t)x * a.To + y) * blk_sz + dg * TD,
                      p2 + (size_t)wd * S, S, SP);
        }
      }
      store4(cur + (size_t)w * S, dg, S, acc);
      if (a.smem) store4(s_cur + (size_t)w * S, dg, S, acc);
    }
    // diagonal d is complete, and visible to the block, before d + 1 reads it
    __syncthreads();
  }
}

}  // namespace

// Launches the kernel on `stream` (one block) and returns cudaGetLastError():
// nonzero means the launch was refused.
extern "C" int viterbi_banded_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* meta,
    const void* c0, const void* up, const void* left, const void* diag,
    void* lat, int Li, int Lo, int Wb, int S, int SP, int Ti, int To,
    void* stream) {
  if (S < 1 || SP < S || SP % viterbi::TD != 0 || Li < 0 || Lo < 0 || Wb < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.meta = (const int*)meta;
  a.c0 = (const float*)c0;
  a.up = (const float*)up;
  a.left = (const float*)left;
  a.diag = (const float*)diag;
  a.lat = (float*)lat;
  a.Li = Li; a.Lo = Lo; a.Wb = Wb; a.S = S; a.SP = SP; a.Ti = Ti; a.To = To;
  const size_t need = (size_t)3 * Wb * S * sizeof(float);
  a.smem = need <= (size_t)MAX_SMEM_BYTES;
  const int bytes = a.smem ? (int)need : 0;
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_banded_wavefront_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  viterbi_banded_wavefront_kernel<<<1, THREADS, bytes, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
