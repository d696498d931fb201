// Batched max-plus (Viterbi) wavefront fill, for Hopper (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/viterbi_kernel.py::_viterbi_kernel.
// The recurrence and the design are described in viterbi_common.cuh. Blocks
// of a CUDA grid run in no order and share nothing, so a block owns whole
// pairs and loops over their diagonals itself, where the TPU kernel stepped
// one sequential grid over the diagonals of all pairs at once. The output is
// written as (n_diags, B, W, S), W = Li + 1, which is the layout the lattice
// walk and lattice_from_diagonals read: no transpose afterwards. A cell
// beyond its pair's (in_len, out_len) lattice is written as NEG_INF and costs
// nothing else. The two previous diagonals are read back from the lattice,
// which this block has just written (they come from L2); a copy of them in
// shared memory was measured and took nothing off this kernel's time, so
// there is none.
//
// What bounds it on this card: the lattice bytes. Every cell's S floats are
// written once (n_diags * B * W * S * 4 bytes); the arithmetic is S*S add+max
// per class per real cell on the f32 pipes. For the 65-state ACGT machine
// the two bounds are close; for wider machines operations lead.

#include "viterbi_common.cuh"

namespace {

using namespace viterbi;

constexpr int THREADS = 512;

struct Args {
  const int* in_toks;   // (B, Li)
  const int* out_toks;  // (B, Lo)
  const int* in_lens;   // (B,)
  const int* out_lens;  // (B,)
  const float* c0;      // (S,)
  const float* up;      // (To, S, SP) or null
  const float* left;    // (Ti, S, SP) or null
  const float* diag;    // (Ti * To, S, SP) or null
  float* lat;           // (n_diags, B, W, S)
  int B, Li, Lo, S, SP, Ti, To;
};

__global__ void __launch_bounds__(THREADS) viterbi_wavefront_kernel(Args a) {
  const int tid = threadIdx.x;
  const int W = a.Li + 1;
  const int S = a.S, SP = a.SP;
  const int n_dg = SP / TD;
  const int n_diags = a.Li + a.Lo + 1;
  const int n_items = W * n_dg;
  const size_t blk_sz = (size_t)S * SP;
  const size_t slab = (size_t)a.B * W * S;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const int il = min(max(a.in_lens[b], 0), a.Li);
    const int ol = min(max(a.out_lens[b], 0), a.Lo);
    const int* xt = a.in_toks + (size_t)b * a.Li;
    const int* yt = a.out_toks + (size_t)b * a.Lo;
    float* pair = a.lat + (size_t)b * W * S;
    for (int d = 0; d < n_diags; ++d) {
      float* cur = pair + (size_t)d * slab;
      // the two diagonals before, as this block wrote them to the lattice
      const float* p1 = cur - slab;
      const float* p2 = cur - 2 * slab;
      for (int item = tid; item < n_items; item += THREADS) {
        const int i = item / n_dg, dg = item - i * n_dg;
        const int o = d - i;
        float4 acc = neg4();
        if (i <= il && o >= 0 && o <= ol) {
          if (d == 0) {
            acc = start4(a.c0, dg, S);
          } else {
            const int x = i >= 1 ? __ldg(xt + i - 1) : -1;
            const int y = o >= 1 ? __ldg(yt + o - 1) : -1;
            const bool x_ok = x >= 0 && x < a.Ti;
            const bool y_ok = y >= 0 && y < a.To;
            if (a.up && y_ok)
              class_max(acc, a.up + y * blk_sz + dg * TD,
                        p1 + (size_t)i * S, S, SP);
            if (a.left && x_ok)
              class_max(acc, a.left + x * blk_sz + dg * TD,
                        p1 + (size_t)(i - 1) * S, S, SP);
            if (a.diag && x_ok && y_ok)
              class_max(acc, a.diag + ((size_t)x * a.To + y) * blk_sz + dg * TD,
                        p2 + (size_t)(i - 1) * S, S, SP);
          }
        }
        store4(cur + (size_t)i * S, dg, S, acc);
      }
      // diagonal d is complete, and visible to the block, before d + 1
      // reads it
      __syncthreads();
    }
  }
}

}  // namespace

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(): nonzero means the launch was refused.
extern "C" int viterbi_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* up, const void* left,
    const void* diag, void* lat, int B, int Li, int Lo, int S, int SP, int Ti,
    int To, int grid, void* stream) {
  if (grid < 1 || S < 1 || SP < S || SP % viterbi::TD != 0 || Li < 0 || Lo < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.in_lens = (const int*)in_lens;
  a.out_lens = (const int*)out_lens;
  a.c0 = (const float*)c0;
  a.up = (const float*)up;
  a.left = (const float*)left;
  a.diag = (const float*)diag;
  a.lat = (float*)lat;
  a.B = B; a.Li = Li; a.Lo = Lo; a.S = S; a.SP = SP; a.Ti = Ti; a.To = To;
  viterbi_wavefront_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
