// Chained wavefront Forward for full-rank transducers over uniform-length
// batches, for Hopper (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::_chained_kernel:
// the merged recurrence (closure folded into each class, sink states
// trimmed; wavefront_common.cuh) over `n_chain` equal-length pairs per lane
// window, staggered by sigma = Lo + 2 diagonals. The lengths are ignored:
// every pair is read out at (Li, Lo). The rescale fires on the ABSOLUTE step
// t, t % rescale_every <= 1, so a chain that starts on an odd step still has
// both parities renormalised; a chain's start cell takes the rescale of its
// step too. Pair n = k * (B / n_chain) + w is chain k of strip w.
//
// Design: one block per strip (strip.cuh), 512 threads. Each step is the
// merged kernel's diagonal step over the strip's live columns, one thread per
// (column, 4 destination states) through cell_update(), with each column's
// tokens taken from the pair its chain holds at that step; chain k's start
// cell (0, 0) is reseeded with the closure row c0 and m = 0. Where the TPU
// kernel gained lane occupancy (a square lattice's diagonals ramp up and
// down, so a rectangular slab is half idle), the CUDA kernels already compute
// only live cells; what chaining changes here is the schedule: one barrier
// per absolute step and sigma steps per pair instead of Li + Lo + 1, wider
// steps, and B / n_chain blocks instead of one per pair. A token outside its
// alphabet sets the pair's flag in `bad` (zeroed by the caller) and the pair
// comes back NaN.
//
// What bounds it on this card: as the merged kernel, f32 FMAs (Sa*Sa per
// present class per cell) against the f32 non-tensor rate; with few strips
// (B / n_chain blocks on 132 multiprocessors) it is also short of blocks.
// TPU tricks dropped: the per-lane (f, k) scratch and the streamed token rows
// (a thread computes its column's chain and token from t), the in-kernel
// one-hot masks, the unified left block, the bf16 hi/lo passes.

#include "strip.cuh"
#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

constexpr int CT = 512;      // threads per block

__global__ void __launch_bounds__(CT)
chained_wavefront_kernel(Args a, strip::Strip st, int* bad) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w = blockIdx.x;
  const int W = a.Li + 1;
  const int Sa = a.Sa, SaP = a.SaP;
  const int n_dg = SaP / TD;
  float* pb = a.pbuf + (size_t)w * 3 * W * SaP;
  float* mb = a.mbuf + (size_t)w * 3 * W;

  // t = 0: chain 0's cell (0, 0), p = c0, m = 0
  for (int s = tid; s < SaP; s += CT) pb[s] = a.c0[s];
  if (tid == 0) mb[0] = 0.f;
  __syncthreads();

  const int n_steps = strip::steps(st);
  for (int t = 1; t < n_steps; ++t) {
    const int slot0 = t % 3, slot1 = (t + 2) % 3, slot2 = (t + 1) % 3;
    float* p0 = pb + (size_t)slot0 * W * SaP;
    const float* p1 = pb + (size_t)slot1 * W * SaP;
    const float* p2 = pb + (size_t)slot2 * W * SaP;
    float* m0 = mb + slot0 * W;
    const float* m1 = mb + slot1 * W;
    const float* m2 = mb + slot2 * W;
    const int lo = strip::col_lo(st, t), hi = strip::col_hi(st, t);

    const int n_items = (hi - lo + 1) * n_dg;
    for (int item = tid; item < n_items; item += CT) {
      const int c = item / n_dg, dg = item - c * n_dg;
      const int i = lo + c;
      int k, o;
      if (!strip::cell(st, t, i, k, o)) continue;      // never read
      const int n = strip::pair(st, k, w);
      float4 v;
      float mu;
      if (i == 0 && o == 0) {                          // chain k starts
        v = *reinterpret_cast<const float4*>(a.c0 + dg * TD);
        mu = 0.f;
      } else {
        v = cell_update(
            a, Cell{i, o, a.in_toks + (size_t)n * a.Li,
                    a.out_toks + (size_t)n * a.Lo, bad + n},
            dg, p1, p2, m1, m2, mu);
      }
      *reinterpret_cast<float4*>(p0 + (size_t)i * SaP + dg * TD) = v;
      if (dg == 0) m0[i] = mu;
    }
    __syncthreads();

    if (t % a.rescale_every <= 1) {
      for (int i = lo + warp; i <= hi; i += CT / 32) {
        int k, o;
        if (strip::cell(st, t, i, k, o))
          rescale_cell(p0 + (size_t)i * SaP, m0 + i, Sa, lane);
      }
      __syncthreads();
    }

    // chain k's readout cell (Li, Lo) is on this step; its slot is next
    // written three steps on, after two more barriers
    const int k = strip::readout_chain(st, t);
    if (k >= 0 && warp == 0) {
      const int n = strip::pair(st, k, w);
      float v = readout_warp(p0 + (size_t)a.Li * SaP, m0[a.Li], a.wvec, Sa,
                             a.sink, lane);
      if (lane == 0) a.out[n] = bad[n] ? quiet_nan() : v;
    }
  }
}

}  // namespace

// Launches the kernel on `stream`, one block per strip of n_chain pairs, and
// returns cudaGetLastError(): nonzero means the launch was refused. `bad`
// holds B ints that the caller has set to 0.
extern "C" int chained_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* c0,
    const void* wvec, const void* mt, void* pbuf, void* mbuf, void* out,
    void* bad, int B, int Li, int Lo, int Sa, int SaP, int To,
    int rescale_every, int sink, int n_cls, const int* desc, int n_chain,
    void* stream) {
  Args args;
  strip::Strip st;
  if (!strip::make_strip(st, B, Li, Lo, n_chain) ||
      !make_args(args, in_toks, out_toks, nullptr, nullptr, c0, wvec, mt,
                 pbuf, mbuf, out, B, Li, Lo, Sa, SaP, To, rescale_every, sink,
                 n_cls, desc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  chained_wavefront_kernel<<<st.n_strips, CT, 0, (cudaStream_t)stream>>>(
      args, st, (int*)bad);
  return (int)cudaGetLastError();
}
