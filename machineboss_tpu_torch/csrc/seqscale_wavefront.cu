// Per-pair-scale wavefront Forward for full-rank transducers, for Hopper
// (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::_seqscale_kernel
// (variant="seqscale"). The host prep is prepare_seqscale
// (ops/kernels/wavefront_kernel.py): the closure folded into every class,
// F[tok] = C^T A[tok]^T, over the full state vector (no sink trim, readout
// at S-1). The carried invariant is value = p * exp(M) with ONE log scale M
// per pair instead of one per cell, so a cell is just
//   cur = sum over classes of F_class[tok] @ p_c
// with no per-neighbour weights (cell_update() in NO_SCALE mode). On
// diagonals with d % rescale_every <= 1 both live diagonals (d and d-1, the
// two the next step reads) are multiplied by the reciprocal of the pair's
// max over their cells and states, and M absorbs the max's log (a factor
// of 1 when that max is 0).
// Between rescales values drift below 1; a cell more than ~87 nats below
// the pair's largest flushes to zero, as on the TPU. The readout at
// (il, ol) is M + log(p[S-1]).
//
// The TPU kernel kept its state as bf16 hi/lo pairs so that the matrix
// unit's bf16x2 operands were pure copies; here the state is plain f32,
// which is at least as precise (24 bits of mantissa against 2 x 8), and the
// products are f32 FMAs. Its per-window max by log2(W) doubling lane rolls
// is a block-wide max here: warp shuffles, then one float per warp in
// shared memory. The max runs over the pair's own cells (i <= il, o <= ol),
// where the TPU's ran over the whole padded window; the scale is a common
// factor, so the scores agree up to rounding.
//
// Design: the merged kernel's walk (one block walks whole pairs, three
// rotating (W, SP) diagonal slots per block; wavefront_common.cuh) with the
// per-cell scale and its rescale pass replaced by the pair's scale. What
// bounds it on this card: f32 FMAs, S*S per present class per cell (a class
// whose folded blocks are all zero is left out: it adds exact zeros),
// against the f32 non-tensor rate; the token blocks are read through L1/L2.

#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

constexpr int NWARP = THREADS / 32;

__device__ float block_max(float v, float* s_red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_max(v);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float r = s_red[0];
  for (int q = 1; q < NWARP; ++q) r = fmaxf(r, s_red[q]);
  __syncthreads();           // s_red is free again
  return r;
}

__device__ float walk_seqscale(const Args& a, int b, int* s_bad,
                               float* s_red) {
  const int tid = threadIdx.x;
  const int W = a.Li + 1;
  const int Sa = a.Sa, SaP = a.SaP;
  const int il = a.in_lens[b];
  const int ol = a.out_lens[b];
  __syncthreads();           // the previous pair's readout is done
  if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) return quiet_nan();
  const int* xt = a.in_toks + (size_t)b * a.Li;
  const int* yt = a.out_toks + (size_t)b * a.Lo;
  float* pb = a.pbuf + (size_t)blockIdx.x * 3 * W * SaP;
  if (tid == 0) *s_bad = 0;

  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  float M = 0.f;             // the pair's log scale, the same in every thread
  __syncthreads();

  const int dfin = il + ol;
  const int n_dg = SaP / TD;
  for (int d = 1; d <= dfin; ++d) {
    const int slot0 = d % 3, slot1 = (d + 2) % 3, slot2 = (d + 1) % 3;
    float* p0 = pb + (size_t)slot0 * W * SaP;
    float* p1 = pb + (size_t)slot1 * W * SaP;
    const float* p2 = pb + (size_t)slot2 * W * SaP;
    const int lo = max(0, d - ol), hi = min(d, il);

    const int n_items = (hi - lo + 1) * n_dg;
    for (int item = tid; item < n_items; item += THREADS) {
      const int c = item / n_dg, dg = item - c * n_dg;
      const int i = lo + c;
      float unused;
      *reinterpret_cast<float4*>(p0 + (size_t)i * SaP + dg * TD) =
          cell_update<NO_SCALE>(a, Cell{i, d - i, xt, yt, s_bad}, dg, p1, p2,
                                nullptr, nullptr, unused);
    }
    __syncthreads();

    if (d % a.rescale_every <= 1) {
      // the live cells of diagonals d (rows lo..hi) and d-1 (lo1..hi1)
      const int lo1 = max(0, d - 1 - ol), hi1 = min(d - 1, il);
      const int n0 = (hi - lo + 1) * SaP, n1 = (hi1 - lo1 + 1) * SaP;
      float* q0 = p0 + (size_t)lo * SaP;
      float* q1 = p1 + (size_t)lo1 * SaP;
      float mx = 0.f;
      for (int e = tid; e < n0; e += THREADS) mx = fmaxf(mx, q0[e]);
      for (int e = tid; e < n1; e += THREADS) mx = fmaxf(mx, q1[e]);
      mx = block_max(mx, s_red);
      // as the TPU kernel: one reciprocal, then a multiply per value
      const float f = mx > 0.f ? mx : 1.f, inv = 1.f / f;
      for (int e = tid; e < n0; e += THREADS) q0[e] *= inv;
      for (int e = tid; e < n1; e += THREADS) q1[e] *= inv;
      M += logf(f);
      __syncthreads();
    }
  }

  float v = NEG_INF;
  if (tid == 0) {
    const float e = pb[((size_t)(dfin % 3) * W + il) * SaP + Sa - 1];
    v = e > 0.f ? M + logf(fmaxf(e, 1e-37f)) : NEG_INF;
    if (*s_bad) v = quiet_nan();                           // bad token
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
seqscale_wavefront_kernel(Args a) {
  __shared__ int s_bad;
  __shared__ float s_red[NWARP];
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float v = walk_seqscale(a, b, &s_bad, s_red);
    if (threadIdx.x == 0) a.out[b] = v;
  }
}

}  // namespace

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(). The operands are prepare_seqscale's, packed as the
// merged kernel's (source-major (SP, SP) blocks, one descriptor per class).
extern "C" int seqscale_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* mt, void* pbuf,
    void* out, int B, int Li, int Lo, int S, int SP, int To,
    int rescale_every, int n_cls, const int* desc, int grid, void* stream) {
  Args args;
  if (grid < 1 ||
      !make_args(args, in_toks, out_toks, in_lens, out_lens, c0, nullptr,
                 mt, pbuf, nullptr, out, B, Li, Lo, S, SP, To, rescale_every,
                 0, n_cls, desc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  seqscale_wavefront_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
