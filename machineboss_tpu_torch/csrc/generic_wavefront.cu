// Generic (unmerged) wavefront Forward for full-rank transducers, for Hopper
// (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::_wavefront_kernel,
// the factory's default (merged=False, no variant). The host prep is
// prepare_generic (ops/kernels/wavefront_kernel.py): the class tensors as
// they are, NOT closure-folded, and the closure's transpose C^T; no sink
// trim (all S states, readout at S-1). Per cell (i, o) of a pair, diagonal
// d = i + o:
//   * mu = max of the log scales of ALL THREE neighbours in the lattice
//     (up (i, o-1), left (i-1, o), diag (i-1, o-1)), whichever classes the
//     machine has;
//   * u = sum over classes of exp(m_c - mu) * (A_c[tok]^T p_c);
//   * cur = C^T u, the closure as its own product per cell;
//   * EVERY diagonal: cur is divided by its max over states and m = mu +
//     log(max); a cell whose max is not positive is zeroed (m = NEG_INF);
//   * readout at (il, ol): m + log(p[S-1]), NEG_INF where the cell's max was
//     not positive.
// The start cell (0, 0) holds C[0, :] with m = 0, unnormalised.
//
// Design: the merged kernel's walk (one block walks whole pairs, block g
// pairs g, g + gridDim.x, ...; three rotating (W, SP) diagonal slots per
// block in a global scratch, SP = round_up(S, 4)) with two product phases
// per diagonal: cell_update() in MU_ALL mode writes u into a fourth (W, SP)
// slot, a barrier, then each thread takes C^T u for its cell's 4 destination
// states. A thread reads only its own cell's token block; the TPU kernel's
// products of every cell with every token's block, and its one-hot
// selection, are not carried over, and neither are the 3-pass bf16 products
// (plain f32 FMAs). A class whose tensor is all zero is left out of the
// products (it adds exact zeros) but its neighbour still enters mu. The TPU
// kernel miscompiled at L >= 200 on one runtime (dispatch.py); this one has
// no such limit.
//
// What bounds it on this card: f32 FMAs, S*S per present class per cell
// with its neighbour in the lattice plus S*S for the closure, against the
// f32 non-tensor rate; as in the merged kernel the token blocks are read
// through L1/L2 and that traffic limits it first. Three barriers per
// diagonal (products, closure, rescale).

#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

__device__ float walk_generic(const Args& a, const float* __restrict__ ct,
                              float* ubuf, int b, int* s_bad) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.Li + 1;
  const int Sa = a.Sa, SaP = a.SaP;
  const int il = a.in_lens[b];
  const int ol = a.out_lens[b];
  __syncthreads();           // the previous pair's readout is done
  if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) return quiet_nan();
  const int* xt = a.in_toks + (size_t)b * a.Li;
  const int* yt = a.out_toks + (size_t)b * a.Lo;
  float* pb = a.pbuf + (size_t)blockIdx.x * 3 * W * SaP;
  float* mb = a.mbuf + (size_t)blockIdx.x * 3 * W;
  float* ub = ubuf + (size_t)blockIdx.x * W * SaP;
  if (tid == 0) *s_bad = 0;

  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  if (tid == 0) mb[0] = 0.f;
  __syncthreads();

  const int dfin = il + ol;
  const int n_dg = SaP / TD;
  for (int d = 1; d <= dfin; ++d) {
    const int slot0 = d % 3, slot1 = (d + 2) % 3, slot2 = (d + 1) % 3;
    float* p0 = pb + (size_t)slot0 * W * SaP;
    const float* p1 = pb + (size_t)slot1 * W * SaP;
    const float* p2 = pb + (size_t)slot2 * W * SaP;
    float* m0 = mb + slot0 * W;
    const float* m1 = mb + slot1 * W;
    const float* m2 = mb + slot2 * W;
    const int lo = max(0, d - ol), hi = min(d, il);
    const int n_items = (hi - lo + 1) * n_dg;

    // u: the weighted class terms, before the closure
    for (int item = tid; item < n_items; item += THREADS) {
      const int c = item / n_dg, dg = item - c * n_dg;
      const int i = lo + c;
      float mu;
      const float4 u = cell_update<MU_ALL>(
          a, Cell{i, d - i, xt, yt, s_bad}, dg, p1, p2, m1, m2, mu);
      *reinterpret_cast<float4*>(ub + (size_t)i * SaP + dg * TD) = u;
      if (dg == 0) m0[i] = mu;
    }
    __syncthreads();

    // cur = C^T u
    for (int item = tid; item < n_items; item += THREADS) {
      const int c = item / n_dg, dg = item - c * n_dg;
      const int i = lo + c;
      *reinterpret_cast<float4*>(p0 + (size_t)i * SaP + dg * TD) =
          block_dot(ub + (size_t)i * SaP, ct + dg * TD, SaP);
    }
    __syncthreads();

    // rescale on every diagonal
    for (int i = lo + warp; i <= hi; i += THREADS / 32)
      rescale_cell(p0 + (size_t)i * SaP, m0 + i, Sa, lane);
    __syncthreads();
  }

  float v = NEG_INF;
  if (tid < 32) {
    const int slot = dfin % 3;
    v = readout_warp(pb + ((size_t)slot * W + il) * SaP, mb[slot * W + il],
                     a.wvec, Sa, 0, tid);
    if (*s_bad) v = quiet_nan();                           // bad token
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
generic_wavefront_kernel(Args a, const float* __restrict__ ct, float* ubuf) {
  __shared__ int s_bad;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float v = walk_generic(a, ct, ubuf, b, &s_bad);
    if (threadIdx.x == 0) a.out[b] = v;
  }
}

}  // namespace

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(). `ct` is C^T source-major, (SP, SP) zero padded;
// `ubuf` holds grid * (Li + 1) * SP floats.
extern "C" int generic_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* mt, const void* ct,
    void* pbuf, void* mbuf, void* ubuf, void* out, int B, int Li, int Lo,
    int S, int SP, int To, int n_cls, const int* desc, int grid,
    void* stream) {
  Args args;
  if (grid < 1 ||
      !make_args(args, in_toks, out_toks, in_lens, out_lens, c0, nullptr,
                 mt, pbuf, mbuf, out, B, Li, Lo, S, SP, To, 1, 0, n_cls,
                 desc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  generic_wavefront_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      args, (const float*)ct, (float*)ubuf);
  return (int)cudaGetLastError();
}
