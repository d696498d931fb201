// Chained wavefront Forward for full-rank transducers over uniform-length
// batches, for Hopper (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::_chained_kernel:
// the merged recurrence (closure folded into each class, sink states
// trimmed; wavefront_common.cuh) over `n_chain` equal-length pairs per lane
// window, staggered by sigma = Lo + 2 diagonals. The lengths are ignored:
// every pair is walked and read out at (Li, Lo). Pair n is chain
// k = n / (B / n_chain), which starts on the absolute step off = sigma * k;
// its diagonal d is step d + off, and the rescale fires on the absolute
// step, (d + off) % rescale_every <= 1, so a chain that starts on an odd
// step still has both parities renormalised; a chain's start cell takes the
// rescale of its step too (off > 0 and off % rescale_every <= 1). A token
// outside its alphabet makes the pair NaN.
//
// Design: the merged kernel's per-pair walk. Block g walks pairs g,
// g + gridDim.x, ... through walk_pair<true>() with the pair's offset, so
// the chain changes only which diagonals rescale and the start cell's
// rescale; the cells, their order of operations and the steps are those of
// the strip schedule this kernel had first, and the scores are bit-equal to
// it. That schedule (one block of 512 threads per strip of n_chain pairs,
// sigma (n_chain - 1) + Li + Lo + 1 dependent steps with one or two block
// barriers each) bought lane occupancy on the TPU; here it left B / n_chain
// blocks for 132 multiprocessors (64 at B = 512, chain 8) and a time that
// grew with the chain. A block per pair, up to four a multiprocessor, runs
// as merged does whatever the chain.
//
// What bounds it on this card: as the merged kernel, f32 FMAs (Sa*Sa per
// present class per reachable cell) against the f32 non-tensor rate; on a
// diag-only machine the walk over the zero cells. TPU tricks dropped: the
// per-lane (f, k) scratch and the streamed token rows, the in-kernel
// one-hot masks, the unified left block, the bf16 hi/lo passes.

#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

// four blocks a multiprocessor (at most 64 registers a thread): a batch of
// up to 4 x 132 pairs runs in one wave
template <int OPTS>
__global__ void __launch_bounds__(THREADS, 4)
chained_wavefront_kernel(Args a, int n_chain) {
  __shared__ WalkShared s_walk;
  const int per_chain = a.B / n_chain;
  const int sigma = a.Lo + 2;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float v = walk_pair<true, OPTS>(a, b, &s_walk,
                                          sigma * (b / per_chain));
    if (threadIdx.x == 0) a.out[b] = v;
  }
}

template <int OPTS>
int launch(const Args& a, int grid, int n_chain, cudaStream_t stream) {
  const size_t smem = (OPTS & WALK_SMEM_SLOTS)
                          ? walk_slot_bytes(a.Li + 1, a.SaP) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      chained_wavefront_kernel<OPTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chained_wavefront_kernel<OPTS><<<grid, THREADS, smem, stream>>>(a,
                                                                  n_chain);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(): nonzero means the launch was refused. B must be a
// multiple of n_chain, Li and Lo at least 1; `opts` is walk_pair's layout
// (WALK_* bits, wavefront_common.cuh).
extern "C" int chained_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* c0,
    const void* wvec, const void* mt, void* pbuf, void* mbuf, void* out,
    int B, int Li, int Lo, int Sa, int SaP, int To, int rescale_every,
    int sink, int n_cls, const int* desc, int n_chain, int grid, int opts,
    void* stream) {
  Args args;
  if (grid < 1 || n_chain < 1 || B % n_chain != 0 || Li < 1 || Lo < 1 ||
      !walk_opts_ok(opts, SaP) ||
      !make_args(args, in_toks, out_toks, nullptr, nullptr, c0, wvec, mt,
                 pbuf, mbuf, out, B, Li, Lo, Sa, SaP, To, rescale_every, sink,
                 n_cls, desc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  WALK_DISPATCH(opts, launch, args, grid, n_chain, (cudaStream_t)stream);
}
