// Merged wavefront Forward for full-rank transducers, for Hopper (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::_merged_kernel.
// The recurrence, what bounds it on this card and what the design does
// about it are described in wavefront_common.cuh: walk_pair() walks one
// pair's lattice with a whole block. Blocks of a CUDA grid run in no order
// and share nothing, so a block owns whole pairs and loops over their
// diagonals itself, where the TPU kernel stepped one sequential grid over
// the diagonals of all pairs at once. Block g walks pairs g, g + gridDim.x,
// ... and walks only the il + ol diagonals of each, so the padding the batch
// API adds costs nothing.

#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

// four blocks a multiprocessor (at most 64 registers a thread), as the
// launch plan counts them
template <int OPTS>
__global__ void __launch_bounds__(THREADS, 4)
merged_wavefront_kernel(Args a) {
  __shared__ WalkShared s_walk;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float v = walk_pair<false, OPTS>(a, b, &s_walk);
    if (threadIdx.x == 0) a.out[b] = v;
  }
}

template <int OPTS>
int launch(const Args& a, int grid, cudaStream_t stream) {
  const size_t smem = (OPTS & WALK_SMEM_SLOTS)
                          ? walk_slot_bytes(a.Li + 1, a.SaP) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      merged_wavefront_kernel<OPTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  merged_wavefront_kernel<OPTS><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(): nonzero means the launch was refused. `opts` is
// walk_pair's layout (WALK_* bits, wavefront_common.cuh).
extern "C" int merged_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* wvec, const void* mt,
    void* pbuf, void* mbuf, void* out, int B, int Li, int Lo, int Sa, int SaP,
    int To, int rescale_every, int sink, int n_cls, const int* desc, int grid,
    int opts, void* stream) {
  Args args;
  if (grid < 1 || !walk_opts_ok(opts, SaP) ||
      !make_args(args, in_toks, out_toks, in_lens, out_lens, c0, wvec, mt,
                 pbuf, mbuf, out, B, Li, Lo, Sa, SaP, To, rescale_every, sink,
                 n_cls, desc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  WALK_DISPATCH(opts, launch, args, grid, (cudaStream_t)stream);
}
