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

__global__ void __launch_bounds__(THREADS)
merged_wavefront_kernel(Args a) {
  __shared__ int s_bad;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float v = walk_pair(a, b, &s_bad);
    if (threadIdx.x == 0) a.out[b] = v;
  }
}

}  // namespace

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(): nonzero means the launch was refused.
extern "C" int merged_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* wvec, const void* mt,
    void* pbuf, void* mbuf, void* out, int B, int Li, int Lo, int Sa, int SaP,
    int To, int rescale_every, int sink, int n_cls, const int* desc, int grid,
    void* stream) {
  Args args;
  if (grid < 1 ||
      !make_args(args, in_toks, out_toks, in_lens, out_lens, c0, wvec, mt,
                 pbuf, mbuf, out, B, Li, Lo, Sa, SaP, To, rescale_every, sink,
                 n_cls, desc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  merged_wavefront_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
