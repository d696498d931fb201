// Ragged-batch wavefront Forward for full-rank transducers, for Hopper
// (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::
// _chained_ragged_kernel. What that kernel adds to the merged one is
// scheduling: a ragged batch is sorted by length and sequences are chained
// back to back inside each lane window, so that no lane idles behind the
// longest pair. Its streamed metadata rows (token, finishing chain, flags
// per lane and diagonal) and the stagger between chains are bookkeeping for
// those lanes and have no counterpart here.
//
// The counterpart on this card is a persistent grid with a work queue: the
// host passes the pairs' indices sorted by descending output length (the
// TPU schedule's order) and a zeroed counter; each block takes the next
// index from the counter with one atomicAdd when its own pair is finished,
// walks that pair (walk_pair() in wavefront_common.cuh, the recurrence of
// the merged kernel from the pair's own diagonal 0) and writes the score to
// the pair's original index. Longest pairs start first, so the tail of the
// run is made of short ones. A block that starts its next pair reuses its
// three diagonal slots without clearing them: walk_pair reads only cells it
// has written for the pair in hand.
//
// What bounds it: as the merged kernel, f32 FMAs (Sa*Sa per class per real
// cell of each pair) against the f32 non-tensor rate.

#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

// four blocks a multiprocessor (at most 64 registers a thread), as the
// launch plan counts them
template <int OPTS>
__global__ void __launch_bounds__(THREADS, 4)
chained_ragged_wavefront_kernel(Args a, const int* __restrict__ order,
                                int* counter) {
  __shared__ WalkShared s_walk;
  __shared__ int s_next;
  for (;;) {
    __syncthreads();              // everyone has read the previous s_next
    if (threadIdx.x == 0) s_next = atomicAdd(counter, 1);
    __syncthreads();
    const int k = s_next;
    if (k >= a.B) break;
    const int b = order[k];
    if (b < 0 || b >= a.B) continue;       // not an index of this batch
    const float v = walk_pair<false, OPTS>(a, b, &s_walk);
    if (threadIdx.x == 0) a.out[b] = v;
  }
}

template <int OPTS>
int launch(const Args& a, int grid, const int* order, int* counter,
           cudaStream_t stream) {
  const size_t smem = (OPTS & WALK_SMEM_SLOTS)
                          ? walk_slot_bytes(a.Li + 1, a.SaP) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      chained_ragged_wavefront_kernel<OPTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chained_ragged_wavefront_kernel<OPTS><<<grid, THREADS, smem, stream>>>(
      a, order, counter);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the persistent kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(). `order` holds the B pair indices, longest first;
// `counter` is one int that the caller has set to 0; `opts` is walk_pair's
// layout (WALK_* bits, wavefront_common.cuh).
extern "C" int chained_ragged_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* wvec, const void* mt,
    void* pbuf, void* mbuf, void* out, const void* order, void* counter,
    int B, int Li, int Lo, int Sa, int SaP, int To, int rescale_every,
    int sink, int n_cls, const int* desc, int grid, int opts, void* stream) {
  Args args;
  if (grid < 1 || !walk_opts_ok(opts, SaP) ||
      !make_args(args, in_toks, out_toks, in_lens, out_lens, c0, wvec, mt,
                 pbuf, mbuf, out, B, Li, Lo, Sa, SaP, To, rescale_every, sink,
                 n_cls, desc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  WALK_DISPATCH(opts, launch, args, grid, (const int*)order, (int*)counter,
                (cudaStream_t)stream);
}
