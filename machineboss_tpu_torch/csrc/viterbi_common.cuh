// Shared device code of the max-plus (Viterbi) wavefront kernels
// (viterbi_wavefront.cu and viterbi_banded_wavefront.cu), for Hopper (sm_90a).
//
// Both kernels fill a value lattice in float32 log space, diagonal by
// diagonal, and write EVERY diagonal to device memory: the lattice is what
// the traceback walks. Per cell (i, o) on diagonal d = i + o and destination
// state s':
//
//   v[s'] = max( NEG_INF,
//                max_s up[y_o][s][s']        + cell(i,   o-1)[s],
//                max_s left[x_i][s][s']      + cell(i-1, o)[s],
//                max_s diag[x_i, y_o][s][s'] + cell(i-1, o-1)[s] )
//
// The max-plus silent closure is folded into the class blocks on the host in
// float64 (maxplus_class_mats, ops/kernels/viterbi_kernel.py). Only float32
// adds and maxes occur, so the result equals the plain PyTorch version and
// the TPU kernel bit for bit.
//
// The two fills differ in what bounds them on this card, and so in design:
//
// - The batched fill (viterbi_wavefront.cu) does S*S add+max per class per
//   cell for a whole batch: operations, and for the 65-state ACGT machine
//   the lattice bytes almost as much. It walks each pair with a cluster of
//   one or two blocks, keeps the previous diagonals in shared-memory slots
//   where they fit (read back from the lattice, they made the first CUDA
//   version half as slow again at S = 132), and groups the cells of a
//   diagonal by token so that each class block is read once per token (its
//   own notes).
// - The banded fill (viterbi_banded_wavefront.cu) walks ONE pair's band, a
//   few dozen cells a diagonal: bound by the latency of its Li + Lo + 1
//   dependent steps. A thread computes 4 neighbouring destination states of
//   one cell with class_max below: per source state one float of the
//   neighbour cell (the same address across the threads of a cell, one
//   broadcast) and one float4 of the cell's own token block, stored
//   source-major and padded to SP = 4 * ceil(S/4) columns, through the
//   read-only cache. It keeps the previous diagonals in three shared slots
//   when its window fits, else reads them back from the lattice.
//
// What the TPU kernels did that neither does: lane-rotated matrix copies and
// their K rolls, one-hot token rows, all-token accumulators with a select
// (a cell here reads only its own token's block), transposed (S, cells)
// slabs, n_chunks, and the banded kernel's (8, 128) meta blocks and static
// roll variants.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace viterbi {

constexpr float NEG_INF = -1e30f;
constexpr int TD = 4;  // destination states per thread

// acc[k] = max(acc[k], max_s blk[s * SP + k] + nbr[s]) for k = 0..3.
// `blk` points at the token block's column group; `nbr` at the neighbour
// cell's S values, in shared memory or in the lattice (written by this block:
// a plain load).
__device__ __forceinline__ void class_max(float4& acc, const float* blk,
                                          const float* nbr, int S, int SP) {
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float v = nbr[s];
    const float4 m =
        __ldg(reinterpret_cast<const float4*>(blk + (size_t)s * SP));
    acc.x = fmaxf(acc.x, m.x + v);
    acc.y = fmaxf(acc.y, m.y + v);
    acc.z = fmaxf(acc.z, m.z + v);
    acc.w = fmaxf(acc.w, m.w + v);
  }
}

__device__ __forceinline__ float4 neg4() {
  return make_float4(NEG_INF, NEG_INF, NEG_INF, NEG_INF);
}

// Column group dg of the (S,) start vector, NEG_INF past S.
__device__ __forceinline__ float4 start4(const float* c0, int dg, int S) {
  float r[TD];
#pragma unroll
  for (int k = 0; k < TD; ++k) {
    const int s = dg * TD + k;
    r[k] = s < S ? c0[s] : NEG_INF;
  }
  return make_float4(r[0], r[1], r[2], r[3]);
}

// Stores column group dg of a cell's S values (rows of S floats are not
// 16-byte aligned, so four scalar stores).
__device__ __forceinline__ void store4(float* cell, int dg, int S, float4 v) {
  const int s = dg * TD;
  if (s < S) cell[s] = v.x;
  if (s + 1 < S) cell[s + 1] = v.y;
  if (s + 2 < S) cell[s + 2] = v.z;
  if (s + 3 < S) cell[s + 3] = v.w;
}

}  // namespace viterbi
