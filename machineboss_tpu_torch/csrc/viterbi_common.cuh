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
//   dependent steps. A cluster of blocks splits the destination states;
//   each block keeps its columns of the class blocks and the previous
//   diagonals in shared memory, stages the band's bounds and tokens ahead
//   of use, and splits an item's source states over lanes (its own notes).
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

// The cluster's rank of this block, the cluster barrier (release and
// acquire: the blocks' shared and global writes before it are seen after
// it), the shared::cluster address of the same shared offset in block
// `rank` of the cluster, and a store there (distributed shared memory).
// Both fills walk a pair with a cluster of blocks that split the
// destination states; the row kernel (row_scan.cu) with a cluster of
// blocks that split the input positions.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned peer_addr(const float* p, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void peer_store(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
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
