// Shared device code of the tensor-core wavefront kernels
// (lowrank_wavefront.cu and factored_wavefront.cu), for Hopper (sm_90a):
// the 3xTF32 split, the m16n8k8 TF32 product, the cp.async copies, a warp's
// max and a named barrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

constexpr int FRAG_A = 128;      // floats of one 16x8 A tile, fragment order

// A barrier of `nthr` threads on hardware barrier `id` (1..15; 0 is
// __syncthreads's).
__device__ __forceinline__ void named_bar(int id, int nthr) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthr) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// x = hi + lo: hi is x rounded to TF32 (10 explicit mantissa bits, to
// nearest, ties away from zero: cvt.rna.tf32.f32, done here by an integer
// add and mask), lo = x - hi exactly in f32, of which the tensor core reads
// the TF32 part (it ignores the low 13 bits of a TF32 operand)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on the tensor cores, m16n8k8, TF32 operands, f32 accumulator.
// A fragment: lane g*4 + t holds A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; B: b0 = B[t][g], b1 = B[t+4][g]; D: d0 = D[g][2t],
// d1 = D[g][2t+1], d2/d3 the same of row g + 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32mma
