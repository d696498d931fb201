// The sparse engine's token walks, for Hopper (sm_90a).
//
// Replaces the jitted sparse walks of machineboss_tpu/ops/sparse.py (no
// pallas_call: each is one @jax.jit program that XLA unrolls over every
// cell): forward_2d_sparse (:89-133), forward_1d_sparse (:168-190),
// backward_1d_sparse (:208-226) and backward_2d_sparse (:228-266), whose
// max-plus form is viterbi_2d_sparse (:269). One launch walks a batch of
// pairs, one block (or a cluster of blocks) a pair at a time, each taking
// the next pair when it is done, cell by cell in the order of the port's
// eager walk (ops/sparse.py, _diagonals and _walk):
//
//   pre(i,o)[t]  = (+) over the edges s -> t of the classes
//                  (x_i, y_o) from cell (i-1,o-1), (x_i, 0) from (i-1,o)
//                  and (0, y_o) from (i,o-1):  cell[s] (x) w
//   cell(i,o)[u] = (+) over the closure's edges t -> u:  pre[t] (x) w
//
// with pre(0,0) the start state's one-hot; (+) is logsumexp or max, (x)
// the sum. A missing neighbour's values are NEG_INF (the eager walk's
// NEG_INF ring row), a token outside the alphabet takes the empty class.
// Backward is the same walk over the reversed tokens with every edge
// traversed dst -> src, from the end state S-1 to state 0; the caller
// hands over the tables of that direction and the two states.
//
// What bounds it on this card: the dependence between cells, as in the
// row kernel. A pair is Li + Lo + 1 dependent diagonals, each a gather, a
// reduction per state and a barrier twice; the arithmetic is small
// (prot2dna: some 220 terms a cell; a 128-node Plan7 generator's cell
// 34,056 closure terms, a 512-node one's 529,416), so the latency of a
// diagonal's two stages, not the card's rates, sets the pace.
//
// Design (the launch plan is ops/kernels/sparse_kernel.py::
// sparse_launch_plan):
//  * CSR lists keyed by the scatter side: for every (class, state t) and
//    for the closure's every state t the entries (gather state, weight)
//    whose terms reduce into t, so a state's result is one reduction with
//    no atomics, and a destination's terms are summed in a fixed order:
//    the same bits run to run.
//  * Two stages a diagonal over the (cell, state) items of the diagonal,
//    a group of G lanes an item (G a power of two up to 32, by the mean
//    list length: one lane for prot2dna's short lists, a warp for a
//    Plan7 closure's); each lane walks every G-th entry, the group
//    combines by a shuffle tree. logsumexp copies segment_logsumexp: the
//    max, guarded to 0 at or below NEG_INF / 2, then log(sum exp(v - m))
//    + m, NEG_INF where the sum is 0; max-plus the max (-inf for a state
//    with no entry, as segment_max), so it equals the eager walk bit for
//    bit.
//  * The ring of the last three diagonals and the pre-closure diagonal
//    (4 W S values, W = min(Li, Lo) + 1) in shared memory where one block
//    walks a pair and they fit (a block a pair launched), else in global
//    scratch, one ring for each cluster launched: then the grid is the
//    clusters the card holds at once (or fewer, where the device memory
//    holds fewer rings), cluster g walking pairs g, g + grid, ..., so a
//    batch's scratch does not grow with its pairs. A cluster of up to 16 blocks splits each stage's items
//    while the batch leaves multiprocessors idle (the 1D forms' diagonal
//    is one cell and the whole closure), with the ring in global memory
//    and a cluster barrier after each stage: each item is a chain of
//    dependent loads (token, class, list offsets, entries, source
//    values), so the items a thread takes a diagonal, not the terms, set
//    the time. The tables are read from global memory (through L1/L2).
//  * One template a dtype (float, double) and semiring.

#include <cuda_runtime.h>
#include <stdint.h>

#include "viterbi_common.cuh"   // the cluster helpers

namespace {

using viterbi::cluster_rank;
using viterbi::cluster_sync;

constexpr int THREADS = 512;

struct Params {
  const int* seq;        // (B, 2 + Li + Lo): in_len, out_len, in, out tokens
  const int* ints;       // eoff | coff | cls | eidx | cidx
  const void* weights;   // ew | cw, the dtype's values
  void* out;             // (B,)
  void* ring;            // (grid, 4, W, S) when the ring is global
  int o_coff, o_cls, o_eidx, o_cidx, o_cw;
  int n_cls, n_in, n_out;
  int B, Li, Lo, S, W;
  int csize, grid, ga, gb, ring_shared;
  int start, read, reverse;
};

template <typename T>
struct Num;
template <>
struct Num<float> {
  __device__ static float neg() { return -1e30f; }
  __device__ static float half() { return -5e29f; }
  __device__ static float ninf() { return __int_as_float(0xff800000); }
  __device__ static float ex(float x) { return expf(x); }
  __device__ static float lg(float x) { return logf(x); }
  __device__ static float mx(float a, float b) { return fmaxf(a, b); }
};
template <>
struct Num<double> {
  __device__ static double neg() { return -1e30; }
  __device__ static double half() { return -5e29; }
  __device__ static double ninf() {
    return __longlong_as_double((long long)0xfff0000000000000ULL);
  }
  __device__ static double ex(double x) { return exp(x); }
  __device__ static double lg(double x) { return log(x); }
  __device__ static double mx(double a, double b) { return fmax(a, b); }
};

// One list of a state's terms: entries [a, b), their gather states read
// from src (null: a missing neighbour, every value NEG_INF).
template <typename T>
struct List {
  int a, b;
  const T* src;
};

// The terms of one state from NL lists, over the G lanes of its group
// (lane `sub`): the group's max by a shuffle tree; max-plus returns it,
// logsumexp takes the exp-sum against the guarded max in a second pass.
// Every lane of the warp calls it (a lane without an item with empty
// lists); every lane of a group gets the group's result.
template <typename T, bool MAXPLUS, int NL>
__device__ __forceinline__ T reduce(const List<T> (&l)[NL], const int* idx,
                                    const T* w, int sub, int g) {
  T m = Num<T>::ninf();
#pragma unroll
  for (int q = 0; q < NL; ++q)
    for (int e = l[q].a + sub; e < l[q].b; e += g)
      m = Num<T>::mx(m, (l[q].src ? l[q].src[idx[e]] : Num<T>::neg()) + w[e]);
  for (int off = g >> 1; off > 0; off >>= 1)
    m = Num<T>::mx(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (MAXPLUS) return m;
  const T safe = m > Num<T>::half() ? m : T(0);
  T s = T(0);
#pragma unroll
  for (int q = 0; q < NL; ++q)
    for (int e = l[q].a + sub; e < l[q].b; e += g)
      s += Num<T>::ex((l[q].src ? l[q].src[idx[e]] : Num<T>::neg()) + w[e] -
                      safe);
  for (int off = g >> 1; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s > T(0) ? Num<T>::lg(s) + safe : Num<T>::neg();
}

__device__ __forceinline__ void sync_all(int csize) {
  if (csize > 1)
    cluster_sync();
  else
    __syncthreads();
}

template <typename T, bool MAXPLUS>
__global__ void __launch_bounds__(THREADS, 1)
    sparse_walk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = p.csize > 1 ? cluster_rank() : 0;
  const int slot = blockIdx.x / p.csize;
  const int S = p.S;
  const size_t WS = (size_t)p.W * S;
  T* base = p.ring_shared
                ? reinterpret_cast<T*>(smem)
                : reinterpret_cast<T*>(p.ring) + (size_t)slot * 4 * WS;
  T* pre = base + 3 * WS;
  const int* eoff = p.ints;
  const int* coff = p.ints + p.o_coff;
  const int* cls = p.ints + p.o_cls;
  const int* eidx = p.ints + p.o_eidx;
  const int* cidx = p.ints + p.o_cidx;
  const T* ew = reinterpret_cast<const T*>(p.weights);
  const T* cw = ew + p.o_cw;

  // every block of a cluster walks the same pairs; the last barrier of a
  // pair's walk frees the ring for the next
  for (int b = slot; b < p.B; b += p.grid) {
    const int* sq = p.seq + (size_t)b * (2 + p.Li + p.Lo);
    const int Lin = min(max(sq[0], 0), p.Li), Lout = min(max(sq[1], 0), p.Lo);
    const int* xs = sq + 2;
    const int* ys = sq + 2 + p.Li;
    const int last = Lin + Lout;

    for (int d = 0; d <= last; ++d) {
      const int lo = max(0, d - Lout), n = min(d, Lin) - lo + 1;
      const int lo1 = max(0, d - 1 - Lout), lo2 = max(0, d - 2 - Lout);
      const T* s1 = base + (size_t)((d + 2) % 3) * WS;   // diagonal d-1
      const T* s2 = base + (size_t)((d + 1) % 3) * WS;   // diagonal d-2
      T* cur = base + (size_t)(d % 3) * WS;
      const int items = n * S;
      // stages 1-2: the neighbours' terms, reduced per scatter-side state
      if (d == 0) {
        for (int k = rank * THREADS + threadIdx.x; k < S;
             k += p.csize * THREADS)
          pre[k] = k == p.start ? T(0) : Num<T>::neg();
      } else {
        const int g = p.ga, gpb = THREADS / g, sub = threadIdx.x & (g - 1);
        const int gid = rank * gpb + threadIdx.x / g, ng = p.csize * gpb;
        for (int k0 = 0; k0 < items; k0 += ng) {
          const int k = k0 + gid;
          List<T> l[3] = {{0, 0, nullptr}, {0, 0, nullptr}, {0, 0, nullptr}};
          int c = 0, t = 0;
          if (k < items) {
            c = k / S;
            t = k - c * S;
            const int i = lo + c, o = d - i;
            const int x = i ? (p.reverse ? xs[Lin - i] : xs[i - 1]) : 0;
            const int y = o ? (p.reverse ? ys[Lout - o] : ys[o - 1]) : 0;
            const bool xin = x >= 0 && x < p.n_in, yin = y >= 0 && y < p.n_out;
            const int empty = p.n_cls - 1;
            const int q0 = xin && yin ? cls[x * p.n_out + y] : empty;
            const int q1 = xin ? cls[x * p.n_out] : empty;
            const int q2 = yin ? cls[y] : empty;
            l[0] = {eoff[q0 * S + t], eoff[q0 * S + t + 1],
                    i && o ? s2 + (size_t)(i - 1 - lo2) * S : nullptr};
            l[1] = {eoff[q1 * S + t], eoff[q1 * S + t + 1],
                    i ? s1 + (size_t)(i - 1 - lo1) * S : nullptr};
            l[2] = {eoff[q2 * S + t], eoff[q2 * S + t + 1],
                    o ? s1 + (size_t)(i - lo1) * S : nullptr};
          }
          const T r = reduce<T, MAXPLUS, 3>(l, eidx, ew, sub, g);
          if (k < items && sub == 0) pre[(size_t)c * S + t] = r;
        }
      }
      sync_all(p.csize);
      // stage 3: the closure
      {
        const int g = p.gb, gpb = THREADS / g, sub = threadIdx.x & (g - 1);
        const int gid = rank * gpb + threadIdx.x / g, ng = p.csize * gpb;
        for (int k0 = 0; k0 < items; k0 += ng) {
          const int k = k0 + gid;
          List<T> l[1] = {{0, 0, nullptr}};
          int c = 0, t = 0;
          if (k < items) {
            c = k / S;
            t = k - c * S;
            l[0] = {coff[t], coff[t + 1], pre + (size_t)c * S};
          }
          const T r = reduce<T, MAXPLUS, 1>(l, cidx, cw, sub, g);
          if (k < items && sub == 0) {
            cur[(size_t)c * S + t] = r;
            if (d == last && t == p.read) reinterpret_cast<T*>(p.out)[b] = r;
          }
        }
      }
      sync_all(p.csize);
    }
  }
}

size_t smem_bytes(int W, int S, int elt, int ring_shared) {
  return ring_shared ? (size_t)4 * W * S * elt : 0;
}

template <typename T, bool MAXPLUS>
int launch(const Params& p, size_t smem, cudaStream_t st) {
  auto kern = sparse_walk_kernel<T, MAXPLUS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (p.csize == 1) {
    kern<<<p.grid, THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (p.csize > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid * p.csize, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool pow2_lanes(int g) { return g >= 1 && g <= 32 && (g & (g - 1)) == 0; }

}  // namespace

extern "C" int sparse_walk_smem_bytes(int W, int S, int elt,
                                      int ring_shared) {
  return (int)smem_bytes(W, S, elt, ring_shared);
}

// Launches the kernel on `stream`: `grid` clusters of `csize` blocks of 512
// threads (one block when csize is 1), cluster g walking pairs g, g +
// grid, ... of the B. seq: the (B, 2 + Li + Lo) int32 lengths and tokens;
// ints, weights: the tables (n_i int32, n_w values of the dtype; sections
// at the o_* offsets); ring: the global rings, (grid, 4, W, S) values
// (null when ring_shared); ga, gb: the lanes a state's terms in the two
// stages; start, read: the start and read-out states; reverse: the tokens
// read from each pair's end; maxplus: the semiring; f64: double (else
// float). Returns
// cudaGetLastError() or the launch's error: nonzero means the launch was
// refused.
extern "C" int sparse_walk_launch(
    const void* seq, const void* ints, const void* weights, void* out,
    void* ring, int n_i, int n_w, int o_coff, int o_cls, int o_eidx,
    int o_cidx, int o_cw, int n_cls, int n_in, int n_out, int B, int Li,
    int Lo, int S, int W, int csize, int grid, int ga, int gb,
    int ring_shared, int start, int read, int reverse, int maxplus, int f64,
    void* stream) {
  const bool shape_ok =
      B >= 0 && Li >= 0 && Lo >= 0 && S >= 1 && n_cls >= 1 && n_in >= 1 &&
      n_out >= 1 && W >= (Li < Lo ? Li : Lo) + 1 && csize >= 1 &&
      csize <= 16 && (B == 0 || (grid >= 1 && grid <= B)) &&
      (!ring_shared || csize == 1) &&
      (B == 0 || ring_shared || ring != nullptr) && pow2_lanes(ga) &&
      pow2_lanes(gb) &&
      o_coff == n_cls * S + 1 && o_cls == o_coff + S + 1 &&
      o_eidx == o_cls + n_in * n_out && o_cidx - o_eidx == o_cw &&
      n_i - o_cidx == n_w - o_cw && start >= 0 && start < S && read >= 0 &&
      read < S;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p{(const int*)seq, (const int*)ints, weights, out, ring, o_coff,
           o_cls, o_eidx, o_cidx, o_cw, n_cls, n_in, n_out, B, Li, Lo, S, W,
           csize, grid, ga, gb, ring_shared, start, read, reverse};
  const size_t smem = smem_bytes(W, S, f64 ? 8 : 4, ring_shared);
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return maxplus ? launch<double, true>(p, smem, st)
                   : launch<double, false>(p, smem, st);
  return maxplus ? launch<float, true>(p, smem, st)
                 : launch<float, false>(p, smem, st);
}
