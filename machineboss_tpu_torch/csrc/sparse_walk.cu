// The sparse engine's token walks, for Hopper (sm_90a).
//
// Replaces the jitted sparse walks of machineboss_tpu/ops/sparse.py (no
// pallas_call: each is one @jax.jit program that XLA unrolls over every
// cell): forward_2d_sparse (:89-133), forward_1d_sparse (:168-190),
// backward_1d_sparse (:208-226) and backward_2d_sparse (:228-266), whose
// max-plus form is viterbi_2d_sparse (:269). One launch walks a batch of
// pairs, each by anti-diagonals, cell by cell as the port's eager walk does
// (ops/sparse.py, _diagonals and _walk):
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
// What bounds it on this card: the dependence between cells. A pair is
// Li + Lo + 1 dependent diagonals; the arithmetic is small (prot2dna: some
// 220 terms a cell; a 128-node Plan7 generator's cell 34,056 closure
// terms, a 512-node one's 529,416), so the latency of a diagonal, not the
// card's rates, sets the pace. The first form of this kernel spread a
// diagonal's (cell, state) items over a cluster, each item a chain of
// dependent loads through L2 (token, class, list offsets, entries, source
// values), with two cluster barriers a diagonal.
//
// Design (the launch plan is ops/kernels/sparse_kernel.py::
// sparse_launch_plan):
//  * CSR lists keyed by the scatter side: for every (class, state t) and
//    for the closure's every state t the entries (gather state, weight)
//    whose terms reduce into t, so a state's result is one reduction with
//    no atomics, in a fixed order: the same bits run to run, at every
//    cluster size and in either form below.
//  * One pass a list: a lane keeps a running max and a sum rescaled to it
//    (logsumexp) or the max (max-plus); the g lanes of a state's group (g
//    a power of two up to 32, by the mean list length) combine by a max
//    tree, one rescale and a sum tree, every lane with the same result. A
//    closure list shorter than LONG_LIST takes one lane and no tree (a
//    Plan7 generator's lists: half of 1-3 entries, the rest in hundreds).
//    logsumexp keeps segment_logsumexp's guard (a max at or below
//    NEG_INF / 2 gives NEG_INF); max-plus the max (-inf for a state with
//    no entry, as segment_max), bit-equal to the eager walk. No prepared
//    exponentials: a closure list of a 512-node generator spans 807 nats,
//    past float32's exp.
//  * 2D form (several cells a diagonal): the positions along the shorter
//    side split into fixed ranges, one a block of the cluster; a group of
//    16 / ncb warps takes a cell (a warp where a block holds 16 cells or
//    more), its pre-closure values in the group's workspace between the
//    two stages (a named barrier of the group, no block barrier), its
//    neighbours from the block's ring of three diagonals. Only a range's
//    edge cell crosses blocks: it goes into the right-hand block's inbox
//    by st.async, counted on the slot's mbarrier, as in
//    csrc/row_scan.cu; one block barrier a diagonal. Where the ring does
//    not fit shared memory it is in global scratch, one a cluster
//    launched (a persistent grid walking pair g, g + grid, ...), with one
//    cluster barrier a diagonal.
//  * 1D form (one side empty: one cell a diagonal, the whole closure in
//    it): the states split into fixed ranges, one a block, balanced by
//    their closure entries a lane. A block reduces its states' lists and
//    sends its slice of the pre-closure vector, then of the cell, into
//    every block's shared copy by st.async, each copy counted on its
//    mbarrier against the vector's bytes: a block waits for bytes to
//    arrive, never for a barrier; every gather reads shared memory.
//  * The tables in shared memory by size: all of them in every block
//    (2D), or a block's states' lists (1D), with 16-bit gather indices
//    below 65,536 states; else read through L1/L2. A warp's next tokens
//    are loaded a diagonal ahead.
//  * One template a dtype (float, double) and semiring.
//
// Built with -DPHASE_PROFILE (a separate library), lane 0 of every warp
// sums clock64 cycles a phase into prof (grid, N_PROF).

#include <cuda_runtime.h>
#include <stdint.h>

#include "viterbi_common.cuh"   // the cluster helpers

namespace {

using viterbi::cluster_rank;
using viterbi::cluster_sync;

constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;
constexpr int BOX = 4;          // inbox slots: a neighbour runs <= 2 ahead
constexpr int BAR_BYTES = 64;   // eight mbarriers
constexpr int LONG_LIST = 8;    // closure entries a state's group takes at
                                // least (shorter: one lane, no shuffles)
constexpr unsigned long long WAIT_NS = 20000000000ull;   // 20 s

// profile slots: diagonals (a block's), rounds (a warp's turns over its
// states), then the warps' cycles in each phase: the tokens and classes,
// stage 1-2's loads and reduction (and its sends), the waits for data
// (2D: the left neighbour's cell in the inbox, and the right one's free
// slot; 1D: the pre-closure vector's bytes), the closure (and its sends),
// the wait after it (2D: the block or cluster barrier; 1D: the cell's
// bytes)
enum { P_DIAG, P_ROUNDS, P_PROLOGUE, P_EMIT, P_WAIT1, P_CLOSURE, P_WAIT2,
       N_PROF };
enum { TAB_GLOBAL = 0, TAB_WHOLE = 1, TAB_SLICE = 2 };

__device__ __forceinline__ long long pclock() {
#ifdef PHASE_PROFILE
  __syncwarp();
  return clock64();
#else
  return 0;
#endif
}

struct Params {
  const int* seq;        // (B, 2 + Li + Lo): in_len, out_len, in, out tokens
  const int* ints;       // eoff | coff | cls | eidx | cidx
  const void* weights;   // ew | cw, the dtype's values
  const int* bounds;     // (csize + 1): the 1D form's state ranges
  void* out;             // (B,)
  void* scratch;         // (grid, 3 W S + csize NW S): global ring, work
  long long* prof;       // (grid, N_PROF) with PHASE_PROFILE
  int o_coff, o_cls, o_eidx, o_cidx, o_cw, n_i;
  int n_cls, n_in, n_out;
  int B, Li, Lo, S, W;
  int csize, grid, ga, gb;
  int one_d, rows_shared, tables, idx16, swap, ncb, n_rows, n_e, n_c;
  int start, read, reverse;
};

template <typename T>
struct Num;
template <>
struct Num<float> {
  __device__ static float neg() { return -1e30f; }
  __device__ static float half() { return -5e29f; }
  __device__ static float ninf() { return __int_as_float(0xff800000); }
  __device__ static float ex(float x) { return __expf(x); }
  __device__ static float lg(float x) { return __logf(x); }
  __device__ static float mx(float a, float b) { return fmaxf(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
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
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

// ---------------------------------------------------------------- layout

__host__ __device__ inline size_t up16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// A block's shared memory, in bytes from its start: the mbarriers; the
// rows (2D with the ring shared: three diagonals of ncb cells, the inbox's
// BOX cells and the warps' workspaces; 1D: the cell and the pre-closure
// vectors); the order of its states' closures (n_rows, and a count);
// then the staged tables (weights, offsets, classes, indices).
struct Smem {
  size_t ring, inbox, work, order, ew, cw, eoff, coff, cls, eidx, cidx, total;
};

__host__ __device__ inline Smem smem_layout(int one_d, int S, int elt,
                                            int ncb, int rows_shared,
                                            int tables, int idx16,
                                            int n_cls, int n_io, int n_rows,
                                            int n_e, int n_c) {
  Smem L;
  size_t at = BAR_BYTES;
  const size_t v = (size_t)S * elt;
  L.ring = at;
  if (one_d) {
    L.inbox = L.work = at + up16(v);        // the pre-closure vector
    at = L.inbox + up16(v);
  } else if (rows_shared) {
    L.inbox = at + up16(3 * (size_t)ncb * v);
    L.work = L.inbox + up16(BOX * v);
    at = L.work + up16(NW * v);
  } else {
    L.inbox = L.work = at;
  }
  L.order = at;                             // the states' closure order
  at += up16(((size_t)n_rows + 2) * 4);
  L.ew = L.cw = L.eoff = L.coff = L.cls = L.eidx = L.cidx = at;
  if (tables != TAB_GLOBAL) {
    const size_t ib = idx16 ? 2 : 4;
    L.ew = at;
    L.cw = L.ew + up16((size_t)n_e * elt);
    L.eoff = L.cw + up16((size_t)n_c * elt);
    L.coff = L.eoff + up16(((size_t)n_cls * n_rows + 1) * 4);
    L.cls = L.coff + up16(((size_t)n_rows + 1) * 4);
    L.eidx = L.cls + up16((size_t)n_io * 4);
    L.cidx = L.eidx + up16((size_t)n_e * ib);
    at = L.cidx + up16((size_t)n_c * ib);
  }
  L.total = at;
  return L;
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// the shared::cluster address of the same shared offset in block `rank`
__device__ __forceinline__ unsigned peer(const void* p, int rank) {
  return viterbi::peer_addr(static_cast<const float*>(p), rank);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_peer(unsigned addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          addr)
      : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// waits for the phase of `parity` to complete; a signal that has not come
// after WAIT_NS of the card's global timer (a fault) traps instead of
// hanging the card. CLUSTER: acquire at cluster scope, for a peer's
// arrive that releases its reads of this block's slot; else at block
// scope, enough for the st.async bytes a phase counts (they land in this
// block's shared memory) and free of the L1 invalidation a cluster-scope
// acquire costs.
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  unsigned long long t0 = 0;
  for (unsigned n = 1;; ++n) {
    if (CLUSTER)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(smem_u32(bar)), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(smem_u32(bar)), "r"(parity)
          : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      const unsigned long long t = global_ns();
      if (t0 == 0)
        t0 = t;
      else if (t - t0 > WAIT_NS)
        __trap();
    }
  }
}
// a value into a block's shared memory (distributed shared memory),
// counted in bytes on that block's mbarrier `bar`
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, double v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(addr), "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------- the lists

// The tables as the kernel reads them (global memory, or a block's staged
// copy): row (c, t) of the emitting lists is eoff[c rs + t - s0] up to the
// next offset, the closure's row t coff[t - s0]; gather indices of 16 or
// 32 bits.
template <typename T>
struct Tab {
  const int* eoff;
  const int* coff;
  const int* cls;
  const void* eidx;
  const void* cidx;
  const T* ew;
  const T* cw;
  int rs, s0, i16;
};

__device__ __forceinline__ int gather(const void* idx, int e, int i16) {
  return i16 ? (int)((const uint16_t*)idx)[e] : ((const int*)idx)[e];
}

// The terms of one state over NL lists ([a, b) of idx / w, gathering from
// src; null: a missing neighbour, every value NEG_INF) by the g = 2^lg
// lanes of its group, lane `sub` taking entries sub, sub + g, ...: a
// lane's running max and its sum rescaled to it, then the group's max by a
// shuffle tree, each lane's sum rescaled to it once and the sums by a
// second tree (the same adds in every lane: all lanes of the group get the
// same result). Every lane of the warp calls it (a lane without a state
// with empty lists).
// ONE: a group of one lane (a constant stride: no trip count to divide).
template <typename T, bool MAXPLUS, int NL, bool ONE>
__device__ __forceinline__ T reduce(const int (&a)[NL], const int (&b)[NL],
                                    const T* const (&src)[NL],
                                    const void* idx, const T* w, int i16,
                                    int sub, int lg) {
  const int g = ONE ? 1 : 1 << lg;
  T m = Num<T>::ninf(), s = T(0);
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    const T* sv = src[q];
#pragma unroll 4
    for (int e = a[q] + sub; e < b[q]; e += g) {
      const T v = (sv ? sv[gather(idx, e, i16)] : Num<T>::neg()) + w[e];
      if (MAXPLUS) {
        m = Num<T>::mx(m, v);
      } else if (v > m) {
        s = s * Num<T>::ex(m - v) + T(1);
        m = v;
      } else {
        s += Num<T>::ex(v - m);
      }
    }
  }
  T M = m;
  for (int off = g >> 1; off > 0; off >>= 1)
    M = Num<T>::mx(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (MAXPLUS) return M;
  if (m != M) s = s * Num<T>::ex(m - M);
  for (int off = g >> 1; off > 0; off >>= 1)
    s = Num<T>::add(s, __shfl_xor_sync(0xffffffffu, s, off));
  return M > Num<T>::half() ? Num<T>::lg(s) + M : Num<T>::neg();
}

// The classes of a cell whose tokens are x (the input token consumed into
// its position, 0 at position 0) and y: (x, y) from the diagonal
// neighbour, (x, 0) from (i-1, o), (0, y) from (i, o-1); the empty class
// for a token outside the alphabet. Lanes 0-2 look one up each.
template <typename T>
__device__ __forceinline__ void classes(const Params& p, const Tab<T>& tb,
                                        int x, int y, int lane, int& q0,
                                        int& q1, int& q2) {
  const int empty = p.n_cls - 1;
  const bool xin = x >= 0 && x < p.n_in, yin = y >= 0 && y < p.n_out;
  int q = empty;
  if (lane == 0 && xin && yin) q = tb.cls[x * p.n_out + y];
  if (lane == 1 && xin) q = tb.cls[x * p.n_out];
  if (lane == 2 && yin) q = tb.cls[y];
  q0 = __shfl_sync(0xffffffffu, q, 0);
  q1 = __shfl_sync(0xffffffffu, q, 1);
  q2 = __shfl_sync(0xffffffffu, q, 2);
}

// State t's pre-closure value from its three lists (classes q0-q2 from
// the sources src), by its group; ok false: a lane without a state.
template <typename T, bool MAXPLUS>
__device__ __forceinline__ T emit_state(const Tab<T>& tb, int t, bool ok,
                                        int q0, int q1, int q2,
                                        const T* const (&src)[3], int sub,
                                        int lg) {
  int a[3] = {0, 0, 0}, b[3] = {0, 0, 0};
  if (ok) {
    const int r = t - tb.s0;
    a[0] = tb.eoff[q0 * tb.rs + r];
    b[0] = tb.eoff[q0 * tb.rs + r + 1];
    a[1] = tb.eoff[q1 * tb.rs + r];
    b[1] = tb.eoff[q1 * tb.rs + r + 1];
    a[2] = tb.eoff[q2 * tb.rs + r];
    b[2] = tb.eoff[q2 * tb.rs + r + 1];
  }
  return lg ? reduce<T, MAXPLUS, 3, false>(a, b, src, tb.eidx, tb.ew,
                                          tb.i16, sub, lg)
            : reduce<T, MAXPLUS, 3, true>(a, b, src, tb.eidx, tb.ew, tb.i16,
                                          sub, lg);
}

// State t's cell value: its closure list over the pre-closure vector.
template <typename T, bool MAXPLUS>
__device__ __forceinline__ T closure_state(const Tab<T>& tb, int t, bool ok,
                                           const T* pre, int sub, int lg) {
  int a[1] = {0}, b[1] = {0};
  if (ok) {
    a[0] = tb.coff[t - tb.s0];
    b[0] = tb.coff[t - tb.s0 + 1];
  }
  const T* const src[1] = {pre};
  return lg ? reduce<T, MAXPLUS, 1, false>(a, b, src, tb.cidx, tb.cw,
                                          tb.i16, sub, lg)
            : reduce<T, MAXPLUS, 1, true>(a, b, src, tb.cidx, tb.cw, tb.i16,
                                          sub, lg);
}

// Copies the tables into shared memory: all of them (TAB_WHOLE), or the
// lists of states [s0, s1) (TAB_SLICE: each class's rows of those states
// are one run of entries; the runs laid back to back, offsets rebased).
// Gather indices become 16-bit where idx16.
template <typename T>
__device__ Tab<T> stage(const Params& p, const Tab<T>& g,
                        unsigned char* smem, const Smem& L, int s0, int s1) {
  const int tid = threadIdx.x, S = p.S;
  int* eoff = (int*)(smem + L.eoff);
  int* coff = (int*)(smem + L.coff);
  int* cls = (int*)(smem + L.cls);
  T* ew = (T*)(smem + L.ew);
  T* cw = (T*)(smem + L.cw);
  void* eidx = smem + L.eidx;
  void* cidx = smem + L.cidx;
  auto put = [&](void* idx, int k, int v) {
    if (p.idx16)
      ((uint16_t*)idx)[k] = (uint16_t)v;
    else
      ((int*)idx)[k] = v;
  };
  for (int k = tid; k < p.n_in * p.n_out; k += THREADS) cls[k] = g.cls[k];
  const int n = s1 - s0;
  if (p.tables == TAB_WHOLE) {
    const int ne = p.o_cidx - p.o_eidx, nc = p.n_i - p.o_cidx;
    for (int k = tid; k <= p.n_cls * S; k += THREADS) eoff[k] = g.eoff[k];
    for (int k = tid; k <= S; k += THREADS) coff[k] = g.coff[k];
    for (int k = tid; k < ne; k += THREADS) {
      put(eidx, k, gather(g.eidx, k, 0));
      ew[k] = g.ew[k];
    }
    for (int k = tid; k < nc; k += THREADS) {
      put(cidx, k, gather(g.cidx, k, 0));
      cw[k] = g.cw[k];
    }
  } else {
    // each class's run length at its first row, then the runs' bases
    for (int c = tid; c < p.n_cls; c += THREADS)
      eoff[c * n] = g.eoff[c * S + s1] - g.eoff[c * S + s0];
    __syncthreads();
    if (tid == 0) {
      int at = 0;
      for (int c = 0; c < p.n_cls; ++c) {
        const int r = eoff[c * n];
        eoff[c * n] = at;
        at += r;
      }
      eoff[p.n_cls * n] = at;
    }
    __syncthreads();
    for (int k = tid; k < p.n_cls * n; k += THREADS) {
      const int c = k / n, j = k - c * n;
      if (j)
        eoff[k] = eoff[c * n] + g.eoff[c * S + s0 + j] - g.eoff[c * S + s0];
    }
    for (int c = 0; c < p.n_cls; ++c) {
      const int base = eoff[c * n], run = eoff[(c + 1) * n] - base;
      const int e0 = g.eoff[c * S + s0];
      for (int k = tid; k < run; k += THREADS) {
        put(eidx, base + k, gather(g.eidx, e0 + k, 0));
        ew[base + k] = g.ew[e0 + k];
      }
    }
    const int c0 = g.coff[s0], nc = g.coff[s1] - c0;
    for (int j = tid; j <= n; j += THREADS) coff[j] = g.coff[s0 + j] - c0;
    for (int k = tid; k < nc; k += THREADS) {
      put(cidx, k, gather(g.cidx, c0 + k, 0));
      cw[k] = g.cw[c0 + k];
    }
  }
  __syncthreads();
  const bool slice = p.tables == TAB_SLICE;
  return Tab<T>{eoff, coff, cls, eidx, cidx, ew, cw, slice ? n : S,
                slice ? s0 : 0, p.idx16};
}

// The closure order of states [s0, s1) into order (n_rows + 2 ints):
// the states whose list one lane takes first, then those a group of gc
// lanes takes (gc > 1 and LONG_LIST entries or more); the first tier's
// count in order[n_rows]. A state's tier depends on its list alone, the
// same in either form, and its result on nothing else: the order within a
// tier (atomics) changes no bit.
template <typename T>
__device__ int closure_order(const Tab<T>& tb, int s0, int s1, int gc,
                             int* order, int n_rows) {
  int* count = order + n_rows;              // the two tiers' counts
  if (threadIdx.x == 0) count[0] = count[1] = 0;
  __syncthreads();
  const int n = s1 - s0;
  for (int t = s0 + threadIdx.x; t < s1; t += THREADS) {
    const int len = tb.coff[t - tb.s0 + 1] - tb.coff[t - tb.s0];
    if (gc > 1 && len >= LONG_LIST)
      order[n - 1 - atomicAdd(count + 1, 1)] = t;
    else
      order[atomicAdd(count, 1)] = t;
  }
  __syncthreads();
  return count[0];
}

// A pair's tokens: the one consumed into input position i and output
// position o (0 at position 0; read from the pair's end for Backward).
struct Pair {
  const int* xs;
  const int* ys;
  int Lin, Lout, reverse;
  __device__ int x(int i) const {
    return i ? (reverse ? xs[Lin - i] : xs[i - 1]) : 0;
  }
  __device__ int y(int o) const {
    return o ? (reverse ? ys[Lout - o] : ys[o - 1]) : 0;
  }
};

__device__ __forceinline__ Pair pair_of(const Params& p, int b) {
  const int* sq = p.seq + (size_t)b * (2 + p.Li + p.Lo);
  return Pair{sq + 2, sq + 2 + p.Li, min(max(sq[0], 0), p.Li),
              min(max(sq[1], 0), p.Lo), p.reverse};
}

// ------------------------------------------------------------ the 2D form

template <typename T, bool MAXPLUS>
__device__ void walk_2d(const Params& p, const Tab<T>& tb,
                        unsigned char* smem, const Smem& L, int rank,
                        int slot, const int* order, int n_short,
                        long long* pr) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int cs = p.csize, S = p.S;
  const bool gring = !p.rows_shared;
  // a group of wpc warps a cell where the shared ring holds fewer cells a
  // block than it has warps (each group then takes one cell a diagonal),
  // else a warp a cell; the warps past the groups idle
  const int wpc = gring ? 1 : max(NW / p.ncb, 1), ng = NW / wpc;
  const int gi = w / wpc, j = w - gi * wpc;
  unsigned long long* full = (unsigned long long*)smem;
  unsigned long long* empty = full + BOX;
  T* ring_s = (T*)(smem + L.ring);
  T* inbox = (T*)(smem + L.inbox);
  const size_t WS = (size_t)p.W * S;
  T* ring_g = gring ? (T*)p.scratch +
                          (size_t)slot * (3 * WS + (size_t)cs * NW * S)
                    : nullptr;
  T* pre = gring ? ring_g + 3 * WS + ((size_t)rank * NW + w) * S
                 : (T*)(smem + L.work) + (size_t)gi * S;
  const unsigned box_bytes = (unsigned)(S * sizeof(T));
  const bool boxes = !gring && cs > 1;
  if (boxes && tid == 0) {
    for (int k = 0; k < BOX; ++k) {
      mbar_init(full + k);
      mbar_init(empty + k);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < BOX; ++k) mbar_expect(full + k, box_bytes);
  }
  // every block of the cluster runs, its mbarriers set, before any store
  // to its shared memory
  cluster_sync();
  // the pre-closure vector is the group's: its warps meet on a named
  // barrier (ids 1-8: a group of two warps or more) between the stages
  auto group_sync = [&]() {
    if (wpc == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(1 + gi), "r"(wpc * 32)
                   : "memory");
  };
  const int lge = __ffs(p.ga) - 1, lgc = __ffs(p.gb) - 1;
  const int pe = 32 >> lge, pc = 32 >> lgc;     // states a warp's round

  for (int b = slot; b < p.B; b += p.grid) {
    const Pair pp = pair_of(p, b);
    // positions P along the shorter padded side (the ranges), Q the other
    const int LP = p.swap ? pp.Lout : pp.Lin, LQ = p.swap ? pp.Lin : pp.Lout;
    const int ncb = (LP + cs) / cs;              // ceil((LP + 1) / cs)
    const int a = rank * ncb, bnd = min(a + ncb, LP + 1);
    const bool consumer = boxes && rank > 0 && a <= LP;
    const bool producer = boxes && rank + 1 < cs && a + ncb <= LP;
    // the stored cell at position PP of diagonal dd: this block's in its
    // ring, its left neighbour's last in the inbox, or the global ring's
    auto source = [&](int dd, int PP) -> const T* {
      if (gring) return ring_g + ((size_t)(dd % 3) * p.W + PP) * S;
      const int c = PP - a;
      if (c >= 0) return ring_s + ((size_t)(dd % 3) * p.ncb + c) * S;
      const int u = dd - (a - 1);
      mbar_wait(full + u % BOX, (u / BOX) & 1);
      return inbox + (size_t)(u % BOX) * S;
    };
    auto tokens = [&](int d, int P, int& x, int& y) {
      const int Q = d - P;
      x = pp.x(p.swap ? Q : P);
      y = pp.y(p.swap ? P : Q);
    };
    // the tokens of the group's first cell of a diagonal, loaded a
    // diagonal ahead
    int nx = 0, ny = 0;
    if (gi < ng && a + gi <= min(bnd - 1, min(0, LP)))
      tokens(0, a + gi, nx, ny);
    for (int d = 0; d <= LP + LQ; ++d) {
      const int plo = max(a, d - LQ), phi = min(bnd - 1, min(d, LP));
      const int cx = nx, cy = ny;
      {
        const int P = max(a, d + 1 - LQ) + gi;
        if (gi < ng && P <= min(bnd - 1, min(d + 1, LP)))
          tokens(d + 1, P, nx, ny);
      }
      for (int P = plo + gi; gi < ng && P <= phi; P += ng) {
        long long t0 = pclock();
        const int Q = d - P;
        const int i = p.swap ? Q : P, o = p.swap ? P : Q;
        int x = cx, y = cy;
        if (P != plo + gi) tokens(d, P, x, y);
        int q0, q1, q2;
        classes(p, tb, x, y, lane, q0, q1, q2);
        long long t1 = pclock();
        pr[P_PROLOGUE] += t1 - t0;
        // the neighbours: (i-1, o-1) on d-2; (i-1, o) and (i, o-1) on d-1
        const int pl = p.swap ? P : P - 1, pu = p.swap ? P - 1 : P;
        const T* const src[3] = {
            i && o ? source(d - 2, P - 1) : nullptr,
            i ? source(d - 1, pl) : nullptr,
            o ? source(d - 1, pu) : nullptr};
        t0 = pclock();
        pr[P_WAIT1] += t0 - t1;
        t1 = t0;
        // stage 1-2 into the group's workspace, a warp's share of states
        {
          const int sub = lane & (p.ga - 1);
          for (int r0 = j * pe; r0 < S; r0 += wpc * pe) {
            const int t = r0 + (lane >> lge);
            const bool ok = t < S;
            T r;
            if (d == 0)
              r = t == p.start ? T(0) : Num<T>::neg();
            else
              r = emit_state<T, MAXPLUS>(tb, t, ok, q0, q1, q2, src, sub,
                                         lge);
            if (ok && sub == 0) pre[t] = r;
            pr[P_ROUNDS] += 1;
          }
        }
        group_sync();
        long long t2 = pclock();
        pr[P_EMIT] += t2 - t1;
        // the closure, into the ring (and the right neighbour's inbox,
        // once its slot is free)
        T* dst = gring ? ring_g + ((size_t)(d % 3) * p.W + P) * S
                       : ring_s + ((size_t)(d % 3) * p.ncb + (P - a)) * S;
        const bool send = producer && P == a + ncb - 1;
        unsigned box = 0, bar = 0;
        if (send) {
          if (Q >= BOX)
            mbar_wait<true>(empty + Q % BOX, (Q / BOX - 1) & 1);
          box = peer(inbox + (size_t)(Q % BOX) * S, rank + 1);
          bar = peer(full + Q % BOX, rank + 1);
        }
        const bool last = i == pp.Lin && o == pp.Lout;
        t1 = pclock();
        pr[P_WAIT1] += t1 - t2;
        auto put = [&](int t, T r) {
          dst[t] = r;
          if (send) st_async(box + t * (unsigned)sizeof(T), r, bar);
          if (last && t == p.read) reinterpret_cast<T*>(p.out)[b] = r;
        };
        // the short lists a lane each, then the long ones a group each
        for (int r0 = j * 32; r0 < n_short; r0 += wpc * 32) {
          const int k = r0 + lane;
          const bool ok = k < n_short;
          const int t = ok ? order[k] : 0;
          const T r = closure_state<T, MAXPLUS>(tb, t, ok, pre, 0, 0);
          if (ok) put(t, r);
          pr[P_ROUNDS] += 1;
        }
        {
          const int sub = lane & (p.gb - 1);
          for (int r0 = n_short + j * pc; r0 < S; r0 += wpc * pc) {
            const int k = r0 + (lane >> lgc);
            const bool ok = k < S;
            const int t = ok ? order[k] : 0;
            const T r = closure_state<T, MAXPLUS>(tb, t, ok, pre, sub, lgc);
            if (ok && sub == 0) put(t, r);
            pr[P_ROUNDS] += 1;
          }
        }
        group_sync();
        pr[P_CLOSURE] += pclock() - t1;
      }
      const long long tw = pclock();
      if (gring && cs > 1)
        cluster_sync();
      else
        __syncthreads();
      // the left neighbour's cell of d - 2 was last read on d (as the
      // diagonal source): its slot goes back, armed for use u + BOX, once
      // its bytes have landed (read or not)
      if (consumer && tid == 0) {
        const int u = d - 1 - a;
        if (u >= 0 && u <= LQ) {
          mbar_wait(full + u % BOX, (u / BOX) & 1);
          mbar_expect(full + u % BOX, box_bytes);
          mbar_arrive_peer(peer(empty + u % BOX, rank - 1));
        }
      }
      pr[P_WAIT2] += pclock() - tw;
      pr[P_DIAG] += 1;
    }
    // no block leaves while its left neighbour's stores may be in flight
    if (consumer && tid == 0) mbar_wait(full + LQ % BOX, (LQ / BOX) & 1);
  }
}

// ------------------------------------------------------------ the 1D form

template <typename T, bool MAXPLUS>
__device__ void walk_1d(const Params& p, const Tab<T>& tb,
                        unsigned char* smem, const Smem& L, int slot, int s0,
                        int s1, const int* order, int n_short,
                        long long* pr) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int cs = p.csize;
  unsigned long long* bar_pre = (unsigned long long*)smem;
  unsigned long long* bar_cell = bar_pre + 1;
  T* cell = (T*)(smem + L.ring);
  T* pre = (T*)(smem + L.inbox);
  const unsigned bytes = (unsigned)(p.S * sizeof(T));
  if (tid == 0) {
    mbar_init(bar_pre);
    mbar_init(bar_cell);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(bar_pre, bytes);
    mbar_expect(bar_cell, bytes);
  }
  cluster_sync();
  const int lge = __ffs(p.ga) - 1, lgc = __ffs(p.gb) - 1;
  // Each stage's values go to every block (this one too) by st.async; a
  // block arms the next phase of a vector's mbarrier right after its wait,
  // and thread 0, which arms both, sends the block's first state in each
  // stage after arming: no peer's bytes of a phase can arrive before the
  // phase is armed.
  unsigned phase = 0;
  for (int b = slot; b < p.B; b += p.grid) {
    const Pair pp = pair_of(p, b);
    const int last = pp.Lin + pp.Lout;          // one of them is 0
    auto tokens = [&](int d, int& x, int& y) {
      x = pp.Lin ? pp.x(d) : 0;
      y = pp.Lout ? pp.y(d) : 0;
    };
    int nx, ny;
    tokens(0, nx, ny);
    for (int d = 0; d <= last; ++d) {
      long long t0 = pclock();
      const int x = nx, y = ny;
      if (d < last) tokens(d + 1, nx, ny);
      int q0, q1, q2;
      classes(p, tb, x, y, lane, q0, q1, q2);
      // (i-1, o-1) never exists; (i-1, o) or (i, o-1), the walked side's
      const T* const src[3] = {nullptr, d && pp.Lin ? cell : nullptr,
                               d && pp.Lout ? cell : nullptr};
      long long t1 = pclock();
      pr[P_PROLOGUE] += t1 - t0;
      // stage 1-2: this block's states, each sent to every block's copy
      {
        const int sub = tid & (p.ga - 1);
        for (int r0 = s0; r0 < s1; r0 += THREADS >> lge) {
          const int t = r0 + (tid >> lge);
          const bool ok = t < s1;
          T r;
          if (d == 0)
            r = t == p.start ? T(0) : Num<T>::neg();
          else
            r = emit_state<T, MAXPLUS>(tb, t, ok, q0, q1, q2, src, sub, lge);
          if (ok)
            for (int k = sub; k < cs; k += p.ga)
              st_async(peer(pre + t, k), r, peer(bar_pre, k));
          pr[P_ROUNDS] += 1;
        }
      }
      long long t2 = pclock();
      pr[P_EMIT] += t2 - t1;
      mbar_wait(bar_pre, phase & 1);
      if (tid == 0) mbar_expect(bar_pre, bytes);
      t1 = pclock();
      pr[P_WAIT1] += t1 - t2;
      // the closure of this block's states, each sent to every block's
      // copy: the short lists a thread each, then the long ones a group
      auto put = [&](int t, T r, int sub, int g) {
        for (int k = sub; k < cs; k += g)
          st_async(peer(cell + t, k), r, peer(bar_cell, k));
        if (d == last && t == p.read && sub == 0)
          reinterpret_cast<T*>(p.out)[b] = r;
      };
      for (int r0 = 0; r0 < n_short; r0 += THREADS) {
        const int k = r0 + tid;
        const bool ok = k < n_short;
        const int t = ok ? order[k] : s0;
        const T r = closure_state<T, MAXPLUS>(tb, t, ok, pre, 0, 0);
        if (ok) put(t, r, 0, 1);
        pr[P_ROUNDS] += 1;
      }
      {
        const int sub = tid & (p.gb - 1);
        for (int r0 = n_short; r0 < s1 - s0; r0 += THREADS >> lgc) {
          const int k = r0 + (tid >> lgc);
          const bool ok = k < s1 - s0;
          const int t = ok ? order[k] : s0;
          const T r = closure_state<T, MAXPLUS>(tb, t, ok, pre, sub, lgc);
          if (ok) put(t, r, sub, p.gb);
          pr[P_ROUNDS] += 1;
        }
      }
      t2 = pclock();
      pr[P_CLOSURE] += t2 - t1;
      mbar_wait(bar_cell, phase & 1);
      if (tid == 0) mbar_expect(bar_cell, bytes);
      ++phase;
      pr[P_WAIT2] += pclock() - t2;
      pr[P_DIAG] += 1;
    }
  }
}

template <typename T, bool MAXPLUS>
__global__ void __launch_bounds__(THREADS, 1)
    sparse_walk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = cluster_rank();
  const int slot = blockIdx.x / p.csize;
  const Smem L = smem_layout(p.one_d, p.S, (int)sizeof(T), p.ncb,
                             p.rows_shared, p.tables, p.idx16, p.n_cls,
                             p.n_in * p.n_out, p.n_rows, p.n_e, p.n_c);
  const T* ew = reinterpret_cast<const T*>(p.weights);
  Tab<T> tb{p.ints, p.ints + p.o_coff, p.ints + p.o_cls, p.ints + p.o_eidx,
            p.ints + p.o_cidx, ew, ew + p.o_cw, p.S, 0, 0};
  int s0 = 0, s1 = p.S;
  if (p.one_d) {
    s0 = p.bounds[rank];
    s1 = p.bounds[rank + 1];
  }
  if (p.tables != TAB_GLOBAL) tb = stage<T>(p, tb, smem, L, s0, s1);
  int* order = (int*)(smem + L.order);
  const int n_short = closure_order<T>(tb, s0, s1, p.gb, order, p.n_rows);
  long long pr[N_PROF] = {0};
  if (p.one_d)
    walk_1d<T, MAXPLUS>(p, tb, smem, L, slot, s0, s1, order, n_short, pr);
  else
    walk_2d<T, MAXPLUS>(p, tb, smem, L, rank, slot, order, n_short, pr);
  // no block leaves while a peer may still store into it or signal it
  cluster_sync();
#ifdef PHASE_PROFILE
  if ((threadIdx.x & 31) == 0) {
    if (threadIdx.x) pr[P_DIAG] = 0;
    for (int q = 0; q < N_PROF; ++q)
      atomicAdd((unsigned long long*)&p.prof[(size_t)slot * N_PROF + q],
                (unsigned long long)pr[q]);
  }
#endif
}

template <typename T, bool MAXPLUS>
int launch(const Params& p, size_t smem, cudaStream_t st) {
  auto kern = sparse_walk_kernel<T, MAXPLUS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
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

// A block's shared bytes for the layout (the plan's sparse_smem_bytes).
extern "C" int sparse_walk_smem_bytes(int one_d, int S, int elt, int ncb,
                                      int rows_shared, int tables, int idx16,
                                      int n_cls, int n_io, int n_rows,
                                      int n_e, int n_c) {
  return (int)smem_layout(one_d, S, elt, ncb, rows_shared, tables, idx16,
                          n_cls, n_io, n_rows, n_e, n_c)
      .total;
}

// Launches the kernel on `stream`: `grid` clusters of `csize` blocks of 512
// threads, cluster g walking pairs g, g + grid, ... of the B (grid = B with
// the 2D form's shared ring: a cluster a pair). seq: the (B, 2 + Li + Lo)
// int32 lengths and tokens; ints, weights: the tables (n_i int32, then the
// dtype's values; sections at the o_* offsets); bounds: the 1D form's
// csize + 1 state bounds (else null); scratch: the 2D form's global rings
// and workspaces, (grid, 3 W S + csize 16 S) values (null with the shared
// ring or the 1D form). one_d: the 1D form (Li or Lo 0); rows_shared: the
// 2D ring in shared memory, ncb cells a block; tables: 0 read from global
// memory, 1 all staged, 2 a block's states' lists (n_rows states, n_e
// emitting and n_c closure entries at most; all of them when 1); idx16:
// 16-bit staged gather indices; swap: the 2D ranges along the output side
// (Li > Lo); ga, gb: the lanes a state's terms in the two stages; start,
// read: the start and read-out states; reverse: the tokens read from each
// pair's end; maxplus: the semiring; f64: double (else float); prof: the
// profile library's (grid, 7) counters (else null). Returns
// cudaGetLastError() or the launch's error: nonzero means the launch was
// refused.
extern "C" int sparse_walk_launch(
    const void* seq, const void* ints, const void* weights,
    const void* bounds, void* out, void* scratch, int n_i, int o_coff,
    int o_cls, int o_eidx, int o_cidx, int o_cw, int n_cls, int n_in,
    int n_out, int B, int Li, int Lo, int S, int W, int csize, int grid,
    int ga, int gb, int one_d, int rows_shared, int tables, int idx16,
    int swap, int ncb, int n_rows, int n_e, int n_c, int start, int read,
    int reverse, int maxplus, int f64, void* prof, void* stream) {
  const bool whole_ok = tables != TAB_WHOLE ||
                        (n_rows == S && n_e == o_cidx - o_eidx &&
                         n_c == n_i - o_cidx);
  const bool form_ok =
      one_d ? (Li == 0 || Lo == 0) && bounds != nullptr &&
                  tables != TAB_WHOLE && csize <= S
            : tables != TAB_SLICE && W == (Li < Lo ? Li : Lo) + 1 &&
                  swap == (Li > Lo) &&
                  (rows_shared ? grid == B && ncb >= (W + csize - 1) / csize
                               : B == 0 || scratch != nullptr);
  const bool shape_ok =
      B >= 0 && Li >= 0 && Lo >= 0 && S >= 1 && n_cls >= 1 && n_in >= 1 &&
      n_out >= 1 && csize >= 1 && csize <= 16 &&
      (B == 0 || (grid >= 1 && grid <= B)) && pow2_lanes(ga) &&
      pow2_lanes(gb) && o_coff == n_cls * S + 1 && o_cls == o_coff + S + 1 &&
      o_eidx == o_cls + n_in * n_out && o_cidx - o_eidx == o_cw &&
      n_i >= o_cidx && (!idx16 || S <= 65536) && n_rows >= 1 &&
      n_e >= 0 && n_c >= 0 && start >= 0 && start < S && read >= 0 &&
      read < S && whole_ok && form_ok;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
#ifdef PHASE_PROFILE
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
#endif
  if (B == 0) return 0;
  Params p{(const int*)seq, (const int*)ints, weights, (const int*)bounds,
           out, scratch, (long long*)prof, o_coff, o_cls, o_eidx, o_cidx,
           o_cw, n_i, n_cls, n_in, n_out, B, Li, Lo, S, W, csize, grid, ga,
           gb, one_d, rows_shared, tables, idx16, swap, ncb, n_rows, n_e,
           n_c, start, read, reverse};
  const size_t smem =
      smem_layout(one_d, S, f64 ? 8 : 4, ncb, rows_shared, tables, idx16,
                  n_cls, n_in * n_out, n_rows, n_e, n_c)
          .total;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return maxplus ? launch<double, true>(p, smem, st)
                   : launch<double, false>(p, smem, st);
  return maxplus ? launch<float, true>(p, smem, st)
                 : launch<float, false>(p, smem, st);
}
