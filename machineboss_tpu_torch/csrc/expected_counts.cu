// Expected transition counts of the E-step, for Hopper (sm_90a).
//
// Replaces the backward pass that XLA derives for machineboss_tpu's
// ops/fwdback.py:112 (jax.value_and_grad of jax.vmap(dp2d.forward_2d), the
// lax.scans of ops/dp2d.py:49 and :98; no pallas_call: the E-step is one
// jitted program). One launch takes a batch's Forward lattices F and the
// Backward lattices of its pairs' reversed prefixes Br (both from
// csrc/row_scan.cu), and returns, for every finite entry of the four
// log-space tensors (A_diag[x, y], A_left[x], A_up[y], the closure C), the
// gradient of sum_b g_b LL_b, LL_b = F_b(il, ol, S-1): a sum over each
// pair's cells (i <= il, o <= ol) of posterior terms
//   emitting  exp(F_nb(s) + A[s,t] + Bk(i,o,t) - LL)   (the neighbour the
//             matrix leads from: (i-1,o-1) diag, (i,o-1) up, (i-1,o) left)
//   closure   exp(U(i,o,s) + C[s,t] + beta(i,o,t) - LL)
// with Bk(i,o) = Br(ol-o, il-i) (pre-closure Backward), U the pre-closure
// Forward and beta the post-closure Backward, neither of which the lattices
// hold. Both come from the emitting terms' sums, with no logsumexp:
//   P_U(s)    = sum of the cell's incoming terms into s
//             = exp(U(s) + Bk(s) - LL),
//   P_beta(t) = sum over the cells (i,o) feeds of exp(F(t) + A[t,u] +
//               Bk_next(u) - LL), plus exp(F(t) - LL) at the end cell
//             = exp(F(t) + beta(t) - LL),
// so the closure term is exp((log P_U(s) - Bk(s) + C[s,t]) + (log P_beta(t)
// - F(t) + LL)). Every term is a posterior (<= 1), so each is one exp of a
// sum of finite numbers; a state with no path has P = 0 and drops out as
// exp(-inf) (IEEE -inf, never +inf, so no NaN). A pair with g_b = 0 or no
// path (LL <= NEG_INF / 2, where exp(... + 1e30) would overflow) is
// skipped.
//
// What bounds it on this card: the bytes of the two lattices (each read
// once: 2 x 848 MB for prot2dna's 128 pairs of 64 x 192, 0.51 ms at 3.35
// TB/s); its arithmetic is one exp and a few adds a finite term (~260 a
// cell at prot2dna, 0.026 ms at the float32 peak). A dense tensor-core
// form would do the 4 S^2 products of a cell, ~270 times the finite
// terms, for an arithmetic bound already 20 times below the bytes'. The
// cells are independent (both lattices are given), so every cell of every
// pair can run at once.
//
// Design (expected_counts_kernel; the plan is
// ops/kernels/counts_kernel.py::counts_launch_plan):
//  * Compact tables: one list a matrix of its finite entries sorted by
//    destination (8 bytes: a key, the log value), and the transposed list
//    sorted by source, with per-matrix offsets; an entry's place in the
//    forward lists is its index among the finite entries. The key's bits
//    0-9 hold the state the list is sorted by, 10-14 the lane of the last
//    entry of its run (same state) in its group of 32 entries, 15 whether
//    it starts its run in the group, 16-25 the other state, 26-28 the
//    shuffle steps the group's longest run needs. Staged once a block in
//    shared memory where they fit (prot2dna: ~7 KB), else read through
//    L1/L2.
//  * A warp takes units of T consecutive cells (a strip) over R rows:
//    units (pair, rows, strip) u = gw, gw + G, ... for the warp's global
//    index gw of G, so the cells of any batch, one pair too, spread over
//    every block. It keeps three row slots of each lattice in shared
//    memory (F at o-1, o and o+1; Bk at o, o+1 and o+2, each slot the
//    strip's T cells and its neighbour), each row copied once a unit by
//    cp.async.bulk (the copy engine, 1D) on one mbarrier, the next row's
//    copies running under this row's arithmetic. The bytes staged a cell
//    are 2 (T+1)(R+1)/(T R) cell vectors, the staging's L2 traffic that
//    bounds the kernel's frame (PERF.md).
//  * Lanes over entries: a list's lane l takes entries l, l + 32, ...; a
//    term's sum into its destination (P_U) or source (P_beta) is a
//    segmented sum over its run in the group by shuffles in a fixed tree
//    (as many steps as the group's longest run needs), added by the run's
//    first lane: no lane idles on an empty column, and the sums never
//    depend on timing. A cell's incoming and outgoing lists of one kind
//    (a_up, A_diag, a_left) are walked together, their chains
//    overlapping.
//  * The closure's diagonal terms (S of prot2dna's 192 closure entries:
//    (I - N)^-1 has every diagonal entry) are taken in the log pass, from
//    the state's lu and lb in registers, the list leading with them.
//  * Sums in registers: the closure's entries (the same in every cell) sum
//    in registers over the warp's cells, and a_up[y_o]'s (the same along a
//    row) over a row of the strip; the rest add
//    into the warp's float32 sums (in shared memory where the block's fit,
//    else a global scratch a warp). At the end a block adds its warps'
//    sums in warp order in float64 into its partial, and the last block to
//    finish (a ticket) adds the blocks' partials in block order in
//    float64: the same bits run to run, no atomics on the sums.
//
// Built with -DPHASE_PROFILE (a separate library), lane 0 of every warp
// sums clock64 cycles a phase into prof (warps of the grid, N_PROF).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float HALF_NEG = -5e29f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CREG = 6;   // closure entries a lane sums in registers
constexpr int UREG = 4;   // a_up[y] entries a lane sums in registers
constexpr int DREG = 5;   // closure diagonal entries a lane sums there
constexpr unsigned long long WAIT_NS = 20000000000ull;   // 20 s

// profile slots: units and cells a warp, then its cycles in each phase:
// the lists (the pair's lengths and tokens and the copies' issue), the
// lattice values (the wait for the staged strip), the emitting terms
// (exps, sums), the logs of P_U and P_beta, the closure terms, the
// reduction (the warps' and blocks' sums)
enum { P_UNITS, P_CELLS, P_LIST, P_LOAD, P_EMIT, P_LOG, P_CLOSURE,
       P_REDUCE, N_PROF };

struct Prof {
#ifdef PHASE_PROFILE
  long long pr[N_PROF];
  long long tp;
  __device__ void start() {
    for (int q = 0; q < N_PROF; ++q) pr[q] = 0;
    __syncwarp();
    tp = clock64();
  }
  __device__ __forceinline__ void mark(int slot) {
    __syncwarp();
    const long long t = clock64();
    pr[slot] += t - tp;
    tp = t;
  }
  __device__ __forceinline__ void count(int slot) { ++pr[slot]; }
  __device__ void write(long long* prof, size_t row) {
    if ((threadIdx.x & 31) == 0)
      for (int q = 0; q < N_PROF; ++q) prof[row * N_PROF + q] = pr[q];
  }
#else
  __device__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count(int) {}
  __device__ void write(long long*, size_t) {}
#endif
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// IEEE minus infinity: exp of it is 0, and it meets no +inf here
__device__ __forceinline__ float ninf() { return __int_as_float(0xff800000); }

// exp and log by the SFU's base-2 approximations, results below float32's
// normal range flushed to 0 (a term that small adds nothing to a count)
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
__device__ __forceinline__ float flog(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y * 0.6931471805599453f;
}

// ------------------------------------------------------------- the strips

struct Params {
  const int* off_f;      // (n_mat + 1): matrix m's entries are
  const uint2* ent_f;    //   ent_f[off_f[m] .. off_f[m+1]), by destination
  const int* off_t;      // the transposed lists, by source
  const uint2* ent_t;
  const float* F;        // (B, Lo+1, Li+1, S) Forward, post-closure
  const float* Br;       // (B, Lo+1, Li+1, S) Backward of reversed prefixes
  const int* in_toks;    // (B, Li)
  const int* out_toks;   // (B, Lo)
  const int* in_lens;    // (B,)
  const int* out_lens;   // (B,)
  const float* g;        // (B,) each pair's weight
  float* acc_g;          // (blocks * warps, n_fin) when the sums are global
  double* partial;       // (blocks, n_fin)
  double* out;           // (n_fin,)
  unsigned* ticket;      // zeroed by the caller
  long long* prof;       // (blocks * warps, N_PROF) with PHASE_PROFILE
  int B, Li, Lo, S, n_in, n_out, n_mat, n_fin, cdiag, T, R, warps;
};

// A block's shared memory, in bytes from its start: the warps' mbarriers
// (one each), their staging slots (six rows of seg floats: three of F,
// three of Bk),
// the tables where shared, the warps' workspaces (P_U, P_beta), the warps'
// sums where shared.
struct Layout {
  size_t bars, stage, tabs, ws, acc, total;
  int seg, sp;
};

__host__ __device__ inline Layout layout(int S, int T, int warps, int n_mat,
                                         int n_fin, int tables_shared,
                                         int acc_shared) {
  Layout L;
  // a segment: (T+1) cells of S floats, plus up to 3 floats each side
  // where a copy's ends are rounded out to 16 bytes
  L.seg = ((T + 1) * S + 8 + 3) & ~3;
  L.sp = (S + 3) & ~3;
  size_t o = 0;
  L.bars = o;
  o += (size_t)warps * 8;
  o = (o + 15) & ~(size_t)15;
  L.stage = o;
  o += (size_t)warps * 6 * L.seg * 4;
  L.tabs = o;
  if (tables_shared) {
    o += 2 * (size_t)(n_mat + 1) * 4;
    o = (o + 7) & ~(size_t)7;
    o += 2 * (size_t)n_fin * 8;
  }
  o = (o + 15) & ~(size_t)15;
  L.ws = o;
  o += (size_t)warps * 2 * L.sp * 4;
  L.acc = o;
  if (acc_shared) o += (size_t)warps * n_fin * 4;
  L.total = o;
  return L;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
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
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// waits for the phase of `parity`; a copy that has not landed after
// WAIT_NS of the card's global timer (a fault) traps instead of hanging
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  unsigned long long t0 = 0;
  for (unsigned n = 1;; ++n) {
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
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"((unsigned long long)src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 16-byte-aligned range around n floats at src: its start, its bytes,
// and the floats before src in it (the allocation holds the rounded range:
// a page boundary is 16-byte aligned, and the wrapper gives aligned bases)
struct Span {
  const char* a0;
  unsigned bytes;
  int shift;
};
__device__ __forceinline__ Span span(const float* src, int n) {
  const uintptr_t a = (uintptr_t)src;
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const uintptr_t a1 = (a + 4 * (uintptr_t)n + 15) & ~(uintptr_t)15;
  return {(const char*)a0, (unsigned)(a1 - a0), (int)((a - a0) >> 2)};
}

// A row segment staged in a slot: where its first cell lands (the copy's
// rounding shift in floats).
__device__ __forceinline__ int stage_row(float* slot, const float* src, int n,
                                         unsigned long long* bar, int lane) {
  const Span sp = span(src, n);
  if (lane == 0) bulk_copy(slot, sp.a0, sp.bytes, bar);
  return sp.shift;
}

__device__ __forceinline__ unsigned key_state(unsigned k) { return k & 0x3ff; }
__device__ __forceinline__ unsigned key_other(unsigned k) {
  return (k >> 16) & 0x3ff;
}

// Two lists of a cell's emitting terms walked together: an incoming list
// (forward, entries [bi, bi + ni) of ef: each term exp((fi[k] + A[k,j]) +
// (Bc[j] - LL)), fi the source neighbour's F, summed into P_U[j]) and an
// outgoing one (transposed, [bo, bo + no) of et: exp((bo_[u] + A[t,u]) +
// (Fc[t] - LL)), bo_ the fed cell's Bk, summed into P_beta[t]); their
// chains are independent, so their loads, exps and shuffles overlap. An
// incoming term, times the pair's weight, goes into its entry's sum: the
// first NR groups' into the lane's registers racc, the rest into the
// warp's sums acc. A group's terms are added over their runs (the lanes up
// to the key's last lane, all with the key's state) by a fixed shuffle
// tree of as many steps as the group's longest run needs (the key's bits
// 26-28), and each run's first lane adds its sum into P[state].
template <int NR>
__device__ __forceinline__ void emit_pair(
    const uint2* __restrict__ ef, int bi, int ni, const float* __restrict__ fi,
    const uint2* __restrict__ et, int bo, int no, const float* __restrict__ bk,
    const float* __restrict__ Bc, const float* __restrict__ Fc, float LL,
    float gb, float* racc, float* acc, float* PU, float* PB, int lane) {
  const int n = max(ni, no);
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int k = k0 + lane;
    float ti = 0.f, to = 0.f;
    unsigned ki = 0u, ko = 0u;
    if (k < ni) {
      const uint2 e = ef[bi + k];
      ki = e.x;
      ti = fexp((fi[key_other(ki)] + __uint_as_float(e.y)) +
                (Bc[key_state(ki)] - LL));
      const float gt = gb * ti;
      bool reg = false;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (k0 == 32 * r) {
          racc[r] += gt;
          reg = true;
        }
      if (!reg) acc[bi + k] += gt;
    }
    if (k < no) {
      const uint2 e = et[bo + k];
      ko = e.x;
      to = fexp((bk[key_other(ko)] + __uint_as_float(e.y)) +
                (Fc[key_state(ko)] - LL));
    }
    const int steps = __shfl_sync(
        FULL, (int)max((ki >> 26) & 7u, (ko >> 26) & 7u), 0);
    const int tail_i = (ki >> 10) & 31, tail_o = (ko >> 10) & 31;
    for (int d = 1; d < (1 << steps); d <<= 1) {
      const float vi = __shfl_down_sync(FULL, ti, d);
      const float vo = __shfl_down_sync(FULL, to, d);
      if (lane + d <= tail_i) ti += vi;
      if (lane + d <= tail_o) to += vo;
    }
    if (ki & 0x8000u) PU[key_state(ki)] += ti;
    if (ko & 0x8000u) PB[key_state(ko)] += to;
    __syncwarp();
  }
}

// Zeroes a warp's P_U and P_beta (S floats each, 16-byte aligned, room
// for S rounded up to 4).
__device__ __forceinline__ void zero_pair(float* PU, float* PB, int S) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 4 * (threadIdx.x & 31); s < S; s += 128) {
    *(float4*)(PU + s) = z;
    *(float4*)(PB + s) = z;
  }
  __syncwarp();
}

// One state's logs: lu = log P_U - Bk into PU, lb = (log P_beta - F) + LL
// into PB (-inf where P is 0); returns the closure's diagonal term
// exp((lu + C[s,s]) + lb) for the diagonal value cs.
__device__ __forceinline__ float log_state(float* PU, float* PB,
                                          const float* __restrict__ Bc,
                                          const float* __restrict__ Fc,
                                          float LL, int s, float cs) {
  const float pu = PU[s], pb = PB[s];
  const float lu = pu > 0.f ? flog(pu) - Bc[s] : ninf();
  const float lb = pb > 0.f ? (flog(pb) - Fc[s]) + LL : ninf();
  PU[s] = lu;
  PB[s] = lb;
  return fexp((lu + cs) + lb);
}

// lu and lb of every state (log_state), lane l taking states l + 32 q.
// Where the closure's list leads with its S diagonal entries (cd, else
// null), each state's diagonal term, times the pair's weight, goes into
// that entry's sum: for q < DREG the lane's registers dacc, else csum
// (the warp's sums of the closure's entries).
__device__ __forceinline__ void log_pair(float* PU, float* PB,
                                         const float* __restrict__ Bc,
                                         const float* __restrict__ Fc,
                                         float LL, int S, int lane,
                                         const uint2* __restrict__ cd,
                                         float gb, float* dacc,
                                         float* csum) {
  if (cd == nullptr) {
#pragma unroll 4
    for (int s = lane; s < S; s += 32)
      log_state(PU, PB, Bc, Fc, LL, s, ninf());
    return;
  }
#pragma unroll
  for (int q = 0; q < DREG; ++q) {
    const int s = lane + 32 * q;
    if (s < S)
      dacc[q] += gb * log_state(PU, PB, Bc, Fc, LL, s,
                                __uint_as_float(cd[s].y));
  }
  for (int s = lane + 32 * DREG; s < S; s += 32)
    csum[s] += gb * log_state(PU, PB, Bc, Fc, LL, s,
                              __uint_as_float(cd[s].y));
}

// TS: the tables staged in shared memory; AS: the warps' sums there (each
// an instantiation, so every access names its memory)
template <bool TS, bool AS>
__global__ void __launch_bounds__(512)
expected_counts_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int S = p.S, Li = p.Li, Lo = p.Lo, T = p.T;
  const int n_io = p.n_in * p.n_out;
  const int m_cl = p.n_mat - 1;
  const Layout L = layout(S, T, p.warps, p.n_mat, p.n_fin, TS, AS);
  Prof pf;
  pf.start();

  // -- the tables, staged once a block where they fit
  const int no = p.n_mat + 1;
  int* so = (int*)(smem_raw + L.tabs);
  uint2* se =
      (uint2*)(smem_raw + ((L.tabs + 2 * (size_t)no * 4 + 7) & ~(size_t)7));
  if (TS) {
    for (int k = tid; k < no; k += blockDim.x) {
      so[k] = p.off_f[k];
      so[no + k] = p.off_t[k];
    }
    for (int k = tid; k < p.n_fin; k += blockDim.x) {
      se[k] = p.ent_f[k];
      se[p.n_fin + k] = p.ent_t[k];
    }
  }
  const int* off_f = TS ? so : p.off_f;
  const int* off_t = TS ? so + no : p.off_t;
  const uint2* ent_f = TS ? se : p.ent_f;
  const uint2* ent_t = TS ? se + p.n_fin : p.ent_t;
  unsigned long long* bar = (unsigned long long*)(smem_raw + L.bars) + w;
  float* stage = (float*)(smem_raw + L.stage) + (size_t)w * 6 * L.seg;
  float* PU = (float*)(smem_raw + L.ws) + (size_t)w * 2 * L.sp;
  float* PB = PU + L.sp;
  const size_t gw = (size_t)blockIdx.x * p.warps + w;
  float* acc = AS ? (float*)(smem_raw + L.acc) + (size_t)w * p.n_fin
                 : p.acc_g + gw * p.n_fin;
  for (int e = lane; e < p.n_fin; e += 32) acc[e] = 0.f;
  if (lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the closure's entries: its diagonal ones (leading its list where
  // cdiag) taken in the log pass, the rest here; their sums in registers
  const int c_all = off_f[m_cl];
  const uint2* cd = p.cdiag ? ent_f + c_all : nullptr;
  const int nd = p.cdiag ? S : 0;
  const int c_beg = c_all + nd, c_n = off_f[m_cl + 1] - c_beg;
  float cacc[CREG], dacc[DREG];
#pragma unroll
  for (int r = 0; r < CREG; ++r) cacc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < DREG; ++r) dacc[r] = 0.f;

  const size_t plane = (size_t)(Li + 1) * S;
  const size_t lat = (size_t)(Lo + 1) * plane;
  const int R = p.R;
  const int nstrip = (Li + 1 + T - 1) / T;
  const int nchunk = (Lo + 1 + R - 1) / R;
  const size_t per_pair = (size_t)nchunk * nstrip;
  const size_t units = (size_t)p.B * per_pair;
  const size_t G = (size_t)gridDim.x * p.warps;
  const int seg = L.seg;
  unsigned phase = 0u;
  int cb = -1, il = 0, ol = 0;
  float LL = 0.f, gb = 0.f;
  pf.mark(P_LIST);

  // unit u: the strip of T cells i0.. of pair b over rows o0 .. o1 - 1. The
  // warp keeps three row slots of each lattice: F at o - 1, o and (loading)
  // o + 1; Bk at o, o + 1 and (loading) o + 2, so each row is staged once
  // a unit, the next row's copies running under this row's arithmetic. A
  // slot is rewritten by the copy engine only after the warp's last read
  // of it (the __syncwarp ending each cell); the copy engine reads nothing
  // the threads wrote, so no proxy fence is needed.
  for (size_t u = gw; u < units; u += G) {
    const int b = (int)(u / per_pair);
    const int rr = (int)(u - (size_t)b * per_pair);
    const int c = rr / nstrip, i0 = (rr - c * nstrip) * T;
    if (b != cb) {
      cb = b;
      il = clampi(p.in_lens[b], 0, Li);
      ol = clampi(p.out_lens[b], 0, Lo);
      gb = p.g[b];
      LL = p.F[(size_t)b * lat + (size_t)ol * plane + (size_t)il * S + S - 1];
    }
    const int o0 = c * R;
    if (!(gb != 0.f && LL > HALF_NEG && o0 <= ol && i0 <= il)) continue;
    pf.count(P_UNITS);
    const int o1 = min(o0 + R, ol + 1);
    const int ie = min(i0 + T - 1, il);
    const int q = i0 - 1 + lane;
    const int tx = (lane <= T && q >= 0 && q < il)
                       ? clampi(p.in_toks[(size_t)b * Li + q], 0, p.n_in - 1)
                       : 0;
    const int* yt = p.out_toks + (size_t)b * Lo;
    // the strip's cells in F (lo_f ..) and in Br (lo_r ..: Bk(i) is Br at
    // il - i, for i0 .. min(ie + 1, il))
    const int lo_f = max(i0 - 1, 0);
    const int lo_r = il - min(ie + 1, il);
    const int nf = (ie - lo_f + 1) * S, nr = (il - i0 - lo_r + 1) * S;
    const float* fb = p.F + (size_t)b * lat + (size_t)lo_f * S;
    const float* rb = p.Br + (size_t)b * lat + (size_t)lo_r * S;
    float* fu = stage;                  // F(., o - 1)
    float* fc = stage + seg;            // F(., o)
    float* fn = stage + 2 * seg;        // F(., o + 1), loading
    float* bc = stage + 3 * seg;        // Bk(., o)
    float* bu = stage + 4 * seg;        // Bk(., o + 1)
    float* bn = stage + 5 * seg;        // Bk(., o + 2), loading
    int sfu = 0, sfc, sfn = 0, sbc, sbu = 0, sbn = 0;
    {
      // the expected bytes first: span() is pure, so the arrival count is
      // known before any copy lands
      unsigned want = span(fb + (size_t)o0 * plane, nf).bytes +
                      span(rb + (size_t)(ol - o0) * plane, nr).bytes;
      if (o0 > 0) want += span(fb + (size_t)(o0 - 1) * plane, nf).bytes;
      if (o0 < ol) want += span(rb + (size_t)(ol - o0 - 1) * plane, nr).bytes;
      if (lane == 0) mbar_expect(bar, want);
      if (o0 > 0)
        sfu = stage_row(fu, fb + (size_t)(o0 - 1) * plane, nf, bar, lane);
      sfc = stage_row(fc, fb + (size_t)o0 * plane, nf, bar, lane);
      sbc = stage_row(bc, rb + (size_t)(ol - o0) * plane, nr, bar, lane);
      if (o0 < ol)
        sbu = stage_row(bu, rb + (size_t)(ol - o0 - 1) * plane, nr, bar, lane);
    }
    int y = o0 > 0 ? clampi(yt[o0 - 1], 0, p.n_out - 1) : 0;
    int y1 = o0 < ol ? clampi(yt[o0], 0, p.n_out - 1) : 0;
    pf.mark(P_LIST);
    mbar_wait(bar, phase);
    phase ^= 1u;
    pf.mark(P_LOAD);
    for (int o = o0; o < o1; ++o) {
      // the next row's copies, and its output token
      const bool more = o + 1 < o1;
      int y2 = 0;
      if (more) {
        unsigned want = span(fb + (size_t)(o + 1) * plane, nf).bytes;
        if (o + 2 <= ol)
          want += span(rb + (size_t)(ol - o - 2) * plane, nr).bytes;
        if (lane == 0) mbar_expect(bar, want);
        sfn = stage_row(fn, fb + (size_t)(o + 1) * plane, nf, bar, lane);
        if (o + 2 <= ol)
          sbn = stage_row(bn, rb + (size_t)(ol - o - 2) * plane, nr, bar,
                          lane);
        if (o + 1 < ol) y2 = clampi(yt[o + 1], 0, p.n_out - 1);
      }
      pf.mark(P_LIST);
      const int m_up = n_io + p.n_in + y, m_up1 = n_io + p.n_in + y1;
      const int up_beg = off_f[m_up], up_n = off_f[m_up + 1] - up_beg;
      const int up1_beg = off_t[m_up1], up1_n = off_t[m_up1 + 1] - up1_beg;
      float uacc[UREG];
#pragma unroll
      for (int r = 0; r < UREG; ++r) uacc[r] = 0.f;
      for (int i = i0; i <= ie; ++i) {
        pf.count(P_CELLS);
        const int k = i - i0;
        const int x = __shfl_sync(FULL, tx, k);
        const int x1 = __shfl_sync(FULL, tx, k + 1);
        const float* Fc = fc + sfc + (size_t)(i - lo_f) * S;
        const float* Fu = fu + sfu + (size_t)(i - lo_f) * S;
        const float* Bc = bc + sbc + (size_t)(il - i - lo_r) * S;
        const float* Bu = bu + sbu + (size_t)(il - i - lo_r) * S;
        zero_pair(PU, PB, S);
        if (i == 0 && o == 0 && lane == 0) PU[0] = fexp(Bc[0] - LL);
        __syncwarp();
        // -- the emitting terms: through a_up (in, and out to the next
        // row), A_diag and a_left, into P_U (incoming) and P_beta
        // (outgoing)
        emit_pair<UREG>(ent_f, up_beg, o > 0 ? up_n : 0, Fu, ent_t,
                        up1_beg, o < ol ? up1_n : 0, Bu, Bc, Fc, LL, gb, uacc,
                        acc, PU, PB, lane);
        {
          const int md = x * p.n_out + y, md1 = x1 * p.n_out + y1;
          const int bi = off_f[md], bo = off_t[md1];
          emit_pair<0>(ent_f, bi, o > 0 && i > 0 ? off_f[md + 1] - bi : 0,
                       Fu - S, ent_t, bo,
                       o < ol && i < il ? off_t[md1 + 1] - bo : 0, Bu - S, Bc,
                       Fc, LL, gb, nullptr, acc, PU, PB, lane);
        }
        {
          const int ml = n_io + x, ml1 = n_io + x1;
          const int bi = off_f[ml], bo = off_t[ml1];
          emit_pair<0>(ent_f, bi, i > 0 ? off_f[ml + 1] - bi : 0, Fc - S,
                       ent_t, bo, i < il ? off_t[ml1 + 1] - bo : 0, Bc - S,
                       Bc, Fc, LL, gb, nullptr, acc, PU, PB, lane);
        }
        if (i == il && o == ol && lane == 0)
          PB[S - 1] += fexp(Fc[S - 1] - LL);
        __syncwarp();
        pf.mark(P_EMIT);
        // -- lu(s) = log P_U(s) - Bk(s), lb(t) = log P_beta(t) - F(t) + LL
        log_pair(PU, PB, Bc, Fc, LL, S, lane, cd, gb, dacc, acc + c_all);
        __syncwarp();
        pf.mark(P_LOG);
        // -- the closure's other terms exp((lu(s) + C[s,t]) + lb(t))
#pragma unroll
        for (int r = 0; r < CREG; ++r)
          if (32 * r + lane < c_n) {
            const uint2 e = ent_f[c_beg + 32 * r + lane];
            cacc[r] += gb * fexp((PU[key_other(e.x)] +
                                    __uint_as_float(e.y)) +
                                   PB[key_state(e.x)]);
          }
        for (int kk = 32 * CREG + lane; kk < c_n; kk += 32) {
          const uint2 e = ent_f[c_beg + kk];
          acc[c_beg + kk] += gb * fexp((PU[key_other(e.x)] +
                                          __uint_as_float(e.y)) +
                                         PB[key_state(e.x)]);
        }
        __syncwarp();
        pf.mark(P_CLOSURE);
      }
      if (o > 0) {
#pragma unroll
        for (int r = 0; r < UREG; ++r)
          if (32 * r + lane < up_n) acc[up_beg + 32 * r + lane] += uacc[r];
      }
      __syncwarp();
      pf.mark(P_EMIT);
      if (more) {
        mbar_wait(bar, phase);
        phase ^= 1u;
        float* t = fu;
        fu = fc;
        fc = fn;
        fn = t;
        sfu = sfc;
        sfc = sfn;
        t = bc;
        bc = bu;
        bu = bn;
        bn = t;
        sbc = sbu;
        sbu = sbn;
        y = y1;
        y1 = y2;
        pf.mark(P_LOAD);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < CREG; ++r)
    if (32 * r + lane < c_n) acc[c_beg + 32 * r + lane] += cacc[r];
#pragma unroll
  for (int r = 0; r < DREG; ++r)
    if (32 * r + lane < nd) acc[c_all + 32 * r + lane] += dacc[r];
  __syncthreads();
  pf.mark(P_CLOSURE);
  // the block's sum over its warps, in warp order, then the blocks' in
  // block order by the last block to finish
  const float* accb = AS ? (const float*)(smem_raw + L.acc)
                         : p.acc_g + (size_t)blockIdx.x * p.warps * p.n_fin;
  for (int e = tid; e < p.n_fin; e += blockDim.x) {
    double s = 0.0;
    for (int q = 0; q < p.warps; ++q)
      s += (double)accb[(size_t)q * p.n_fin + e];
    p.partial[(size_t)blockIdx.x * p.n_fin + e] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    for (int e = tid; e < p.n_fin; e += blockDim.x) {
      double s = 0.0;
      for (unsigned q = 0; q < gridDim.x; ++q)
        s += __ldcg(p.partial + (size_t)q * p.n_fin + e);
      p.out[e] = s;
    }
  }
  pf.mark(P_REDUCE);
  pf.write(p.prof, gw);
}

}  // namespace

// A block's shared bytes of the strips kernel (its dynamic shared memory).
extern "C" long long expected_counts_smem_bytes(int S, int T, int warps,
                                                int n_mat, int n_fin,
                                                int tables_shared,
                                                int acc_shared) {
  return (long long)layout(S, T, warps, n_mat, n_fin, tables_shared,
                           acc_shared)
      .total;
}

// Launches the strips kernel on `stream`: `blocks` blocks of `warps`
// warps, units of T cells a row over R rows; cdiag: the closure's list
// leads with its S diagonal entries. off_f, ent_f, off_t, ent_t: the
// compact lists (counts_tables; ent 8-byte aligned); F, Br: float32 (B,
// Lo+1, Li+1, S),
// 16-byte aligned; tokens, lengths int32; g float32 (B,); acc_g: (blocks *
// warps, n_fin) float32 when acc_shared is 0, else null; partial (blocks,
// n_fin) and out (n_fin) float64; ticket one zeroed unsigned; prof (blocks
// * warps, N_PROF) int64 for the profile library, else null. Returns
// cudaGetLastError() or the launch's error: nonzero means the launch was
// refused.
extern "C" int expected_counts_launch(
    const void* off_f, const void* ent_f, const void* off_t,
    const void* ent_t, const void* F, const void* Br, const void* in_toks,
    const void* out_toks, const void* in_lens, const void* out_lens,
    const void* g, void* acc_g, void* partial, void* out, void* ticket,
    void* prof, int B, int Li, int Lo, int S, int n_in, int n_out, int n_mat,
    int n_fin, int cdiag, int T, int R, int warps, int blocks,
    int tables_shared, int acc_shared, void* stream) {
  const bool ok =
      B >= 1 && Li >= 0 && Lo >= 0 && S >= 1 && S <= 512 && n_in >= 1 &&
      n_out >= 1 && n_mat == n_in * n_out + n_in + n_out + 1 && n_fin >= 1 &&
      T >= 1 && T <= 31 && R >= 1 && warps >= 1 && warps <= 16 &&
      blocks >= 1 &&
      (acc_shared || acc_g != nullptr) && partial != nullptr &&
      out != nullptr && ticket != nullptr &&
      ((uintptr_t)F & 15) == 0 && ((uintptr_t)Br & 15) == 0 &&
      ((uintptr_t)ent_f & 7) == 0 && ((uintptr_t)ent_t & 7) == 0;
#ifdef PHASE_PROFILE
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
#endif
  if (!ok) return (int)cudaErrorInvalidValue;
  Params a{(const int*)off_f, (const uint2*)ent_f, (const int*)off_t,
           (const uint2*)ent_t, (const float*)F, (const float*)Br,
           (const int*)in_toks, (const int*)out_toks, (const int*)in_lens,
           (const int*)out_lens, (const float*)g, (float*)acc_g,
           (double*)partial, (double*)out, (unsigned*)ticket,
           (long long*)prof, B, Li, Lo, S, n_in, n_out, n_mat, n_fin, cdiag,
           T, R, warps};
  const size_t smem =
      layout(S, T, warps, n_mat, n_fin, tables_shared, acc_shared).total;
  void (*kern)(Params) =
      tables_shared ? (acc_shared ? expected_counts_kernel<true, true>
                                  : expected_counts_kernel<true, false>)
                    : (acc_shared ? expected_counts_kernel<false, true>
                                  : expected_counts_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
