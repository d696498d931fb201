// The row engine of the pairwise (2D) DP, for Hopper (sm_90a).
//
// Replaces the jitted row scans of machineboss_tpu/ops/dp2d.py (no
// pallas_call: XLA compiles each into one program): forward_2d,
// forward_2d_lattice and backward_2d_lattice (:103-127), an outer lax.scan
// over output rows (:98) around the inner lax.scan over input positions
// (_row_scan, :37-49), and forward_2d_banded (:144-200, _row_scan_banded).
// One launch computes, for every pair b of a batch,
//   cell(o,i) = ( cell(o-1,i) (x) A_up[y_o]  (+)  cell(o-1,i-1) (x)
//                 A_diag[x_i,y_o]  (+)  cell(o,i-1) (x) A_left[x_i] ) (x) C
// with cell(0,0) = start (x) C, the three neighbour terms combined first
// and the closure C applied once a cell, as the JAX engine orders them;
// with a band, cell(o,i) = zero unless in_start[o] <= i < in_end[o]
// (inside the recurrence, as _row_scan_banded does). The output is the
// score cell(in_len, out_len, S-1) of each pair (its cells up to those
// lengths: nothing past them feeds that cell) or the whole (Lo+1, Li+1, S)
// lattice of each pair. Backward is the caller's: transposed matrices,
// reversed tokens and the end state's start vector, then the lattice
// flipped. Tokens outside the alphabet are clamped to it, lengths to the
// padded shape, as the JAX package's gathers clamp their indices.
//
// What bounds it on this card: the dependence between cells. Every
// neighbour of cell (o,i) lies on anti-diagonal d-1 or d-2 (d = o+i), so a
// pair is Li+Lo+1 dependent steps, one a diagonal, and each step is a
// handful of short sums: the machines the row engine serves have few
// finite entries (prot2dna: ~230 a cell of 4 S^2 = 69,696), so a cell is
// some 3-4 S exps and logs and a few hundred multiply-adds, and the step's
// latency and its barrier, not the card's rates, set the pace.
//
// Design (the launch plan is ops/kernels/row_kernel.py::row_launch_plan):
//  * Anti-diagonals. A block (or a cluster of blocks) walks a pair one
//    diagonal at a time, one block barrier a diagonal; a warp takes one
//    cell at a time, a lane the destinations j = lane, lane + 32, ...
//  * Prepared exponentials, the plain version's arithmetic (sr.prepare /
//    vecmat_prepared): every matrix column j is kept as exp(M[:, j] -
//    colmax_j) with its shift colmax_j, and every stored cell as
//    exp(cell - max cell) with its max, so a logsumexp term is one FMA, a
//    source value one exp (when its cell is written) and a destination one
//    log: log(sum) + max + colmax_j, the neighbour sums combined by
//    logaddexp. Max-plus keeps the float32 sums and maxes of the same
//    terms, so it is bit-equal to the plain version on every live cell.
//  * Finite entries only. Each column's sources with a finite entry, in
//    ELL slices of 32 destinations (one 8-byte (source, value) a lane a
//    row, the slice's first row the lanes' shifts), built once per set of
//    operand tensors by the wrapper. An omitted entry adds exp(-1e30 - m)
//    = 0 to a logsumexp sum and never beats a live max-plus term, so this
//    is exact. A destination with no finite term is NEG_INF.
//  * A cluster of blocks a pair where the batch leaves the card idle: the
//    input positions 0..in_len split into contiguous ranges, one a block,
//    fixed for the whole walk, so a block needs only its left neighbour's
//    last cell of diagonals d-1 and d-2, which that block stores into this
//    one's inbox (a ring of BOX slots) by st.async as it writes the cell,
//    counted on the slot's mbarrier: a block waits only for that cell, and
//    frees the slot to its neighbour once the cell has come and its last
//    reader is past (whether or not a band let the cell be read), so
//    blocks run at most two diagonals apart with no cluster barrier (one a diagonal spent ~5,000
//    cycles of the ~14,000 a diagonal took), and no remote read stalls a
//    cell.
//  * The last two diagonals and the current one (a ring of three slots):
//    in shared memory where a block's range fits ("shared"), else in the
//    pair's global scratch ("global": a cell's three neighbours staged
//    through L2 into the warp's workspace, and one cluster barrier a
//    diagonal), so no length is refused below the card's memory. A
//    lattice call writes every cell's log values to the lattice beside
//    the ring. The lists in shared memory where they fit beside it, else
//    read through L1/L2.
//
// Built with -DPHASE_PROFILE (a separate library), lane 0 of every warp
// sums clock64 cycles a phase into prof (B, N_PROF).

#include <cuda_runtime.h>
#include <stdint.h>

#include "viterbi_common.cuh"   // the cluster helpers

namespace {

using viterbi::cluster_rank;
using viterbi::cluster_sync;
using viterbi::peer_addr;

constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG = -5e29f;
constexpr float TINY = 1.17549435e-38f;   // torch.finfo(float32).tiny
constexpr int BOX = 4;          // inbox slots: a neighbour runs <= 2 ahead
constexpr int BAR_BYTES = 2 * BOX * 8;    // the inbox's mbarriers
constexpr unsigned long long WAIT_NS = 20000000000ull;   // 20 s

// profile slots: diagonals (a block's), cells (a warp's), then the warps'
// cycles in each phase: the neighbour loads (the tokens, and the cells
// staged into the warp's workspace), the three neighbour products, the
// closure's source vector (its max and exps), the block or cluster
// barrier, the closure product, the writes
enum { P_DIAG, P_CELLS, P_LOAD, P_PROD, P_SCALE, P_BARRIER, P_CLOSURE,
       P_WRITE, N_PROF };

struct Params {
  const int2* tab;       // headers (n_mat * nsl: offset, rows), then entries
  const float* start;    // (S,)
  const int* in_toks;    // (B, Li)
  const int* out_toks;   // (B, Lo)
  const int* in_lens;    // (B,), read in score mode
  const int* out_lens;   // (B,), read in score mode
  const int* band;       // (B, 2, Lo+1): in_start rows, then in_end rows
  float* out;            // (B,) scores or (B, Lo+1, Li+1, S) lattices
  float* ring;           // (B, 3, Li+1, S+1) when the ring is "global"
  long long* prof;       // (B, N_PROF) with PHASE_PROFILE
  int n_hdr, n_tab, tab_shared;
  int B, Li, Lo, S, n_in, n_out, csize, ncb, lattice;
};

__device__ __forceinline__ long long pclock() {
#ifdef PHASE_PROFILE
  __syncwarp();
  return clock64();
#else
  return 0;
#endif
}

// IEEE minus infinity: the max's start, below every finite term
__device__ __forceinline__ float ninf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// semiring.py's _safe: a vector's shift, 0 when it is all impossible
__device__ __forceinline__ float safe(float m) {
  return m > HALF_NEG ? m : 0.f;
}

// torch.logaddexp's float32 formula; an impossible (NEG_INF) side leaves
// the other as the formula does (x + log1p(exp(-1e30 - x)) == x)
__device__ __forceinline__ float lae(float a, float b) {
  if (a <= HALF_NEG) return b;
  if (b <= HALF_NEG) return a;
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// The inbox's mbarriers: full[k] completes when slot k holds its cell
// (the bytes of the left neighbour's st.async stores), empty[k] (in the
// left neighbour) when this block has read it for the last time.
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
__device__ __forceinline__ void mbar_arrive_peer(unsigned addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          addr)
      : "memory");
}
// waits for the phase of `parity` to complete. A signal that has not come
// after WAIT_NS of the card's global timer (a fault: the longest wait, a
// block's first while the cluster's pipeline fills, is some thousands of
// diagonals of a ring that fits shared memory, well under a second) traps
// instead of hanging the card.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  unsigned long long t0 = 0;
  for (unsigned n = 1;; ++n) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
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
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(addr), "f"(v), "r"(bar)
      : "memory");
}

// One destination j = 32 r + lane of src (x) M for matrix m: src is a
// stored cell (S scaled values, then its max; max-plus: raw values).
// Logsumexp: (log(sum_k ev_k E_kj) + vmax) + colmax_j, NEG_INF for a zero
// sum, as LogSemiring.matmul_prepared takes it; max-plus: the max of the
// float32 sums v_k + M_kj. A slice without a finite entry (its count is
// the same in every lane: a uniform branch) returns at once. Lanes past S
// read the padding and are dropped by the caller.
template <bool MAX>
__device__ __forceinline__ float product(const int2* __restrict__ T,
                                         int n_hdr, int m, int nsl, int r,
                                         int lane, const float* src,
                                         float vmax) {
  const int2 h = T[m * nsl + r];
  if (h.y == 0) return NEG_INF;
  const int2* e = T + n_hdr + h.x + lane;
  float s = MAX ? ninf() : 0.f;
  const int n = h.y;
#pragma unroll 4
  for (int t = 1; t <= n; ++t) {
    const int2 q = e[t * 32];
    const float v = src[q.x];
    if (MAX)
      s = fmaxf(s, v + __int_as_float(q.y));
    else
      s = fmaf(v, __int_as_float(q.y), s);
  }
  if (MAX) return s > HALF_NEG ? s : NEG_INF;
  return s > 0.f ? (logf(fmaxf(s, TINY)) + vmax) + __int_as_float(e[0].y)
                 : NEG_INF;
}

template <bool MAX, bool GRING>
__global__ void __launch_bounds__(THREADS, 1)
row_scan_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int cs = p.csize;
  const int b = blockIdx.x / cs;
  const int rank = cs > 1 ? cluster_rank() : 0;
  const int S = p.S, Li = p.Li, Lo = p.Lo, CS = S + 1;
  const int nsl = (S + 31) >> 5;
  const int n_hdr = p.n_hdr;
  const int n_io = p.n_in * p.n_out;
  const int m_cl = n_io + p.n_in + p.n_out;

  unsigned long long* full = (unsigned long long*)smem_raw;
  unsigned long long* empty = full + BOX;
  unsigned char* after = smem_raw + BAR_BYTES;
  const int2* T = p.tab;
  float* sp = (float*)(after + (p.tab_shared ? (size_t)p.n_tab * 8 : 0));
  if (p.tab_shared) {
    int2* st = (int2*)after;
    for (int k = tid; k < p.n_tab; k += THREADS) st[k] = p.tab[k];
    T = st;
  }
  // a warp's workspace: three staged source cells (a neighbour block's or
  // the global ring's), then the closure's source vector
  float* stg = sp + (size_t)w * (4 * S + 3);
  float* tv = stg + 3 * CS;
  float* ring_s = sp + (size_t)NW * (4 * S + 3);
  // the inbox: BOX slots for the left neighbour's last cell of a diagonal,
  // stored here by that block (st.async, distributed shared memory)
  float* inbox = ring_s + 3 * (size_t)p.ncb * CS;
  const unsigned box_bytes = (unsigned)CS * 4;

  const int Lp = p.lattice ? Li : clampi(p.in_lens[b], 0, Li);
  const int Lq = p.lattice ? Lo : clampi(p.out_lens[b], 0, Lo);
  const int ncb = (Lp + cs) / cs;            // ceil((Lp + 1) / cs)
  const int a = rank * ncb, bnd = min(a + ncb, Lp + 1);
  const int* xt = p.in_toks + (size_t)b * Li;
  const int* yt = p.out_toks + (size_t)b * Lo;
  const int* bs = p.band ? p.band + (size_t)b * 2 * (Lo + 1) : nullptr;
  float* ring_g = GRING ? p.ring + (size_t)b * 3 * (Li + 1) * CS : nullptr;
  float* lat = p.lattice ? p.out + (size_t)b * (Lo + 1) * (Li + 1) * S
                         : nullptr;
  // with a shared ring, a block of a cluster waits only on its left
  // neighbour's cell (use u = d - (a - 1) of slot u % BOX) and lets it
  // reuse a slot once past its last use; the blocks exchange nothing else
  const bool boxes = !GRING && cs > 1;
  const bool consumer = boxes && rank > 0 && a <= Lp;
  const bool producer = boxes && rank + 1 < cs && a + ncb <= Lp;
  if (boxes && tid == 0) {
    for (int k = 0; k < BOX; ++k) {
      mbar_init(full + k);
      mbar_init(empty + k);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < BOX; ++k) mbar_expect(full + k, box_bytes);
  }
  long long pr[N_PROF] = {0};
  // every block of the cluster runs, its mbarriers set, before any store
  // to its shared memory
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();

  // the stored cell of diagonal dd at input position ii, ready to read:
  // this block's in its shared ring; else (its left neighbour's last, or
  // any cell of the global ring) staged into the warp's slot q
  auto source = [&](int dd, int ii, int q) -> const float* {
    const int slot = dd % 3;
    if (!GRING) {
      const int c = ii - a;
      if (c >= 0) return ring_s + ((size_t)slot * p.ncb + c) * CS;
      const int u = dd - (a - 1);
      mbar_wait(full + u % BOX, (u / BOX) & 1);
      return inbox + (size_t)(u % BOX) * CS;
    }
    // eight loads a lane in flight, then their stores
    const float* from = ring_g + ((size_t)slot * (Li + 1) + ii) * CS;
    float* to = stg + q * CS;
    for (int k0 = lane; k0 < CS; k0 += 256) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + 32 * u < CS) v[u] = __ldcg(from + k0 + 32 * u);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + 32 * u < CS) to[k0 + 32 * u] = v[u];
    }
    return to;
  };

  for (int d = 0; d <= Lp + Lq; ++d) {
    const int ilo = max(a, d - Lq), ihi = min(bnd - 1, min(d, Lp));
    for (int i = ilo + w; i <= ihi; i += NW) {
      const int o = d - i;
      long long t0 = pclock();
      const bool in_band = !bs || (i >= bs[o] && i < bs[Lo + 1 + o]);
      float cmax = 0.f;
      float* cv = stg;    // the cell's log values, over the staged cells
      if (in_band) {
        // -- the neighbour loads
        const int x = i > 0 ? clampi(xt[i - 1], 0, p.n_in - 1) : 0;
        const int y = o > 0 ? clampi(yt[o - 1], 0, p.n_out - 1) : 0;
        const float* su = o > 0 ? source(d - 1, i, 0) : nullptr;
        const float* sl = i > 0 ? source(d - 1, i - 1, 1) : nullptr;
        const float* sd = (i > 0 && o > 0) ? source(d - 2, i - 1, 2)
                                           : nullptr;
        __syncwarp();
        long long t1 = pclock();
        pr[P_LOAD] += t1 - t0;
        // -- the neighbour products, combined as the JAX engine combines
        // them, (up (+) diag) (+) left, into the closure's source vector
        float tmax = ninf();
        for (int r = 0; r < nsl; ++r) {
          const int j = 32 * r + lane;
          float t;
          if (d == 0) {
            t = j < S ? p.start[j] : NEG_INF;
          } else {
            const float up = su ? product<MAX>(T, n_hdr, n_io + p.n_in + y,
                                               nsl, r, lane, su, su[S])
                                : NEG_INF;
            const float dg = sd ? product<MAX>(T, n_hdr, x * p.n_out + y,
                                               nsl, r, lane, sd, sd[S])
                                : NEG_INF;
            const float lf = sl ? product<MAX>(T, n_hdr, n_io + x, nsl, r,
                                               lane, sl, sl[S])
                                : NEG_INF;
            t = MAX ? fmaxf(fmaxf(up, dg), lf) : lae(lae(up, dg), lf);
          }
          if (j < S) {
            tv[j] = t;
            tmax = fmaxf(tmax, t);
          }
        }
        long long t2 = pclock();
        pr[P_PROD] += t2 - t1;
        t1 = t2;
        if (!MAX) {
          tmax = safe(warp_max(tmax));
          for (int j = lane; j < S; j += 32) tv[j] = expf(tv[j] - tmax);
        }
        __syncwarp();
        t2 = pclock();
        pr[P_SCALE] += t2 - t1;
        // -- the closure product (the staged cells are dead: every lane
        // passed the __syncwarp after the products)
        float cm = ninf();
        for (int r = 0; r < nsl; ++r) {
          const int j = 32 * r + lane;
          const float c = product<MAX>(T, n_hdr, m_cl, nsl, r, lane, tv,
                                       tmax);
          if (j < S) {
            cv[j] = c;
            cm = fmaxf(cm, c);
          }
        }
        if (!MAX) cmax = safe(warp_max(cm));
        t0 = pclock();
        pr[P_CLOSURE] += t0 - t2;
      }
      // -- the writes: the stored cell (scaled, then its max), the
      // lattice's log values, the score
      float* dst = GRING ? ring_g + ((size_t)(d % 3) * (Li + 1) + i) * CS
                         : ring_s + ((size_t)(d % 3) * p.ncb + (i - a)) * CS;
      // the block's last position is its right neighbour's left edge: a
      // copy into that block's inbox, once the slot is free
      const bool send = producer && i == a + ncb - 1;
      unsigned box = 0, bar = 0;
      if (send) {
        const int u = d - i;
        if (u >= BOX) mbar_wait(empty + u % BOX, (u / BOX - 1) & 1);
        box = peer_addr(inbox + (size_t)(u % BOX) * CS, rank + 1);
        bar = peer_addr((const float*)(full + u % BOX), rank + 1);
      }
      for (int j = lane; j < S; j += 32) {
        const float c = in_band ? cv[j] : NEG_INF;
        const float v = MAX ? c : (in_band ? expf(c - cmax) : 0.f);
        dst[j] = v;
        if (send) st_async(box + 4 * j, v, bar);
        if (lat)
          lat[((size_t)o * (Li + 1) + i) * S + j] = c;
        else if (o == Lq && i == Lp && j == S - 1)
          p.out[b] = c;
      }
      if (lane == 0) {
        dst[S] = cmax;
        if (send) st_async(box + 4 * S, cmax, bar);
      }
      __syncwarp();
      pr[P_WRITE] += pclock() - t0;
      pr[P_CELLS] += 1;
    }
    __syncwarp();
    const long long tb = pclock();
    if (GRING && cs > 1)
      cluster_sync();
    else
      __syncthreads();
    // the left neighbour's cell of d - 2 was last read on d (as the
    // diagonal source): its slot goes back, armed for use u + BOX. The
    // wait comes first because the cell may not have been read at all (a
    // band can leave this block's first position out), and the slot is
    // rearmed only once its bytes have landed: so no block runs more than
    // two diagonals ahead of its left neighbour, band or not
    if (consumer && tid == 0) {
      const int u = d - 1 - a;
      if (u >= 0 && u <= Lq) {
        mbar_wait(full + u % BOX, (u / BOX) & 1);
        mbar_expect(full + u % BOX, box_bytes);
        mbar_arrive_peer(peer_addr((const float*)(empty + u % BOX),
                                   rank - 1));
      }
    }
    pr[P_BARRIER] += pclock() - tb;
  }
  // no block leaves while its left neighbour's stores may be in flight
  // (the last cell, u = Lq, is not released above when a == Lp) or while
  // a neighbour may still signal it
  if (consumer && tid == 0) mbar_wait(full + Lq % BOX, (Lq / BOX) & 1);
  if (cs > 1) cluster_sync();
#ifdef PHASE_PROFILE
  if (lane == 0) {
    if (w == 0) pr[P_DIAG] = Lp + Lq + 1;
    for (int q = 0; q < N_PROF; ++q)
      atomicAdd((unsigned long long*)&p.prof[(size_t)b * N_PROF + q],
                (unsigned long long)pr[q]);
  }
#endif
}

// A block's shared bytes: the staged lists (n_tab 8-byte entries, or
// none), the warps' workspaces (three source cells and a vector each) and,
// where shared, the ring (three diagonals of ncb cells of S + 1 floats)
// and the inbox (BOX cells), after the inbox's mbarriers.
size_t smem_bytes(int S, int ncb, int ring_shared, int n_tab) {
  size_t n = (size_t)NW * (4 * (size_t)S + 3);
  if (ring_shared) n += (3 * (size_t)ncb + BOX) * (S + 1);
  return BAR_BYTES + n * sizeof(float) + (size_t)n_tab * 8;
}

template <bool MAX, bool GRING>
int launch(const Params& p, size_t smem, cudaStream_t st) {
  auto kern = row_scan_kernel<MAX, GRING>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (p.csize == 1) {
    kern<<<p.B, THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  if (p.csize > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.csize, 1, 1);
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

}  // namespace

extern "C" int row_scan_smem_bytes(int S, int ncb, int ring_shared,
                                   int n_tab) {
  return (int)smem_bytes(S, ncb, ring_shared, n_tab);
}

// Launches the kernel on `stream`: B clusters of `csize` blocks of 512
// threads, one cluster a pair (one block when csize is 1), each block
// holding ncb = ceil((Li + 1) / csize) cells of a diagonal. tab: the
// (n_tab, 2) int32 lists (n_hdr headers first), staged in shared memory
// when tab_shared. maxplus: the semiring (0 logsumexp, 1 max-plus);
// lattice: every pair's lattice to `out` (else its score); band: null for
// no band; ring: the global ring (null when ring_shared); prof: the
// profile library's counters (else null). Returns cudaGetLastError() or
// the launch's error: nonzero means the launch was refused.
extern "C" int row_scan_launch(const void* tab, const void* start,
                               const void* in_toks, const void* out_toks,
                               const void* in_lens, const void* out_lens,
                               const void* band, void* out, void* ring,
                               void* prof, int n_hdr, int n_tab,
                               int tab_shared, int B, int Li, int Lo, int S,
                               int n_in, int n_out, int csize, int ncb,
                               int ring_shared, int maxplus, int lattice,
                               void* stream) {
  const bool shape_ok =
      B >= 0 && Li >= 0 && Lo >= 0 && S >= 1 && n_in >= 1 && n_out >= 1 &&
      csize >= 1 && csize <= 16 && ncb >= (Li + csize) / csize &&
      n_hdr == (n_in * n_out + n_in + n_out + 1) * ((S + 31) / 32) &&
      n_tab >= n_hdr && (ring_shared || ring != nullptr) &&
      (lattice || (in_lens != nullptr && out_lens != nullptr));
  if (!shape_ok) return (int)cudaErrorInvalidValue;
#ifdef PHASE_PROFILE
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
#endif
  if (B == 0) return 0;
  Params a{(const int2*)tab, (const float*)start, (const int*)in_toks,
           (const int*)out_toks, (const int*)in_lens, (const int*)out_lens,
           (const int*)band, (float*)out, (float*)ring, (long long*)prof,
           n_hdr, n_tab, tab_shared, B, Li, Lo, S, n_in, n_out, csize, ncb,
           lattice};
  const size_t smem = smem_bytes(S, ncb, ring_shared, tab_shared ? n_tab : 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (maxplus)
    return ring_shared ? launch<true, false>(a, smem, st)
                       : launch<true, true>(a, smem, st);
  return ring_shared ? launch<false, false>(a, smem, st)
                     : launch<false, true>(a, smem, st);
}
