// Envelope-banded max-plus (Viterbi) wavefront fill of ONE pair, for Hopper
// (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/viterbi_kernel.py::
// _viterbi_banded_kernel. The recurrence and the cell update are those of
// viterbi_common.cuh; only the addressing differs. Diagonal d keeps the
// cells i in [base_d, base_d + Wb) at window index w = i - base_d, of which
// [lo_d, hi_d) lie in the band; base_d never falls and rises by at most one
// per diagonal (band_windows on the host). The neighbours of window index w
// are therefore plain index arithmetic on the bases: up (i, o-1) at
// w + (base_d - base_{d-1}) of diagonal d-1, left (i-1, o) one below that,
// diag (i-1, o-1) at w + (base_d - base_{d-2}) - 1 of diagonal d-2; an index
// off the window is a missing neighbour. The TPU kernel selected between
// three static lane rolls by a streamed scalar for the same purpose. The
// output is (n_diags, Wb, S), NEG_INF outside the band and the lattice, and
// stays on the device for the lattice walk.
//
// What bounds it on this card: neither bytes nor operations but the
// Li + Lo + 1 dependent diagonals, each a few dozen cells wide (align_banded:
// 3,001 diagonals, about 16 band cells each). The first version walked them
// with ONE block of 512 threads: 6.2 us a diagonal, spent on a chain of
// dependent global loads (the band's bounds, then the tokens, then 65 serial
// float4 loads of the token's block from L2, which did not fit one SM's L1).
// The design takes every global load off a diagonal's critical path and
// spreads a diagonal over several multiprocessors:
//
//  1. A cluster of `csize` blocks (1 to 16) walks the pair; rank h owns a
//     contiguous range of the SP/4 destination column groups.
//  2. Resident blocks: each rank's columns of every present class block sit
//     in its shared memory (packed per rank by pack_banded on the host, rows
//     of an odd count of 16-byte groups so that 8 lanes reading 8 rows hit
//     distinct banks, loaded once with cp.async), when they fit beside the
//     slots; otherwise they are read from L2 through the read-only cache
//     (`resident` = 0).
//  3. Shared slots: the previous diagonals, whole (Wb rows of SP floats),
//     sit in each rank's five rotating slots. A rank sends its columns of
//     diagonal d to every peer's slot of d with 16-byte st.async stores
//     that count their bytes on the peer's mbarrier of that slot, and waits
//     on its own mbarrier for the peers' columns: no cluster barrier and no
//     release fence on the path (a first version with one cluster barrier a
//     diagonal and scalar DSMEM stores spent most of its time there). On a
//     diag-only machine diagonal d reads only d-2, so the wait lags one
//     diagonal and d's columns travel while d + 1 is computed. The warps
//     that hold no item copy the rank's share of diagonal d-2 from its slot
//     to the lattice, coalesced, while the others compute d. A window too
//     wide for the slots is read back from the lattice instead (`slots` =
//     0), with one cluster barrier a diagonal.
//  4. Staged bookkeeping: the band's bounds and the tokens they reach are
//     copied to shared memory by cp.async in chunks of CH diagonals, the
//     next chunk in flight while the current one is walked. A band too wide
//     for a chunk's tokens (about 2 Wb ints, twice over: some 14,000 cells)
//     stages the bounds alone and reads the tokens from global memory
//     through L1/L2 (`staged` = 0, with read-back: its own instantiations,
//     so the staged layout's loads stay shared loads).
//  5. Only band cells are items. An item is (cell, 4 destination states)
//     taken by `split` neighbouring lanes (1, 2, 4 or 8; each split its own
//     kernel instantiation), each over every split-th source state; the
//     lanes meet by __shfl_xor_sync max. The window rows outside the band
//     take no product and are not exchanged: a reader takes NEG_INF for a
//     neighbour outside its diagonal's band, and the lattice copy writes
//     NEG_INF there.
//
// Only float32 adds and maxes occur, so any order is exact: the lattice
// equals the plain PyTorch version bit for bit in every layout.

#include "viterbi_common.cuh"

namespace {

using namespace viterbi;

constexpr int THREADS = 512;
constexpr int CH = 32;            // diagonals a staged chunk
constexpr int MAX_CSIZE = 16;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90
// Diagonal slots: a rank reads d-2 (and d-1) while a peer may already
// write d+2 (see the kernel's end of a diagonal), so five rotate.
constexpr int NSLOT = 5;
constexpr int BAR_FLOATS = 12;    // five 8-byte mbarriers, 16-byte padded

__host__ __device__ inline int up4(int n) { return (n + 3) / 4 * 4; }

// The staged ints of one chunk: CH rows of (lo, hi, base), the x tokens
// from index base_ref - 1 (XW) and the y tokens (YW), where base_ref is the
// base of the previous chunk's first diagonal (of diagonal 0 for chunk 0):
// a chunk's cells lie in i in [base_ref, base_ref + 2 CH + Wb). Unstaged
// tokens: the rows alone.
__host__ __device__ inline int xw(int Wb) { return 2 * CH + Wb + 1; }
__host__ __device__ inline int yw(int Wb) { return 3 * CH + Wb; }
__host__ __device__ inline int stage_ints(int Wb, bool staged) {
  return up4(3 * CH + (staged ? xw(Wb) + yw(Wb) : 0));
}

// Column groups a rank owns (the last ranks may own fewer, or none), and
// the groups of a packed row: the same for every rank, and odd, so that
// the 8 lanes of a quarter-warp, reading 8 consecutive source rows of one
// item, hit 8 distinct groups of 4 banks.
__host__ __device__ inline int groups_per_rank(int SP, int csize) {
  return (SP / TD + csize - 1) / csize;
}
__host__ __device__ inline int row_groups(int SP, int csize) {
  return groups_per_rank(SP, csize) | 1;
}

// Shared floats of a block: the slots' mbarriers, the resident class
// columns, the slots, two staged chunks and their reference bases.
__host__ __device__ inline long smem_floats(int S, int SP, int Wb,
                                            int n_tok_sum, int csize,
                                            int resident, int slots,
                                            int staged) {
  long n = BAR_FLOATS;
  if (resident)
    n += (long)n_tok_sum * S * TD * row_groups(SP, csize);
  if (slots) n += NSLOT * Wb * SP;
  return n + 2 * stage_ints(Wb, staged) + 4;
}

struct Args {
  const int* in_toks;   // (Li,)
  const int* out_toks;  // (Lo,)
  const int* meta;      // (n_diags, 3): lo_d, hi_d, base_d
  const float* c0;      // (S,)
  const float* blk[3];  // up (To, S, SP), left (Ti, S, SP), diag (Ti*To, S, SP)
  const float* packed;  // pack_banded: per class (csize, n_tok, S, Wr)
  int n_tok[3];         // 0: the class is absent
  float* lat;           // (n_diags, Wb, S)
  int Li, Lo, Wb, S, SP, Ti, To;
  int csize;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copies of chunk c into `st` (stage_ints(Wb, STG) ints) and
// sets *ref to its reference base; out-of-range entries are left unwritten
// (no cell reads them).
template <bool STG>
__device__ void stage_chunk(const Args& a, int c, int base_ref, int* st,
                            int* ref) {
  const int n_diags = a.Li + a.Lo + 1;
  const int XW = xw(a.Wb), YW = yw(a.Wb);
  const int xb = base_ref - 1;
  const int yb = c * CH - base_ref - 2 * CH - a.Wb;
  const int n = 3 * CH + (STG ? XW + YW : 0);
  for (int e = threadIdx.x; e < n; e += THREADS) {
    if (e < 3 * CH) {
      if (c * CH * 3 + e < n_diags * 3) cp_async4(st + e, a.meta + c * CH * 3 + e);
    } else if (e < 3 * CH + XW) {
      const int k = xb + e - 3 * CH;
      if (k >= 0 && k < a.Li) cp_async4(st + e, a.in_toks + k);
    } else {
      const int k = yb + e - 3 * CH - XW;
      if (k >= 0 && k < a.Lo) cp_async4(st + e, a.out_toks + k);
    }
  }
  if (threadIdx.x == 0) *ref = base_ref;
}

// max over this lane's source states (s = sub, sub + SPLIT, ...) of
// blk[s][0..3] + nbr[s], into acc. `row` is the float stride of blk's rows.
// A neighbour outside its diagonal's band holds NEG_INF in every state: it
// is not read (`live` false), the constant takes its place.
template <bool RES, bool SLOTS, int SPLIT>
__device__ __forceinline__ void lane_max(float4& acc, const float* blk,
                                         int row, const float* nbr, bool live,
                                         int S, int sub) {
#pragma unroll 4
  for (int s = sub; s < S; s += SPLIT) {
    const float v = !live ? NEG_INF : SLOTS ? nbr[s] : __ldcg(nbr + s);
    const float4 m =
        RES ? *reinterpret_cast<const float4*>(blk + s * row)
            : __ldg(reinterpret_cast<const float4*>(blk + s * row));
    acc.x = fmaxf(acc.x, m.x + v);
    acc.y = fmaxf(acc.y, m.y + v);
    acc.z = fmaxf(acc.z, m.z + v);
    acc.w = fmaxf(acc.w, m.w + v);
  }
}

// One item's classes: for each present class q (ok[q]) its block columns
// blk[q] against its neighbour nbr[q] (live[q]: inside its band).
template <bool RES, bool SLOTS, int SPLIT>
__device__ __forceinline__ void cell_max(float4& acc, const float* const* blk,
                                         const float* const* nbr,
                                         const bool* ok, const bool* live,
                                         int row, int S, int sub) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (ok[q])
      lane_max<RES, SLOTS, SPLIT>(acc, blk[q], row, nbr[q], live[q], S, sub);
}

// The diagonals' exchange between the ranks of a cluster with shared
// slots: rank h stores its columns of diagonal d into every peer's slot of
// d with st.async, which counts the bytes on the peer's mbarrier of that
// slot; the peer's phase of d completes when one of its own threads has
// posted the bytes it expects (the band cells x the peers' column groups x 16)
// and they have all arrived. No cluster barrier, no release fence: a rank
// waits only for the data it reads. The slot of d is rewritten for d + 3
// only after its owner has sent its columns of d + 2, which follow its
// last reads of that slot.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void st_async4(unsigned addr, float4 v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// This rank's share of a diagonal's window (Wb, S) from its slot (rows of
// SP floats) to the lattice, NEG_INF outside the band rows [blo, bhi):
// coalesced, share `part` of the slab per rank, by `n` threads from
// thread `first`.
__device__ __forceinline__ void copy_out(const Args& a, int rank,
                                         const float* slot, float* out,
                                         int blo, int bhi, int first, int n) {
  const int slab = a.Wb * a.S;
  const int part = (slab + a.csize - 1) / a.csize;
  const int e1 = min(slab, (rank + 1) * part);
  for (int e = rank * part + first; e < e1; e += n) {
    const int w = e / a.S;
    out[e] = w >= blo && w < bhi ? slot[w * a.SP + e - w * a.S] : NEG_INF;
  }
}

template <bool RES, bool SLOTS, int SPLIT, bool STG>
__global__ void __launch_bounds__(THREADS, 1)
viterbi_banded_wavefront_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = a.csize > 1 ? cluster_rank() : 0;
  const int S = a.S, SP = a.SP, Wb = a.Wb;
  constexpr int split = SPLIT;
  const int n_diags = a.Li + a.Lo + 1;
  const int slab = Wb * S;          // a diagonal in the lattice
  const int sslab = Wb * SP;        // a diagonal in a slot (16-byte rows)
  const int nrow = SLOTS ? SP : S;  // a neighbour row's stride
  // this rank's destination states: column groups dg0 .. dg0 + ng - 1
  const int gpr = groups_per_rank(SP, a.csize);
  const int Wr = row_groups(SP, a.csize) * TD;
  const int dg0 = rank * gpr;
  const int ng = max(0, min(SP / TD, dg0 + gpr) - dg0);
  const int s_lo = dg0 * TD, s_hi = min(S, (dg0 + ng) * TD);
  const int ncols = max(0, s_hi - s_lo);
  // an item's `split` lanes are neighbours in the warp: they read
  // consecutive source rows and meet by shuffles at distances 1, 2, 4
  const int sub = lane % split;
  // this thread's item in a diagonal's first pass, and its cell and group
  const int item0 = tid / split;
  const int cell0 = ng ? item0 / ng : 0, g0 = ng ? item0 - cell0 * ng : 0;

  // shared layout: the slots' three mbarriers, resident columns, slots,
  // two staged chunks, their bases
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm);
  const bool mbar = SLOTS && a.csize > 1;
  float* res = sm + BAR_FLOATS;
  const float* cls[3];
  long o = BAR_FLOATS;
  for (int q = 0; q < 3; ++q) {
    cls[q] = sm + o;
    if (RES) o += (long)a.n_tok[q] * S * Wr;
  }
  float* slots = sm + o;
  if (SLOTS) o += NSLOT * sslab;
  int* stage = reinterpret_cast<int*>(sm + o);
  const int SI = stage_ints(Wb, STG);
  int* refs = stage + 2 * SI;

  // the resident columns (each rank's slice is contiguous in `packed`)
  if (RES) {
    long src = 0, dst = 0;
    for (int q = 0; q < 3; ++q) {
      const long n = (long)a.n_tok[q] * S * Wr;
      const float* p = a.packed + src + (long)rank * n;
      for (long v = tid; v < n / 4; v += THREADS)
        cp_async16(res + dst + v * 4, p + v * 4);
      src += n * a.csize;
      dst += n;
    }
  }
  stage_chunk<STG>(a, 0, __ldg(a.meta + 2), stage, refs);
  cp_async_commit();
  if (mbar && tid == 0) {
    for (int k = 0; k < NSLOT; ++k) mbar_init(bars + k);
    mbar_fence_init();
  }
  // every block of the cluster runs, its mbarriers set, before any store
  // to its shared memory
  if (a.csize > 1) cluster_sync();
  const int peer_groups = SP / TD - ng;   // the column groups peers send
  // diag class only: diagonal d reads d - 2 alone
  const int lag = a.n_tok[0] == 0 && a.n_tok[1] == 0;

  const size_t blk_sz = (size_t)S * (RES ? Wr : SP);
  const int brow = RES ? Wr : SP;
  int b1 = 0, b2 = 0;               // base_{d-1}, base_{d-2}
  int l1 = 0, h1 = 0, l2 = 0, h2 = 0;   // their band rows, window indices
  for (int d = 0; d < n_diags; ++d) {
    const int c = d / CH;
    if (d % CH == 0) {
      cp_async_wait_all();
      __syncthreads();                // chunk c is staged, chunk c-1 is read
      if ((c + 1) * CH < n_diags)
        stage_chunk<STG>(a, c + 1, stage[(c & 1) * SI + 2],
                    stage + ((c + 1) & 1) * SI, refs + ((c + 1) & 1));
      cp_async_commit();
    }
    const int* st = stage + (c & 1) * SI;
    const int r3 = (d - c * CH) * 3;
    const int lo = st[r3], hi = st[r3 + 1], base = st[r3 + 2];
    const int bref = refs[c & 1];
    const int* xs = STG ? st + 3 * CH - (bref - 1)            // xs[i - 1]
                        : a.in_toks;
    const int* ys = STG ? st + 3 * CH + xw(Wb) - (c * CH - bref - 2 * CH - Wb)
                        : a.out_toks;
    const int s1 = base - b1, s2 = base - b2;
    const int ilo = max(max(lo, base), max(d - a.Lo, 0));
    const int ihi = min(min(hi, base + Wb), min(a.Li + 1, d + 1));
    const int nc = max(0, ihi - ilo);

    // the bytes the peers send for d, posted by the last thread (the items
    // start from thread 0, so it is the last to hold one)
    if (mbar && tid == THREADS - 1)
      mbar_expect(bars + d % NSLOT, 16u * nc * peer_groups);

    float* cur = a.lat + (size_t)d * slab;
    float* slot = slots + (d % NSLOT) * sslab;
    const float* p1 =
        SLOTS ? slots + ((d + NSLOT - 1) % NSLOT) * sslab : cur - slab;
    const float* p2 =
        SLOTS ? slots + ((d + NSLOT - 2) % NSLOT) * sslab : cur - 2 * slab;

    // the band's cells: (cell, column group), `split` lanes each. The warps
    // without one copy this rank's share of diagonal d-2 to the lattice
    // meanwhile (its slot is p2 here, complete in both schedules below,
    // and rewritten for d + 3); when every warp has an item, all copy it
    // after d's items.
    const int n_items = nc * ng;
    const int busy = (n_items * split + 31) & ~31;
    if (SLOTS && d >= 2 && busy < THREADS && tid >= busy)
      copy_out(a, rank, p2, cur - 2 * slab, l2, h2, tid - busy,
               THREADS - busy);
    for (int e0 = 0; e0 < n_items * split; e0 += THREADS) {
      const int item = e0 / split + item0;
      const bool active = item < n_items;
      float4 acc = neg4();
      int w = 0, dg = 0;
      if (active) {
        const int cell = e0 ? item / ng : cell0;
        const int g = e0 ? item - cell * ng : g0;
        const int i = ilo + cell, oo = d - i;
        w = i - base;
        dg = dg0 + g;
        if (d == 0) {
          acc = start4(a.c0, dg, S);
        } else {
          const int x = i >= 1 ? xs[i - 1] : -1;
          const int y = oo >= 1 ? ys[oo - 1] : -1;
          const bool x_ok = x >= 0 && x < a.Ti;
          const bool y_ok = y >= 0 && y < a.To;
          const int wu = w + s1, wl = w + s1 - 1, wd = w + s2 - 1;
          const int col = RES ? g * TD : dg * TD;
          const float* blk[3] = {
              (RES ? cls[0] : a.blk[0]) + y * blk_sz + col,
              (RES ? cls[1] : a.blk[1]) + x * blk_sz + col,
              (RES ? cls[2] : a.blk[2]) + (x * a.To + y) * blk_sz + col};
          const float* nbr[3] = {p1 + wu * nrow, p1 + wl * nrow,
                                 p2 + wd * nrow};
          const bool ok[3] = {
              a.n_tok[0] && y_ok && wu >= 0 && wu < Wb,
              a.n_tok[1] && x_ok && wl >= 0 && wl < Wb,
              a.n_tok[2] && d >= 2 && x_ok && y_ok && wd >= 0 && wd < Wb};
          const bool live[3] = {wu >= l1 && wu < h1, wl >= l1 && wl < h1,
                                wd >= l2 && wd < h2};
          cell_max<RES, SLOTS, SPLIT>(acc, blk, nbr, ok, live, brow, S, sub);
        }
      }
      for (int off = split >> 1; off > 0; off >>= 1) {
        acc.x = fmaxf(acc.x, __shfl_xor_sync(0xffffffffu, acc.x, off));
        acc.y = fmaxf(acc.y, __shfl_xor_sync(0xffffffffu, acc.y, off));
        acc.z = fmaxf(acc.z, __shfl_xor_sync(0xffffffffu, acc.z, off));
        acc.w = fmaxf(acc.w, __shfl_xor_sync(0xffffffffu, acc.w, off));
      }
      if (active) {
        if (SLOTS) {
          // the 4 states as one 16-byte store to each rank's slot, the
          // ranks shared among the item's lanes
          float* dst = slot + w * SP + dg * TD;
          for (int r = sub; r < a.csize; r += split) {
            if (r == rank)
              *reinterpret_cast<float4*>(dst) = acc;
            else
              st_async4(peer_addr(dst, r), acc,
                        peer_addr(reinterpret_cast<const float*>(
                                      bars + d % NSLOT), r));
          }
        } else if (sub == 0) {
          store4(cur + w * S, dg, S, acc);
        }
      }
    }
    // read back: the window rows outside the band hold NEG_INF in the
    // lattice (with slots, the band rows tell the readers and copy_out)
    if (!SLOTS) {
      const int n_neg = (Wb - nc) * ncols;
      for (int e = THREADS - 1 - tid; e < n_neg; e += THREADS) {
        int w = e / ncols;
        const int s = s_lo + e - w * ncols;
        if (w >= ilo - base && nc > 0) w += nc;   // skip the band's rows
        cur[w * S + s] = NEG_INF;
      }
    }

    // diagonal d is complete in every rank before a diagonal reads it: d + 1
    // when an up or left class is present, else d + 2, and then the wait
    // here is for d - 1, so that d's columns travel while d + 1 is computed
    // (a rank may then run two diagonals ahead of a peer, which the five
    // slots allow)
    if (SLOTS) {
      if (d >= 2 && busy >= THREADS)
        copy_out(a, rank, p2, cur - 2 * slab, l2, h2, tid, THREADS);
      __syncthreads();
      const int done = d - lag;
      if (mbar && done >= 0)
        mbar_wait(bars + done % NSLOT, (done / NSLOT) & 1);
    } else if (a.csize > 1) {
      // read back: the cluster's lattice stores, then one cluster barrier
      __threadfence();
      cluster_sync();
    } else {
      __syncthreads();
    }
    b2 = b1;
    b1 = base;
    l2 = l1;
    h2 = h1;
    l1 = ilo - base;
    h1 = l1 + nc;
  }
  // the last two diagonals to the lattice
  if (SLOTS) {
    const int d = n_diags - 1;
    if (mbar && lag) mbar_wait(bars + d % NSLOT, (d / NSLOT) & 1);
    if (d >= 1)
      copy_out(a, rank, slots + ((d - 1) % NSLOT) * sslab,
               a.lat + (size_t)(d - 1) * slab, l2, h2, tid, THREADS);
    copy_out(a, rank, slots + (d % NSLOT) * sslab, a.lat + (size_t)d * slab,
             l1, h1, tid, THREADS);
  }
}

using Kernel = void (*)(Args);

// The kernel of a layout: the columns resident or not, slots or read-back,
// 1, 2, 4 or 8 lanes an item (each its own instantiation, so that a
// diagonal's loop holds one split's code), the tokens staged or not (not:
// read-back only; null for slots without staged tokens).
Kernel pick(int resident, int slots, int split, int staged) {
#define K(R, S, T) {viterbi_banded_wavefront_kernel<R, S, 1, T>, \
                    viterbi_banded_wavefront_kernel<R, S, 2, T>, \
                    viterbi_banded_wavefront_kernel<R, S, 4, T>, \
                    viterbi_banded_wavefront_kernel<R, S, 8, T>}
  static const Kernel table[2][2][4] = {
      {K(false, false, true), K(false, true, true)},
      {K(true, false, true), K(true, true, true)}};
  static const Kernel unstaged[2][4] = {K(false, false, false),
                                        K(true, false, false)};
#undef K
  const int l = split == 8 ? 3 : split == 4 ? 2 : split == 2 ? 1 : 0;
  if (!staged) return slots ? nullptr : unstaged[resident ? 1 : 0][l];
  return table[resident ? 1 : 0][slots ? 1 : 0][l];
}

cudaError_t prepare(Kernel k, int csize, long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (csize > 8)
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t config(int csize, long smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid(int S, int SP, int Wb, int csize, int split) {
  return S >= 1 && SP >= S && SP % TD == 0 && Wb >= 1 && csize >= 1 &&
         csize <= MAX_CSIZE && csize <= SP / TD &&
         (split == 1 || split == 2 || split == 4 || split == 8);
}

}  // namespace

// Shared bytes of a block in the layout (csize, resident, slots, staged).
extern "C" long viterbi_banded_smem_bytes(int S, int SP, int Wb, int n_up,
                                          int n_left, int n_diag, int csize,
                                          int resident, int slots,
                                          int staged) {
  return smem_floats(S, SP, Wb, n_up + n_left + n_diag, csize, resident,
                     slots, staged) * (long)sizeof(float);
}

// The card's occupancy calculator: how many clusters of this layout can be
// resident at once (0: the layout cannot launch), or -1 on an error.
extern "C" int viterbi_banded_max_clusters(int S, int SP, int Wb, int n_up,
                                           int n_left, int n_diag, int csize,
                                           int resident, int slots,
                                           int split, int staged) {
  if (!valid(S, SP, Wb, csize, split)) return -1;
  const long smem = viterbi_banded_smem_bytes(S, SP, Wb, n_up, n_left, n_diag,
                                              csize, resident, slots, staged);
  if (smem > SMEM_MAX) return 0;
  const Kernel k = pick(resident, slots, split, staged);
  if (k == nullptr) return -1;
  cudaError_t err = prepare(k, csize, smem);
  if (err != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(csize, smem, 0, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  return err == cudaSuccess ? n : -1;
}

// Launches the kernel on `stream`: one cluster of `csize` blocks walks the
// pair, with the class columns `resident` in shared memory (from `packed`,
// pack_banded's layout for csize) or read through L2, the previous
// diagonals in shared `slots` or read back from the lattice, `split` lanes
// an item, the band's tokens `staged` in shared memory or read from global
// memory (with read-back only). n_up, n_left, n_diag: the tokens of each
// class's blocks (0: absent). Returns cudaGetLastError() (or the launch's
// error): nonzero means the launch was refused.
extern "C" int viterbi_banded_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* meta,
    const void* c0, const void* up, const void* left, const void* diag,
    const void* packed, void* lat, int Li, int Lo, int Wb, int S, int SP,
    int Ti, int To, int n_up, int n_left, int n_diag, int csize, int resident,
    int slots, int split, int staged, void* stream) {
  if (!valid(S, SP, Wb, csize, split) || Li < 0 || Lo < 0 || n_up < 0 ||
      n_left < 0 || n_diag < 0 || (n_up > 0 && !up) || (n_left > 0 && !left) ||
      (n_diag > 0 && !diag) || (resident && !packed))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.meta = (const int*)meta;
  a.c0 = (const float*)c0;
  a.blk[0] = (const float*)up;
  a.blk[1] = (const float*)left;
  a.blk[2] = (const float*)diag;
  a.packed = (const float*)packed;
  a.n_tok[0] = n_up;
  a.n_tok[1] = n_left;
  a.n_tok[2] = n_diag;
  a.lat = (float*)lat;
  a.Li = Li; a.Lo = Lo; a.Wb = Wb; a.S = S; a.SP = SP; a.Ti = Ti; a.To = To;
  a.csize = csize;
  const long smem = viterbi_banded_smem_bytes(S, SP, Wb, n_up, n_left, n_diag,
                                              csize, resident, slots, staged);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Kernel k = pick(resident, slots, split, staged);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(k, csize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(csize, smem, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, k, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
