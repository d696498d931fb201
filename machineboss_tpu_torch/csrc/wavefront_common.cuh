// Shared device code of the full-rank wavefront kernels (merged_wavefront.cu,
// chained_ragged_wavefront.cu and chained_wavefront.cu; generic_wavefront.cu
// and seqscale_wavefront.cu take Args, make_args, block_dot, warp_max and
// readout_warp), for Hopper (sm_90a).
//
// cell_update() is the per-cell step that every one of them takes: the
// class products of one cell for 4 destination states. walk_pair() walks ONE
// pair's lattice with the whole thread block and returns its Forward
// log-likelihood: it is what machineboss_tpu/ops/pallas/wavefront_kernel.py::
// _merged_kernel computes for one lane window, and what
// ::_chained_ragged_kernel and ::_chained_kernel compute for one chain
// element; those three CUDA kernels differ only in how they hand pairs to
// blocks (and chained in the pair's absolute-diagonal offset). The host prep is
// prepare_merged (ops/kernels/wavefront_kernel.py): the silent closure is
// folded into each present class, F[tok] = C^T A[tok]^T, trailing sink
// states are trimmed (Sa states remain).
//
// Per cell (i, o) of the pair, diagonal d = i + o, carried as scaled
// probabilities p (Sa floats) with a per-cell log scale m:
//   * each present class reads one neighbour: up (i, o-1) by the y token and
//     left (i-1, o) by the x token on d-1, diag (i-1, o-1) by (x, y) on d-2;
//     a neighbour outside the lattice is skipped;
//   * mu = max of the neighbours' m; cur = sum_class exp(m_c - mu) *
//     (F_class[tok] @ p_c);
//   * on diagonals with d % rescale_every <= 1 (both parities: the diag
//     class's mass lives on one) p is divided by its max over states and the
//     log of that max is added to m; a cell whose max is not positive is
//     zeroed;
//   * the readout at (il, ol) is m + log(p[Sa-1]), or m + log(w . p) when the
//     sink states were trimmed.
//
// What the TPU kernels did that this code does not: the transposed
// (S, cells) slabs and their lane rolls, the 128-lane windows, two diagonals
// per grid step, the bf16 hi/lo 3-pass products (a plain f32 FMA is at least
// as accurate), and the one-hot wide product with its "unify" block, which
// multiplies every cell by every token's block to fill the matrix unit. Here
// a thread reads the (Sa, Sa) block of its own cell's token directly, so a
// cell costs Sa*Sa multiply-adds per class and not n_tok times that.
//
// Design (walk_pair): a block walks one pair, a diagonal at a time, with one
// block barrier a diagonal. The diagonal state lives in three rotating
// (W, SaP) slots per block, in a global scratch (it stays in L2) or, where
// the launch plan says so, in the block's shared memory. Each cell's
// destination states are computed by LPC = next_pow2(SaP / 4) neighbouring
// lanes of one warp, 4 states a lane: a lane reads p of the neighbour cell
// as float4s (the same address across the cell's lanes, one broadcast) and
// the token's block, stored source-major, as float4s through the read-only
// cache (neighbouring lanes on neighbouring addresses).
//  * The live cells only: the block keeps, in shared memory, the range
//    [lo, hi] of the cells with m > NEG_INF on each of the last diagonals,
//    found in the product phase (a warp's min and max, then one shared
//    atomic). Diagonal d's candidates are the union of what the present
//    classes reach from them (up: the same i on d-1; left: i+1 from d-1;
//    diag: i+1 from d-2), and only they get lanes. A reader outside a
//    neighbour's range takes NEG_INF and loads nothing; a cell none of
//    whose neighbours is live holds exact zeros, so the scores do not
//    change. Where every cell is live the range is the whole diagonal.
//  * The rescale inside the product phase: on a rescale diagonal a cell's
//    lanes take its max by xor shuffles, divide and add logf(den) to m
//    before storing, the operations of rescale_cell on the same values.
//    (A state vector wider than 128 takes the separate pass behind a
//    second barrier, WALK_RESCALE_PASS.)
//  * A token outside its alphabet makes the pair NaN: the tokens are read
//    once before the walk (each class's tokens in range; for diag, the
//    smallest and largest x * To + y), and a bad pair is not walked.
// Only neighbours inside the lattice and a live range are ever read, and
// each of those was written earlier in the same walk, so a block that
// starts its next pair needs no clearing of the previous pair's slots.
//
// What bounds it on this card: the work is f32 FMAs, Sa*Sa per class per
// cell whose neighbour of that class is live; the bytes that must move are
// tokens, lengths and the class blocks. No tensor cores are used, so the
// bound is the f32 non-tensor rate. The class blocks of a 64-state ACGT
// machine (16 x 16 KB) do not fit shared memory and are read through
// L1/L2, one float4 per 4 FMAs. bench.py's dense machine has the diag class
// only, so a pair of 200 x 200 reaches 200 of its 40,400 cells: there a
// diagonal is one cell, and the walk costs the latency of one diagonal's
// loads, products and barrier, 400 times in a row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wavefront {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int TD = 4;        // destination states per thread
constexpr int MAX_CLS = 3;

enum { KIND_UP = 0, KIND_LEFT = 1, KIND_DIAG = 2 };

// Per-class descriptor, laid out as the host passes it (DESC_LEN ints).
struct ClassDesc {
  int kind;    // KIND_*
  int n_tok;
  int mt_off;  // float offset of this class's [n_tok][SaP][SaP] blocks
};
constexpr int DESC_LEN = 3;

struct Plan {
  ClassDesc cls[MAX_CLS];
  int n_cls;
};

// What every launch function takes besides the pair assignment.
struct Args {
  const int* in_toks;
  const int* out_toks;
  const int* in_lens;
  const int* out_lens;
  const float* c0;     // (SaP,) start vector, zero padded
  const float* wvec;   // (SaP,) sink readout vector, zero padded
  const float* mt;     // packed class blocks
  float* pbuf;         // blocks * 3 * W * SaP
  float* mbuf;         // blocks * 3 * W
  float* out;          // (B,)
  int B, Li, Lo, Sa, SaP, To, rescale_every, sink;
  Plan plan;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// sum_s src[s] * blk[s][0..3]: 4 destination states of one (SaP, SaP)
// source-major block against one source vector (both zero padded to SaP).
__device__ __forceinline__ float4 block_dot(const float* sp, const float* mp,
                                            int SaP) {
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int s = 0; s < SaP; s += 4) {
    const float4 pv = *reinterpret_cast<const float4*>(sp + s);
    const float4 r0 = __ldg(
        reinterpret_cast<const float4*>(mp + (size_t)s * SaP));
    const float4 r1 = __ldg(
        reinterpret_cast<const float4*>(mp + (size_t)(s + 1) * SaP));
    const float4 r2 = __ldg(
        reinterpret_cast<const float4*>(mp + (size_t)(s + 2) * SaP));
    const float4 r3 = __ldg(
        reinterpret_cast<const float4*>(mp + (size_t)(s + 3) * SaP));
    t.x = fmaf(pv.x, r0.x, t.x); t.y = fmaf(pv.x, r0.y, t.y);
    t.z = fmaf(pv.x, r0.z, t.z); t.w = fmaf(pv.x, r0.w, t.w);
    t.x = fmaf(pv.y, r1.x, t.x); t.y = fmaf(pv.y, r1.y, t.y);
    t.z = fmaf(pv.y, r1.z, t.z); t.w = fmaf(pv.y, r1.w, t.w);
    t.x = fmaf(pv.z, r2.x, t.x); t.y = fmaf(pv.z, r2.y, t.y);
    t.z = fmaf(pv.z, r2.z, t.z); t.w = fmaf(pv.z, r2.w, t.w);
    t.x = fmaf(pv.w, r3.x, t.x); t.y = fmaf(pv.w, r3.y, t.y);
    t.z = fmaf(pv.w, r3.z, t.z); t.w = fmaf(pv.w, r3.w, t.w);
  }
  return t;
}

// A diagonal's live cells: m > NEG_INF on [lo, hi]; lo > hi when none.
struct Range {
  int lo, hi;
};
constexpr int RANGE_NONE = 1 << 29;

// The class terms of cell (i, o) for destination states dg*TD .. dg*TD+3:
// p1/m1 hold diagonal d-1 and p2/m2 diagonal d-2 as (W, SaP) / (W,) slots,
// r1 and r2 their live ranges (RANGED; else every lattice cell of theirs
// was written). Each term is weighed by exp(m_c - mu), mu the max over the
// present classes' neighbours; a class whose neighbour is outside the
// lattice or the live range adds nothing and loads nothing, and one whose
// neighbour has m = NEG_INF (a zero cell) adds nothing. Sets mu to the
// cell's new log scale before any rescale (NEG_INF without a weighted
// neighbour). The pair's tokens are in their alphabets (walk_pair checks).
template <bool RANGED>
__device__ __forceinline__ float4 cell_update(
    const Args& a, int i, int o, const int* xt, const int* yt, int dg,
    const float* p1, const float* p2, const float* m1, const float* m2,
    Range r1, Range r2, float& mu) {
  const int SaP = a.SaP;
  float mc[MAX_CLS];
  const float* src[MAX_CLS];
  const float* blk[MAX_CLS];
  mu = NEG_INF;
  for (int q = 0; q < a.plan.n_cls; ++q) {
    const ClassDesc& k = a.plan.cls[q];
    float mv = NEG_INF;
    int tok = 0;
    const float* sp = p1;
    if (k.kind == KIND_UP) {
      if (o >= 1 && (!RANGED || (i >= r1.lo && i <= r1.hi))) {
        mv = m1[i];
        tok = __ldg(yt + o - 1);
        sp = p1 + (size_t)i * SaP;
      }
    } else if (k.kind == KIND_LEFT) {
      if (i >= 1 && (!RANGED || (i - 1 >= r1.lo && i - 1 <= r1.hi))) {
        mv = m1[i - 1];
        tok = __ldg(xt + i - 1);
        sp = p1 + (size_t)(i - 1) * SaP;
      }
    } else {
      if (i >= 1 && o >= 1 &&
          (!RANGED || (i - 1 >= r2.lo && i - 1 <= r2.hi))) {
        mv = m2[i - 1];
        tok = __ldg(xt + i - 1) * a.To + __ldg(yt + o - 1);
        sp = p2 + (size_t)(i - 1) * SaP;
      }
    }
    mc[q] = mv;
    src[q] = sp;
    blk[q] = a.mt + k.mt_off + (size_t)tok * SaP * SaP + dg * TD;
    mu = fmaxf(mu, mv);
  }
  const float mu_safe = mu > NEG_INF / 2 ? mu : 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = 0; q < a.plan.n_cls; ++q) {
    if (!(mc[q] > NEG_INF / 2)) continue;
    const float w = expf(mc[q] - mu_safe);
    const float4 t = block_dot(src[q], blk[q], SaP);
    acc.x = fmaf(w, t.x, acc.x); acc.y = fmaf(w, t.y, acc.y);
    acc.z = fmaf(w, t.z, acc.z); acc.w = fmaf(w, t.w, acc.w);
  }
  return acc;
}

// One warp: divides cell pc by its max over the Sa states and adds the log
// of that max to *mc; a cell whose max is not positive is zeroed and its
// scale set to NEG_INF.
__device__ __forceinline__ void rescale_cell(float* pc, float* mc, int Sa,
                                             int lane) {
  float mx = -3.4e38f;
  for (int s = lane; s < Sa; s += 32) mx = fmaxf(mx, pc[s]);
  mx = warp_max(mx);
  const bool has = mx > 0.f;
  const float den = fmaxf(mx, 1e-37f);
  for (int s = lane; s < Sa; s += 32) pc[s] = has ? pc[s] / den : 0.f;
  if (lane == 0) *mc = has ? *mc + logf(den) : NEG_INF;
}

// One warp: the score of readout cell pc with log scale m, m + log(p[Sa-1])
// or, when sink, m + log(w . p); NEG_INF where that is not positive.
__device__ __forceinline__ float readout_warp(const float* pc, float m,
                                              const float* wvec, int Sa,
                                              int sink, int lane) {
  float e;
  if (sink) {
    e = 0.f;
    for (int s = lane; s < Sa; s += 32) e = fmaf(pc[s], wvec[s], e);
    e = warp_sum(e);
  } else {
    e = pc[Sa - 1];
  }
  return e > 0.f ? m + logf(fmaxf(e, 1e-37f)) : NEG_INF;
}

// walk_pair's layout, a compile-time bit set (the launch plan's choice,
// or a variant that undoes one design choice for timing):
enum {
  WALK_NO_RANGE = 1,      // every lattice cell gets lanes, every neighbour
                          // inside the lattice is read
  WALK_RESCALE_PASS = 2,  // the rescale as its own pass, a warp a cell,
                          // behind a second barrier
  WALK_SMEM_SLOTS = 4     // the three diagonal slots in shared memory
};

// The block's shared state of a walk.
struct WalkShared {
  int bad;                 // a token outside its alphabet
  int xmin, xmax, ymin, ymax;
  int lo[4], hi[4];        // the live range of diagonal d at d % 4
};

// Shared bytes of the slots of a walk over rows of W cells.
inline size_t walk_slot_bytes(int W, int SaP) {
  return (size_t)3 * W * (SaP + 1) * sizeof(float);
}

// Whether a launch can take layout `opts`: the rescale inside the product
// phase needs a cell's lanes in one warp (SaP / 4 <= 32).
inline bool walk_opts_ok(int opts, int SaP) {
  return opts >= 0 && opts < 8 &&
         ((opts & WALK_RESCALE_PASS) || SaP / TD <= 32);
}

// Calls fn<OPTS>(args...) for the layout `opts` (0-7) and returns its value.
#define WALK_DISPATCH(opts, fn, ...)                                  \
  switch (opts) {                                                     \
    case 0: return fn<0>(__VA_ARGS__);                                \
    case 1: return fn<1>(__VA_ARGS__);                                \
    case 2: return fn<2>(__VA_ARGS__);                                \
    case 3: return fn<3>(__VA_ARGS__);                                \
    case 4: return fn<4>(__VA_ARGS__);                                \
    case 5: return fn<5>(__VA_ARGS__);                                \
    case 6: return fn<6>(__VA_ARGS__);                                \
    default: return fn<7>(__VA_ARGS__);                               \
  }

// Walks pair b with the whole block. Thread 0 returns the score; every
// thread must call it (it synchronises the block). sh is the block's
// WalkShared.
//
// CHAINED (chained_wavefront.cu): the pair's lengths are ignored (it is
// walked and read out at the padded (Li, Lo); in_lens may be null) and
// its diagonal d is the absolute step d + off of the chained schedule:
// the rescale fires on (d + off) % rescale_every <= 1, and the start cell
// (0, 0) takes the rescale of its step when off > 0. Unchained (merged,
// chained_ragged) the walk is the same code with off = 0, fixed when it
// is compiled.
template <bool CHAINED, int OPTS>
__device__ float walk_pair(const Args& a, int b, WalkShared* sh, int off = 0) {
  constexpr bool RANGED = !(OPTS & WALK_NO_RANGE);
  constexpr bool PASS = OPTS & WALK_RESCALE_PASS;
  extern __shared__ float4 walk_smem[];
  if (!CHAINED) off = 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.Li + 1;
  const int Sa = a.Sa, SaP = a.SaP;
  const int il = CHAINED ? a.Li : a.in_lens[b];
  const int ol = CHAINED ? a.Lo : a.out_lens[b];
  // the previous pair's readout must be done before its slots are reused
  __syncthreads();
  if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) return quiet_nan();
  const int* xt = a.in_toks + (size_t)b * a.Li;
  const int* yt = a.out_toks + (size_t)b * a.Lo;
  float* pb = (OPTS & WALK_SMEM_SLOTS)
                  ? reinterpret_cast<float*>(walk_smem)
                  : a.pbuf + (size_t)blockIdx.x * 3 * W * SaP;
  float* mb = (OPTS & WALK_SMEM_SLOTS)
                  ? reinterpret_cast<float*>(walk_smem) + (size_t)3 * W * SaP
                  : a.mbuf + (size_t)blockIdx.x * 3 * W;
  int n_up = -1, n_left = -1, n_diag = -1;
  for (int q = 0; q < a.plan.n_cls; ++q) {
    const ClassDesc& k = a.plan.cls[q];
    (k.kind == KIND_UP ? n_up : k.kind == KIND_LEFT ? n_left : n_diag) =
        k.n_tok;
  }
  if (tid == 0) {
    sh->bad = 0;
    sh->xmin = sh->ymin = 0x7fffffff;
    sh->xmax = sh->ymax = -0x7fffffff - 1;
    for (int k = 0; k < 4; ++k) {
      sh->lo[k] = RANGE_NONE;
      sh->hi[k] = -RANGE_NONE;
    }
  }
  __syncthreads();

  // the tokens, once: each class's in its alphabet (up reads every y,
  // left every x, diag every x * To + y)
  {
    int bad = 0, xmin = 0x7fffffff, xmax = -0x7fffffff - 1;
    int ymin = xmin, ymax = xmax;
    for (int k = tid; k < il; k += THREADS) {
      const int x = __ldg(xt + k);
      bad |= n_left >= 0 && (x < 0 || x >= n_left);
      xmin = min(xmin, x);
      xmax = max(xmax, x);
    }
    for (int k = tid; k < ol; k += THREADS) {
      const int y = __ldg(yt + k);
      bad |= n_up >= 0 && (y < 0 || y >= n_up);
      ymin = min(ymin, y);
      ymax = max(ymax, y);
    }
    bad = __reduce_or_sync(0xffffffffu, bad);
    xmin = __reduce_min_sync(0xffffffffu, xmin);
    xmax = __reduce_max_sync(0xffffffffu, xmax);
    ymin = __reduce_min_sync(0xffffffffu, ymin);
    ymax = __reduce_max_sync(0xffffffffu, ymax);
    if (lane == 0) {
      if (bad) sh->bad = 1;
      atomicMin(&sh->xmin, xmin);
      atomicMax(&sh->xmax, xmax);
      atomicMin(&sh->ymin, ymin);
      atomicMax(&sh->ymax, ymax);
    }
  }
  // d = 0: only cell (0, 0), p = c0 (closure row 0), m = 0
  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  if (tid == 0) mb[0] = 0.f;
  __syncthreads();
  bool bad = sh->bad != 0;
  if (n_diag >= 0 && il >= 1 && ol >= 1) {
    const long long lo = (long long)sh->xmin * a.To + sh->ymin;
    const long long hi = (long long)sh->xmax * a.To + sh->ymax;
    bad = bad || lo < 0 || hi >= n_diag;
  }
  if (bad) return quiet_nan();
  if (CHAINED && off > 0 && off % a.rescale_every <= 1 && tid < 32)
    rescale_cell(pb, mb, Sa, tid);
  if (tid == 0 && mb[0] > NEG_INF / 2) {
    sh->lo[0] = 0;
    sh->hi[0] = 0;
  }
  __syncthreads();

  const int dfin = il + ol;
  const int n_dg = SaP / TD;
  int lg_lpc = 0;                       // a cell's lanes: next_pow2(n_dg)
  while ((1 << lg_lpc) < n_dg) ++lg_lpc;
  const int LPC = 1 << lg_lpc;
  for (int d = 1; d <= dfin; ++d) {
    const int slot0 = d % 3, slot1 = (d + 2) % 3, slot2 = (d + 1) % 3;
    float* p0 = pb + (size_t)slot0 * W * SaP;
    const float* p1 = pb + (size_t)slot1 * W * SaP;
    const float* p2 = pb + (size_t)slot2 * W * SaP;
    float* m0 = mb + slot0 * W;
    const float* m1 = mb + slot1 * W;
    const float* m2 = mb + slot2 * W;
    int clo = max(0, d - ol), chi = min(d, il);
    Range r1{0, 0}, r2{0, 0};
    if (RANGED) {
      r1 = Range{sh->lo[(d - 1) & 3], sh->hi[(d - 1) & 3]};
      r2 = Range{sh->lo[(d - 2) & 3], sh->hi[(d - 2) & 3]};
      int lo = RANGE_NONE, hi = -RANGE_NONE;
      if (n_up >= 0) { lo = min(lo, r1.lo); hi = max(hi, r1.hi); }
      if (n_left >= 0) { lo = min(lo, r1.lo + 1); hi = max(hi, r1.hi + 1); }
      if (n_diag >= 0) { lo = min(lo, r2.lo + 1); hi = max(hi, r2.hi + 1); }
      clo = max(clo, lo);
      chi = min(chi, hi);
      if (tid == 0) {                 // d + 1 writes the slot of d - 3
        sh->lo[(d + 1) & 3] = RANGE_NONE;
        sh->hi[(d + 1) & 3] = -RANGE_NONE;
      }
    }
    const int n_cells = max(chi - clo + 1, 0);
    const bool resc = (d + off) % a.rescale_every <= 1;
    int live_lo = RANGE_NONE, live_hi = -RANGE_NONE;   // this thread's

    if (!PASS) {
      // products and rescale: a cell to LPC lanes, 4 states a lane; every
      // thread takes the same number of rounds, so a cell's lanes shuffle
      // together
      const int n_items = n_cells << lg_lpc;
      for (int base = 0; base < n_items; base += THREADS) {
        const int item = base + tid;
        const int c = item >> lg_lpc, dg = item & (LPC - 1);
        const bool valid = item < n_items;
        const int i = clo + c;
        float mu = NEG_INF;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (valid && dg < n_dg)
          acc = cell_update<RANGED>(a, i, d - i, xt, yt, dg, p1, p2, m1, m2,
                                    r1, r2, mu);
        if (resc) {
          // rescale_cell's max over the cell's states (the padding holds
          // zeros), its division and its log
          float mx = fmaxf(fmaxf(acc.x, acc.y), fmaxf(acc.z, acc.w));
          for (int o = LPC >> 1; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const bool has = mx > 0.f;
          const float den = fmaxf(mx, 1e-37f);
          acc = has ? make_float4(acc.x / den, acc.y / den, acc.z / den,
                                  acc.w / den)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
          mu = has ? mu + logf(den) : NEG_INF;
        }
        if (valid && dg < n_dg)
          *reinterpret_cast<float4*>(p0 + (size_t)i * SaP + dg * TD) = acc;
        if (valid && dg == 0) {
          m0[i] = mu;
          if (mu > NEG_INF / 2) {
            live_lo = min(live_lo, i);
            live_hi = max(live_hi, i);
          }
        }
      }
    } else {
      // products: one thread per (cell, 4 destination states)
      const int n_items = n_cells * n_dg;
      for (int item = tid; item < n_items; item += THREADS) {
        const int c = item / n_dg, dg = item - c * n_dg;
        const int i = clo + c;
        float mu;
        const float4 acc = cell_update<RANGED>(
            a, i, d - i, xt, yt, dg, p1, p2, m1, m2, r1, r2, mu);
        *reinterpret_cast<float4*>(p0 + (size_t)i * SaP + dg * TD) = acc;
        if (dg == 0) {
          m0[i] = mu;
          if (!resc && mu > NEG_INF / 2) {
            live_lo = min(live_lo, i);
            live_hi = max(live_hi, i);
          }
        }
      }
      // rescale on two consecutive diagonals of every rescale_every
      if (resc) {
        __syncthreads();
        for (int i = clo + warp; i <= chi; i += THREADS / 32) {
          rescale_cell(p0 + (size_t)i * SaP, m0 + i, Sa, lane);
          if (lane == 0 && m0[i] > NEG_INF / 2) {
            live_lo = min(live_lo, i);
            live_hi = max(live_hi, i);
          }
        }
      }
    }
    if (RANGED) {
      live_lo = __reduce_min_sync(0xffffffffu, live_lo);
      live_hi = __reduce_max_sync(0xffffffffu, live_hi);
      if (lane == 0 && live_lo <= live_hi) {
        atomicMin(&sh->lo[d & 3], live_lo);
        atomicMax(&sh->hi[d & 3], live_hi);
      }
    }
    __syncthreads();
  }

  // readout at (il, ol) by warp 0; a cell outside the live range holds
  // zeros (and may not have been written)
  float v = NEG_INF;
  if (tid < 32) {
    const int slot = dfin % 3;
    if (!RANGED || (il >= sh->lo[dfin & 3] && il <= sh->hi[dfin & 3]))
      v = readout_warp(pb + ((size_t)slot * W + il) * SaP, mb[slot * W + il],
                       a.wvec, Sa, a.sink, tid);
  }
  return v;
}

// Fills `args` from the C interface's arguments; returns false on a bad plan.
inline bool make_args(Args& args, const void* in_toks, const void* out_toks,
                      const void* in_lens, const void* out_lens,
                      const void* c0, const void* wvec, const void* mt,
                      void* pbuf, void* mbuf, void* out, int B, int Li,
                      int Lo, int Sa, int SaP, int To, int rescale_every,
                      int sink, int n_cls, const int* desc) {
  if (n_cls < 0 || n_cls > MAX_CLS || SaP % TD != 0 || Sa < 1 || Sa > SaP ||
      rescale_every < 1)
    return false;
  args.in_toks = (const int*)in_toks;
  args.out_toks = (const int*)out_toks;
  args.in_lens = (const int*)in_lens;
  args.out_lens = (const int*)out_lens;
  args.c0 = (const float*)c0;
  args.wvec = (const float*)wvec;
  args.mt = (const float*)mt;
  args.pbuf = (float*)pbuf;
  args.mbuf = (float*)mbuf;
  args.out = (float*)out;
  args.B = B; args.Li = Li; args.Lo = Lo; args.Sa = Sa; args.SaP = SaP;
  args.To = To; args.rescale_every = rescale_every; args.sink = sink;
  args.plan.n_cls = n_cls;
  for (int q = 0; q < n_cls; ++q) {
    const int* v = desc + q * DESC_LEN;
    args.plan.cls[q] = ClassDesc{v[0], v[1], v[2]};
  }
  return true;
}

}  // namespace wavefront
