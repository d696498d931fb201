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
// Design: the diagonal state lives in a global scratch of three rotating
// (W, SaP) slots per block (it stays in L2; the active part is
// 3*(il+1)*SaP floats). Only neighbours inside the lattice are ever read, and
// each of those was written earlier in the same walk, so a block that starts
// its next pair needs no clearing of the previous pair's slots. Each thread
// computes 4 neighbouring destination states of one cell: it reads p of the
// neighbour cell as float4s (the same address across the 16 threads of a
// cell, one broadcast) and the token's block, stored source-major, as
// float4s through the read-only cache (neighbouring threads on neighbouring
// addresses).
//
// What bounds it on this card: the work is f32 FMAs, Sa*Sa per class per
// cell whose neighbour of that class is not zero (cell_update skips a
// neighbour with m = NEG_INF); the bytes that must move are tokens,
// lengths and the class blocks. No tensor cores are used, so the bound is
// the f32 non-tensor rate. The class blocks of a 64-state ACGT machine
// (16 x 16 KB) do not fit shared memory and are read through L1/L2, one
// float4 per 4 FMAs. bench.py's dense machine has the diag class only, so
// a pair of 200 x 200 reaches 200 of its 40,400 cells: there the walk over
// the zero cells (an item per cell and 4 states, a barrier, the rescale
// pass) is the cost, not the products.

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

// One cell of one pair: its coordinates in the pair's lattice, the pair's
// tokens, and the flag that a token outside its alphabet sets.
struct Cell {
  int i, o;
  const int* xt;
  const int* yt;
  int* bad;
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

// The class terms of cell c for destination states dg*TD .. dg*TD+3: p1/m1
// hold diagonal d-1 and p2/m2 diagonal d-2 as (W, SaP) / (W,) slots. Each
// term is weighed by exp(m_c - mu), mu the max over the present classes'
// neighbours; a class whose neighbour has m = NEG_INF (a zero cell) adds
// nothing and is skipped. Sets mu to the cell's new log scale before any
// rescale (NEG_INF without a weighted neighbour).
__device__ __forceinline__ float4 cell_update(const Args& a, const Cell& c,
                                              int dg, const float* p1,
                                              const float* p2,
                                              const float* m1,
                                              const float* m2, float& mu) {
  const int i = c.i, o = c.o, SaP = a.SaP;
  float mc[MAX_CLS];
  const float* src[MAX_CLS];
  const float* blk[MAX_CLS];
  mu = NEG_INF;
  for (int q = 0; q < a.plan.n_cls; ++q) {
    const ClassDesc& k = a.plan.cls[q];
    float mv = NEG_INF;
    int tok = 0;
    bool in_lattice = false;
    const float* sp = p1;
    if (k.kind == KIND_UP) {
      if (o >= 1) {
        in_lattice = true;
        mv = m1[i];
        tok = __ldg(c.yt + o - 1);
        sp = p1 + (size_t)i * SaP;
      }
    } else if (k.kind == KIND_LEFT) {
      if (i >= 1) {
        in_lattice = true;
        mv = m1[i - 1];
        tok = __ldg(c.xt + i - 1);
        sp = p1 + (size_t)(i - 1) * SaP;
      }
    } else {
      if (i >= 1 && o >= 1) {
        in_lattice = true;
        mv = m2[i - 1];
        tok = __ldg(c.xt + i - 1) * a.To + __ldg(c.yt + o - 1);
        sp = p2 + (size_t)(i - 1) * SaP;
      }
    }
    if (in_lattice && (tok < 0 || tok >= k.n_tok)) {
      *c.bad = 1;
      tok = 0;
      mv = NEG_INF;
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

// Walks pair b with the whole block. Thread 0 returns the score; every
// thread must call it (it synchronises the block). s_bad is one int of
// shared memory.
//
// CHAINED (chained_wavefront.cu): the pair's lengths are ignored (it is
// walked and read out at the padded (Li, Lo); in_lens may be null) and
// its diagonal d is the absolute step d + off of the chained schedule:
// the rescale fires on (d + off) % rescale_every <= 1, and the start cell
// (0, 0) takes the rescale of its step when off > 0. Unchained (merged,
// chained_ragged) the walk is the same code with off = 0, fixed when it
// is compiled.
template <bool CHAINED = false>
__device__ float walk_pair(const Args& a, int b, int* s_bad, int off = 0) {
  if (!CHAINED) off = 0;
  const int tid = threadIdx.x;
  const int W = a.Li + 1;
  const int Sa = a.Sa, SaP = a.SaP;
  const int il = CHAINED ? a.Li : a.in_lens[b];
  const int ol = CHAINED ? a.Lo : a.out_lens[b];
  // the previous pair's readout must be done before its slots are reused
  __syncthreads();
  if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) return quiet_nan();
  const int* xt = a.in_toks + (size_t)b * a.Li;
  const int* yt = a.out_toks + (size_t)b * a.Lo;
  float* pb = a.pbuf + (size_t)blockIdx.x * 3 * W * SaP;
  float* mb = a.mbuf + (size_t)blockIdx.x * 3 * W;
  if (tid == 0) *s_bad = 0;

  // d = 0: only cell (0, 0), p = c0 (closure row 0), m = 0
  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  if (tid == 0) mb[0] = 0.f;
  __syncthreads();
  if (CHAINED && off > 0 && off % a.rescale_every <= 1) {
    if (tid < 32) rescale_cell(pb, mb, Sa, tid);
    __syncthreads();
  }

  const int dfin = il + ol;
  const int n_dg = SaP / TD;
  for (int d = 1; d <= dfin; ++d) {
    const int slot0 = d % 3, slot1 = (d + 2) % 3, slot2 = (d + 1) % 3;
    float* p0 = pb + (size_t)slot0 * W * SaP;
    const float* p1 = pb + (size_t)slot1 * W * SaP;
    const float* p2 = pb + (size_t)slot2 * W * SaP;
    float* m0 = mb + slot0 * W;
    const float* m1 = mb + slot1 * W;
    const float* m2 = mb + slot2 * W;
    const int lo = max(0, d - ol), hi = min(d, il);

    // products: one thread per (cell, 4 destination states)
    const int n_items = (hi - lo + 1) * n_dg;
    for (int item = tid; item < n_items; item += THREADS) {
      const int c = item / n_dg, dg = item - c * n_dg;
      const int i = lo + c;
      float mu;
      const float4 acc = cell_update(
          a, Cell{i, d - i, xt, yt, s_bad}, dg, p1, p2, m1, m2, mu);
      *reinterpret_cast<float4*>(p0 + (size_t)i * SaP + dg * TD) = acc;
      if (dg == 0) m0[i] = mu;
    }
    __syncthreads();

    // rescale on two consecutive diagonals of every rescale_every
    if ((d + off) % a.rescale_every <= 1) {
      const int warp = tid >> 5, lane = tid & 31;
      for (int i = lo + warp; i <= hi; i += THREADS / 32)
        rescale_cell(p0 + (size_t)i * SaP, m0 + i, Sa, lane);
      __syncthreads();
    }
  }

  // readout at (il, ol) by warp 0
  float v = NEG_INF;
  if (tid < 32) {
    const int slot = dfin % 3;
    v = readout_warp(pb + ((size_t)slot * W + il) * SaP, mb[slot * W + il],
                     a.wvec, Sa, a.sink, tid);
    if (*s_bad) v = quiet_nan();                           // bad token
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
