// Per-pair-scale wavefront Forward for full-rank transducers, for Hopper
// (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::_seqscale_kernel
// (variant="seqscale"). The host prep is prepare_seqscale
// (ops/kernels/wavefront_kernel.py): the closure folded into every class,
// F[tok] = C^T A[tok]^T, over the full state vector (no sink trim, readout
// at S-1). The carried invariant is value = p * exp(M) with ONE log scale M
// per pair instead of one per cell, so a cell is just
//   cur = sum over classes of F_class[tok] @ p_c
// with no per-neighbour weights (cell_update() in NO_SCALE mode). On
// diagonals with d % rescale_every <= 1 both live diagonals (d and d-1, the
// two the next step reads) are multiplied by the reciprocal of the pair's
// max over their cells and states, and M absorbs the max's log (a factor
// of 1 when that max is 0).
// Between rescales values drift below 1; a cell more than ~87 nats below
// the pair's largest flushes to zero, as on the TPU. The readout at
// (il, ol) is M + log(p[S-1]).
//
// The TPU kernel kept its state as bf16 hi/lo pairs so that the matrix
// unit's bf16x2 operands were pure copies, and took its per-window max by
// log2(W) doubling lane rolls over the whole padded window; here the state
// is plain f32 (24 bits of mantissa against 2 x 8), the products are f32
// FMAs, and the max runs over the pair's own cells (i <= il, o <= ol): the
// scale is a common factor, so the scores agree up to rounding.
//
// What bounds it on this card: f32 FMAs, S*S per present class per cell
// whose source is not zero (a class whose folded blocks are all zero is
// left out), against the f32 non-tensor rate; the token blocks are read
// through L1/L2. On bench.py's dense machine only the diag class exists,
// so a pair of 200 x 200 reaches 200 of its 40,400 cells: there the bound
// is the walk itself (a pass over every cell of every diagonal and a
// barrier), as for the merged kernel, whose walk this is (one block walks
// whole pairs, three rotating (W, SP) diagonal slots per block;
// wavefront_common.cuh).
//
// Design. The first version took every product of every cell (a per-pair
// scale leaves no per-cell scale to mark a zero cell, so nothing was
// skipped: 29 ms on that machine against merged's 6), and found the pair's
// max with two scalar passes over the live cells of d and d-1, a block
// reduction (two more barriers) and a third scalar pass to scale. Now:
//  * a row of diagonal d that holds a nonzero value carries a tag, step +
//    d, in a (3, W) int scratch beside the slots (`step` numbers the
//    block's diagonals across its pairs, the tags are cleared at launch, so
//    a stale tag never matches). A class whose source row has no tag is
//    all zero and is left out (it would add exact zeros); a cell with no
//    such class is not stored, and every reader of a row (the products,
//    the scale pass, the readout) checks its tag first;
//  * the max of diagonal d comes from the product phase: each thread keeps
//    the max of the float4s it writes, then a warp max, then one shared
//    atomicMax on the float's bits per warp (the values are >= 0, so the
//    integer order is the float order);
//  * the max of d-1 is carried from the previous diagonal, exactly: a
//    round-to-nearest multiplication by a positive factor is monotone, so
//    after a rescale by inv the max is round(max * inv), and without one it
//    is the raw max of the product phase;
//  * the tagged rows of d and d-1 are scaled in one float4 pass with four
//    loads in flight per thread, then one barrier.
// The max word is triple-buffered by d % 3: the word of d+1 is cleared
// during d's product phase, after every thread has read d-2's (a barrier
// lies between), and before anyone adds to it (the barrier after d's
// products), so clearing it needs no barrier of its own. The sums and the
// multiplications are the plain version's (the same order, the same inv),
// so the kernel stays bit-equal to it. For timing, MAX_PASS = true keeps
// the first version's separate max pass and block reduction, and skip = 0
// takes the products of untagged rows too.

#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

constexpr int NWARP = THREADS / 32;

__device__ float block_max(float v, float* s_red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_max(v);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float r = s_red[0];
  for (int q = 1; q < NWARP; ++q) r = fmaxf(r, s_red[q]);
  __syncthreads();           // s_red is free again
  return r;
}

// The class terms of cell (i, o) for destination states dg*TD .. dg*TD+3:
// sum over classes of F_class[tok] @ p_c, the classes in order. p1, tag1 and
// p2, tag2 hold diagonals d-1 and d-2; a source row whose tag is not its
// diagonal's (t1, t2) is all zero, and with `skip` its class is left out
// (it would add exact zeros). Sets `any` when a class was summed.
__device__ __forceinline__ float4 cell_terms(const Args& a, int i, int o,
                                             int dg, const int* xt,
                                             const int* yt, int* bad,
                                             const float* p1, const float* p2,
                                             const int* tag1, const int* tag2,
                                             int t1, int t2, bool skip,
                                             bool& any) {
  const int SaP = a.SaP;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  any = false;
  for (int q = 0; q < a.plan.n_cls; ++q) {
    const ClassDesc& k = a.plan.cls[q];
    int tok, row;
    bool live;
    const float* sp;
    if (k.kind == KIND_UP) {
      if (o < 1) continue;
      tok = __ldg(yt + o - 1);
      row = i;
      sp = p1;
      live = tag1[row] == t1;
    } else if (k.kind == KIND_LEFT) {
      if (i < 1) continue;
      tok = __ldg(xt + i - 1);
      row = i - 1;
      sp = p1;
      live = tag1[row] == t1;
    } else {
      if (i < 1 || o < 1) continue;
      tok = __ldg(xt + i - 1) * a.To + __ldg(yt + o - 1);
      row = i - 1;
      sp = p2;
      live = tag2[row] == t2;
    }
    if (tok < 0 || tok >= k.n_tok) {
      *bad = 1;
      continue;
    }
    if (skip && !live) continue;
    const float4 t = block_dot(
        sp + (size_t)row * SaP,
        a.mt + k.mt_off + (size_t)tok * SaP * SaP + dg * TD, SaP);
    acc.x = fmaf(1.f, t.x, acc.x); acc.y = fmaf(1.f, t.y, acc.y);
    acc.z = fmaf(1.f, t.z, acc.z); acc.w = fmaf(1.f, t.w, acc.w);
    any = true;
  }
  return acc;
}

// Multiplies the live rows of two diagonals by inv: rows lo0.. of p0 (n0
// float4s, tags tag0 == t0) and lo1.. of p1 (the rest of the n float4s,
// tags tag1 == t1), four loads in flight per thread; an all-zero row is
// left as it is.
__device__ __forceinline__ void scale_pass(float* p0, float* p1,
                                           const int* tag0, const int* tag1,
                                           int t0, int t1, int lo0, int lo1,
                                           int n0, int n, int n_dg, int SaP,
                                           float inv) {
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * THREADS) {
    float4 v[4];
    float4* q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * THREADS;
      q[k] = nullptr;
      if (e < n) {
        const bool first = e < n0;
        const int f = first ? e : e - n0;
        const int r = f / n_dg;
        const int row = (first ? lo0 : lo1) + r;
        if (first ? tag0[row] == t0 : tag1[row] == t1) {
          q[k] = reinterpret_cast<float4*>((first ? p0 : p1) +
                                           (size_t)row * SaP) + (f - r * n_dg);
          v[k] = *q[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (q[k] != nullptr) {
        v[k].x *= inv; v[k].y *= inv; v[k].z *= inv; v[k].w *= inv;
        *q[k] = v[k];
      }
    }
  }
}

// One pair, the whole block. `step` numbers the block's diagonals across
// the pairs it walks: a row of diagonal d carries the tag step + d when it
// holds a nonzero value, so tags left by earlier diagonals or pairs never
// match.
template <bool MAX_PASS>
__device__ float walk_seqscale(const Args& a, int b, int* s_bad,
                               unsigned* s_mx, float* s_red, int& step,
                               bool skip) {
  const int tid = threadIdx.x;
  const int W = a.Li + 1;
  const int Sa = a.Sa, SaP = a.SaP;
  const int il = a.in_lens[b];
  const int ol = a.out_lens[b];
  __syncthreads();           // the previous pair's readout and reads are done
  if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) return quiet_nan();
  const int* xt = a.in_toks + (size_t)b * a.Li;
  const int* yt = a.out_toks + (size_t)b * a.Lo;
  float* pb = a.pbuf + (size_t)blockIdx.x * 3 * W * SaP;
  int* tb = reinterpret_cast<int*>(a.mbuf) + (size_t)blockIdx.x * 3 * W;
  const int base = step;
  step += il + ol + 1;
  if (tid == 0) {
    *s_bad = 0;
    s_mx[1] = 0u;            // diagonal 1's word; 2's is cleared at d = 1
  }

  // d = 0: the start cell, and the max of diagonal 0
  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  float carried = 0.f;       // the same in every thread
  for (int s = 0; s < SaP; ++s) carried = fmaxf(carried, __ldg(a.c0 + s));
  if (tid == 0 && carried > 0.f) tb[0] = base;
  float M = 0.f;             // the pair's log scale, the same in every thread
  __syncthreads();

  const int dfin = il + ol;
  const int n_dg = SaP / TD;
  for (int d = 1; d <= dfin; ++d) {
    const int slot0 = d % 3, slot1 = (d + 2) % 3, slot2 = (d + 1) % 3;
    float* p0 = pb + (size_t)slot0 * W * SaP;
    float* p1 = pb + (size_t)slot1 * W * SaP;
    const float* p2 = pb + (size_t)slot2 * W * SaP;
    int* tag0 = tb + slot0 * W;
    const int* tag1 = tb + slot1 * W;
    const int* tag2 = tb + slot2 * W;
    const int t0 = base + d;
    const int lo = max(0, d - ol), hi = min(d, il);
    if (!MAX_PASS && tid == 0) s_mx[slot2] = 0u;   // the word of d + 1

    // products: one thread per (cell, 4 destination states); a cell none
    // of whose sources is live is zero and needs no store, but the
    // max-pass variant reads every cell
    float tmax = 0.f;
    const int n_items = (hi - lo + 1) * n_dg;
    for (int item = tid; item < n_items; item += THREADS) {
      const int c = item / n_dg, dg = item - c * n_dg;
      const int i = lo + c;
      bool any;
      const float4 v = cell_terms(a, i, d - i, dg, xt, yt, s_bad, p1, p2,
                                  tag1, tag2, t0 - 1, t0 - 2, skip, any);
      if (!any && skip && !MAX_PASS) continue;
      *reinterpret_cast<float4*>(p0 + (size_t)i * SaP + dg * TD) = v;
      const float vm = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
      if (vm > 0.f) tag0[i] = t0;
      tmax = fmaxf(tmax, vm);
    }
    if (!MAX_PASS) {
      tmax = warp_max(tmax);
      if ((tid & 31) == 0 && tmax > 0.f)
        atomicMax(s_mx + slot0, __float_as_uint(tmax));
    }
    __syncthreads();

    // the max of d as written (unused by the max-pass variant)
    const float raw = __uint_as_float(
        *static_cast<volatile unsigned*>(s_mx + slot0));
    if (d % a.rescale_every <= 1) {
      // the live cells of diagonals d (rows lo..hi) and d-1 (lo1..hi1)
      const int lo1 = max(0, d - 1 - ol), hi1 = min(d - 1, il);
      const int n0 = (hi - lo + 1) * n_dg, n1 = (hi1 - lo1 + 1) * n_dg;
      float mx;
      if (MAX_PASS) {
        const float* f0 = p0 + (size_t)lo * SaP;
        const float* f1 = p1 + (size_t)lo1 * SaP;
        mx = 0.f;
        for (int e = tid; e < n0 * TD; e += THREADS) mx = fmaxf(mx, f0[e]);
        for (int e = tid; e < n1 * TD; e += THREADS) mx = fmaxf(mx, f1[e]);
        mx = block_max(mx, s_red);
      } else {
        mx = fmaxf(raw, carried);
      }
      // as the TPU kernel: one reciprocal, then a multiply per value
      const float f = mx > 0.f ? mx : 1.f, inv = 1.f / f;
      scale_pass(p0, p1, tag0, tag1, t0, t0 - 1, lo, lo1, n0, n0 + n1, n_dg,
                 SaP, inv);
      M += logf(f);
      carried = raw * inv;   // d's max as scaled: round(raw * inv)
      __syncthreads();
    } else {
      carried = raw;
    }
  }

  float v = NEG_INF;
  if (tid == 0) {
    const int slot = dfin % 3;
    const float e = tb[slot * W + il] == base + dfin
                        ? pb[((size_t)slot * W + il) * SaP + Sa - 1]
                        : 0.f;
    v = e > 0.f ? M + logf(fmaxf(e, 1e-37f)) : NEG_INF;
    if (*s_bad) v = quiet_nan();                           // bad token
  }
  return v;
}

// 4 blocks a multiprocessor: the default grid's 4 per SM in one wave
template <bool MAX_PASS>
__global__ void __launch_bounds__(THREADS, 4)
seqscale_wavefront_kernel(Args a, int skip) {
  __shared__ int s_bad;
  __shared__ unsigned s_mx[3];
  __shared__ float s_red[NWARP];
  // no tag of an earlier launch may match: clear the block's tags (the
  // first walk's opening barrier orders the stores), and number from 1
  const int n_tags = 3 * (a.Li + 1);
  int* tb = reinterpret_cast<int*>(a.mbuf) + (size_t)blockIdx.x * n_tags;
  for (int e = threadIdx.x; e < n_tags; e += THREADS) tb[e] = 0;
  int step = 1;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float v = walk_seqscale<MAX_PASS>(a, b, &s_bad, s_mx, s_red, step,
                                            skip != 0);
    if (threadIdx.x == 0) a.out[b] = v;
  }
}

}  // namespace

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(). The operands are prepare_seqscale's, packed as the
// merged kernel's (source-major (SP, SP) blocks, one descriptor per class);
// `tags` holds grid * 3 * (Li + 1) ints. max_pass = 1 launches the variant
// with the separate max pass; skip = 0 sums every class of every cell, the
// all-zero sources too.
extern "C" int seqscale_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* mt, void* pbuf,
    void* tags, void* out, int B, int Li, int Lo, int S, int SP, int To,
    int rescale_every, int n_cls, const int* desc, int grid, int max_pass,
    int skip, void* stream) {
  Args args;
  if (grid < 1 || max_pass < 0 || max_pass > 1 || skip < 0 || skip > 1 ||
      !make_args(args, in_toks, out_toks, in_lens, out_lens, c0, nullptr,
                 mt, pbuf, tags, out, B, Li, Lo, S, SP, To, rescale_every,
                 0, n_cls, desc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (max_pass)
    seqscale_wavefront_kernel<true>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(args, skip);
  else
    seqscale_wavefront_kernel<false>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(args, skip);
  return (int)cudaGetLastError();
}
