// Low-rank wavefront Forward for structured transducers, for Hopper (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/lowrank_kernel.py::_lowrank_kernel in
// both its modes: plain (one pair per lane window) and chained
// (_body_chained, n_chain uniform-length pairs staggered by Lo + 2
// diagonals). The host prep is the same (prepare_lowrank in
// ops/kernels/lowrank_kernel.py): the silent closure is folded into each
// neighbour class, dead states are pruned (Sa live states) and every class
// is factored at its minimum rank on the source or destination side.
//
// What it computes, per pair b, on the cells (i, o) of its lattice, diagonal
// d = i + o, carried as scaled probabilities p (Sa floats) with a per-cell
// log scale m (float64):
//   * each present class reads one neighbour: up (i, o-1) and left (i-1, o)
//     on d-1, diag (i-1, o-1) on d-2; w_c = exp(m_c - mu), mu = max m_c;
//   * a src-side class adds  M_c @ concat_r(p_c * w_c * E_c[r-block, tok]),
//     a dest-side class adds sum_r (M_c @ (p_c * w_c))[r-block] * E_c[., tok];
//   * on diagonals with (d + off) % rescale_every <= 1 (both parities) p is
//     divided by its max over states and the log of that max is added to m;
//   * the readout is m + log(p[Sa-1]) at cell (il, ol).
// Plain mode: off = 0, the pair's own lengths. Chained mode: the pairs'
// lengths are ignored (every pair is read out at the padded (Li, Lo)) and
// pair n starts on absolute diagonal off = (Lo + 2) * (n / (B / n_chain)),
// which the rescale rule reads; its start cell is rescaled when off > 0 and
// its own step fires (plain_walk.walk_plain with diag_offset). A token
// outside its class's alphabet makes the pair NaN, and so does a length
// outside the padded shape in plain mode.
//
// What bounds it on this card: operations. A cell does sum_c rank_c * Sa^2
// multiply-adds (3.0e4 at prot2dna, 3.9e11 FLOP for its B=512 batch: 5.75 ms
// at the f32 non-tensor 67 TFLOP/s); the bytes that must move are tokens,
// lengths and the 0.2 MB of factors. The products here run on the tensor
// cores in TF32 with the 3xTF32 split (one TF32 pass is ruled out: the
// signed SVD factors cancel; scripts/lowrank_variants.py measures one
// pass), so the rate the design runs at is 3 x those FLOP over 495 TFLOP/s
// TF32 dense, 2.3 ms, before the padding of the tiles (states to 16, cells
// to 8, k to 8) and below what mma.sync reaches (wgmma is later work).
//
// Design, against what held the first CUDA version back:
//  1. A persistent grid: one block per multiprocessor (or fewer for a small
//     batch) takes pairs from an atomic counter in the host's order
//     (longest first in plain mode), so the factor tables load once per
//     block and the diagonal scratch in global memory is grid x walkers
//     pairs, not B.
//  2. The factor tables in shared memory, packed by the host in the A
//     fragment order of mma.m16n8k8 (one float4 per lane per 16x8 tile).
//     When all 16-row tiles fit beside the operand chunk they are copied in
//     once per block (resident); otherwise groups of 16-row tiles are
//     streamed through a double-buffered ring with cp.async, the next
//     group's copy overlapping the current group's products (streamed).
//     One kernel, the size parameter `seg_mt` (tiles per group) decides. The
//     token scales E go to shared memory too where they fit.
//  3. The class products on the tensor cores: mma.sync m16n8k8 TF32, each
//     operand split into hi (x rounded to TF32) and lo = x - hi, and
//     acc += hi_a hi_b + (hi_a lo_b + lo_a hi_b) in f32 (the small terms in
//     their own accumulator, issued after the big ones). Destination states
//     are the 16-row side, the cells of a diagonal the 8-column side. A
//     src-side class multiplies the token-scaled operand; a dest-side class
//     keeps one accumulator tile per rank and scales it by E[(r, d), tok] in
//     the epilogue. mma.sync and not wgmma: the split happens in registers
//     after one shared load; wgmma would need a resident hi and lo copy of
//     its shared operand.
//  4. Less latency between barriers: a warp builds one cell's operand column
//     at a time, its loads issued before its stores (no per-element division
//     or class search); the pair's tokens, the cells' log scales and the
//     rescale divisors live in shared memory, so a diagonal reads only its
//     neighbours' states from global memory; the rescale is folded into the
//     products (each cell's max by a shared atomicMax on the float's bits,
//     exact for the positive maxima that matter) and its division into the
//     weights of the next reads (w / den, once per neighbour cell).
//     Two pair walkers run in a block, each a group of warps with its own
//     named barrier (bar.sync 1 + walker), sharing the resident factors, so
//     one walker's loads overlap the other's products.
//     Past the lengths where the pair's tokens no longer fit beside the
//     chunk (Li + Lo words), the walker reads them from global memory
//     through L1/L2 (`pair_mode` 1), and past those where the cells' log
//     scales, divisors and maxima (7 (Li + 1) words) do not fit either, they
//     live in a global buffer of the walker's own (`pair_mode` 2), as the
//     diagonal states already do. launch_plan picks the mode by size alone,
//     the shared one wherever it fits; each mode is its own instantiation
//     of the kernel, so the shared mode's loads stay shared loads.
//  5. Chained mode is the same per-pair walk with a diagonal offset: no
//     strip schedule, the whole grid busy.
//  6. One walker computes a pair, in a fixed order, with no atomic sums (a
//     max does not depend on the order): the scores do not depend on the
//     grid or the walkers.
//  7. The cells' log scales and the scores are float64 (the states and all
//     products stay float32): a float32 scale gains a rounding of its own
//     size at every rescale, and a GeneWise pair against tens of kilobases
//     of genomic DNA takes some 10^4 of them along its path at scales near
//     10^4-10^5 nats; in float32 that drifted 0.033 nats from the float64
//     oracle at 16 aa x 10,048 nt (the plain version, on the CPU), past the
//     0.01-nat gate. The TPU kernel keeps them in float32.

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 512;
constexpr int MAX_CLS = 3;
constexpr int NG_MAX = 3;        // 8-cell tiles per warp item
constexpr int PV = 4;            // states a lane loads per pass of the build
constexpr int FRAG_B = 64;       // floats of one 8x8 B tile, fragment order
constexpr int SMEM_MAX = 232448; // a block's shared memory on sm_90
constexpr int NO_MAX = (int)0x80000000;  // below every float's bits

enum { KIND_UP = 0, KIND_LEFT = 1, KIND_DIAG = 2 };
enum { SIDE_SRC = 0, SIDE_DEST = 1 };

// Per-class descriptor, laid out as the host passes it (DESC_LEN ints).
struct ClassDesc {
  int kind;    // KIND_*
  int side;    // SIDE_*
  int rank;
  int n_tok;
  int KT;      // k-tiles (8 rows) of this class's operand
  int na;      // A tile groups per 16-row tile: 1 (src) or rank (dest)
  int a_off;   // float offset of this class inside a 16-row slab
  int e_off;   // float offset of this class's ET (n_tok x rank*Sa)
  int z_row;   // first operand row of this class (a multiple of 8)
};
constexpr int DESC_LEN = 9;

struct Args {
  const int* in_toks;
  const int* out_toks;
  const int* in_lens;
  const int* out_lens;
  const float* c0;
  const float* a;      // n_mt slabs of packed A tiles
  const float* et;     // every class's ET, packed
  float* pbuf;
  double* out;
  const int* order;
  int* counter;
  int B, Li, Lo, Sa, SaP, To, rescale_every, n_chain;
  int n_cls;
  ClassDesc cls[MAX_CLS];
  int n_mt, slab, KZ, CC, seg_mt, walkers;
  int et_floats;       // ET floats copied to shared memory (0: read global)
};

// Shared memory: the A tiles (all n_mt slabs, or a ring of two groups of
// seg_mt), the token scales ET when they fit (et_floats, a multiple of 4),
// then per walker: the operand chunk Z (KZ/8 k-tiles of CC/8 B tiles,
// stride zstride), the chunk's tokens per class, the bad-token flag and the
// next pair's slot (4), per cell of three diagonal slots its log scale (a
// double: 3 W of them) and its rescale divisor (3 W) and the current
// diagonal's max bits (W), W = Li + 1 (pair_mode 0 and 1; in pair_mode 2
// these 10 W words are the walker's in `cbuf`), then the pair's tokens
// (Li + Lo; pair_mode 0 only); rounded up to 4 floats. The words before the
// log scales are even in number, so the doubles are 8-byte aligned.
enum { PAIR_SHARED = 0, TOKENS_GLOBAL = 1, CELLS_GLOBAL = 2 };
__host__ __device__ inline int zstride(int CC) { return CC / 8 * FRAG_B + 8; }
__host__ __device__ inline long a_floats(int n_mt, int slab, int seg_mt) {
  return seg_mt >= n_mt ? (long)n_mt * slab : 2L * seg_mt * slab;
}
__host__ __device__ inline long cell_floats(int Li) { return 10L * (Li + 1); }
__host__ __device__ inline long walker_floats(int KZ, int CC, int Li, int Lo,
                                              int pair_mode) {
  long n = (long)(KZ / 8) * zstride(CC) + MAX_CLS * CC + 4;
  if (pair_mode != CELLS_GLOBAL) n += cell_floats(Li);
  if (pair_mode == PAIR_SHARED) n += Li + Lo;
  return (n + 3) / 4 * 4;
}
long smem_bytes(int n_mt, int slab, int seg_mt, int KZ, int CC, int walkers,
                int et_floats, int Li, int Lo, int pair_mode) {
  return (a_floats(n_mt, slab, seg_mt) + et_floats +
          walkers * walker_floats(KZ, CC, Li, Lo, pair_mode)) *
         (long)sizeof(float);
}

struct Walker {
  const float* et;   // the token scales: in shared memory, or global
  float* Z;
  int* tok;          // the chunk's tokens, per class
  int* bad;
  int* next;
  const int* xs;     // the pair's tokens
  const int* ys;
  double* ms;        // log scales, 3 slots of W cells
  float* dn;         // rescale divisors (1: none, 0: zeroed), 3 slots
  int* mx;           // the current diagonal's max over states, float bits
  int id, tid, nthr, warp, nwarps, lane;
  float* pb;         // global: 3 slots of W cells of SaP states
};

__device__ __forceinline__ void wbar(const Walker& w) {
  named_bar(w.id + 1, w.nthr);
}

// Operand element (row k, cell column c) of the chunk, in B fragment order:
// b0 = B[t][g], b1 = B[t + 4][g] for lane g * 4 + t.
__device__ __forceinline__ int zpos(int k, int c, int zs) {
  return (k >> 3) * zs + (c >> 3) * FRAG_B +
         (((c & 7) * 4 + (k & 3)) << 1) + ((k >> 2) & 1);
}

// Copy the 16-row slabs mt0 .. mt0 + nmt - 1 into `dst` (asynchronously).
__device__ void load_slabs(const Args& a, float* dst, int mt0, int nmt,
                           const Walker& w) {
  const float* src = a.a + (size_t)mt0 * a.slab;
  const int n4 = nmt * a.slab / 4;
  for (int v = w.tid; v < n4; v += w.nthr)
    cp_async16(dst + v * 4, src + v * 4);
  cp_async_commit();
}

// The rescale of a cell whose max over states has the bits `bits`: its
// divisor (0 when the max is not positive: the cell is zeroed) and its new
// log scale.
__device__ __forceinline__ void rescale_cell(int bits, float* dn, double* ms) {
  const float mx = __int_as_float(bits);
  const bool has = mx > 0.f;
  const float den = fmaxf(mx, 1e-37f);
  *dn = has ? den : 0.f;
  *ms = has ? *ms + (double)logf(den) : (double)NEG_INF;
}

// Build the operand chunk of cells cs .. cs + ncc - 1 of diagonal d (slots
// s0, s1 = d-1, s2 = d-2): one cell per warp, every lane computing the
// cell's class weights and tokens and loading its states s0p + lane + 32 j
// of every neighbour before anything is stored, so that the loads overlap;
// lane 0 writes the cell's new log scale, its divisor and its tokens.
template <int PM>
__device__ void build(const Args& a, const Walker& w, int d, int cs, int ncc,
                      int s0, int s1, int s2, bool fire) {
  const int Sa = a.Sa, SaP = a.SaP, CC = a.CC, zs = zstride(CC);
  const int W = a.Li + 1;
  const float* p1 = w.pb + (size_t)s1 * W * SaP;
  const float* p2 = w.pb + (size_t)s2 * W * SaP;
  for (int c = w.warp; c < ncc; c += w.nwarps) {
    const int i = cs + c, o = d - i;
    double mq[MAX_CLS];
    float wq[MAX_CLS], dq[MAX_CLS];
    int tq[MAX_CLS];
    const float* src[MAX_CLS];
    double mu = NEG_INF;
#pragma unroll
    for (int q = 0; q < MAX_CLS; ++q) {
      double mv = NEG_INF;
      float dv = 1.f;
      int tok = 0;
      src[q] = nullptr;
      if (q < a.n_cls) {
        const ClassDesc& k = a.cls[q];
        int sl = s1, cell = -1;
        if (k.kind == KIND_UP) {
          if (o >= 1) { cell = i; tok = w.ys[o - 1]; }
        } else if (k.kind == KIND_LEFT) {
          if (i >= 1) { cell = i - 1; tok = w.xs[i - 1]; }
        } else if (i >= 1 && o >= 1) {
          sl = s2;
          cell = i - 1;
          tok = w.xs[i - 1] * a.To + w.ys[o - 1];
        }
        if (cell >= 0) {
          mv = w.ms[sl * W + cell];
          dv = w.dn[sl * W + cell];
          src[q] = (sl == s1 ? p1 : p2) + (size_t)cell * SaP;
        }
        if (tok < 0 || tok >= k.n_tok) {
          if (w.lane == 0) *w.bad = 1;
          tok = 0;
        }
      }
      mq[q] = mv;
      dq[q] = dv;
      tq[q] = tok;
      mu = fmax(mu, mv);
    }
    const double mu_safe = mu > NEG_INF / 2 ? mu : 0.0;
    for (int s0p = 0; s0p < Sa; s0p += 32 * PV) {
      float pv[MAX_CLS][PV];
#pragma unroll
      for (int q = 0; q < MAX_CLS; ++q)
#pragma unroll
        for (int j = 0; j < PV; ++j) {
          const int s = s0p + w.lane + 32 * j;
          pv[q][j] = src[q] != nullptr && s < Sa ? src[q][s] : 0.f;
        }
      if (s0p == 0) {
        // the weights, with the neighbour's pending rescale folded in:
        // w / den (the plain version divides p by den first, so the two
        // differ by rounding only), one division per neighbour
#pragma unroll
        for (int q = 0; q < MAX_CLS; ++q) {
          const float wv =
              mq[q] > NEG_INF / 2 ? expf((float)(mq[q] - mu_safe)) : 0.f;
          wq[q] = wv == 0.f ? 0.f : dq[q] == 1.f ? wv : wv / dq[q];
        }
        if (w.lane == 0) {
          w.ms[s0 * W + i] = mu;
          w.dn[s0 * W + i] = 1.f;
          if (fire) w.mx[i] = NO_MAX;
#pragma unroll
          for (int q = 0; q < MAX_CLS; ++q)
            if (q < a.n_cls) w.tok[q * CC + c] = tq[q];
        }
      }
#pragma unroll
      for (int q = 0; q < MAX_CLS; ++q) {
        if (q >= a.n_cls) break;
        const ClassDesc& k = a.cls[q];
        const float wv = wq[q];
        const float* e = w.et + k.e_off + tq[q] * k.rank * Sa;
#pragma unroll
        for (int j = 0; j < PV; ++j) {
          const int s = s0p + w.lane + 32 * j;
          if (s >= Sa) break;
          const float z = wv != 0.f ? pv[q][j] * wv : 0.f;
          if (k.side == SIDE_SRC) {
            for (int r = 0; r < k.rank; ++r)
              w.Z[zpos(k.z_row + r * Sa + s, c, zs)] =
                  wv != 0.f ? z * e[r * Sa + s] : 0.f;
          } else {
            w.Z[zpos(k.z_row + s, c, zs)] = z;
          }
        }
      }
    }
  }
}

// The class products of one group of 16-row tiles (mt0 .. mt0 + nmt - 1,
// their slabs at `As`) for the chunk's nt cell tiles, written to p0; on a
// rescale diagonal each cell's max over states goes to w.mx.
template <int PM>
__device__ void products(const Args& a, const Walker& w, const float* As,
                         int mt0, int nmt, int cs, int ncc, float* p0,
                         bool fire) {
  const int Sa = a.Sa, SaP = a.SaP, CC = a.CC, zs = zstride(CC);
  const int nt = (ncc + 7) / 8;
  int ng = (nmt * nt + w.nwarps - 1) / w.nwarps;
  ng = min(NG_MAX, max(1, ng));
  const int groups = (nt + ng - 1) / ng;
  ng = (nt + groups - 1) / groups;
  const int g = w.lane >> 2, t = w.lane & 3;
  for (int item = w.warp; item < nmt * groups; item += w.nwarps) {
    const int ml = item / groups;
    const int nt0 = (item - ml * groups) * ng;
    const int nn = min(ng, nt - nt0);
    const int mt = mt0 + ml;
    const float* slab = As + (size_t)ml * a.slab;
    float acc[NG_MAX][4];
#pragma unroll
    for (int j = 0; j < NG_MAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int q = 0; q < a.n_cls; ++q) {
      const ClassDesc& k = a.cls[q];
      const float* zq = w.Z + (k.z_row >> 3) * zs + nt0 * FRAG_B + w.lane * 2;
      for (int r = 0; r < k.na; ++r) {
        const float* ar = slab + k.a_off + r * k.KT * FRAG_A + w.lane * 4;
        float tb[NG_MAX][4], ts[NG_MAX][4];
#pragma unroll
        for (int j = 0; j < NG_MAX; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tb[j][e] = ts[j][e] = 0.f;
#pragma unroll 2
        for (int kt = 0; kt < k.KT; ++kt) {
          const float4 av = *reinterpret_cast<const float4*>(ar + kt * FRAG_A);
          uint32_t ah[4], al[4];
          split(av.x, ah[0], al[0]);
          split(av.y, ah[1], al[1]);
          split(av.z, ah[2], al[2]);
          split(av.w, ah[3], al[3]);
          uint32_t bh[NG_MAX][2], bl[NG_MAX][2];
#pragma unroll
          for (int j = 0; j < NG_MAX; ++j) {
            if (j < nn) {
              const float2 bv = *reinterpret_cast<const float2*>(
                  zq + kt * zs + j * FRAG_B);
              split(bv.x, bh[j][0], bl[j][0]);
              split(bv.y, bh[j][1], bl[j][1]);
            }
          }
          // the big products first, then the two small ones: products into
          // one accumulator are issued NG_MAX apart
#pragma unroll
          for (int j = 0; j < NG_MAX; ++j)
            if (j < nn) mma_tf32(tb[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < NG_MAX; ++j)
            if (j < nn) mma_tf32(ts[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
          for (int j = 0; j < NG_MAX; ++j)
            if (j < nn) mma_tf32(ts[j], al, bh[j][0], bh[j][1]);
        }
        // epilogue: c0 = C[g][2t], c1 = C[g][2t+1], c2/c3 rows g + 8
#pragma unroll
        for (int j = 0; j < NG_MAX; ++j) {
          if (j >= nn) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = tb[j][e] + ts[j][e];
            if (k.side == SIDE_SRC) {
              acc[j][e] += v;
            } else {
              const int dst = mt * 16 + g + (e >> 1) * 8;
              const int col = (nt0 + j) * 8 + 2 * t + (e & 1);
              if (dst < Sa && col < ncc) {
                const int tok = w.tok[q * CC + col];
                acc[j][e] += v * w.et[k.e_off + tok * k.rank * Sa +
                                      r * Sa + dst];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NG_MAX; ++j) {
      if (j >= nn) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dst = mt * 16 + g + (e >> 1) * 8;
        const int col = (nt0 + j) * 8 + 2 * t + (e & 1);
        if (dst < Sa && col < ncc)
          p0[(size_t)(cs + col) * SaP + dst] = acc[j][e];
      }
      if (fire) {
        // each cell's max over this tile's 16 rows (the padded rows hold
        // 0), across the lanes of one t, then one atomic per cell
        float m0 = fmaxf(acc[j][0], acc[j][2]);
        float m1 = fmaxf(acc[j][1], acc[j][3]);
        for (int off = 4; off < 32; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        const int col = (nt0 + j) * 8 + 2 * t;
        if (g == 0 && col < ncc)
          atomicMax(w.mx + cs + col, __float_as_int(m0));
        if (g == 0 && col + 1 < ncc)
          atomicMax(w.mx + cs + col + 1, __float_as_int(m1));
      }
    }
  }
}

// One diagonal d over cells lo..hi, in chunks of at most CC cells, then the
// rescale's divisors. Every thread of the walker calls it; it ends
// synchronised.
template <int PM>
__device__ void step(const Args& a, const Walker& w, float* A, int d, int lo,
                     int hi, int off) {
  const int W = a.Li + 1, SaP = a.SaP;
  const int s0 = d % 3, s1 = (d + 2) % 3, s2 = (d + 1) % 3;
  float* p0 = w.pb + (size_t)s0 * W * SaP;
  const bool fire = (d + off) % a.rescale_every <= 1;
  const bool resident = a.seg_mt >= a.n_mt;
  const int n = hi - lo + 1;
  const int nch = (n + a.CC - 1) / a.CC;
  const int per = ((n + nch - 1) / nch + 7) / 8 * 8;
  for (int cs = lo; cs <= hi; cs += per) {
    const int ncc = min(per, hi - cs + 1);
    if (!resident) load_slabs(a, A, 0, min(a.seg_mt, a.n_mt), w);
    build<PM>(a, w, d, cs, ncc, s0, s1, s2, fire);
    if (resident) {
      wbar(w);
      products<PM>(a, w, A, 0, a.n_mt, cs, ncc, p0, fire);
    } else {
      const int n_seg = (a.n_mt + a.seg_mt - 1) / a.seg_mt;
      const size_t ring = (size_t)a.seg_mt * a.slab;
      for (int sg = 0; sg < n_seg; ++sg) {
        if (sg + 1 < n_seg) {
          const int nxt = (sg + 1) * a.seg_mt;
          load_slabs(a, A + ((sg + 1) & 1) * ring, nxt,
                     min(a.seg_mt, a.n_mt - nxt), w);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        wbar(w);
        const int mt0 = sg * a.seg_mt;
        products<PM>(a, w, A + (sg & 1) * ring, mt0,
                     min(a.seg_mt, a.n_mt - mt0), cs, ncc, p0, fire);
        if (sg + 1 < n_seg) wbar(w);
      }
    }
    wbar(w);
  }
  // rescale on two consecutive diagonals of every rescale_every: the
  // divisors; the states are divided where they are next read
  if (fire) {
    for (int i = lo + w.tid; i <= hi; i += w.nthr)
      rescale_cell(w.mx[i], w.dn + s0 * W + i, w.ms + s0 * W + i);
    wbar(w);
  }
}

// Walk pair b from its start cell to its readout and write its score.
template <int PM>
__device__ void walk_pair(const Args& a, const Walker& w, float* A, int b) {
  const int W = a.Li + 1;
  int il, ol, off = 0;
  if (a.n_chain > 0) {
    il = a.Li;
    ol = a.Lo;
    off = (a.Lo + 2) * (b / (a.B / a.n_chain));
  } else {
    il = a.in_lens[b];
    ol = a.out_lens[b];
    if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) {
      if (w.tid == 0)
        a.out[b] = __longlong_as_double(0x7ff8000000000000LL);  // bad length
      return;
    }
  }
  // d = 0: only cell (0, 0), p = c0 (closure row 0), m = 0; the tokens
  Walker wg = w;                     // pair_mode 1, 2: tokens in global
  for (int s = w.tid; s < a.SaP; s += w.nthr) w.pb[s] = a.c0[s];
  if constexpr (PM == PAIR_SHARED) {
    int* xs = const_cast<int*>(w.xs);
    int* ys = const_cast<int*>(w.ys);
    for (int t = w.tid; t < a.Li; t += w.nthr)
      xs[t] = a.in_toks[(size_t)b * a.Li + t];
    for (int t = w.tid; t < a.Lo; t += w.nthr)
      ys[t] = a.out_toks[(size_t)b * a.Lo + t];
  } else {
    wg.xs = a.in_toks + (size_t)b * a.Li;
    wg.ys = a.out_toks + (size_t)b * a.Lo;
  }
  if (w.warp == 0) {
    // the chained start cell takes its step's rescale
    float mx = -3.4e38f;
    for (int s = w.lane; s < a.Sa; s += 32) mx = fmaxf(mx, a.c0[s]);
    mx = warp_max(mx);
    if (w.lane == 0) {
      *w.bad = 0;
      w.ms[0] = 0.0;
      w.dn[0] = 1.f;
      if (off > 0 && off % a.rescale_every <= 1)
        rescale_cell(__float_as_int(mx), w.dn, w.ms);
    }
  }
  wbar(w);
  const int dfin = il + ol;
  if constexpr (PM == PAIR_SHARED) {
    for (int d = 1; d <= dfin; ++d)
      step<PM>(a, w, A, d, max(0, d - ol), min(d, il), off);
  } else {
    for (int d = 1; d <= dfin; ++d)
      step<PM>(a, wg, A, d, max(0, d - ol), min(d, il), off);
  }
  if (w.tid == 0) {
    const int slot = dfin % 3;
    const float den = w.dn[slot * W + il];
    float e = w.pb[((size_t)slot * W + il) * a.SaP + a.Sa - 1];
    e = den == 1.f ? e : den > 0.f ? e / den : 0.f;
    const double m = w.ms[slot * W + il];
    double v = e > 0.f ? m + (double)logf(fmaxf(e, 1e-37f)) : NEG_INF;
    if (*w.bad) v = __longlong_as_double(0x7ff8000000000000LL);  // bad token
    a.out[b] = v;
  }
}

// cbuf: pair_mode 2's 10 W floats a walker (a parameter of its own: a field
// more in Args can change ptxas's allocation of the whole kernel)
template <int PM>
__global__ void __launch_bounds__(THREADS, 1)
lowrank_wavefront_kernel(Args a, float* cbuf) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const bool resident = a.seg_mt >= a.n_mt;
  float* A = sm;
  const long af = a_floats(a.n_mt, a.slab, a.seg_mt) + a.et_floats;
  const long wf = walker_floats(a.KZ, a.CC, a.Li, a.Lo, PM);
  if (resident) {
    const float4* src = reinterpret_cast<const float4*>(a.a);
    float4* dst = reinterpret_cast<float4*>(A);
    for (long v = threadIdx.x; v < (long)a.n_mt * a.slab / 4; v += THREADS)
      dst[v] = src[v];
  }
  float* et_s = sm + (af - a.et_floats);
  for (long v = threadIdx.x; v < a.et_floats; v += THREADS) et_s[v] = a.et[v];
  // zero the walkers' regions: operand rows past a class's K and columns
  // past a chunk's cells are never written, and must not hold NaN
  for (long v = af + threadIdx.x; v < af + a.walkers * wf; v += THREADS)
    sm[v] = 0.f;
  __syncthreads();

  Walker w;
  w.nthr = THREADS / a.walkers;
  w.id = threadIdx.x / w.nthr;
  w.tid = threadIdx.x - w.id * w.nthr;
  w.warp = w.tid >> 5;
  w.nwarps = w.nthr >> 5;
  w.lane = threadIdx.x & 31;
  const int W = a.Li + 1;
  float* base = sm + af + w.id * wf;
  w.et = a.et_floats > 0 ? et_s : a.et;
  w.Z = base;
  w.tok = reinterpret_cast<int*>(base + (long)(a.KZ / 8) * zstride(a.CC));
  w.bad = w.tok + MAX_CLS * a.CC;
  w.next = w.bad + 1;
  const size_t slot = (size_t)blockIdx.x * a.walkers + w.id;
  float* cells = reinterpret_cast<float*>(w.bad + 4);
  if constexpr (PM == CELLS_GLOBAL) cells = cbuf + slot * cell_floats(a.Li);
  w.ms = reinterpret_cast<double*>(cells);
  w.dn = reinterpret_cast<float*>(w.ms + 3 * W);
  w.mx = reinterpret_cast<int*>(w.dn + 3 * W);
  w.xs = w.ys = nullptr;             // pair_mode 1 and 2: set per pair
  if constexpr (PM == PAIR_SHARED) {
    w.xs = w.mx + W;
    w.ys = w.xs + a.Li;
  }
  w.pb = a.pbuf + slot * 3 * W * a.SaP;

  for (;;) {
    wbar(w);                   // everyone has read the previous *next
    if (w.tid == 0) *w.next = atomicAdd(a.counter, 1);
    wbar(w);
    const int k = *w.next;
    if (k >= a.B) break;
    const int b = a.order[k];
    if (b < 0 || b >= a.B) continue;       // not an index of this batch
    walk_pair<PM>(a, w, A, b);
  }
}

}  // namespace

extern "C" long lowrank_wavefront_smem_bytes(int n_mt, int slab, int seg_mt,
                                             int KZ, int CC, int walkers,
                                             int et_floats, int Li, int Lo,
                                             int pair_mode) {
  return smem_bytes(n_mt, slab, seg_mt, KZ, CC, walkers, et_floats, Li, Lo,
                    pair_mode);
}

// Launches the kernel on `stream` with `grid` blocks of `walkers` pair
// walkers each and returns cudaGetLastError(): nonzero means the launch was
// refused. et_floats > 0 copies that many floats of `et` (all of it, padded
// to a multiple of 4) into shared memory. n_chain = 0 is plain mode (the
// lengths are read); n_chain >= 1 chained mode (B a multiple of n_chain,
// the lengths not read). `order` holds the B pair indices in the order the
// walkers take them; `counter` is one int that the caller has set to 0.
// pair_mode: the pair's tokens and cells in shared memory (0), the tokens
// read from global memory (1), and the cells' 10 (Li + 1) floats too, in
// `cbuf`, grid * walkers of them (2; cbuf is not read otherwise).
extern "C" int lowrank_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* a_tiles,
    const void* et, void* pbuf, void* out, const void* order, void* counter,
    void* cbuf, int B, int Li, int Lo, int Sa, int SaP, int To,
    int rescale_every, int n_cls, const int* desc, int n_mt, int slab, int KZ,
    int CC, int seg_mt, int walkers, int et_floats, int grid, int n_chain,
    int pair_mode, void* stream) {
  if (n_cls < 0 || n_cls > MAX_CLS || rescale_every < 1 || CC < 8 ||
      CC % 8 != 0 || KZ % 8 != 0 || slab % FRAG_A != 0 || seg_mt < 1 ||
      (walkers != 1 && walkers != 2) || (seg_mt < n_mt && walkers != 1) ||
      grid < 1 || n_chain < 0 || Sa > n_mt * 16 || SaP < Sa ||
      et_floats < 0 || et_floats % 4 != 0 || Li < 0 || Lo < 0 ||
      pair_mode < PAIR_SHARED || pair_mode > CELLS_GLOBAL ||
      (pair_mode == CELLS_GLOBAL && cbuf == nullptr) ||
      (n_chain > 0 && (B % n_chain != 0 || Li < 1 || Lo < 1)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.in_lens = (const int*)in_lens;
  a.out_lens = (const int*)out_lens;
  a.c0 = (const float*)c0;
  a.a = (const float*)a_tiles;
  a.et = (const float*)et;
  a.pbuf = (float*)pbuf;
  a.out = (double*)out;
  a.order = (const int*)order;
  a.counter = (int*)counter;
  a.B = B; a.Li = Li; a.Lo = Lo; a.Sa = Sa; a.SaP = SaP; a.To = To;
  a.rescale_every = rescale_every;
  a.n_chain = n_chain;
  a.n_cls = n_cls;
  for (int q = 0; q < n_cls; ++q) {
    const int* v = desc + q * DESC_LEN;
    a.cls[q] = ClassDesc{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7],
                         v[8]};
    if (a.cls[q].z_row % 8 != 0 || a.cls[q].z_row + 8 * a.cls[q].KT > KZ)
      return (int)cudaErrorInvalidValue;
  }
  a.n_mt = n_mt; a.slab = slab; a.KZ = KZ; a.CC = CC; a.seg_mt = seg_mt;
  a.walkers = walkers;
  a.et_floats = et_floats;
  const long smem = smem_bytes(n_mt, slab, seg_mt, KZ, CC, walkers, et_floats,
                              Li, Lo, pair_mode);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = lowrank_wavefront_kernel<CELLS_GLOBAL>;
  if (pair_mode == PAIR_SHARED) kern = lowrank_wavefront_kernel<PAIR_SHARED>;
  if (pair_mode == TOKENS_GLOBAL)
    kern = lowrank_wavefront_kernel<TOKENS_GLOBAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a, (float*)cbuf);
  return (int)cudaGetLastError();
}
