// Destination-factored wavefront Forward, for Hopper (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::_factored_kernel
// (variant="factored"). The host prep is prepare_factored
// (ops/kernels/wavefront_kernel.py): trailing sink states are trimmed as for
// the merged kernel (Sa states, readout w . p), and each class tensor is
// factored per destination column (ops/kernels/factorize.py):
//   A[t, s, s'] = sum_r T_r[s, s'] * E_r[t, s'].
// Per cell (i, o), with mu = max of the present classes' neighbours' log
// scales and w_c = exp(m_c - mu):
//   pre[s'] = sum_c w_c sum_r (sum_s T_r[s, s'] p_c[s]) * E_r[tok_c, s'],
//   cur = C^T pre (the closure as its own product: the per-destination token
//   scale keeps it out of the factors);
// then the merged kernel's rescale (d % rescale_every <= 1), NEG_INF rules
// and readout. prot2dna's ranks are 4 (up), 1 (left) and 0 (diag: absent).
//
// What bounds it on this card: operations. A cell does
// sum_c R_c (Sa^2 + Sa) + Sa^2 multiply-adds (1.32e12 FLOP for prot2dna's
// B=512 batch: 19.75 ms at the f32 non-tensor 67 TFLOP/s). The tables (T 343
// KB, E 19 KB, C^T 70 KB at prot2dna) are larger than a block's shared
// memory, so they stream.
//
// Design (the first CUDA version read every table through L1/L2 once per
// cell and 4 destination states, round-tripped pre through global memory and
// took three or four block barriers a diagonal):
//  1. A persistent grid: one block of 512 threads per multiprocessor takes
//     pairs from an atomic counter, longest first. A block walks `ns` pairs
//     (1 or 2: "walkers") in lockstep, one diagonal of each per step: their
//     cells are the columns of one product, so every table byte streamed into
//     the block serves both pairs. When a pair is read out its walker takes
//     the next one at the next step.
//  2. The states in shared memory: the states of the diagonals a step reads
//     live there as a row-major (state, cell) operand: `up` reads cell i of
//     d-1, `left` cell i-1 of d-1, `diag` cell i-1 of d-2, so one operand
//     serves every class and the neighbour shift is a column offset. Stage
//     A takes, per (class, rank), T_r^T against it and adds w_c E_r[tok, s']
//     times the product into `pre` in shared memory, one (class, rank)
//     after the other in a fixed order. Stage B takes C^T pre and writes the
//     cells' states straight back into the operand (no state in global
//     memory) and, on a rescale diagonal, each cell's max by a shared
//     atomicMax on the float's bits; the fired cells are then divided by it
//     in place, as the plain version divides.
//  3. The products: stage A on the f32 pipes, in register tiles (a lane owns
//     4 cells x 4 destination states, fed by one float4 of the states and
//     one of the unit a source state), stage B on the tensor cores as
//     3xTF32 mma.sync m16n8k8 (tf32_mma.cuh; destination states on the
//     16-row side, cells on the 8-column side). The class factors are signed
//     SVD factors that cancel: 3xTF32's products carry about 8 times
//     float32's rounding, which on the 64-state dense machine's deep pairs
//     moved the score 1.8e-3 nats from the float32 plain version and, on
//     other pairs, 5.5e-3 nats from float64 (scripts/factored_numerics.py);
//     the closure is non-negative and keeps the tensor cores. Folding the
//     rescale's division into the next read's weight, as the lowrank kernel
//     does, moved that score 4.3e-3 nats from the plain version too, so the
//     states are divided.
//  4. The tables in shared memory: the host packs T (per class and rank,
//     source-major) and C^T (A-fragment order) as "units" of 16 destination
//     rows x all source states (pack_factored). When every unit fits they
//     are copied in once (resident); otherwise groups of `seg` units stream
//     through a double-buffered cp.async ring, the next group's copy (across
//     the end of a step too) overlapping the current group's products. E
//     goes to shared memory where it fits. factored_launch_plan
//     (ops/kernels/wavefront_kernel.py) chooses ns, seg and E's place; a
//     plan that does not fit is refused.
//  5. Past the lengths where a whole diagonal's state operands no longer fit
//     beside the tables (prot2dna: about 200 cells a diagonal), the
//     chunked layout (`CC` > 0, one walker): the walker's last three
//     diagonals of states and its cells' log scales live in a global buffer
//     of the block's own (3 x KP x W states, a row of W cells a state, and
//     3 W scales), and a step takes the diagonal in chunks of at most CC
//     cells, as the lowrank kernel takes its operand chunk: the chunk's
//     neighbour cells of d-1 and d-2 are copied into the shared operand
//     (zero outside their diagonals' cells), stages A and B run on the
//     chunk as on a whole diagonal (the tables streamed once a chunk), and
//     stage B writes the chunk's states to the global diagonal, which the
//     rescale then divides in place; the pair's tokens are read from global
//     memory. factored_launch_plan picks it by size alone, the whole
//     diagonal wherever it fits; each layout is its own instantiation of
//     the kernel, so the whole-diagonal layout's loads stay shared loads.
//  6. Deterministic: every output element is summed in one fixed order
//     (units in class and rank order, source states in order) and a max
//     does not depend on the order, so the scores do not depend on the grid,
//     the walkers or the group size.

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_CLS = 3;
constexpr int MAX_NS = 2;
constexpr int MAX_NR = 128;      // ranks summed over the classes
constexpr int NG_MAX = 3;        // 8-cell tiles per warp item (stage B)
constexpr int CELL0 = 4;         // a walker's cell 0 in the state operand
constexpr int SMEM_MAX = 232448; // a block's shared memory on sm_90
constexpr int NO_MAX = (int)0x80000000;  // below every float's bits

enum { KIND_UP = 0, KIND_LEFT = 1, KIND_DIAG = 2 };
// a walker's state, 16 ints in shared memory
enum { ST_B = 0, ST_D, ST_IL, ST_OL, ST_BAD, ST_ACT, ST_DONE, ST_CS,
       ST_NT = 15 };                      // ST_CS: the chunk's first cell

struct FacClass {
  int kind;    // KIND_*
  int n_tok;
  int rank;
  int e_off;   // float offset of its E, [n_tok][rank][SaP]
};
constexpr int FDESC_LEN = 4;

// The smallest row stride of at least n floats whose lanes (k = t, t + 4 of
// a B fragment, t = 0..3, columns g = 0..7) fall on 32 distinct banks.
__host__ __device__ inline int bank_stride(int n) {
  int s = (n + 7) / 8 * 8;
  while (s % 32 != 8 && s % 32 != 24) s += 8;
  return s;
}
__host__ __device__ inline long up4(long n) { return (n + 3) / 4 * 4; }

// Shared memory, in floats: the tables (all units, or a ring of two groups
// of seg units), E (e_floats, 0: read from global memory), the state
// operands (nbp buffers of KP rows, stride PS: walker s's cell i at column
// s * CS + CELL0 + i, 16-byte aligned, the column before it the missing
// cell -1, zero), pre (KP rows, stride
// QS, cell i at s * CQ + i), per class and cell the weight and the token,
// three roles of log scales, the rescale's maxima, the pairs'
// tokens, the walkers' state and the step's tile list. The chunked layout
// (CC > 0, one walker) lays out CQ = CC cells where the whole one lays out
// the diagonal's, keeps the maxima of a chunk's cells, and has no log
// scales or tokens here (chunk_gfloats: the block's global buffer, the
// scales then the states, a diagonal of KP rows of WG cells).
struct Layout {
  long tab, e, p, pre, wgt, tok, ms, mx, xs, ys, st, tl, total;
  int W, CQ, CS, KP, PS, QS, WG;
  bool resident, chunked;
};

__host__ __device__ inline Layout layout(int Sa, int NR, int Li, int Lo,
                                         int ns, int nbp, int seg,
                                         int e_floats, int CC) {
  Layout L;
  const int KT = (Sa + 7) / 8, n_mt = (Sa + 15) / 16;
  const long U = (long)KT * FRAG_A;
  const long NU = (long)n_mt * (NR + 1);
  L.W = Li + 1;
  L.chunked = CC > 0;
  L.CQ = L.chunked ? CC : (L.W + 7) / 8 * 8;
  L.CS = L.CQ + CELL0;
  L.KP = KT * 8;
  L.WG = (int)up4(L.W);
  L.PS = bank_stride(ns * L.CS);
  L.QS = bank_stride(ns * L.CQ);
  L.resident = seg >= NU;
  long o = 0;
  L.tab = o; o += L.resident ? NU * U : 2L * seg * U;
  L.e = o; o += up4(e_floats);
  L.p = o; o += (long)nbp * L.KP * L.PS;
  L.pre = o; o += (long)L.KP * L.QS;
  L.wgt = o; o += up4((long)MAX_CLS * ns * L.CQ);
  L.tok = o; o += up4((long)MAX_CLS * ns * L.CQ);
  L.ms = o; if (!L.chunked) o += up4(3L * ns * L.W);
  L.mx = o; o += up4((long)ns * (L.chunked ? L.CQ : L.W));
  L.xs = o; if (!L.chunked) o += up4((long)ns * Li);
  L.ys = o; if (!L.chunked) o += up4((long)ns * Lo);
  L.st = o; o += 16L * ns;
  L.tl = o; o += up4((long)ns * L.CQ / 8);
  L.total = o;
  return L;
}

// Floats of a block's global buffer in the chunked layout.
__host__ __device__ inline long chunk_gfloats(int Sa, int Li) {
  const long W = Li + 1, KP = (Sa + 7) / 8 * 8;
  return up4(3 * W) + 3 * KP * up4(W);
}

struct Args {
  const int* in_toks;
  const int* out_toks;
  const int* in_lens;
  const int* out_lens;
  const int* order;
  int* counter;
  const float* c0;     // (SaP,)
  const float* wv;     // (SaP,) sink readout vector
  const float* tab;    // the units: stage A (k-major), then stage B
  const float* ek;     // every class's E
  float* out;
  int B, Li, Lo, Sa, To, rescale_every, sink;
  int n_cls;
  FacClass cls[MAX_CLS];
  int NR, KT, n_mt, SaP, ns, nbp, seg, e_floats;
  unsigned char kq[MAX_NR], kr[MAX_NR];   // unit row k -> (class, rank)
};

struct Smem {
  float* tab;
  const float* E;
  float* P;
  float* pre;
  float* wgt;
  int* tok;
  float* ms;
  int* mx;
  int* xs;
  int* ys;
  int* st;
  int* tl;
  float* G;            // the chunked layout: three diagonals of states
};

// Walker s's input token i and output token o.
template <bool CH>
__device__ __forceinline__ int tok_x(const Args& a, const Smem& S, int s,
                                     int i) {
  if constexpr (CH) return a.in_toks[(long)S.st[16 * s + ST_B] * a.Li + i];
  return S.xs[s * a.Li + i];
}
template <bool CH>
__device__ __forceinline__ int tok_y(const Args& a, const Smem& S, int s,
                                     int o) {
  if constexpr (CH) return a.out_toks[(long)S.st[16 * s + ST_B] * a.Lo + o];
  return S.ys[s * a.Lo + o];
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// The score of walker s's pair from its last diagonal (states in P buffer
// `pb`, or in the chunked layout in global diagonal `rm`; log scales in
// role `rm`); lane 0 writes it.
template <bool CH>
__device__ void readout(const Args& a, const Layout& L, const Smem& S, int s,
                        int pb, int rm, int lane) {
  const int* st = S.st + 16 * s;
  const int il = st[ST_IL];
  const float* pc = CH ? S.G + (long)rm * L.KP * L.WG + il
                       : S.P + (long)pb * L.KP * L.PS + s * L.CS + CELL0 + il;
  const long ks = CH ? L.WG : L.PS;
  float e = 0.f;
  if (a.sink) {
    for (int k = lane; k < a.Sa; k += 32)
      e = fmaf(pc[(long)k * ks], a.wv[k], e);
    for (int off = 16; off > 0; off >>= 1)
      e += __shfl_xor_sync(0xffffffffu, e, off);
  } else {
    e = pc[(long)(a.Sa - 1) * ks];
  }
  if (lane == 0) {
    const int c = (rm * a.ns + s) * L.W + il;
    float v = e > 0.f ? S.ms[c] + logf(fmaxf(e, 1e-37f)) : NEG_INF;
    if (st[ST_BAD]) v = nan_f();                              // bad token
    a.out[st[ST_B]] = v;
  }
}

// Warp s before a step: advance walker s to its next diagonal; read out a
// pair that is complete and take pairs from the queue until one needs a
// step (or the queue is empty). The d = 0 state goes to the role the step
// reads as d - 1.
template <bool CH>
__device__ void prep(const Args& a, const Layout& L, const Smem& S, int s,
                     int lane, int pb, int rm) {
  int* st = S.st + 16 * s;
  if (st[ST_ACT]) {
    const int d = st[ST_D] + 1;
    __syncwarp();
    if (lane == 0) st[ST_D] = d;
    if (d > st[ST_IL] + st[ST_OL]) {
      readout<CH>(a, L, S, s, pb, rm, lane);
      __syncwarp();
      if (lane == 0) st[ST_ACT] = 0;
    }
    __syncwarp();
  }
  while (!st[ST_ACT] && !st[ST_DONE]) {
    int k = 0;
    if (lane == 0) k = atomicAdd(a.counter, 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    if (k >= a.B) {
      if (lane == 0) st[ST_DONE] = 1;
      __syncwarp();
      break;
    }
    const int b = a.order[k];
    if (b < 0 || b >= a.B) continue;       // not an index of this batch
    const int il = a.in_lens[b], ol = a.out_lens[b];
    if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) {
      if (lane == 0) a.out[b] = nan_f();   // bad length
      continue;
    }
    if constexpr (CH) {
      // the start cell of global diagonal rm; the chunks' operands are
      // copied from the diagonals' own cells only
      float* p0 = S.G + (long)rm * L.KP * L.WG;
      for (int v = lane; v < a.Sa; v += 32) p0[(long)v * L.WG] = a.c0[v];
    } else {
      for (int v = lane; v < a.Li; v += 32)
        S.xs[s * a.Li + v] = a.in_toks[(long)b * a.Li + v];
      for (int v = lane; v < a.Lo; v += 32)
        S.ys[s * a.Lo + v] = a.out_toks[(long)b * a.Lo + v];
      // the walker's columns of every state buffer: zero, then the start
      // cell
      for (int q = 0; q < a.nbp; ++q) {
        float* pq = S.P + (long)q * L.KP * L.PS + s * L.CS;
        for (int v = lane; v < L.KP * L.CS; v += 32)
          pq[(long)(v / L.CS) * L.PS + v % L.CS] = 0.f;
      }
      __syncwarp();
      float* p0 = S.P + (long)pb * L.KP * L.PS + s * L.CS + CELL0;
      for (int v = lane; v < a.Sa; v += 32) p0[(long)v * L.PS] = a.c0[v];
    }
    if (lane == 0) {
      const int c = (rm * a.ns + s) * L.W;
      S.ms[c] = 0.f;
      st[ST_B] = b;
      st[ST_D] = 0;
      st[ST_IL] = il;
      st[ST_OL] = ol;
      st[ST_BAD] = 0;
      st[ST_ACT] = 1;
    }
    __syncwarp();
    if (il + ol == 0) {                    // read out at the start cell
      readout<CH>(a, L, S, s, pb, rm, lane);
      __syncwarp();
      if (lane == 0) st[ST_ACT] = 0;
      __syncwarp();
    } else if (lane == 0) {
      st[ST_D] = 1;
    }
    __syncwarp();
  }
}

// Copy units u0 .. u1 - 1 into `dst` (asynchronously, every thread).
__device__ void load_units(const Args& a, float* dst, int u0, int u1) {
  const long U = (long)a.KT * FRAG_A;
  const float* src = a.tab + u0 * U;
  const long n4 = (u1 - u0) * U / 4;
  for (long v = threadIdx.x; v < n4; v += THREADS)
    cp_async16(dst + v * 4, src + v * 4);
  cp_async_commit();
}

// Group g of a step: units [u0, u1) of stage A (groups 0 .. nga - 1), then
// of stage B.
__device__ __forceinline__ void group_units(const Args& a, bool resident,
                                            int g, int& u0, int& u1) {
  const int NA = a.n_mt * a.NR;
  const int seg = resident ? NA + a.n_mt : a.seg;
  const int nga = resident ? 1 : (NA + seg - 1) / seg;
  if (g < nga) {
    u0 = resident ? 0 : g * seg;
    u1 = resident ? NA : min(NA, u0 + seg);
  } else {
    u0 = resident ? NA : NA + (g - nga) * seg;
    u1 = resident ? NA + a.n_mt : min(NA + a.n_mt, u0 + seg);
  }
}

// The items of a group: (unit row tile m, group of `ng` cell tiles), as
// many tiles an item as fill the warps once (at most NG_MAX: each A fragment
// loaded and split serves ng tiles).
__device__ __forceinline__ int tile_groups(int n_m, int T, int& ng) {
  ng = min(NG_MAX, max(1, (n_m * T + NWARPS - 1) / NWARPS));
  const int groups = (T + ng - 1) / ng;
  ng = (T + groups - 1) / groups;
  return groups;
}

// Stage A on units [u0, u1) (k-major: unit u is rank row k = u / n_mt of
// destination tile m = u % n_mt), their rows at Tb: pre += w E (T_r^T p),
// on the f32 pipes. A unit is stored source-major, [s][16 destination
// rows]. A warp item is one destination tile against 32 of the step's
// cells; lane c * 4 + g owns destination rows 4g .. 4g + 3 and cells
// 4c .. 4c + 3: per source state one float4 of the unit and one aligned
// float4 of the states (and, for a class that reads cell i - 1, the one
// state before it) feed 16 multiply-adds. The two neighbour shifts have a
// loop each: a select per source state measured slower.
template <bool CH>
__device__ void stage_a(const Args& a, const Layout& L, const Smem& S,
                        const float* Tb, int u0, int u1, int pb_prev,
                        int pb_prev2, int lane, int warp) {
  const long U = (long)a.KT * FRAG_A;
  const int n_pos = S.st[ST_NT] * 8;          // the step's cells, by tile
  const int n_ch = (n_pos + 31) / 32;
  const int n_m = min(a.n_mt, u1 - u0);
  const int nsq = a.ns * L.CQ;
  const int cg = lane >> 2, rg = lane & 3;
  for (int item = warp; item < n_m * n_ch; item += NWARPS) {
    const int ml = item / n_ch;
    const int ch = item - ml * n_ch;
    const int m = (u0 + ml) % a.n_mt;
    const int pos = ch * 32 + cg * 4;
    const bool live = pos < n_pos;
    const int e0 = live ? S.tl[pos >> 3] : 0;
    const int sj = e0 >> 16;
    const int cell = live ? (e0 & 0xffff) * 8 + (pos & 7) : 0;
    for (int u = u0 + ml; u < u1; u += a.n_mt) {
      const int k = u / a.n_mt;
      const int q = a.kq[k], r = a.kr[k];
      const FacClass& c = a.cls[q];
      const float* bcol =
          S.P + (long)(c.kind == KIND_DIAG ? pb_prev2 : pb_prev) * L.KP * L.PS +
          sj * L.CS + CELL0 + cell;
      const float4* ar =
          reinterpret_cast<const float4*>(Tb + (u - u0) * U) + rg;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (c.kind == KIND_UP) {              // cells i of d-1
#pragma unroll 4
        for (int s = 0; s < a.Sa; ++s) {
          const float4 x = ar[s * 4];
          const float4 y =
              *reinterpret_cast<const float4*>(bcol + (long)s * L.PS);
          const float av[4] = {x.x, x.y, x.z, x.w};
          const float bv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      } else {                              // cells i - 1
#pragma unroll 4
        for (int s = 0; s < a.Sa; ++s) {
          const float4 x = ar[s * 4];
          const float* b = bcol + (long)s * L.PS;
          const float4 y = *reinterpret_cast<const float4*>(b);
          const float av[4] = {x.x, x.y, x.z, x.w};
          const float bv[4] = {b[-1], y.x, y.y, y.z};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      // epilogue: pre (+)= product * w * E[tok][r][dst], rank row k after
      // rank row k - 1
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = q * nsq + sj * L.CQ + cell + j;
        const float w = S.wgt[ci];
        const float* ep = S.E + c.e_off + (S.tok[ci] * c.rank + r) * a.SaP;
        float* pp = S.pre + sj * L.CQ + cell + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dst = m * 16 + rg * 4 + i;
          if (dst < a.Sa) {
            const float v = w != 0.f ? acc[i][j] * w * ep[dst] : 0.f;
            float* pd = pp + (long)dst * L.QS;
            *pd = (k == 0 ? 0.f : *pd) + v;
          }
        }
      }
    }
  }
}

// Stage B on units [u0, u1) (destination tile m = u - NA): the states
// C^T pre of the step's cells into P buffer `pb_out` (the chunked layout:
// the chunk's cells of global diagonal `gout`); on a rescale diagonal each
// cell's max over states into mx.
template <bool CH>
__device__ void stage_b(const Args& a, const Layout& L, const Smem& S,
                        const float* Tb, int u0, int u1, int pb_out,
                        float* gout, int lane, int warp) {
  const long U = (long)a.KT * FRAG_A;
  const int NA = a.n_mt * a.NR;
  const int T = S.st[ST_NT];
  const int n_m = u1 - u0;
  int ng;
  const int groups = tile_groups(n_m, T, ng);
  const int g = lane >> 2, t = lane & 3;
  float* Po = S.P + (long)pb_out * L.KP * L.PS;
  const int cs = CH ? S.st[ST_CS] : 0;   // the chunk's first cell
  for (int item = warp; item < n_m * groups; item += NWARPS) {
    const int ml = item / groups;
    const int t0 = (item - ml * groups) * ng;
    const int nn = min(ng, T - t0);
    const int m = u0 + ml - NA;
    int sj[NG_MAX], cj[NG_MAX], lo[NG_MAX], hi[NG_MAX];
    bool fire[NG_MAX];
#pragma unroll
    for (int j = 0; j < NG_MAX; ++j) {
      const int e = j < nn ? S.tl[t0 + j] : 0;
      sj[j] = e >> 16;
      cj[j] = (e & 0xffff) * 8;
      const int* st = S.st + 16 * sj[j];
      const int d = st[ST_D];
      lo[j] = max(0, d - st[ST_OL]);
      hi[j] = min(d, st[ST_IL]);
      fire[j] = d % a.rescale_every <= 1;
    }
    const float* ar = Tb + (u0 + ml - u0) * U + lane * 4;
    float tb[NG_MAX][4], ts[NG_MAX][4];
#pragma unroll
    for (int j = 0; j < NG_MAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tb[j][e] = ts[j][e] = 0.f;
    const float* bq[NG_MAX];
#pragma unroll
    for (int j = 0; j < NG_MAX; ++j)
      bq[j] = S.pre + (long)t * L.QS + sj[j] * L.CQ + cj[j] + g;
#pragma unroll 4
    for (int kt = 0; kt < a.KT; ++kt) {
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
          const float* bp = bq[j] + (long)kt * 8 * L.QS;
          split(bp[0], bh[j][0], bl[j][0]);
          split(bp[4 * L.QS], bh[j][1], bl[j][1]);
        }
      }
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
#pragma unroll
    for (int j = 0; j < NG_MAX; ++j) {
      if (j >= nn) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = tb[j][e] + ts[j][e];
        const int dst = m * 16 + g + (e >> 1) * 8;
        const int cell = cj[j] + 2 * t + (e & 1);
        if (dst < a.Sa && cs + cell >= lo[j] && cs + cell <= hi[j]) {
          if constexpr (CH)
            gout[(long)dst * L.WG + cs + cell] = v[e];
          else
            Po[(long)dst * L.PS + sj[j] * L.CS + CELL0 + cell] = v[e];
        }
      }
      if (fire[j]) {
        // each cell's max over this tile's 16 rows (the padded rows hold
        // 0), across the lanes of one t, then one atomic per cell
        float m0 = fmaxf(v[0], v[2]);
        float m1 = fmaxf(v[1], v[3]);
        for (int off = 4; off < 32; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        const int cell = cj[j] + 2 * t;
        int* mx = CH ? S.mx : S.mx + sj[j] * L.W;
        if (g == 0 && cs + cell >= lo[j] && cs + cell <= hi[j])
          atomicMax(mx + cell, __float_as_int(m0));
        if (g == 0 && cs + cell + 1 >= lo[j] && cs + cell + 1 <= hi[j])
          atomicMax(mx + cell + 1, __float_as_int(m1));
      }
    }
  }
}

// Cell i of walker s on diagonal d: each class's weight and token into
// column c of the weights (position ci0 + c of a class's row), its new log
// scale into role rm_out, and its max reset on a rescale diagonal (at
// mx_at).
template <bool CH>
__device__ __forceinline__ void cell_weights(const Args& a, const Layout& L,
                                             const Smem& S, int s, int d,
                                             int i, int ci, int mx_at,
                                             int nsq, int rm_out, int rm_prev,
                                             int rm_prev2) {
  const int o = d - i;
  float wq[MAX_CLS];
  int tq[MAX_CLS];
  float mu = NEG_INF;
  for (int q = 0; q < a.n_cls; ++q) {
    const FacClass& c = a.cls[q];
    int rl = rm_prev, cell = -1, tok = 0;
    if (c.kind == KIND_UP) {
      if (o >= 1) { cell = i; tok = tok_y<CH>(a, S, s, o - 1); }
    } else if (c.kind == KIND_LEFT) {
      if (i >= 1) { cell = i - 1; tok = tok_x<CH>(a, S, s, i - 1); }
    } else if (i >= 1 && o >= 1) {
      rl = rm_prev2;
      cell = i - 1;
      tok = tok_x<CH>(a, S, s, i - 1) * a.To + tok_y<CH>(a, S, s, o - 1);
    }
    float mv = NEG_INF;
    if (cell >= 0) {
      mv = S.ms[(rl * a.ns + s) * L.W + cell];
      if (tok < 0 || tok >= c.n_tok) {
        S.st[16 * s + ST_BAD] = 1;
        tok = 0;
        mv = NEG_INF;
      }
    }
    wq[q] = mv;
    tq[q] = tok;
    mu = fmaxf(mu, mv);
  }
  const float mu_safe = mu > NEG_INF / 2 ? mu : 0.f;
  for (int q = 0; q < a.n_cls; ++q) {
    S.wgt[q * nsq + ci] = wq[q] > NEG_INF / 2 ? expf(wq[q] - mu_safe) : 0.f;
    S.tok[q * nsq + ci] = tq[q];
  }
  S.ms[(rm_out * a.ns + s) * L.W + i] = mu;
  if (d % a.rescale_every <= 1) S.mx[mx_at] = NO_MAX;
}

// The rescale of cell i's state k (in `pk`) by its max's bits, and, for
// k == 0, of its log scale m: divided by the max (a cell whose max is not
// positive zeroed), the log of the max added to the scale.
__device__ __forceinline__ void rescale_state(int bits, int k, float* pk,
                                              float* m) {
  const float mx = __int_as_float(bits);
  const bool has = mx > 0.f;
  const float den = fmaxf(mx, 1e-37f);
  *pk = has ? *pk / den : 0.f;
  if (k == 0) *m = has ? *m + logf(den) : NEG_INF;
}

// CH: the chunked layout, CC cells a chunk, gbuf chunk_gfloats a block
// (parameters of their own: a field more in Args can change ptxas's
// allocation of the whole kernel)
template <bool CH>
__global__ void __launch_bounds__(THREADS, 1)
factored_wavefront_kernel(Args a, float* gbuf, int CC) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout L = layout(a.Sa, a.NR, a.Li, a.Lo, a.ns, a.nbp, a.seg,
                          a.e_floats, CH ? CC : 0);
  Smem S;
  S.tab = sm + L.tab;
  S.E = a.e_floats > 0 ? sm + L.e : a.ek;
  S.P = sm + L.p;
  S.pre = sm + L.pre;
  S.wgt = sm + L.wgt;
  S.tok = reinterpret_cast<int*>(sm + L.tok);
  S.mx = reinterpret_cast<int*>(sm + L.mx);
  S.st = reinterpret_cast<int*>(sm + L.st);
  S.tl = reinterpret_cast<int*>(sm + L.tl);
  if constexpr (CH) {
    float* g = gbuf + (long)blockIdx.x * chunk_gfloats(a.Sa, a.Li);
    S.ms = g;
    S.G = g + up4(3L * L.W);
    S.xs = S.ys = nullptr;
  } else {
    S.ms = sm + L.ms;
    S.xs = reinterpret_cast<int*>(sm + L.xs);
    S.ys = reinterpret_cast<int*>(sm + L.ys);
    S.G = nullptr;
  }
  const long U = (long)a.KT * FRAG_A;
  const int NA = a.n_mt * a.NR, NU = NA + a.n_mt;
  const bool resident = L.resident;

  // everything past E is zero (a token of 0 is valid, 0 states are finite)
  for (long v = L.p + tid; v < L.total; v += THREADS) sm[v] = 0.f;
  if (resident) {
    const float4* src = reinterpret_cast<const float4*>(a.tab);
    float4* dst = reinterpret_cast<float4*>(S.tab);
    for (long v = tid; v < NU * U / 4; v += THREADS) dst[v] = src[v];
  }
  for (long v = tid; v < a.e_floats; v += THREADS) sm[L.e + v] = a.ek[v];
  const int n_groups = resident ? 2
                                : (NA + a.seg - 1) / a.seg +
                                      (a.n_mt + a.seg - 1) / a.seg;
  if (!resident) {
    int u0, u1;
    group_units(a, false, 0, u0, u1);
    load_units(a, S.tab, u0, u1);
  }
  __syncthreads();

  const int nsq = a.ns * L.CQ;
  long rg = 0;                   // groups consumed: the ring's parity
  // the step's (or the chunk's) groups of units: stage A, then stage B
  auto groups = [&](int pb_prev, int pb_prev2, int pb_out, float* gout) {
    for (int g = 0; g < n_groups; ++g) {
      int u0, u1;
      group_units(a, resident, g, u0, u1);
      const float* Tb;
      if (resident) {
        Tb = S.tab + u0 * U;
      } else {
        // the next group's copy (the next step's first after the last)
        int v0, v1;
        group_units(a, false, g + 1 < n_groups ? g + 1 : 0, v0, v1);
        load_units(a, S.tab + ((rg + 1) & 1) * a.seg * U, v0, v1);
        cp_async_wait<1>();
        __syncthreads();
        Tb = S.tab + (rg & 1) * a.seg * U;
      }
      if (u0 < NA)
        stage_a<CH>(a, L, S, Tb, u0, u1, pb_prev, pb_prev2, lane, warp);
      else
        stage_b<CH>(a, L, S, Tb, u0, u1, pb_out, gout, lane, warp);
      __syncthreads();
      ++rg;
    }
  };
  for (int step = 0;; ++step) {
    // roles: P buffer written (out), read as d-1 (prev) and as d-2 (prev2);
    // log scales (and the chunked layout's global diagonals) likewise over
    // three roles
    const int pb_out = step % a.nbp;
    const int pb_prev = (step + 1) % a.nbp;
    const int pb_prev2 = pb_out;
    const int rm_out = step % 3, rm_prev = (step + 2) % 3,
              rm_prev2 = (step + 1) % 3;
    if (warp < a.ns) prep<CH>(a, L, S, warp, lane, pb_prev, rm_prev);
    __syncthreads();
    int n_act = 0;
    for (int s = 0; s < a.ns; ++s) n_act += S.st[16 * s + ST_ACT];
    if (n_act == 0) break;

    if constexpr (CH) {
      // one walker; the diagonal in chunks of at most CQ cells, the
      // neighbours copied into P buffers 0 (d-1) and 1 (d-2)
      const int* st = S.st;
      const int d = st[ST_D], il = st[ST_IL], ol = st[ST_OL];
      const int lo = max(0, d - ol), hi = min(d, il);
      const int lo1 = max(0, d - 1 - ol), hi1 = min(d - 1, il);
      const int lo2 = max(0, d - 2 - ol), hi2 = min(d - 2, il);
      const bool fire = d % a.rescale_every <= 1;
      const long dg = (long)L.KP * L.WG;
      float* gout = S.G + rm_out * dg;
      const float* gin1 = S.G + rm_prev * dg;
      const float* gin2 = S.G + rm_prev2 * dg;
      const int n = hi - lo + 1;
      const int nch = (n + L.CQ - 1) / L.CQ;
      const int per = ((n + nch - 1) / nch + 7) / 8 * 8;
      for (int cs = lo; cs <= hi; cs += per) {
        const int ncc = min(per, hi - cs + 1);
        // the neighbours: cells cs - 1 .. cs + ncc - 1 at columns CELL0 - 1
        // on, zero outside their diagonal's cells
        const int ncol = ncc + 1;
        for (int idx = tid; idx < a.nbp * a.Sa * ncol; idx += THREADS) {
          const int q = idx / (a.Sa * ncol);
          const int rest = idx - q * a.Sa * ncol;
          const int k = rest / ncol, c = rest - k * ncol;
          const int cell = cs - 1 + c;
          const bool in = q ? cell >= lo2 && cell <= hi2
                            : cell >= lo1 && cell <= hi1;
          const float* gi = q ? gin2 : gin1;
          S.P[q * L.KP * L.PS + (long)k * L.PS + CELL0 - 1 + c] =
              in ? gi[(long)k * L.WG + cell] : 0.f;
        }
        for (int c = tid; c < ncc; c += THREADS)
          cell_weights<CH>(a, L, S, 0, d, cs + c, c, c, nsq, rm_out, rm_prev,
                           rm_prev2);
        if (tid == 0) {
          int nt = 0;
          for (int j = 0; j * 8 < ncc; ++j) S.tl[nt++] = j;
          S.st[ST_NT] = nt;
          S.st[ST_CS] = cs;
        }
        __syncthreads();
        groups(0, a.nbp > 1 ? 1 : 0, 0, gout);
        if (fire) {
          for (int idx = tid; idx < a.Sa * ncc; idx += THREADS) {
            const int k = idx / ncc, c = idx - k * ncc;
            rescale_state(S.mx[c], k, gout + (long)k * L.WG + cs + c,
                          S.ms + rm_out * L.W + cs + c);
          }
        }
        __syncthreads();
      }
      continue;
    }

    // each cell's class weights, tokens and new log scale
    for (int idx = tid; idx < nsq; idx += THREADS) {
      const int s = idx / L.CQ, i = idx - s * L.CQ;
      const int* st = S.st + 16 * s;
      if (!st[ST_ACT]) continue;
      const int d = st[ST_D];
      const int lo = max(0, d - st[ST_OL]), hi = min(d, st[ST_IL]);
      if (i < lo || i > hi) continue;
      cell_weights<CH>(a, L, S, s, d, i, s * L.CQ + i, s * L.W + i, nsq,
                       rm_out, rm_prev, rm_prev2);
    }
    if (tid == 0) {
      // the step's 8-cell tiles, (walker << 16) | tile
      int n = 0;
      for (int s = 0; s < a.ns; ++s) {
        const int* st = S.st + 16 * s;
        if (!st[ST_ACT]) continue;
        const int d = st[ST_D];
        const int lo = max(0, d - st[ST_OL]), hi = min(d, st[ST_IL]);
        for (int j = lo / 8; j <= hi / 8; ++j) S.tl[n++] = (s << 16) | j;
      }
      S.st[ST_NT] = n;
    }
    __syncthreads();

    groups(pb_prev, pb_prev2, pb_out, nullptr);

    // the rescale, on two consecutive diagonals of every rescale_every:
    // each fired cell's states divided by their max (a cell whose max is
    // not positive zeroed), the log of the max added to its scale
    for (long idx = tid; idx < (long)a.ns * L.W * a.Sa; idx += THREADS) {
      const int s = (int)(idx / ((long)L.W * a.Sa));
      const int rest = (int)(idx - (long)s * L.W * a.Sa);
      const int i = rest / a.Sa, k = rest - i * a.Sa;
      const int* st = S.st + 16 * s;
      if (!st[ST_ACT]) continue;
      const int d = st[ST_D];
      if (d % a.rescale_every > 1) continue;
      if (i < max(0, d - st[ST_OL]) || i > min(d, st[ST_IL])) continue;
      rescale_state(S.mx[s * L.W + i], k,
                    S.P + (long)pb_out * L.KP * L.PS + (long)k * L.PS +
                        s * L.CS + CELL0 + i,
                    S.ms + (rm_out * a.ns + s) * L.W + i);
    }
    __syncthreads();
  }
  if (!resident) cp_async_wait<0>();
}

}  // namespace

extern "C" long factored_wavefront_smem_bytes(int Sa, int NR, int Li, int Lo,
                                              int ns, int nbp, int seg,
                                              int e_floats, int CC) {
  return layout(Sa, NR, Li, Lo, ns, nbp, seg, e_floats, CC).total *
         (long)sizeof(float);
}

extern "C" long factored_wavefront_chunk_gfloats(int Sa, int Li) {
  return chunk_gfloats(Sa, Li);
}

// Launches the kernel on `stream` with `grid` blocks of `ns` walkers and
// returns cudaGetLastError(): nonzero means the launch was refused. desc:
// FDESC_LEN ints per class (kind, n_tok, rank, e_off). `tab` holds the
// n_mt * NR stage-A units (k-major: rank row k of destination tile m at
// k * n_mt + m) and the n_mt stage-B units, each KT A tiles in fragment
// order; seg >= n_mt * (NR + 1) keeps them resident. e_floats > 0 copies
// that many floats of `ek` into shared memory. `order` holds the B pair
// indices in the order the walkers take them; `counter` is one int that the
// caller has set to 0. CC > 0 (a multiple of 8, one walker) is the chunked
// layout, with `gbuf` holding grid blocks of chunk_gfloats (not read with
// CC = 0).
extern "C" int factored_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* order, void* counter, const void* c0,
    const void* wvec, const void* tab, const void* ek, void* out, void* gbuf,
    int B, int Li, int Lo, int Sa, int To, int rescale_every, int sink,
    int n_cls, const int* desc, int NR, int KT, int n_mt, int SaP, int ns,
    int nbp, int seg, int e_floats, int grid, int CC, void* stream) {
  if (n_cls < 1 || n_cls > MAX_CLS || rescale_every < 1 || Sa < 1 ||
      KT != (Sa + 7) / 8 || n_mt != (Sa + 15) / 16 || SaP < Sa || NR < 1 ||
      NR > MAX_NR || ns < 1 || ns > MAX_NS || nbp < 1 || nbp > 2 ||
      seg < 1 || e_floats < 0 || e_floats % 4 != 0 || grid < 1 || Li < 0 ||
      Lo < 0 || Li + 1 > 0xffff * 8 || CC < 0 || CC % 8 != 0 ||
      (CC > 0 && (ns != 1 || gbuf == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.in_lens = (const int*)in_lens;
  a.out_lens = (const int*)out_lens;
  a.order = (const int*)order;
  a.counter = (int*)counter;
  a.c0 = (const float*)c0;
  a.wv = (const float*)wvec;
  a.tab = (const float*)tab;
  a.ek = (const float*)ek;
  a.out = (float*)out;
  a.B = B; a.Li = Li; a.Lo = Lo; a.Sa = Sa; a.To = To;
  a.rescale_every = rescale_every;
  a.sink = sink;
  a.n_cls = n_cls;
  int k = 0;
  bool diag = false;
  for (int q = 0; q < n_cls; ++q) {
    const int* v = desc + q * FDESC_LEN;
    a.cls[q] = FacClass{v[0], v[1], v[2], v[3]};
    if (v[0] < KIND_UP || v[0] > KIND_DIAG || v[2] < 1 || k + v[2] > NR)
      return (int)cudaErrorInvalidValue;
    diag = diag || v[0] == KIND_DIAG;
    for (int r = 0; r < v[2]; ++r, ++k) {
      a.kq[k] = (unsigned char)q;
      a.kr[k] = (unsigned char)r;
    }
  }
  if (k != NR || nbp != (diag ? 2 : 1)) return (int)cudaErrorInvalidValue;
  a.NR = NR; a.KT = KT; a.n_mt = n_mt; a.SaP = SaP;
  a.ns = ns; a.nbp = nbp; a.seg = seg; a.e_floats = e_floats;
  const long smem = layout(Sa, NR, Li, Lo, ns, nbp, seg, e_floats, CC).total *
                    (long)sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = CC > 0 ? factored_wavefront_kernel<true>
                     : factored_wavefront_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a, (float*)gbuf, CC);
  return (int)cudaGetLastError();
}
