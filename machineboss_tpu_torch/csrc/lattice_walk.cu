// Viterbi traceback walk over a value lattice on the device, for Hopper
// (sm_90a).
//
// Counterpart of the jitted lax.while_loop of
// machineboss_tpu/algo/traceback_device.py::make_lattice_walker (not a Pallas
// kernel there, but one device invocation). A pair is walked from
// (li, lo, S-1) back to (0, 0, 0) at cell granularity, recording for every
// distinct cell it visits the value vectors of the cell and of its diag,
// left and up neighbours: exactly what the host's float64 traceback will
// query on the same path. All B pairs of a batch are walked in ONE launch.
//
// Per step the 4*S candidates [diag, left, up, silent] x source state are
//   neighbour[src] + edge[tok][src -> s]
// for the current state s; the FIRST maximum wins (lowest index among equal
// float32 sums, like argmax on the host); a best value <= NEG_INF / 2 means
// the walk is stuck. A record is written at slot n on every step and n moves
// on only when the cell changed, so a silent move rewrites the same record.
//
// The lattice is the wavefront slab layout (n_diags, B, W, S): cell (i, o) of
// pair b sits in slab d = i + o at window index w = i - bases[d] (bases all
// zero for a full lattice). The edge matrices are stored destination-major,
// [tok][dst][src], so that the candidates of one destination state are
// contiguous.
//
// What bounds it on this card: the dependent steps, at most
// Ncap * (1 + silent depth) per pair: latency, not bytes or operations. On
// one warp a step costs an L2 round trip (about 210 SM cycles) for the loads
// that wait on the last move, plus its instructions: each global load or
// store of a warp takes some 10-20 cycles to issue (measured on the H100), so
// a step issues as few as it can.
//
// Design: one warp walks one pair, several pairs a block, and no step waits
// on a block barrier: the first maximum of the 4*S candidates is a
// lane-local max over ceil(S/32) candidates a lane and block, a redux.sync
// for the warp's largest value, a lane-local min over the indices holding
// it and a redux.sync for the lowest. The pair's tokens are staged in
// shared memory once, and the block's diagonal bases once a block, where
// they fit; where they do not (a long banded pair: tens of thousands of
// diagonals and tokens) the default walk reads both from global memory
// through L1, so no length is refused. Which one is a template parameter,
// so that a staged read is a shared load and not a generic one (a generic
// load of the bases, which every cell address waits on, cost some 170
// cycles a step on the H100). A step then issues, together and ahead of any use,
// the loads that wait on the last move: the open edge rows of state s
// (read through the read-only path) and the record's four cells, one L2
// round trip for all of them. The cell addresses are chosen without a
// branch (a cell outside the lattice reads a row of NEG_INF), so the
// compiler keeps those loads in one block and issues them first. The edge
// rows of every table sit in one (rows + 1, round4(S)) array: ad's (tx, ty,
// s), al's (tx, s), au's (ty, s), sil's s, then the NEG_INF row. Where S is
// a multiple of 4 a lane holds float4s (one load instruction per 128
// floats).
//
// The variants undo one choice each and give the same records:
// V_BLOCK_BARRIER meets the whole block at a barrier every step,
// V_TOKENS_GLOBAL reads the tokens from global memory, V_PREFETCH keeps the
// cells in a ring of 9 slots in shared memory (cell (i', o') in slot (i' mod
// 3, o' mod 3)) and loads, a step ahead, the cells of the 2-ring (i-2..i,
// o-2..o) that the last move brought in (the row i-2 after a move in i, the
// column o-2 after one in o), V_EDGES_SHARED stages the left, up and silent
// rows in shared memory. A lane holding more than 8 values of a cell (S >
// 256) walks its values in a loop.
//
// Built with -DPHASE_PROFILE (a separate library), lane 0 of each pair sums
// clock64 cycles per phase of a step into prof (B, N_PROF).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_PAIRS = 8;         // warps, one pair each, a block

enum Variant {
  V_WARP = 0,
  V_BLOCK_BARRIER = 1,
  V_TOKENS_GLOBAL = 2,
  V_PREFETCH = 3,
  V_EDGES_SHARED = 4
};

// profile slots: steps, then cycles in each phase of a step
enum {
  P_STEPS, P_WAIT, P_ISSUE, P_EDGE, P_CAND, P_ARGMAX, P_BARRIER, P_MOVE,
  N_PROF
};

struct Args {
  const float* lat;     // (nd, B, W, S)
  const int* bases;     // (nd,)
  const int* in_toks;   // (B, Lip)
  const int* out_toks;  // (B, Lop)
  const int* in_lens;   // (B,)
  const int* out_lens;  // (B,)
  const float* rows;    // (n_rows + 1, Sp): the four tables' rows, padded,
                        // then a row of NEG_INF
  int* n_out;           // (B,)
  int* ij;              // (B, Ncap, 2), preset to -1
  float* vals;          // (B, Ncap, 4, S), preset to NEG_INF
  int* ok_out;          // (B,)
  long long* prof;      // (B, N_PROF) with PHASE_PROFILE, else unused
  int B, W, nd, S, Ti, To, Lip, Lop, Ncap, max_steps;
  int P;                // pairs a block
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// the edge rows: ad's (tx, ty, s), then al's (tx, s), au's (ty, s), sil's
// s; a row is padded to Sp = round4(S) floats
__host__ __device__ inline int edge_rows(int S, int Ti, int To) {
  return (Ti * To + Ti + To + 1) * S;
}

// shared floats: the staged left, up and silent rows (V_EDGES_SHARED), when
// staged the bases once a block, then per pair the ring of 9 cells
// (V_PREFETCH only) and, when staged, the pair's tokens (not
// V_TOKENS_GLOBAL's)
__host__ __device__ inline int edge_floats(int S, int Ti, int To) {
  return (Ti + To + 1) * S * round4(S);
}
__host__ __device__ inline int ring_floats(int S, int variant) {
  return variant == V_PREFETCH ? 9 * round4(S) : 0;
}
__host__ __device__ inline int pair_floats(int S, int Lip, int Lop,
                                           bool staged, int variant) {
  return ring_floats(S, variant) +
         (staged && variant != V_TOKENS_GLOBAL ? round4(Lip) + round4(Lop)
                                               : 0);
}

// lower index wins among equal values
__device__ __forceinline__ bool better(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

// The order of floats as an int order (a candidate is never NaN; -0 is
// taken as +0, which `better` treats as equal).
__device__ __forceinline__ int ordered(float v) {
  const int i = __float_as_int(v + 0.f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ long long tick() {
#ifdef PHASE_PROFILE
  __syncwarp();
  return clock64();
#else
  return 0;
#endif
}

// The lattice row of cell (ci, co) of pair b, or nullptr outside the pair
// or the stored window.
__device__ __forceinline__ const float* cell_ptr(const Args& a,
                                                 const int* bases, int b,
                                                 int li, int lo, int ci,
                                                 int co) {
  if (ci < 0 || co < 0 || ci > li || co > lo) return nullptr;
  const int d = min(ci + co, a.nd - 1);
  const int w = ci - bases[d];
  if (w < 0 || w >= a.W) return nullptr;
  return a.lat + (((size_t)d * a.B + b) * a.W + w) * a.S;
}

// the ring slot of cell (ci, co), ci, co >= -3
__device__ __forceinline__ int slot(int ci, int co) {
  return ((ci + 3) % 3) * 3 + (co + 3) % 3;
}

// A candidate of block q [diag, left, up, silent] and source src into the
// running first maximum (bv, bk): v + e when `use`, else NEG_INF.
__device__ __forceinline__ void candidate(float v, float e, bool use, int q,
                                          int src, int S, float& bv,
                                          int& bk) {
  const float cand = use ? v + e : NEG_INF;
  if (better(cand, q * S + src, bv, bk)) {
    bv = cand;
    bk = q * S + src;
  }
}

// Float u of a lane's share of a row: lane + 32u, or with VEC (S a multiple
// of 4, rows 16-byte aligned) component u % 4 of float4 lane + 32 (u / 4).
template <bool VEC>
__device__ __forceinline__ int elem(int lane, int u) {
  return VEC ? 4 * (lane + 32 * (u >> 2)) + (u & 3) : lane + 32 * u;
}

// Starts the loads of a lane's share of a row of S floats into v, where `on`
// (NEG_INF elsewhere and past S): through the read-only path when RO.
template <bool VEC, bool RO, int NPL>
__device__ __forceinline__ void load_row(const float* p, int S, bool on,
                                         int lane, float (&v)[NPL]) {
  if constexpr (VEC) {
#pragma unroll
    for (int g = 0; g < NPL / 4; ++g) {
      const int f = 4 * (lane + 32 * g);
      float4 x = make_float4(NEG_INF, NEG_INF, NEG_INF, NEG_INF);
      if (on && f < S)
        x = RO ? __ldg(reinterpret_cast<const float4*>(p + f))
               : *reinterpret_cast<const float4*>(p + f);
      v[4 * g] = x.x; v[4 * g + 1] = x.y; v[4 * g + 2] = x.z;
      v[4 * g + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < NPL; ++u) {
      const int t = lane + 32 * u;
      v[u] = NEG_INF;
      if (on && t < S) v[u] = RO ? __ldg(p + t) : p[t];
    }
  }
}

template <bool VEC, int NPL>
__device__ __forceinline__ void store_row(float* p, int S, int lane,
                                          const float (&v)[NPL]) {
  if constexpr (VEC) {
#pragma unroll
    for (int g = 0; g < NPL / 4; ++g) {
      const int f = 4 * (lane + 32 * g);
      if (f < S)
        *reinterpret_cast<float4*>(p + f) =
            make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < NPL; ++u)
      if (lane + 32 * u < S) p[lane + 32 * u] = v[u];
  }
}

// Starts the loads of cell (ci, co) of pair b into registers: a cell
// outside the pair or the window reads the edge table's last row, all
// NEG_INF, so that nothing waits for a load here; the address is chosen
// without a branch, so that a step's loads form one block of code that the
// compiler issues before their first use.
template <bool VEC, int NPL>
__device__ __forceinline__ void load_cell(const Args& a, const int* bases,
                                          int b, int li, int lo, int ci,
                                          int co, int lane, float (&v)[NPL]) {
  const int d = min(max(ci + co, 0), a.nd - 1);
  const int w = ci - bases[d];
  const bool in = ci >= 0 && co >= 0 && ci <= li && co <= lo && w >= 0 &&
                  w < a.W;
  const float* p =
      in ? a.lat + (((size_t)d * a.B + b) * a.W + w) * a.S
         : a.rows + (size_t)edge_rows(a.S, a.Ti, a.To) * round4(a.S);
  load_row<VEC, true>(p, a.S, true, lane, v);
}

// NPL: values a lane holds of one row, ceil(S / 32) (1 to 8), or with VEC
// 4 ceil(S / 128) (4 or 8); 0 for any S: a loop over the rows' values.
// STAGED: the bases and tokens in shared memory, else read from global.
template <int V, int NPL, bool VEC, bool STAGED>
__global__ void __launch_bounds__(MAX_PAIRS * 32) lattice_walk_warp(Args a) {
  constexpr int NP = NPL > 0 ? NPL : 1;
  constexpr bool RING = V == V_PREFETCH && NPL > 0;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int S = a.S, Sp = round4(S);
  const int TT = a.Ti * a.To * S;     // the first al row
  int at = 0;
  const float* erows = a.rows;        // the left, up and silent rows
  if constexpr (V == V_EDGES_SHARED) {
    const int n4 = edge_floats(S, a.Ti, a.To) / 4;
    const float4* g =
        reinterpret_cast<const float4*>(a.rows + (size_t)TT * Sp);
    for (int t = threadIdx.x; t < n4; t += blockDim.x) smem4[t] = g[t];
    erows = smem - (size_t)TT * Sp;
    at = 4 * n4;
  }
  int* s_bases = reinterpret_cast<int*>(smem + at);
  if constexpr (STAGED) {
    for (int t = threadIdx.x; t < a.nd; t += blockDim.x)
      s_bases[t] = a.bases[t];
    at += round4(a.nd);
  }
  const int* bases = STAGED ? s_bases : a.bases;
  __syncthreads();                 // the block's tables

  float* ring = smem + at + wp * pair_floats(S, a.Lip, a.Lop, STAGED, V);
  const int b = blockIdx.x * a.P + wp;
  const bool active = b < a.B;
  const int li = active ? a.in_lens[b] : 0;
  const int lo = active ? a.out_lens[b] : 0;
  constexpr bool TOK_SMEM = STAGED && V != V_TOKENS_GLOBAL;
  const int* g_xt = a.in_toks + (size_t)b * a.Lip;
  const int* g_yt = a.out_toks + (size_t)b * a.Lop;
  int* s_xt = reinterpret_cast<int*>(ring + ring_floats(S, V));
  int* s_yt = s_xt + round4(a.Lip);
  if constexpr (TOK_SMEM) {
    if (active) {
      for (int t = lane; t < a.Lip; t += 32) s_xt[t] = g_xt[t];
      for (int t = lane; t < a.Lop; t += 32) s_yt[t] = g_yt[t];
    }
  }
  const int* xt = TOK_SMEM ? s_xt : g_xt;
  const int* yt = TOK_SMEM ? s_yt : g_yt;

  // the walk's state, kept identically by every lane
  int i = li, o = lo, s = S - 1, n = 0, step = 0, pi = -1, po = -1;
  int mi = 0, mo = 0;              // the last move lowered i, o
  bool done = !active || ((S == 1) && li == 0 && lo == 0);
  bool stuck = false;
  long long pr[N_PROF] = {};
  // V_PREFETCH: the cells the last step loaded into registers, their ring
  // slots, and which of the six were asked for
  float pf[6][NP];
  int pslot[6] = {0, 0, 0, 0, 0, 0};
  unsigned pneed = 0;
  if (RING && active) {
    // the whole 2-ring of the first cell
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float v[NP];
      load_cell<VEC>(a, bases, b, li, lo, i - k / 3, o - k % 3, lane, v);
      store_row<VEC>(ring + slot(i - k / 3, o - k % 3) * Sp, S, lane, v);
    }
  }
  __syncwarp();                    // the pair's tokens and ring

  for (;;) {
    const bool go = !done && step < a.max_steps && n < a.Ncap;
    long long t0 = tick();
    if constexpr (V == V_BLOCK_BARRIER) {
      if (!__syncthreads_or(go)) break;
      const long long t1 = tick();
      pr[P_BARRIER] += t1 - t0;
      t0 = t1;
      if (!go) continue;
    } else {
      if (!go) break;
    }

    // the open edge rows of state s and the record's four cells: every
    // load that waits on the last move, issued together
    const int tx = min(max(xt[min(max(i - 1, 0), a.Lip - 1)], 0), a.Ti - 1);
    const int ty = min(max(yt[min(max(o - 1, 0), a.Lop - 1)], 0), a.To - 1);
    const int rows[4] = {(tx * a.To + ty) * S + s, TT + tx * S + s,
                         TT + (a.Ti + ty) * S + s,
                         TT + (a.Ti + a.To) * S + s};
    const bool open[4] = {i > 0 && o > 0, i > 0, o > 0, true};
    const bool* use = open;
    const int ci[4] = {i, i - 1, i - 1, i};
    const int co[4] = {o, o - 1, o, o - 1};
    float ev[4][NP], vv[4][NP];
    if constexpr (NPL > 0) {
      load_row<VEC, true>(a.rows + (size_t)rows[0] * Sp, S, use[0], lane,
                          ev[0]);
#pragma unroll
      for (int q = 1; q < 4; ++q)
        load_row<VEC, V != V_EDGES_SHARED>(erows + (size_t)rows[q] * Sp, S,
                                           use[q], lane, ev[q]);
      if constexpr (!RING) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          load_cell<VEC>(a, bases, b, li, lo, ci[c], co[c], lane, vv[c]);
      }
    }
    long long t1 = tick();
    pr[P_EDGE] += t1 - t0;

    if constexpr (RING) {
      // the cells the last step loaded go into the ring
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (pneed >> k & 1) store_row<VEC>(ring + pslot[k] * Sp, S, lane, pf[k]);
      __syncwarp();
      long long t2 = tick();
      pr[P_WAIT] += t2 - t1;
      // the cells of the 2-ring that the last move brought in, for the
      // next step: the row i-2 after a move in i, the column o-2 after one
      // in o
      const int ni[6] = {i - 2, i - 2, i - 2, i, i - 1, i - 2};
      const int no[6] = {o, o - 1, o - 2, o - 2, o - 2, o - 2};
      pneed = (mi ? 0x7u : 0u) | (mo ? (mi ? 0x18u : 0x38u) : 0u);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        if (!(pneed >> k & 1)) continue;
        load_cell<VEC>(a, bases, b, li, lo, ni[k], no[k], lane, pf[k]);
        pslot[k] = slot(ni[k], no[k]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        load_row<VEC, false>(ring + slot(ci[c], co[c]) * Sp, S, true, lane,
                             vv[c]);
      t1 = tick();
      pr[P_ISSUE] += t1 - t2;
    }

    float* rec = a.vals + ((size_t)b * a.Ncap + n) * 4 * S;
    if (lane == 0) {
      a.ij[((size_t)b * a.Ncap + n) * 2] = i;
      a.ij[((size_t)b * a.Ncap + n) * 2 + 1] = o;
    }
    // the first maximum: the largest value, then the lowest index holding
    // it (-0 taken as +0, which `better` treats as equal)
    int m, kk;
    if constexpr (NPL > 0) {
      float cv[4 * NPL];
      int ck[4 * NPL];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // record block c [cell, diag, left, up] is candidate block q
        // [diag, left, up, silent] = (c + 3) & 3
        const int q = (c + 3) & 3;
        store_row<VEC>(rec + c * S, S, lane, vv[c]);
#pragma unroll
        for (int u = 0; u < NPL; ++u) {
          const int t = elem<VEC>(lane, u);
          // (a lane's slot past S holds what the scan starts from)
          cv[c * NPL + u] = t >= S ? -3.4e38f
                            : use[q] ? vv[c][u] + ev[q][u] : NEG_INF;
          ck[c * NPL + u] = t < S ? q * S + t : 4 * S;
        }
      }
      float mx = cv[0];
#pragma unroll
      for (int j = 1; j < 4 * NPL; ++j) mx = fmaxf(mx, cv[j]);
      m = __reduce_max_sync(FULL, ordered(mx));
      const float mv = unordered(m);
      kk = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4 * NPL; ++j)
        kk = min(kk, cv[j] == mv ? ck[j] : 0x7fffffff);
    } else {
      float bv = -3.4e38f;
      int bk = 4 * S;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = (c + 3) & 3;
        const float* p = cell_ptr(a, bases, b, li, lo, ci[c], co[c]);
        const float* row = erows + (size_t)rows[q] * Sp;
        if (q == 0) row = a.rows + (size_t)rows[q] * Sp;
        for (int t = lane; t < S; t += 32) {
          const float v = p ? __ldg(p + t) : NEG_INF;
          rec[c * S + t] = v;
          float e = NEG_INF;
          if (use[q])
            e = (V == V_EDGES_SHARED && q != 0) ? row[t] : __ldg(row + t);
          candidate(v, e, use[q], q, t, S, bv, bk);
        }
      }
      m = __reduce_max_sync(FULL, ordered(bv));
      kk = ordered(bv) == m ? bk : 0x7fffffff;
    }
    long long t4 = tick();
    pr[P_CAND] += t4 - t1;
    const int bk = __reduce_min_sync(FULL, kk);
    const float bv = unordered(m);
    long long t5 = tick();
    pr[P_ARGMAX] += t5 - t4;
    if constexpr (RING) __syncwarp();   // the ring read before it is written

    const bool moved = (i != pi) || (o != po);
    pi = i; po = o;
    n += moved ? 1 : 0;
    const bool bad = bv <= NEG_INF / 2;
    mi = mo = 0;
    if (!bad) {
      const int q = (bk >= S) + (bk >= 2 * S) + (bk >= 3 * S);
      s = bk - q * S;
      mi = (q == 0 || q == 1) ? 1 : 0;
      mo = (q == 0 || q == 2) ? 1 : 0;
      i -= mi;
      o -= mo;
    }
    done = (i == 0 && o == 0 && s == 0) || bad;
    stuck = stuck || bad;
    step += 1;
    pr[P_MOVE] += tick() - t5;
  }
  if (active && lane == 0) {
    a.n_out[b] = n;
    a.ok_out[b] = (done && !stuck && i == 0 && o == 0 && s == 0) ? 1 : 0;
#ifdef PHASE_PROFILE
    pr[P_STEPS] += step;
    for (int p = 0; p < N_PROF; ++p) a.prof[(size_t)b * N_PROF + p] = pr[p];
#endif
  }
}

template <int V, int NPL, bool VEC, bool STAGED>
int launch_warp(const Args& a, int smem, cudaStream_t stream) {
  auto kern = lattice_walk_warp<V, NPL, VEC, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(a.B + a.P - 1) / a.P, a.P * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// values a lane holds of one row: float4s when S is a multiple of 4, else
// ceil(S / 32) floats; a loop past 256
template <int V, bool STAGED>
int launch_npl(const Args& a, int smem, cudaStream_t stream) {
  if (a.S % 4 == 0 && a.S <= 128)
    return launch_warp<V, 4, true, STAGED>(a, smem, stream);
  if (a.S % 4 == 0 && a.S <= 256)
    return launch_warp<V, 8, true, STAGED>(a, smem, stream);
  switch ((a.S + 31) / 32) {
    case 1: return launch_warp<V, 1, false, STAGED>(a, smem, stream);
    case 2: return launch_warp<V, 2, false, STAGED>(a, smem, stream);
    case 3: return launch_warp<V, 3, false, STAGED>(a, smem, stream);
    case 4: return launch_warp<V, 4, false, STAGED>(a, smem, stream);
    case 5: return launch_warp<V, 5, false, STAGED>(a, smem, stream);
    case 6: return launch_warp<V, 6, false, STAGED>(a, smem, stream);
    case 7: return launch_warp<V, 7, false, STAGED>(a, smem, stream);
    case 8: return launch_warp<V, 8, false, STAGED>(a, smem, stream);
    default: return launch_warp<V, 0, false, STAGED>(a, smem, stream);
  }
}

}  // namespace

// Shared bytes of one block: P pairs, the bases and tokens staged or not,
// the edge rows staged (V_EDGES_SHARED) or not.
extern "C" int lattice_walk_smem_bytes(int S, int Ti, int To, int nd,
                                       int Lip, int Lop, int P, int staged,
                                       int variant) {
  const int edges = variant == V_EDGES_SHARED ? edge_floats(S, Ti, To) : 0;
  return 4 * (edges + (staged ? round4(nd) : 0) +
              P * pair_floats(S, Lip, Lop, staged != 0, variant));
}

// Launches the walk of B pairs on `stream`: a warp a pair, P pairs a block,
// `smem` bytes of shared memory (lattice_walk_smem_bytes); unstaged (the
// bases and tokens read from global memory) only in the default layout.
// rows: (edge_rows + 1, round4(S)) the edge rows padded with NEG_INF, then a
// row of NEG_INF. prof: (B, N_PROF) int64 for the profile library, else
// null. Returns cudaGetLastError(): nonzero means the launch was refused.
extern "C" int lattice_walk_launch(
    const void* lat, const void* bases, const void* in_toks,
    const void* out_toks, const void* in_lens, const void* out_lens,
    const void* rows, void* n_out, void* ij, void* vals, void* ok_out,
    void* prof, int B, int W, int nd, int S, int Ti, int To, int Lip, int Lop,
    int Ncap, int max_steps, int P, int staged, int variant, int smem,
    void* stream) {
  if (S < 1 || W < 1 || nd < 1 || Ti < 1 || To < 1 || Lip < 1 || Lop < 1 ||
      Ncap < 1 || P < 1 || P > MAX_PAIRS || variant < V_WARP ||
      variant > V_EDGES_SHARED || (!staged && variant != V_WARP))
    return (int)cudaErrorInvalidValue;
#ifdef PHASE_PROFILE
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
#endif
  if (smem != lattice_walk_smem_bytes(S, Ti, To, nd, Lip, Lop, P, staged,
                                      variant))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.lat = (const float*)lat;
  a.bases = (const int*)bases;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.in_lens = (const int*)in_lens;
  a.out_lens = (const int*)out_lens;
  a.rows = (const float*)rows;
  a.n_out = (int*)n_out;
  a.ij = (int*)ij;
  a.vals = (float*)vals;
  a.ok_out = (int*)ok_out;
  a.prof = (long long*)prof;
  a.B = B; a.W = W; a.nd = nd; a.S = S; a.Ti = Ti; a.To = To;
  a.Lip = Lip; a.Lop = Lop; a.Ncap = Ncap; a.max_steps = max_steps;
  a.P = P;
  cudaStream_t st = (cudaStream_t)stream;
  if (!staged) return launch_npl<V_WARP, false>(a, smem, st);
  switch (variant) {
    case V_WARP: return launch_npl<V_WARP, true>(a, smem, st);
    case V_BLOCK_BARRIER: return launch_npl<V_BLOCK_BARRIER, true>(a, smem, st);
    case V_TOKENS_GLOBAL: return launch_npl<V_TOKENS_GLOBAL, true>(a, smem, st);
    case V_PREFETCH: return launch_npl<V_PREFETCH, true>(a, smem, st);
    default: return launch_npl<V_EDGES_SHARED, true>(a, smem, st);
  }
}
