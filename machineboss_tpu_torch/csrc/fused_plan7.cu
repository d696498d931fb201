// Fused Plan7 profile (x) transducer Forward over a read batch, for Hopper
// (sm_90a): the whole row solve of every read in one launch.
//
// Replaces machineboss_tpu/ops/pallas/fused_plan7_kernel.py::_kernel.
// What it computes, per read b over its output tokens tok[0..len), in scaled
// probability (every semiring op is a multiply-add):
//   state X: per profile node k the blocks M, Mx, I, Ix, D (St values each)
//            and the flank rows N, Nx, B, E, C, Cx, J, Jx, T;
//   row 0:   solve_row from the start vector first = e_0 . t_closure;
//   a token row: cold = X (x) Ty0[tok] for every block and flank; hot = the M
//            and I blocks through the token's paired-emission panels, N/C/J
//            through the token's flank matrix; then solve_row:
//              N flank -> B0;
//              row core: u = entry_k B, b_mx = (u + cold_M) em0_k + hot_Mx,
//                ix_aff = cold_I ei0_k + hot_Ix,
//                b_ix = ((m_to_i b_mx + i_to_i ix_aff) ci_k) ei0_k + ix_aff,
//                the along-k solve carry_k = [b_mx, b_ix, 0]_k + carry_{k-1} A_k
//                for carry = [Mx, Ix, D], A_k = exp(a_mat)_k a row-independent
//                (3St, 3St) matrix; M_k from carry_{k-1} and u,
//                I_k = (m_to_i Mx_k + i_to_i ix_aff) ci_k;
//              E = sum over nodes of M_k + D_k, plus the last node's Ix exit;
//              multihit: the row core runs ONCE without B mass, B follows
//                from the exact re-entry closure mloop_star, and its
//                contribution is added through the basis maps mb_*;
//              the C and T flanks; new X = solved + cold;
//            then X is scaled by the exact power of two 2^(127-kexp) of its
//            maximum's biased exponent kexp (read from the float's bits) and
//            kexp-127 is added to an integer: no log, exp or division in the
//            loop. A read whose maximum is not positive is flagged dead.
//   Rows at or past a read's length do not run; token 0 or a token past the
//   alphabet selects all-zero coefficients. Out: the mantissa X[T][St-1],
//   the exponent sum and the dead flag; the caller takes
//   log(mantissa) + exponent*ln2 in float64.
//
// What bounds it on this card: operations ((12 + 9) St^2 + 8 St
// multiply-adds per node, row and read for the cold blocks, the paired
// emissions, em0, ei0, ci and the solve's cheapest form; 5 St^2 more with
// multihit) against the f32 non-tensor rate; the bytes are the tokens and
// the tables, read once. The rows of a read depend on each other, so the run
// time is rows x the dependent chain of a row, which the bound does not see.
//
// Design (the warp layout): a warp solves a read, several reads a block, and
// no row waits on a block or named barrier. Lane c owns the contiguous chunk
// of C = ceil(K/32) nodes [cC, cC + C) and holds their five blocks in its
// registers: the lane's loops over its nodes are unrolled for a chunk of 4,
// 8 or 12 nodes while nodes x St is at most 24 (K = 384 at St = 2); past
// that the state sits in local memory, which only the lane touches (on the
// H100 at St = 2 that doubled K = 300's time). The flank rows are
// replicated in every lane, so the flank algebra needs no exchange. A row
// is:
//   pass A, lane-serial over the lane's nodes: cold, hot and b_k, and the
//     chunk's local solve from zero, l_k = b_k + l_{k-1} A_k ((3St)^2 a node);
//   a log-depth scan across the lanes by shuffles on the chunk ends: at
//     level l lane c adds lane c-2^l's value times the product of the A_k
//     over the 2^l whole chunks ending at chunk c, a row-independent span
//     product prepared on the host in float64 (ceil(log2(K/C)) levels,
//     (3St)^2 a lane each);
//   pass B, lane-serial again from the carry into the chunk (lane c-1's
//     end): the true carry_k ((3St)^2 a node), M and I recombined, the solved
//     values added, the E terms summed;
//   the E sum and the state's maximum as warp shuffles (the maximum one
//     redux.sync on the floats' bits), the flanks, the multihit B
//     contribution (pass C), and the power-of-two scale, which the state
//     takes as it is read at the next row's pass A.
// Against the node doubling this replaced (a thread a node, ceil(log2 K)
// levels of (3St)^2 a node, each behind a named barrier of the read's
// threads) the solve is 2 (3St)^2 a node plus 5 (3St)^2 a lane, and nothing
// between a row's first and last instruction waits for another warp. The
// tables do not depend on the read or the row, so they are copied to shared
// memory once a block and every warp reads the same copy: the per-node
// records (scalars, the eight St x St matrices, A_k), the span products and
// the paired-emission panels, each interleaved by lane in float4 units, so a
// warp's load is 512 contiguous bytes. What does not fit (greedily in that
// order) is read from global memory through L1.
//
// The node-doubling layout, the default past 512 nodes (the warp layout's
// limit; it was slower at every K from 86 to 512 measured) and the variant
// that undoes the warp layout: a block owns R reads, TPR threads
// each (one thread per profile node when K <= 256), the node blocks in shared
// memory, the along-k solve by log-depth doubling over the affine maps (at
// level l every node k >= 2^l absorbs the node 2^l to its left, b_k +=
// b_{k-2^l} P_l[k], P_l[k] = A_{k-2^l+1} ... A_k from the host), ceil(log2 K)
// + 3 named barriers a row, the doubling's matrices and the panels in shared
// memory when they fit beside the state. The TPU kernel multiplies by the
// (3St K)^2 lower-block-triangular prefix-product matrix instead, the closed
// form that suits a matrix unit: K/2 (3St)^2 multiply-adds per node.
//
// Past the profiles whose per-read state (12 K St floats) and per-node tables
// fit a block's shared memory beside the constants (918 nodes at St = 2, 512
// at St = 4), the node-doubling layout keeps each read's node blocks, the
// solve's buffers and ix_aff in a global buffer of its own, read and
// written through L1/L2, and reads the per-node scalars and matrices from
// global memory as it reads the doubling's matrices there (`gstate`); only
// the constants and the per-warp reduction slots stay in shared memory.
// launch_plan picks it by size alone, the shared state wherever it fits; it
// is its own instantiation of the kernel, so the shared layout's loads stay
// shared loads. Why this and not a read spread over a block of warps: PERF.md
// (the PR that added it) has the reckoning.
//
// Built with -DPHASE_PROFILE (a separate library), lane 0 of each read sums
// clock64 cycles per phase of a row into prof (B, N_PROF).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_SC = 7, N_CO = 8, N_FL = 9;
constexpr int MAX_THREADS = 768;     // node-doubling layout
constexpr int MAX_WARP_READS = 8;    // warp layout: reads (warps) a block
constexpr int MAX_CHUNK = 16;        // warp layout: nodes a lane
// warp layout: a lane's nodes are unrolled (their state in registers) while
// nodes x St is at most this; the chunk sizes instantiated are 4, 8 and 12
// where unrolled, and MAX_CHUNK
constexpr int UNROLL_NODE_STATES = 24;
constexpr int N_PROF = 20;
enum { SC_ENTRY, SC_M2I, SC_I2I, SC_ROLL_M, SC_ROLL_I, SC_ROLL_D, SC_LAST };
enum { CO_EM0, CO_EI0, CO_CI, CO_MB_M };   // CO_MB_M + block: the basis maps
enum { F_N, F_NX, F_B, F_E, F_C, F_CX, F_J, F_JX, F_T };
enum { BLK_M, BLK_MX, BLK_I, BLK_IX, BLK_D };
// profile slots of the warp layout (a row's phases)
enum { PW_ROWS, PW_FLANK1, PW_PASS_A, PW_SCAN, PW_PASS_B, PW_REDUCE_E,
       PW_FLANK3, PW_MAX_SCALE };
// profile slots of the node-doubling layout; slot PN_LEVEL + l is level l
enum { PN_ROWS, PN_PHASE1, PN_BARRIER, PN_PHASE3A, PN_REDUCE, PN_PHASE3B,
       PN_PHASE4, PN_LEVEL };

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// ---------------------------------------------------------------- helpers

// N floats from p, which is aligned to A floats (A in 1, 2, 4).
template <int N, int A>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (A == 4 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  } else if constexpr (A >= 2 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = t.x; v[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N, int A>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (A == 4 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (A >= 2 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

// o = v (x) m: o[d] = sum_s v[s] m[s][d]; o must not alias v.
template <int ST>
__device__ __forceinline__ void vm(const float (&v)[ST],
                                   const float (&m)[ST * ST], float (&o)[ST]) {
#pragma unroll
  for (int d = 0; d < ST; ++d) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < ST; ++s) acc = fmaf(v[s], m[s * ST + d], acc);
    o[d] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Barrier of the n threads (a multiple of 32) that share barrier `id` (1-15;
// 0 is __syncthreads'); orders their shared-memory accesses.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ long long tick() {
#ifdef PHASE_PROFILE
  __syncwarp();
  return clock64();
#else
  return 0;
#endif
}

// The host's flank constants in shared memory: cloop, enull0, mloop_star,
// mb_E (ST x ST each), first (ST), loop_s, exit_s, e_to_c, then ty0 and en_y
// (n_sym x ST x ST each).
template <int ST>
struct Consts {
  const float *cloop, *enull0, *mstar, *mbe, *first, *ty0, *eny;
  float loop_s, exit_s, e_to_c;
  __device__ __forceinline__ explicit Consts(const float* c) {
    constexpr int N = ST * ST;
    cloop = c;
    enull0 = c + N;
    mstar = c + 2 * N;
    mbe = c + 3 * N;
    first = c + 4 * N;
    loop_s = first[ST];
    exit_s = first[ST + 1];
    e_to_c = first[ST + 2];
    ty0 = first + ST + 3;
  }
};

// Phase 1's flank part, the same in every thread of a read: the token's
// transfer matrix ty, the cold flank rows and the N, C, J flanks' hot
// parts, and the solve's entry vector b0.
template <int ST>
__device__ __forceinline__ void flank_phase1(
    const Consts<ST>& k, int y, int row, int n_sym, const float (&fl)[N_FL][ST],
    float (&ty)[ST * ST], float (&cold_f)[N_FL][ST], float (&b0)[ST],
    float (&nx_hot)[ST], float (&hot_cx)[ST], float (&hot_jx)[ST]) {
  constexpr int N = ST * ST;
  constexpr int AM = (N % 4 == 0) ? 4 : 1;
  float eny[N], cloop[N], enull0[N];
  if (y >= 0) {
    load_vec<N, 1>(k.ty0 + y * N, ty);
    load_vec<N, 1>(k.ty0 + (n_sym + y) * N, eny);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) ty[i] = eny[i] = 0.f;
  }
  load_vec<N, AM>(k.cloop, cloop);
  load_vec<N, AM>(k.enull0, enull0);
#pragma unroll
  for (int f = 0; f < N_FL; ++f) vm<ST>(fl[f], ty, cold_f[f]);
  float hot_nx[ST], nx_in[ST];
  vm<ST>(fl[F_N], eny, hot_nx);
  vm<ST>(fl[F_C], eny, hot_cx);
  vm<ST>(fl[F_J], eny, hot_jx);
  vm<ST>(cold_f[F_N], enull0, nx_in);
#pragma unroll
  for (int s = 0; s < ST; ++s)
    nx_in[s] += hot_nx[s] + (row < 0 ? k.first[s] : 0.f);
  vm<ST>(nx_in, cloop, nx_hot);
#pragma unroll
  for (int s = 0; s < ST; ++s) b0[s] = k.exit_s * nx_hot[s];
}

// Phase 3b's flank part from the E sum e: the multihit B row b_hot, and the
// new flank rows; returns their maximum (at least 0).
template <int ST, bool MULTIHIT>
__device__ __forceinline__ float flank_phase3(
    const Consts<ST>& k, const float (&e)[ST], const float (&cold_f)[N_FL][ST],
    const float (&b0)[ST], const float (&nx_hot)[ST],
    const float (&hot_cx)[ST], const float (&hot_jx)[ST], float (&b_hot)[ST],
    float (&fl)[N_FL][ST]) {
  constexpr int N = ST * ST;
  constexpr int AM = (N % 4 == 0) ? 4 : 1;
  float cloop[N], enull0[N];
  load_vec<N, AM>(k.cloop, cloop);
  load_vec<N, AM>(k.enull0, enull0);
  float e_hot[ST], jx_hot[ST], j_hot[ST];
  if constexpr (MULTIHIT) {
    float jxb[ST], jcl[ST], c_in[ST], be[ST], jx_in[ST], mat[N];
    vm<ST>(cold_f[F_J], enull0, jxb);
#pragma unroll
    for (int s = 0; s < ST; ++s) jxb[s] += hot_jx[s] + 0.5f * e[s];
    vm<ST>(jxb, cloop, jcl);
#pragma unroll
    for (int s = 0; s < ST; ++s) c_in[s] = b0[s] + k.exit_s * jcl[s];
    load_vec<N, AM>(k.mstar, mat);
    vm<ST>(c_in, mat, b_hot);
    load_vec<N, AM>(k.mbe, mat);
    vm<ST>(b_hot, mat, be);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      e_hot[s] = e[s] + be[s];
      jx_in[s] = jxb[s] + 0.5f * be[s];
    }
    vm<ST>(jx_in, cloop, jx_hot);
#pragma unroll
    for (int s = 0; s < ST; ++s) j_hot[s] = k.loop_s * jx_hot[s];
  } else {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      b_hot[s] = b0[s];
      e_hot[s] = e[s];
      jx_hot[s] = j_hot[s] = 0.f;
    }
  }
  float cx_in[ST], cx_hot[ST];
  vm<ST>(cold_f[F_C], enull0, cx_in);
#pragma unroll
  for (int s = 0; s < ST; ++s) cx_in[s] += hot_cx[s] + k.e_to_c * e_hot[s];
  vm<ST>(cx_in, cloop, cx_hot);
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    fl[F_N][s] = k.loop_s * nx_hot[s] + cold_f[F_N][s];
    fl[F_NX][s] = nx_hot[s] + cold_f[F_NX][s];
    fl[F_B][s] = b_hot[s] + cold_f[F_B][s];
    fl[F_E][s] = e_hot[s] + cold_f[F_E][s];
    fl[F_C][s] = k.loop_s * cx_hot[s] + cold_f[F_C][s];
    fl[F_CX][s] = cx_hot[s] + cold_f[F_CX][s];
    fl[F_J][s] = j_hot[s] + cold_f[F_J][s];
    fl[F_JX][s] = jx_hot[s] + cold_f[F_JX][s];
    fl[F_T][s] = k.exit_s * cx_hot[s] + cold_f[F_T][s];
  }
  float mx = 0.f;
#pragma unroll
  for (int f = 0; f < N_FL; ++f)
#pragma unroll
    for (int s = 0; s < ST; ++s) mx = fmaxf(mx, fl[f][s]);
  return mx;
}

// ------------------------------------------------------- the warp layout

// A lane's record of one node (floats): the 7 scalars and a pad, the 8
// matrices em0, ei0, ci, mb_M..mb_D (ST x ST each), then A_k (3ST x 3ST,
// [src][dst]); a panel record: emm then emi (ST x ST each); a span record:
// one (3ST x 3ST) product. Each rounded up to float4s.
__host__ __device__ constexpr int rec_floats(int ST) {
  return round4(8 + 17 * ST * ST);
}
__host__ __device__ constexpr int pan_floats(int ST) {
  return round4(2 * ST * ST);
}
__host__ __device__ constexpr int span_floats(int ST) {
  return round4(9 * ST * ST);
}
constexpr int R_KCO = 8;   // the matrices' first float in a node record

// Shared floats of one block: the constants, then the node records, the
// span products and the panels where `in_smem` (bits 1, 2, 4) says so.
inline int warp_smem_floats(int ST, int n_sym, int C, int n_lev, int in_smem,
                            int n_consts) {
  int n = round4(n_consts);
  if (in_smem & 1) n += C * rec_floats(ST) * 32;
  if (in_smem & 2) n += n_lev * span_floats(ST) * 32;
  if (in_smem & 4) n += n_sym * C * pan_floats(ST) * 32;
  return n;
}

// NF floats from float F0 on of a lane's record, whose float4 q lies at
// r[32 q] (the records of a warp's lanes interleaved by float4): whole
// float4 loads, so a warp reads 512 contiguous bytes a load.
template <int F0, int NF>
__device__ __forceinline__ void rec_read(const float4* r, float (&v)[NF]) {
  constexpr int Q0 = F0 / 4, Q1 = (F0 + NF - 1) / 4;
  float buf[(Q1 - Q0 + 1) * 4];
#pragma unroll
  for (int q = Q0; q <= Q1; ++q) {
    const float4 t = r[32 * q];
    buf[4 * (q - Q0)] = t.x;
    buf[4 * (q - Q0) + 1] = t.y;
    buf[4 * (q - Q0) + 2] = t.z;
    buf[4 * (q - Q0) + 3] = t.w;
  }
#pragma unroll
  for (int e = 0; e < NF; ++e) v[e] = buf[F0 - 4 * Q0 + e];
}

// o += v (x) A for the (3ST x 3ST) matrix at float F0 of a lane's record.
template <int ST, int F0>
__device__ __forceinline__ void rec_vm3(const float4* r,
                                        const float (&v)[3 * ST],
                                        float (&o)[3 * ST]) {
  constexpr int D3 = 3 * ST;
  float m[D3 * D3];
  rec_read<F0, D3 * D3>(r, m);
#pragma unroll
  for (int s = 0; s < D3; ++s)
#pragma unroll
    for (int d = 0; d < D3; ++d) o[d] = fmaf(v[s], m[s * D3 + d], o[d]);
}

template <int I>
struct Int {
  static constexpr int value = I;
};

// f(Int<I>()) for I = 0 .. N-1: a loop whose index is a constant expression.
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Int<I>());
    static_for<I + 1, N>(f);
  }
}

// f(j) for the lane's nodes j < C: unrolled while CM x ST is at most
// UNROLL_NODE_STATES, so that the arrays f indexes by j stay in registers; a
// plain loop past that.
template <int ST, int CM, typename F>
__device__ __forceinline__ void for_nodes(int C, F&& f) {
  if constexpr (CM * ST <= UNROLL_NODE_STATES) {
#pragma unroll
    for (int j = 0; j < CM; ++j)
      if (j < C) f(j);
  } else {
#pragma unroll 1
    for (int j = 0; j < C; ++j) f(j);
  }
}

// Copies n4 float4s of a table to shared memory at `at` (floats), if asked;
// returns the table's address for the kernel's reads.
__device__ __forceinline__ const float4* stage(const float* g, int n4,
                                               bool to_smem, float* smem,
                                               int& at) {
  if (!to_smem) return reinterpret_cast<const float4*>(g);
  float4* d = reinterpret_cast<float4*>(smem + at);
  const float4* s = reinterpret_cast<const float4*>(g);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) d[i] = s[i];
  at += 4 * n4;
  return d;
}

// consts as Consts reads them; ntab (C, rec/4, 32, 4): lane c's node cC + j
// at [j, q, c]; span (n_lev, span/4, 32, 4): level l's product for lane c at
// [l, q, c]; pan (n_sym, C, pan/4, 32, 4); toks (B, L) 1-based; lens (B,);
// out (3, B). blockDim.x = 32 x reads a block; C <= CM.
template <int ST, bool MULTIHIT, int CM>
__global__ void __launch_bounds__(MAX_WARP_READS * 32)
fused_plan7_warp(const float* __restrict__ consts_g,
                 const float* __restrict__ ntab_g,
                 const float* __restrict__ span_g,
                 const float* __restrict__ pan_g,
                 const int* __restrict__ toks, const int* __restrict__ lens,
                 float* __restrict__ out, long long* __restrict__ prof, int B,
                 int L, int C, int n_sym, int n_lev, int in_smem,
                 int n_consts) {
  constexpr int N = ST * ST, D3 = 3 * ST;
  constexpr int RQ = rec_floats(ST) / 4, PQ = pan_floats(ST) / 4,
                SQ = span_floats(ST) / 4;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;

  // ---- the tables, once a block
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x)
    smem[i] = consts_g[i];
  int at = round4(n_consts);
  const float4* ntab = stage(ntab_g, C * RQ * 32, in_smem & 1, smem, at);
  const float4* span = stage(span_g, n_lev * SQ * 32, in_smem & 2, smem, at);
  const float4* pan = stage(pan_g, n_sym * C * PQ * 32, in_smem & 4, smem, at);
  __syncthreads();

  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;              // after the block's only barrier
  const Consts<ST> kc(smem);
  const int len = min(max(lens[b], 0), L);
  const int* tk = toks + (size_t)b * L;

  float X[CM][5][ST];              // the lane's nodes' blocks
  float BM[CM][ST], BI[CM][ST], IA[CM][ST];   // b_mx, b_ix, ix_aff
#pragma unroll
  for (int j = 0; j < CM; ++j)
#pragma unroll
    for (int blk = 0; blk < 5; ++blk)
#pragma unroll
      for (int s = 0; s < ST; ++s) X[j][blk][s] = 0.f;
  float fl[N_FL][ST];
#pragma unroll
  for (int f = 0; f < N_FL; ++f)
#pragma unroll
    for (int s = 0; s < ST; ++s) fl[f][s] = 0.f;
  int expo = 0;
  bool dead = false;
  float inv_x = 1.f;               // the scale X has still to take
  int t_next = len > 0 ? __ldg(tk) : 0;
  long long pr[N_PROF] = {};

  // row -1 solves the start row (no token, no renormalisation)
  for (int row = -1; row < len; ++row) {
    long long t0 = tick();
    int y = -1;
    if (row >= 0) {
      if (t_next >= 1 && t_next <= n_sym) y = t_next - 1;
      t_next = row + 1 < len ? __ldg(tk + row + 1) : 0;
    }
    float ty[N], cold_f[N_FL][ST], b0[ST], nx_hot[ST], hot_cx[ST], hot_jx[ST];
    flank_phase1<ST>(kc, y, row, n_sym, fl, ty, cold_f, b0, nx_hot, hot_cx,
                     hot_jx);
    long long t1 = tick();
    pr[PW_FLANK1] += t1 - t0;

    // ---- pass A: cold, hot, b and the chunk's local solve
    float loc[D3];
#pragma unroll
    for (int d = 0; d < D3; ++d) loc[d] = 0.f;
    for_nodes<ST, CM>(C, [&](int j) {
      const float4* r = ntab + (size_t)j * RQ * 32 + lane;
      const float4* pp = pan + ((size_t)max(y, 0) * C + j) * PQ * 32 + lane;
      float ks[8], x[ST], cold_m[ST], cold_i[ST], hot[ST], t[ST], t2[ST];
      float bmx[ST], ixa[ST], bix[ST], mat[N], ei0[N];
      rec_read<0, 8>(r, ks);
      const float entry = MULTIHIT ? 0.f : ks[SC_ENTRY];
      // M block: cold_M, hot_Mx, b_mx
#pragma unroll
      for (int s = 0; s < ST; ++s) x[s] = X[j][BLK_M][s] * inv_x;
      vm<ST>(x, ty, cold_m);
      if (y >= 0) {
        rec_read<0, N>(pp, mat);
        vm<ST>(x, mat, hot);
      } else {
#pragma unroll
        for (int s = 0; s < ST; ++s) hot[s] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < ST; ++s) t[s] = entry * b0[s] + cold_m[s];
      rec_read<R_KCO + CO_EM0 * N, N>(r, mat);
      vm<ST>(t, mat, bmx);
#pragma unroll
      for (int s = 0; s < ST; ++s) bmx[s] += hot[s];
      // I block: cold_I, hot_Ix, ix_aff, b_ix
#pragma unroll
      for (int s = 0; s < ST; ++s) x[s] = X[j][BLK_I][s] * inv_x;
      vm<ST>(x, ty, cold_i);
      if (y >= 0) {
        rec_read<N, N>(pp, mat);
        vm<ST>(x, mat, hot);
      }
      rec_read<R_KCO + CO_EI0 * N, N>(r, ei0);
      vm<ST>(cold_i, ei0, ixa);
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        ixa[s] += hot[s];
        t[s] = ks[SC_M2I] * bmx[s] + ks[SC_I2I] * ixa[s];
      }
      rec_read<R_KCO + CO_CI * N, N>(r, mat);
      vm<ST>(t, mat, t2);
      vm<ST>(t2, ei0, bix);
      float v[D3];
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        bix[s] += ixa[s];
        BM[j][s] = bmx[s];
        BI[j][s] = bix[s];
        IA[j][s] = ixa[s];
        X[j][BLK_M][s] = cold_m[s];
        X[j][BLK_I][s] = cold_i[s];
        v[s] = bmx[s];
        v[ST + s] = bix[s];
        v[2 * ST + s] = 0.f;
      }
      // the other blocks' cold parts
#pragma unroll
      for (int blk = 0; blk < 5; ++blk) {
        if (blk == BLK_M || blk == BLK_I) continue;
#pragma unroll
        for (int s = 0; s < ST; ++s) x[s] = X[j][blk][s] * inv_x;
        vm<ST>(x, ty, t);
#pragma unroll
        for (int s = 0; s < ST; ++s) X[j][blk][s] = t[s];
      }
      // l_k = b_k + l_{k-1} A_k
      rec_vm3<ST, R_KCO + 8 * N>(r, loc, v);
#pragma unroll
      for (int d = 0; d < D3; ++d) loc[d] = v[d];
    });
    long long t2 = tick();
    pr[PW_PASS_A] += t2 - t1;

    // ---- the scan of the chunk ends across the lanes: at level l, lane c
    // adds lane c - 2^l's value times its span product (zero for c < 2^l,
    // so no lane branches and the product's loads go first)
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      if (l >= n_lev) break;
      float m[D3 * D3], u[D3];
      rec_read<0, D3 * D3>(span + (size_t)l * SQ * 32 + lane, m);
#pragma unroll
      for (int d = 0; d < D3; ++d) u[d] = __shfl_up_sync(FULL, loc[d], 1 << l);
#pragma unroll
      for (int t = 0; t < D3; ++t)
#pragma unroll
        for (int d = 0; d < D3; ++d) loc[d] = fmaf(u[t], m[t * D3 + d], loc[d]);
    }
    float p[D3];                   // carry_{k-1}: first lane c-1's end
#pragma unroll
    for (int d = 0; d < D3; ++d) {
      p[d] = __shfl_up_sync(FULL, loc[d], 1);
      if (lane == 0) p[d] = 0.f;
    }
    long long t3 = tick();
    pr[PW_SCAN] += t3 - t2;

    // ---- pass B: the carries, M and I recombined, the solved values added
    float ep[ST], mx = 0.f;
#pragma unroll
    for (int s = 0; s < ST; ++s) ep[s] = 0.f;
    for_nodes<ST, CM>(C, [&](int j) {
      const float4* r = ntab + (size_t)j * RQ * 32 + lane;
      float ks[8], c[D3], t[ST], ih[ST], mh[ST], mat[N];
      rec_read<0, 8>(r, ks);
      const float entry = MULTIHIT ? 0.f : ks[SC_ENTRY];
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        c[s] = BM[j][s];
        c[ST + s] = BI[j][s];
        c[2 * ST + s] = 0.f;
      }
      rec_vm3<ST, R_KCO + 8 * N>(r, p, c);    // carry_k = b_k + carry_{k-1} A_k
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        mh[s] = (ks[SC_ROLL_M] * p[s] + ks[SC_ROLL_I] * p[ST + s] +
                 ks[SC_ROLL_D] * p[2 * ST + s]) +
                entry * b0[s];
        t[s] = ks[SC_M2I] * c[s] + ks[SC_I2I] * IA[j][s];
        ep[s] += mh[s] + c[2 * ST + s] + ks[SC_LAST] * c[ST + s];
      }
      rec_read<R_KCO + CO_CI * N, N>(r, mat);
      vm<ST>(t, mat, ih);
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        X[j][BLK_M][s] += mh[s];
        X[j][BLK_MX][s] += c[s];
        X[j][BLK_I][s] += ih[s];
        X[j][BLK_IX][s] += c[ST + s];
        X[j][BLK_D][s] += c[2 * ST + s];
      }
      if constexpr (!MULTIHIT) {
#pragma unroll
        for (int blk = 0; blk < 5; ++blk)
#pragma unroll
          for (int s = 0; s < ST; ++s) mx = fmaxf(mx, X[j][blk][s]);
      }
#pragma unroll
      for (int d = 0; d < D3; ++d) p[d] = c[d];
    });
    long long t4 = tick();
    pr[PW_PASS_B] += t4 - t3;
    float e[ST];
#pragma unroll
    for (int s = 0; s < ST; ++s) e[s] = warp_sum(ep[s]);
    long long t5 = tick();
    pr[PW_REDUCE_E] += t5 - t4;

    // ---- the flanks, and the multihit B contribution (pass C)
    float b_hot[ST];
    mx = fmaxf(mx, flank_phase3<ST, MULTIHIT>(kc, e, cold_f, b0, nx_hot,
                                              hot_cx, hot_jx, b_hot, fl));
    if constexpr (MULTIHIT) {
      for_nodes<ST, CM>(C, [&](int j) {
        const float4* r = ntab + (size_t)j * RQ * 32 + lane;
        static_for<0, 5>([&](auto blk) {
          float mat[N], add[ST];
          rec_read<R_KCO + (CO_MB_M + decltype(blk)::value) * N, N>(r, mat);
          vm<ST>(b_hot, mat, add);
#pragma unroll
          for (int s = 0; s < ST; ++s) {
            X[j][decltype(blk)::value][s] += add[s];
            mx = fmaxf(mx, X[j][decltype(blk)::value][s]);
          }
        });
      });
    }
    long long t6 = tick();
    pr[PW_FLANK3] += t6 - t5;

    // ---- exact power-of-two renormalisation of the whole state
    if (row >= 0) {
      // non-negative floats order as their bits do
      const float m = __int_as_float(
          __reduce_max_sync(FULL, __float_as_int(mx)));
      const bool alive = m > 0.f;
      const float msafe = alive ? m : 1.f;
      const int kexp = (__float_as_int(msafe) >> 23) & 0xFF;
      inv_x = __int_as_float((254 - kexp) << 23);
#pragma unroll
      for (int f = 0; f < N_FL; ++f)
#pragma unroll
        for (int s = 0; s < ST; ++s) fl[f][s] *= inv_x;
      expo += kexp - 127;
      dead = dead || !alive;
    }
    pr[PW_MAX_SCALE] += tick() - t6;
  }
  if (lane == 0) {
    out[b] = fl[F_T][ST - 1];
    out[B + b] = (float)expo;
    out[2 * B + b] = dead ? 1.f : 0.f;
#ifdef PHASE_PROFILE
    pr[PW_ROWS] = len + 1;
    for (int q = 0; q < N_PROF; ++q) prof[(size_t)b * N_PROF + q] = pr[q];
#endif
  }
}

// ----------------------------------------------- the node-doubling layout

// Floats of one block's dynamic shared memory: the constants, the per-node
// scalars and matrices, the doubling's matrices and the panels when `tables`,
// and per read the node blocks, the solve's two b buffers,
// ix_aff and the reduction slots. With `gstate` the per-node scalars and
// matrices are read from global memory, and a read's state (state_floats)
// lies in the global buffer: shared memory holds the constants and each
// read's reduction slots.
__host__ __device__ inline long state_floats(int K, int ST) {
  return round4(5 * K * ST) + 2L * round4(3 * K * ST) + round4(K * ST);
}
__host__ __device__ inline int red_floats(int ST, int TPR) {
  return round4((TPR >> 5) * (ST + 1));
}
__host__ __device__ inline int per_read_floats(int K, int ST, int TPR) {
  return round4(5 * K * ST) + 2 * round4(3 * K * ST) + round4(K * ST) +
         round4((TPR >> 5) * (ST + 1));
}
inline long smem_floats(int K, int ST, int n_sym, int n_lev, int R, int TPR,
                        int tables, int gstate) {
  const int N = ST * ST;
  long n = round4(4 * N + ST + 3 + 2 * n_sym * N);
  if (gstate) return n + (long)R * red_floats(ST, TPR);
  n += round4(N_SC * K) + round4(N_CO * K * N);
  if (tables) n += round4(n_lev * K * 9 * N) + 2L * round4(n_sym * K * N);
  return n + (long)R * per_read_floats(K, ST, TPR);
}

// One doubling level for node k >= off: v = cur[k] + cur[k - off] P[k],
// where P[k] is this level's (3ST, 3ST) matrix of node k. `lev` points at the
// level: float4 q of node k at lev[(q * K + k) * 4] when (3ST)^2 is a multiple
// of 4, else element e of node k at lev[e * K + k].
template <int ST>
__device__ __forceinline__ void doubling_step(const float* cur,
                                              const float* lev, int K, int k,
                                              int off, float (&v)[3 * ST]) {
  constexpr int D3 = 3 * ST, NA = D3 * D3;
  constexpr int AB = (D3 % 4 == 0) ? 4 : (D3 % 2 == 0) ? 2 : 1;
  load_vec<D3, AB>(cur + k * D3, v);
  if (k < off) return;
  float p[D3];
  load_vec<D3, AB>(cur + (k - off) * D3, p);
  if constexpr (NA % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NA / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(lev)[q * K + k];
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * q + e;
        v[idx % D3] = fmaf(p[idx / D3], tv[e], v[idx % D3]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < NA; ++e)
      v[e % D3] = fmaf(p[e / D3], lev[e * K + k], v[e % D3]);
  }
}

// consts as Consts reads them; ksc (7, K); kco (8, K, ST, ST); alev: n_lev
// levels of K (3ST, 3ST) matrices in doubling_step's layout; emm, emi
// (n_sym, K, ST, ST); toks (B, L) 1-based; lens (B,); out (3, B); GS: gst
// holds state_floats for each of the grid's R-read slots.
// blockDim.x = R * TPR, TPR a multiple of 32, R <= 15 (one named barrier a
// read).
template <int ST, bool MULTIHIT, bool GS>
__global__ void __launch_bounds__(MAX_THREADS)
fused_plan7_nodes(const float* __restrict__ consts_g,
                  const float* __restrict__ ksc_g,
                  const float* __restrict__ kco_g,
                  const float* __restrict__ alev_g,
                  const float* __restrict__ emm_g,
                  const float* __restrict__ emi_g,
                  const int* __restrict__ toks, const int* __restrict__ lens,
                  float* __restrict__ out, long long* __restrict__ prof,
                  float* __restrict__ gst,
                  int B, int L, int K, int n_sym, int n_lev, int R, int TPR,
                  int tables, int n_consts) {
  constexpr int N = ST * ST, D3 = 3 * ST;
  constexpr int AV = (ST % 4 == 0) ? 4 : (ST % 2 == 0) ? 2 : 1;  // X[k] rows
  constexpr int AM = (N % 4 == 0) ? 4 : 1;                       // matrices
  constexpr int AB = (D3 % 4 == 0) ? 4 : (D3 % 2 == 0) ? 2 : 1;  // bc slots
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = blockDim.x, tid = threadIdx.x;

  // ---- carve the shared memory and fill the tables (GS: the per-node
  // scalars and matrices stay in global memory; the shared layout's code is
  // kept as it was, since a reordering changed ptxas's allocation of it)
  float* s_consts = smem;
  int at = round4(n_consts);
  float* s_ksc = GS ? const_cast<float*>(ksc_g) : smem + at;
  if (!GS) at += round4(N_SC * K);
  float* s_kco = GS ? const_cast<float*>(kco_g) : smem + at;
  if (!GS) at += round4(N_CO * K * N);
  const float* alev = alev_g;
  const float* emm = emm_g;
  const float* emi = emi_g;
  if (tables) {
    const int n_a = n_lev * K * 9 * N;
    float* s_alev = smem + at;
    at += round4(n_a);
    for (int i = tid; i < n_a; i += T) s_alev[i] = alev_g[i];
    alev = s_alev;
    const int n = n_sym * K * N;
    float* s_emm = smem + at;
    at += round4(n);
    float* s_emi = smem + at;
    at += round4(n);
    for (int i = tid; i < n; i += T) {
      s_emm[i] = emm_g[i];
      s_emi[i] = emi_g[i];
    }
    emm = s_emm;
    emi = s_emi;
  }
  for (int i = tid; i < n_consts; i += T) s_consts[i] = consts_g[i];
  if (!GS) {
    for (int i = tid; i < N_SC * K; i += T) s_ksc[i] = ksc_g[i];
    for (int i = tid; i < N_CO * K * N; i += T) s_kco[i] = kco_g[i];
  }

  const int r = tid / TPR, j = tid - r * TPR;
  const int w = j >> 5, lane = tid & 31, nw = TPR >> 5;
  float* X = GS ? gst + ((size_t)blockIdx.x * R + r) * state_floats(K, ST)
                : smem + at + r * per_read_floats(K, ST, TPR);
  float* BC = X + round4(5 * K * ST);        // two buffers of 3 K ST
  float* IXA = BC + 2 * round4(3 * K * ST);
  float* red = GS ? smem + at + r * red_floats(ST, TPR)
                  : IXA + round4(K * ST);
  for (int k = j; k < K; k += TPR)
#pragma unroll
    for (int blk = 0; blk < 5; ++blk)
#pragma unroll
      for (int s = 0; s < ST; ++s) X[(blk * K + k) * ST + s] = 0.f;
  __syncthreads();

  const Consts<ST> kc(s_consts);
  const int b = blockIdx.x * R + r;
  if (b >= B) return;              // after the block's only full barrier
  const int len = min(max(lens[b], 0), L);
  const int* tk = toks + (size_t)b * L;
  const int bar = r + 1;           // this read's barrier

  float fl[N_FL][ST];
#pragma unroll
  for (int f = 0; f < N_FL; ++f)
#pragma unroll
    for (int s = 0; s < ST; ++s) fl[f][s] = 0.f;
  int expo = 0;
  bool dead = false;
  long long pr[N_PROF] = {};

  // row -1 solves the start row (no token, no renormalisation)
  for (int row = -1; row < len; ++row) {
    long long t0 = tick();
    int y = -1;
    if (row >= 0) {
      const int t = __ldg(tk + row);
      if (t >= 1 && t <= n_sym) y = t - 1;
    }
    float ty[N], cold_f[N_FL][ST], b0[ST], nx_hot[ST], hot_cx[ST], hot_jx[ST];

    // ---- phase 1: cold, hot and the solve's right-hand side b
    flank_phase1<ST>(kc, y, row, n_sym, fl, ty, cold_f, b0, nx_hot, hot_cx,
                     hot_jx);
    for (int k = j; k < K; k += TPR) {
      float x[ST], cold_m[ST], cold_i[ST], hot[ST], t[ST], t2[ST];
      float bmx[ST], ixa[ST], bix[ST], mat[N], ei0[N];
      // M block: cold_M, hot_Mx, b_mx
      load_vec<ST, AV>(X + (BLK_M * K + k) * ST, x);
      vm<ST>(x, ty, cold_m);
      store_vec<ST, AV>(X + (BLK_M * K + k) * ST, cold_m);
      if (y >= 0) {
        load_vec<N, AM>(emm + ((size_t)y * K + k) * N, mat);
        vm<ST>(x, mat, hot);
      } else {
#pragma unroll
        for (int s = 0; s < ST; ++s) hot[s] = 0.f;
      }
      const float entry = MULTIHIT ? 0.f : s_ksc[SC_ENTRY * K + k];
#pragma unroll
      for (int s = 0; s < ST; ++s) t[s] = entry * b0[s] + cold_m[s];
      load_vec<N, AM>(s_kco + ((size_t)CO_EM0 * K + k) * N, mat);
      vm<ST>(t, mat, bmx);
#pragma unroll
      for (int s = 0; s < ST; ++s) bmx[s] += hot[s];
      // I block: cold_I, hot_Ix, ix_aff, b_ix
      load_vec<ST, AV>(X + (BLK_I * K + k) * ST, x);
      vm<ST>(x, ty, cold_i);
      store_vec<ST, AV>(X + (BLK_I * K + k) * ST, cold_i);
      if (y >= 0) {
        load_vec<N, AM>(emi + ((size_t)y * K + k) * N, mat);
        vm<ST>(x, mat, hot);
      }
      load_vec<N, AM>(s_kco + ((size_t)CO_EI0 * K + k) * N, ei0);
      vm<ST>(cold_i, ei0, ixa);
      const float m2i = s_ksc[SC_M2I * K + k], i2i = s_ksc[SC_I2I * K + k];
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        ixa[s] += hot[s];
        t[s] = m2i * bmx[s] + i2i * ixa[s];
      }
      load_vec<N, AM>(s_kco + ((size_t)CO_CI * K + k) * N, mat);
      vm<ST>(t, mat, t2);
      vm<ST>(t2, ei0, bix);
#pragma unroll
      for (int s = 0; s < ST; ++s) bix[s] += ixa[s];
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        BC[k * D3 + s] = bmx[s];
        BC[k * D3 + ST + s] = bix[s];
        BC[k * D3 + 2 * ST + s] = 0.f;
      }
      store_vec<ST, AV>(IXA + k * ST, ixa);
      // the other blocks' cold parts
#pragma unroll
      for (int blk = 0; blk < 5; ++blk) {
        if (blk == BLK_M || blk == BLK_I) continue;
        load_vec<ST, AV>(X + (blk * K + k) * ST, x);
        vm<ST>(x, ty, t);
        store_vec<ST, AV>(X + (blk * K + k) * ST, t);
      }
    }
    long long t1 = tick();
    pr[PN_PHASE1] += t1 - t0;
    // ---- phase 2: the along-k solve, ceil(log2 K) doubling levels that
    // pass b from one buffer to the other
    const float* carry = BC;
    {
      float* nxt = BC + round4(3 * K * ST);
      for (int l = 0, off = 1; l < n_lev; ++l, off <<= 1) {
        group_sync(bar, TPR);
        const long long tb = tick();
        pr[PN_BARRIER] += tb - t1;
        for (int k = j; k < K; k += TPR) {
          float v[D3];
          doubling_step<ST>(carry, alev + (size_t)l * K * 9 * N, K, k, off,
                            v);
          store_vec<D3, AB>(nxt + k * D3, v);
        }
        float* done = nxt;
        nxt = const_cast<float*>(carry);
        carry = done;
        t1 = tick();
        pr[PN_LEVEL + min(l, N_PROF - 1 - PN_LEVEL)] += t1 - tb;
      }
    }
    group_sync(bar, TPR);
    long long t2 = tick();
    pr[PN_BARRIER] += t2 - t1;

    // ---- phase 3a: recombine into M and I, add the solved values, E sums
    float ep[ST];
#pragma unroll
    for (int s = 0; s < ST; ++s) ep[s] = 0.f;
    for (int k = j; k < K; k += TPR) {
      float c[D3], p[D3], ixa[ST], t[ST], ih[ST], mat[N], x[ST];
      load_vec<D3, AB>(carry + k * D3, c);
      if (k > 0) {
        load_vec<D3, AB>(carry + (k - 1) * D3, p);
      } else {
#pragma unroll
        for (int d = 0; d < D3; ++d) p[d] = 0.f;
      }
      const float rm = s_ksc[SC_ROLL_M * K + k],
                  ri = s_ksc[SC_ROLL_I * K + k],
                  rd = s_ksc[SC_ROLL_D * K + k],
                  last = s_ksc[SC_LAST * K + k];
      const float entry = MULTIHIT ? 0.f : s_ksc[SC_ENTRY * K + k];
      const float m2i = s_ksc[SC_M2I * K + k], i2i = s_ksc[SC_I2I * K + k];
      load_vec<ST, AV>(IXA + k * ST, ixa);
      float mh[ST];
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        mh[s] = (rm * p[s] + ri * p[ST + s] + rd * p[2 * ST + s]) +
                entry * b0[s];
        t[s] = m2i * c[s] + i2i * ixa[s];
        ep[s] += mh[s] + c[2 * ST + s] + last * c[ST + s];
      }
      load_vec<N, AM>(s_kco + ((size_t)CO_CI * K + k) * N, mat);
      vm<ST>(t, mat, ih);
#pragma unroll
      for (int blk = 0; blk < 5; ++blk) {
        load_vec<ST, AV>(X + (blk * K + k) * ST, x);
#pragma unroll
        for (int s = 0; s < ST; ++s)
          x[s] += blk == BLK_M ? mh[s] : blk == BLK_MX ? c[s]
                  : blk == BLK_I ? ih[s] : blk == BLK_IX ? c[ST + s]
                  : c[2 * ST + s];
        store_vec<ST, AV>(X + (blk * K + k) * ST, x);
      }
    }
    long long t3 = tick();
    pr[PN_PHASE3A] += t3 - t2;
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      ep[s] = warp_sum(ep[s]);
      if (lane == 0) red[w * (ST + 1) + s] = ep[s];
    }
    long long t4 = tick();
    pr[PN_REDUCE] += t4 - t3;
    group_sync(bar, TPR);
    long long t5 = tick();
    pr[PN_BARRIER] += t5 - t4;

    // ---- phase 3b: the flanks, the multihit B contribution, the maximum
    float e[ST], b_hot[ST];
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      float acc = red[s];
      for (int ww = 1; ww < nw; ++ww) acc += red[ww * (ST + 1) + s];
      e[s] = acc;
    }
    float mx = flank_phase3<ST, MULTIHIT>(kc, e, cold_f, b0, nx_hot, hot_cx,
                                          hot_jx, b_hot, fl);
    for (int k = j; k < K; k += TPR) {
#pragma unroll
      for (int blk = 0; blk < 5; ++blk) {
        float x[ST];
        load_vec<ST, AV>(X + (blk * K + k) * ST, x);
        if constexpr (MULTIHIT) {
          float mat[N], add[ST];
          load_vec<N, AM>(s_kco + ((size_t)(CO_MB_M + blk) * K + k) * N,
                          mat);
          vm<ST>(b_hot, mat, add);
#pragma unroll
          for (int s = 0; s < ST; ++s) x[s] += add[s];
          store_vec<ST, AV>(X + (blk * K + k) * ST, x);
        }
#pragma unroll
        for (int s = 0; s < ST; ++s) mx = fmaxf(mx, x[s]);
      }
    }
    long long t6 = tick();
    pr[PN_PHASE3B] += t6 - t5;

    // ---- phase 4: exact power-of-two renormalisation of the whole state
    if (row >= 0) {
      mx = warp_max(mx);
      if (lane == 0) red[w * (ST + 1) + ST] = mx;
      const long long t7 = tick();
      pr[PN_REDUCE] += t7 - t6;
      group_sync(bar, TPR);
      t6 = tick();
      pr[PN_BARRIER] += t6 - t7;
      {
        float m = red[ST];
        for (int ww = 1; ww < nw; ++ww)
          m = fmaxf(m, red[ww * (ST + 1) + ST]);
        const bool alive = m > 0.f;
        const float msafe = alive ? m : 1.f;
        const int kexp = (__float_as_int(msafe) >> 23) & 0xFF;
        const float inv = __int_as_float((254 - kexp) << 23);
        for (int k = j; k < K; k += TPR)
#pragma unroll
          for (int blk = 0; blk < 5; ++blk)
#pragma unroll
            for (int s = 0; s < ST; ++s) X[(blk * K + k) * ST + s] *= inv;
#pragma unroll
        for (int f = 0; f < N_FL; ++f)
#pragma unroll
          for (int s = 0; s < ST; ++s) fl[f][s] *= inv;
        expo += kexp - 127;
        dead = dead || !alive;
      }
    }
    pr[PN_PHASE4] += tick() - t6;
  }
  if (j == 0) {
    out[b] = fl[F_T][ST - 1];
    out[B + b] = (float)expo;
    out[2 * B + b] = dead ? 1.f : 0.f;
#ifdef PHASE_PROFILE
    pr[PN_ROWS] = len + 1;
    for (int q = 0; q < N_PROF; ++q) prof[(size_t)b * N_PROF + q] = pr[q];
#endif
  }
}

template <typename Kern>
int set_smem(Kern kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int ST, bool MH, int CM>
int launch_warp(const float* consts, const float* ntab, const float* span,
                const float* pan, const int* toks, const int* lens,
                float* out, long long* prof, int B, int L, int C, int n_sym,
                int n_lev, int R, int in_smem, int smem, int n_consts,
                cudaStream_t stream) {
  auto kern = fused_plan7_warp<ST, MH, CM>;
  const int err = set_smem(kern, smem);
  if (err != 0 || B == 0) return err;
  kern<<<(B + R - 1) / R, R * 32, smem, stream>>>(
      consts, ntab, span, pan, toks, lens, out, prof, B, L, C, n_sym, n_lev,
      in_smem, n_consts);
  return (int)cudaGetLastError();
}

template <int ST, bool MH, bool GS>
int launch_nodes(const float* consts, const float* ksc, const float* kco,
                 const float* alev, const float* emm, const float* emi,
                 const int* toks, const int* lens, float* out,
                 long long* prof, float* gst, int B, int L, int K, int n_sym,
                 int n_lev, int R, int TPR, int tables, int smem,
                 int n_consts, cudaStream_t stream) {
  auto kern = fused_plan7_nodes<ST, MH, GS>;
  const int err = set_smem(kern, smem);
  if (err != 0 || B == 0) return err;
  kern<<<(B + R - 1) / R, R * TPR, smem, stream>>>(
      consts, ksc, kco, alev, emm, emi, toks, lens, out, prof, gst, B, L, K,
      n_sym, n_lev, R, TPR, tables, n_consts);
  return (int)cudaGetLastError();
}

// f(Int<CM>()) for the chunk size instantiated for C nodes a lane: the
// least of 4, 8 and 12 that holds C and is unrolled at ST states, else
// MAX_CHUNK.
template <int ST, int CM = 4, typename F>
int with_chunk(int C, F&& f) {
  if constexpr (CM >= MAX_CHUNK) {
    return f(Int<MAX_CHUNK>());
  } else {
    if constexpr (CM * ST <= UNROLL_NODE_STATES) {
      if (C <= CM) return f(Int<CM>());
    }
    return with_chunk<ST, CM + 4>(C, f);
  }
}

int ceil_log2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

// Launches the warp layout on `stream`: (B + R - 1) / R blocks of R warps
// with `smem` bytes of dynamic shared memory, which must be what
// warp_smem_floats says for `in_smem`. C = ceil(K / 32) nodes a lane, n_lev
// = ceil(log2(ceil(K / C))) span levels. prof: (B, 20) int64 for the
// profile library, else null. Returns cudaGetLastError(): nonzero means the
// launch was refused.
extern "C" int fused_plan7_warp_launch(
    const void* consts, const void* ntab, const void* span, const void* pan,
    const void* toks, const void* lens, void* out, void* prof, int B, int L,
    int K, int St, int n_sym, int C, int n_lev, int multihit, int R,
    int in_smem, int smem, int n_consts, void* stream) {
  if (St < 1 || St > 4 || K < 1 || n_sym < 1 || R < 1 ||
      R > MAX_WARP_READS || B < 0 || L < 0 || C != (K + 31) / 32 ||
      C > MAX_CHUNK || n_lev != ceil_log2((K + C - 1) / C) || in_smem < 0 ||
      in_smem > 7 || n_consts != 4 * St * St + St + 3 + 2 * n_sym * St * St)
    return (int)cudaErrorInvalidValue;
#ifdef PHASE_PROFILE
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
#endif
#define PLAN7_WARP(ST, MH, CM)                                               \
  if (smem != 4 * warp_smem_floats(ST, n_sym, C, n_lev, in_smem, n_consts))  \
    return (int)cudaErrorInvalidValue;                                       \
  return launch_warp<ST, MH, CM>(                                            \
      (const float*)consts, (const float*)ntab, (const float*)span,          \
      (const float*)pan, (const int*)toks, (const int*)lens, (float*)out,    \
      (long long*)prof, B, L, C, n_sym, n_lev, R, in_smem, smem, n_consts,   \
      (cudaStream_t)stream);
#define PLAN7_WARP_ST(ST)                                                    \
  if (St == ST) {                                                            \
    if (multihit)                                                            \
      return with_chunk<ST>(C, [&](auto cm) {                                \
        PLAN7_WARP(ST, true, decltype(cm)::value)                            \
      });                                                                    \
    return with_chunk<ST>(C, [&](auto cm) {                                  \
      PLAN7_WARP(ST, false, decltype(cm)::value)                             \
    });                                                                      \
  }
  PLAN7_WARP_ST(1) PLAN7_WARP_ST(2) PLAN7_WARP_ST(3) PLAN7_WARP_ST(4)
#undef PLAN7_WARP_ST
#undef PLAN7_WARP
  return (int)cudaErrorInvalidValue;
}

// Launches the node-doubling layout on `stream`: (B + R - 1) / R blocks of
// R * TPR threads with `smem` bytes of dynamic shared memory, which must be
// what smem_floats says. gstate = 1 keeps each read's state in `gst`,
// (B + R - 1) / R * R times nodes_state_floats (not read with gstate = 0).
// prof as above. Returns cudaGetLastError().
extern "C" long fused_plan7_nodes_state_floats(int K, int St) {
  return state_floats(K, St);
}

extern "C" int fused_plan7_nodes_launch(
    const void* consts, const void* ksc, const void* kco, const void* alev,
    const void* emm, const void* emi, const void* toks, const void* lens,
    void* out, void* prof, void* gst, int B, int L, int K, int St, int n_sym,
    int n_lev, int multihit, int R, int TPR, int tables, int gstate,
    int smem, int n_consts, void* stream) {
  if (St < 1 || St > 4 || K < 1 || n_sym < 1 || R < 1 || R > 15 || TPR < 32 ||
      TPR % 32 != 0 || R * TPR > MAX_THREADS || B < 0 || L < 0 ||
      n_lev != ceil_log2(K) || gstate < 0 || gstate > 1 ||
      (gstate && (gst == nullptr || tables)) ||
      n_consts != 4 * St * St + St + 3 + 2 * n_sym * St * St ||
      smem != 4 * smem_floats(K, St, n_sym, n_lev, R, TPR, tables, gstate))
    return (int)cudaErrorInvalidValue;
#ifdef PHASE_PROFILE
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
#endif
#define PLAN7_CASE(ST, MH, GS)                                               \
  if (St == ST && (multihit != 0) == MH && (gstate != 0) == GS)              \
    return launch_nodes<ST, MH, GS>(                                         \
        (const float*)consts, (const float*)ksc, (const float*)kco,          \
        (const float*)alev, (const float*)emm, (const float*)emi,            \
        (const int*)toks, (const int*)lens, (float*)out, (long long*)prof,   \
        (float*)gst, B, L, K, n_sym, n_lev, R, TPR, tables, smem, n_consts,  \
        (cudaStream_t)stream);
#define PLAN7_CASES(ST)                                                      \
  PLAN7_CASE(ST, false, false) PLAN7_CASE(ST, true, false)                   \
  PLAN7_CASE(ST, false, true) PLAN7_CASE(ST, true, true)
  PLAN7_CASES(1) PLAN7_CASES(2) PLAN7_CASES(3) PLAN7_CASES(4)
#undef PLAN7_CASES
#undef PLAN7_CASE
  return (int)cudaErrorInvalidValue;
}
