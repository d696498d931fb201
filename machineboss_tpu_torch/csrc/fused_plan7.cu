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
// The along-k solve runs by log-depth doubling over the affine maps
// (A_k, b_k): at level l every node k >= 2^l absorbs the node 2^l to its left,
// b_k += b_{k-2^l} P_l[k], where P_l[k] = A_{k-2^l+1} ... A_k does not depend
// on the row and comes from the host; ceil(log2 K) levels of (3St)^2
// multiply-adds per node, all nodes side by side, one block barrier a level.
// The TPU kernel multiplies by the (3St K)^2 lower-block-triangular
// prefix-product matrix instead, the closed form of the same recurrence that
// suits a matrix unit: K/2 (3St)^2 multiply-adds per node, and at K=86, St=2 a
// 1 MB operand that no block's shared memory holds. Walking the recurrence
// step by step is the least arithmetic ((3St)^2 per node) but K dependent
// steps by one thread per read, which took most of the kernel's time when it
// was tried (PERF.md). The doubling also serves profiles too long for a
// prefix matrix.
//
// What the TPU kernel did that this one does not: node blocks padded to
// multiples of 8 rows and never sliced, reads padded to 128 lanes and the
// solve's operand to 128 rows, tokens streamed as (8, B) blocks, one grid
// step per token row with the state carried in scratch memory (here the row
// loop is inside the kernel and each read walks to its own length), one-hot
// mask accumulation over all output tokens to select a read's coefficients
// (here a thread reads its own token's St x St coefficients), and the St x St
// constants baked into the program (here they sit in shared memory).
//
// Design: a block owns R reads, TPR threads each (a multiple of 32, one
// thread per profile node when K <= 256). The node blocks of a read's state
// live in shared memory and are touched only by the thread that owns the
// node; the flank rows live in registers, replicated in every thread of the
// read, so the flank algebra needs no exchange. Per row: the owner threads
// write b and the cold part of the new state; the doubling levels pass b
// between two buffers; the owners recombine, and the E sum and the state's
// maximum are reduced by warp shuffles and one shared-memory pass each:
// ceil(log2 K) + 3 barriers a row. The reads of a block share nothing once
// the tables are loaded, so each read's threads meet at a named barrier of
// their own, and every read walks to its own length while the others go on.
// The per-node tables are copied to shared memory once per block, and with
// them the doubling's matrices and the paired-emission panels when all of it
// fits beside the state (`tables`); else those two are read through the
// read-only cache, laid out so that neighbouring nodes read neighbouring
// addresses.
//
// What bounds it on this card: operations ((12 + 9 ceil(log2 K)) St^2 + 8 St
// multiply-adds per node, row and read (12 St x St products: five cold
// blocks, two paired emissions, em0, ei0 twice, ci twice), 5 St^2 more with
// multihit (the basis maps), against the f32 non-tensor rate); the bytes are the tokens and the tables, read
// once. The rows of a read depend on each other and every row has its
// barriers, so the run time is rows x (phases + barriers), which the bound
// does not see.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_SC = 7, N_CO = 8, N_FL = 9;
constexpr int MAX_THREADS = 768;
enum { SC_ENTRY, SC_M2I, SC_I2I, SC_ROLL_M, SC_ROLL_I, SC_ROLL_D, SC_LAST };
enum { CO_EM0, CO_EI0, CO_CI, CO_MB_M };   // CO_MB_M + block: the basis maps
enum { F_N, F_NX, F_B, F_E, F_C, F_CX, F_J, F_JX, F_T };
enum { BLK_M, BLK_MX, BLK_I, BLK_IX, BLK_D };

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Floats of one block's dynamic shared memory: the constants, the per-node
// scalars and matrices, the doubling's matrices and the panels when `tables`,
// and per read the node blocks, the solve's two b buffers,
// ix_aff and the reduction slots.
__host__ __device__ inline int per_read_floats(int K, int ST, int TPR) {
  return round4(5 * K * ST) + 2 * round4(3 * K * ST) + round4(K * ST) +
         round4((TPR >> 5) * (ST + 1));
}
inline int smem_floats(int K, int ST, int n_sym, int n_lev, int R, int TPR,
                       int tables) {
  const int N = ST * ST;
  int n = round4(4 * N + ST + 3 + 2 * n_sym * N) + round4(N_SC * K) +
          round4(N_CO * K * N);
  if (tables) n += round4(n_lev * K * 9 * N) + 2 * round4(n_sym * K * N);
  return n + R * per_read_floats(K, ST, TPR);
}

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

// Barrier of the n threads (a multiple of 32) that share barrier `id` (1-15;
// 0 is __syncthreads'); orders their shared-memory accesses.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
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

// consts: cloop, enull0, mloop_star, mb_E (ST x ST each), first (ST),
// loop_s, exit_s, e_to_c, ty0 and en_y (n_sym x ST x ST each); ksc (7, K);
// kco (8, K, ST, ST); alev: n_lev levels of K (3ST, 3ST) matrices in
// doubling_step's layout; emm, emi (n_sym, K, ST, ST); toks (B, L) 1-based;
// lens (B,); out (3, B). blockDim.x = R * TPR, TPR a multiple of 32, R <= 15
// (one named barrier a read).
template <int ST, bool MULTIHIT>
__global__ void __launch_bounds__(MAX_THREADS)
fused_plan7_kernel(const float* __restrict__ consts_g,
                   const float* __restrict__ ksc_g,
                   const float* __restrict__ kco_g,
                   const float* __restrict__ alev_g,
                   const float* __restrict__ emm_g,
                   const float* __restrict__ emi_g,
                   const int* __restrict__ toks, const int* __restrict__ lens,
                   float* __restrict__ out, int B, int L, int K, int n_sym,
                   int n_lev, int R, int TPR, int tables, int n_consts) {
  constexpr int N = ST * ST, D3 = 3 * ST;
  constexpr int AV = (ST % 4 == 0) ? 4 : (ST % 2 == 0) ? 2 : 1;  // X[k] rows
  constexpr int AM = (N % 4 == 0) ? 4 : 1;                       // matrices
  constexpr int AB = (D3 % 4 == 0) ? 4 : (D3 % 2 == 0) ? 2 : 1;  // bc slots
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = blockDim.x, tid = threadIdx.x;

  // ---- carve the shared memory and fill the tables
  float* s_consts = smem;
  int at = round4(n_consts);
  float* s_ksc = smem + at;
  at += round4(N_SC * K);
  float* s_kco = smem + at;
  at += round4(N_CO * K * N);
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
  for (int i = tid; i < N_SC * K; i += T) s_ksc[i] = ksc_g[i];
  for (int i = tid; i < N_CO * K * N; i += T) s_kco[i] = kco_g[i];

  const int r = tid / TPR, j = tid - r * TPR;
  const int w = j >> 5, lane = tid & 31, nw = TPR >> 5;
  float* X = smem + at + r * per_read_floats(K, ST, TPR);
  float* BC = X + round4(5 * K * ST);        // two buffers of 3 K ST
  float* IXA = BC + 2 * round4(3 * K * ST);
  float* red = IXA + round4(K * ST);
  for (int k = j; k < K; k += TPR)
#pragma unroll
    for (int blk = 0; blk < 5; ++blk)
#pragma unroll
      for (int s = 0; s < ST; ++s) X[(blk * K + k) * ST + s] = 0.f;
  __syncthreads();

  const float* c_cloop = s_consts;
  const float* c_enull0 = s_consts + N;
  const float* c_mstar = s_consts + 2 * N;
  const float* c_mbe = s_consts + 3 * N;
  const float* c_first = s_consts + 4 * N;
  const float loop_s = c_first[ST], exit_s = c_first[ST + 1],
              e_to_c = c_first[ST + 2];
  const float* c_ty0 = c_first + ST + 3;
  const float* c_eny = c_ty0 + n_sym * N;

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

  // row -1 solves the start row (no token, no renormalisation)
  for (int row = -1; row < len; ++row) {
    int y = -1;
    if (row >= 0) {
      const int t = __ldg(tk + row);
      if (t >= 1 && t <= n_sym) y = t - 1;
    }
    float ty[N];
    float cold_f[N_FL][ST];
    float b0[ST], nx_hot[ST], hot_cx[ST], hot_jx[ST];

    // ---- phase 1: cold, hot and the solve's right-hand side b
    {
      float eny[N], cloop[N], enull0[N];
      if (y >= 0) {
        load_vec<N, 1>(c_ty0 + y * N, ty);
        load_vec<N, 1>(c_eny + y * N, eny);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) ty[i] = eny[i] = 0.f;
      }
      load_vec<N, AM>(c_cloop, cloop);
      load_vec<N, AM>(c_enull0, enull0);
#pragma unroll
      for (int f = 0; f < N_FL; ++f) vm<ST>(fl[f], ty, cold_f[f]);
      float hot_nx[ST], nx_in[ST];
      vm<ST>(fl[F_N], eny, hot_nx);
      vm<ST>(fl[F_C], eny, hot_cx);
      vm<ST>(fl[F_J], eny, hot_jx);
      vm<ST>(cold_f[F_N], enull0, nx_in);
#pragma unroll
      for (int s = 0; s < ST; ++s)
        nx_in[s] += hot_nx[s] + (row < 0 ? c_first[s] : 0.f);
      vm<ST>(nx_in, cloop, nx_hot);
#pragma unroll
      for (int s = 0; s < ST; ++s) b0[s] = exit_s * nx_hot[s];

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
    }
    // ---- phase 2: the along-k solve, ceil(log2 K) doubling levels that
    // pass b from one buffer to the other
    const float* carry = BC;
    {
      float* nxt = BC + round4(3 * K * ST);
      for (int l = 0, off = 1; l < n_lev; ++l, off <<= 1) {
        group_sync(bar, TPR);
        for (int k = j; k < K; k += TPR) {
          float v[D3];
          doubling_step<ST>(carry, alev + (size_t)l * K * 9 * N, K, k, off,
                            v);
          store_vec<D3, AB>(nxt + k * D3, v);
        }
        float* done = nxt;
        nxt = const_cast<float*>(carry);
        carry = done;
      }
    }
    group_sync(bar, TPR);

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
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      ep[s] = warp_sum(ep[s]);
      if (lane == 0) red[w * (ST + 1) + s] = ep[s];
    }
    group_sync(bar, TPR);

    // ---- phase 3b: the flanks, the multihit B contribution, the maximum
    float mx = 0.f;
    {
      float cloop[N], enull0[N];
      load_vec<N, AM>(c_cloop, cloop);
      load_vec<N, AM>(c_enull0, enull0);
      float e[ST], b_hot[ST], e_hot[ST], jx_hot[ST], j_hot[ST];
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        float acc = red[s];
        for (int ww = 1; ww < nw; ++ww) acc += red[ww * (ST + 1) + s];
        e[s] = acc;
      }
      if constexpr (MULTIHIT) {
        float jxb[ST], jcl[ST], c_in[ST], be[ST], jx_in[ST], mat[N];
        vm<ST>(cold_f[F_J], enull0, jxb);
#pragma unroll
        for (int s = 0; s < ST; ++s) jxb[s] += hot_jx[s] + 0.5f * e[s];
        vm<ST>(jxb, cloop, jcl);
#pragma unroll
        for (int s = 0; s < ST; ++s) c_in[s] = b0[s] + exit_s * jcl[s];
        load_vec<N, AM>(c_mstar, mat);
        vm<ST>(c_in, mat, b_hot);
        load_vec<N, AM>(c_mbe, mat);
        vm<ST>(b_hot, mat, be);
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          e_hot[s] = e[s] + be[s];
          jx_in[s] = jxb[s] + 0.5f * be[s];
        }
        vm<ST>(jx_in, cloop, jx_hot);
#pragma unroll
        for (int s = 0; s < ST; ++s) j_hot[s] = loop_s * jx_hot[s];
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
      for (int s = 0; s < ST; ++s) cx_in[s] += hot_cx[s] + e_to_c * e_hot[s];
      vm<ST>(cx_in, cloop, cx_hot);
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        fl[F_N][s] = loop_s * nx_hot[s] + cold_f[F_N][s];
        fl[F_NX][s] = nx_hot[s] + cold_f[F_NX][s];
        fl[F_B][s] = b_hot[s] + cold_f[F_B][s];
        fl[F_E][s] = e_hot[s] + cold_f[F_E][s];
        fl[F_C][s] = loop_s * cx_hot[s] + cold_f[F_C][s];
        fl[F_CX][s] = cx_hot[s] + cold_f[F_CX][s];
        fl[F_J][s] = j_hot[s] + cold_f[F_J][s];
        fl[F_JX][s] = jx_hot[s] + cold_f[F_JX][s];
        fl[F_T][s] = exit_s * cx_hot[s] + cold_f[F_T][s];
      }
#pragma unroll
      for (int f = 0; f < N_FL; ++f)
#pragma unroll
        for (int s = 0; s < ST; ++s) mx = fmaxf(mx, fl[f][s]);
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
    }

    // ---- phase 4: exact power-of-two renormalisation of the whole state
    if (row >= 0) {
      mx = warp_max(mx);
      if (lane == 0) red[w * (ST + 1) + ST] = mx;
      group_sync(bar, TPR);
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
  }
  if (j == 0) {
    out[b] = fl[F_T][ST - 1];
    out[B + b] = (float)expo;
    out[2 * B + b] = dead ? 1.f : 0.f;
  }
}

template <int ST, bool MULTIHIT>
int launch(const float* consts, const float* ksc, const float* kco,
           const float* alev, const float* emm, const float* emi,
           const int* toks, const int* lens, float* out, int B, int L, int K,
           int n_sym, int n_lev, int R, int TPR, int tables, int smem,
           int n_consts, cudaStream_t stream) {
  auto kern = fused_plan7_kernel<ST, MULTIHIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  kern<<<(B + R - 1) / R, R * TPR, smem, stream>>>(
      consts, ksc, kco, alev, emm, emi, toks, lens, out, B, L, K, n_sym,
      n_lev, R, TPR, tables, n_consts);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream`: (B + R - 1) / R blocks of R * TPR threads
// with `smem` bytes of dynamic shared memory, which must be what the layout
// above needs. Returns cudaGetLastError(): nonzero means the launch was
// refused.
extern "C" int fused_plan7_launch(
    const void* consts, const void* ksc, const void* kco, const void* alev,
    const void* emm, const void* emi, const void* toks, const void* lens,
    void* out, int B, int L, int K, int St, int n_sym, int n_lev,
    int multihit, int R, int TPR, int tables, int smem, int n_consts,
    void* stream) {
  int need_lev = 0;
  while ((1 << need_lev) < K) ++need_lev;
  if (St < 1 || St > 4 || K < 1 || n_sym < 1 || R < 1 || R > 15 || TPR < 32 ||
      TPR % 32 != 0 || R * TPR > MAX_THREADS || B < 0 || L < 0 ||
      n_lev != need_lev ||
      n_consts != 4 * St * St + St + 3 + 2 * n_sym * St * St ||
      smem != 4 * smem_floats(K, St, n_sym, n_lev, R, TPR, tables))
    return (int)cudaErrorInvalidValue;
#define PLAN7_CASE(ST, MH)                                                   \
  if (St == ST && (multihit != 0) == MH)                                     \
    return launch<ST, MH>((const float*)consts, (const float*)ksc,           \
                          (const float*)kco, (const float*)alev,             \
                          (const float*)emm, (const float*)emi,              \
                          (const int*)toks, (const int*)lens, (float*)out,   \
                          B, L, K, n_sym, n_lev, R, TPR, tables, smem,       \
                          n_consts, (cudaStream_t)stream);
  PLAN7_CASE(1, false) PLAN7_CASE(1, true) PLAN7_CASE(2, false)
  PLAN7_CASE(2, true) PLAN7_CASE(3, false) PLAN7_CASE(3, true)
  PLAN7_CASE(4, false) PLAN7_CASE(4, true)
#undef PLAN7_CASE
  return (int)cudaErrorInvalidValue;
}
