// Low-rank wavefront Forward for structured transducers, for Hopper (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/lowrank_kernel.py::_lowrank_kernel, in
// its plain mode (lowrank_wavefront_kernel) and its chained mode
// (lowrank_chained_kernel, _body_chained there). The host prep is the same
// (prepare_lowrank in ops/kernels/lowrank_kernel.py): the silent closure is
// folded into each neighbour class, dead states are pruned (Sa live states)
// and every class is factored at its minimum rank on the source or
// destination side.
//
// What it computes, per pair b, on the cells (i, o) of its own lattice,
// diagonal d = i + o, carried as scaled probabilities p (Sa floats) with a
// per-cell log scale m:
//   * each present class reads one neighbour: up (i, o-1) and left (i-1, o)
//     on d-1, diag (i-1, o-1) on d-2; w_c = exp(m_c - mu), mu = max m_c;
//   * a src-side class adds  M_c @ concat_r(p_c * w_c * E_c[r-block, tok]),
//     a dest-side class adds sum_r (M_c @ (p_c * w_c))[r-block] * E_c[., tok];
//   * on diagonals with d % rescale_every <= 1 (both parities) p is divided
//     by its max over states and the log of that max is added to m;
//   * the readout is m + log(p[Sa-1]) at cell (il, ol).
// Chained mode walks n_chain uniform-length pairs per strip on the schedule
// of strip.cuh (stagger sigma = Lo + 2, one block per strip): the rescale
// fires on the absolute step, chain k restarts at (0, 0) with m = 0 and is
// read out at (Li, Lo); the lengths are ignored. The TPU kernel's chained
// mode builds the left class's token scale in the kernel (prepare_lowrank
// with chained=True has no static scale); this kernel reads every class's
// token column of E in the kernel in both modes, so the operands are the
// same.
//
// What the TPU kernel did that this one does not: the bf16 hi/lo 3-pass
// products, the one-hot token matrices, the 128-lane cell windows and the
// two diagonals per grid step are workarounds for the MXU and Mosaic; the
// per-lane (f, k) chain scratch and streamed token rows of chained mode
// become a column's chain and token computed from the step. Here every
// product is a plain f32 FMA (at least as accurate as the 3-pass split), a
// token's column of E is read directly, and the diagonal loop runs inside
// the block.
//
// Design: plain mode, one thread block per pair, so pairs share no state and
// no block waits on another; the block loops over its own il+ol diagonals
// only, so the padding the batch API adds costs nothing. Chained mode, one
// block per strip. The diagonal state lives in a global scratch of three
// rotating (Li+1, SaP) slots per block (L2-resident; the active part per
// block is 3*(il+1)*SaP floats). For each chunk of cells on a diagonal the
// block builds the class operands Z (k rows x cells) in shared memory, then
// each thread accumulates a tile of 8 cells x 4 destination states over k,
// reading the transposed M_c (k-major, so neighbouring threads read
// neighbouring addresses) through the read-only cache. lr_step() is that
// diagonal step; the two kernels differ only in how a column maps to a pair
// and a cell (PairCells, StripCells).
//
// What bounds it on this card: the work is f32 FMAs, sum over classes of
// rank * Sa * Sa per cell (3.0e4 for prot2dna), and the bytes that must move
// are only tokens, lengths and the small M/E tables. No tensor cores are
// used (wgmma is later work), so the bound is the H100's f32 non-tensor
// rate. Each FMA needs one M value (read-only cache) and one Z value
// (shared memory); the 8x4 register tile cuts that to 12 loads per 32 FMAs
// so that the loads do not bound the loop before the FMA pipes do. Chained
// mode has B / n_chain blocks for 132 multiprocessors.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strip.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int TC = 8;        // cells per thread tile
constexpr int TD = 4;        // destination states per thread tile
constexpr int MAX_CLS = 3;

enum { KIND_UP = 0, KIND_LEFT = 1, KIND_DIAG = 2 };
enum { SIDE_SRC = 0, SIDE_DEST = 1 };
// what a column holds on a step
enum { CELL_LIVE = 0, CELL_START = 1, CELL_DEAD = 2 };

// Per-class descriptor, laid out as the host passes it (DESC_LEN ints).
struct ClassDesc {
  int kind;    // KIND_*
  int side;    // SIDE_*
  int rank;
  int n_tok;
  int K;       // rows of this class's Z block (= rows of MT)
  int N;       // columns of MT: SaP (src) or rank*SaP (dest)
  int mt_off;  // float offset of this class's MT in the packed buffer
  int e_off;   // float offset of this class's E (rank*Sa, n_tok) block
  int z_off;   // first Z row of this class in shared memory
};
constexpr int DESC_LEN = 9;

struct Plan {
  ClassDesc cls[MAX_CLS];
  int n_cls;
};

struct LrArgs {
  const int* in_toks;
  const int* out_toks;
  const float* c0;
  const float* mt;
  const float* emat;
  float* pbuf;
  float* mbuf;
  float* out;
  int Li, Lo, Sa, SaP, To, rescale_every;
  Plan plan;
  int CC, k_total;
};

// the block's shared memory: Z (k_total x CC), per-cell class weights and
// tokens (MAX_CLS x CC each), per-cell states (CC), the bad-token flag
struct Smem {
  float* Z;
  float* w;
  int* tok;
  int* state;
  int* bad;
};

struct CellInfo {
  int state;   // CELL_*
  int o;
  const int* xt;
  const int* yt;
  int* bad;
};

// plain mode: every column of diagonal d in [lo, hi] is a live cell of the
// block's own pair
struct PairCells {
  const int* xt;
  const int* yt;
  int* bad;
  __device__ CellInfo at(int d, int i) const {
    return CellInfo{CELL_LIVE, d - i, xt, yt, bad};
  }
};

// chained mode: column i at step t holds a cell of chain k of strip w
struct StripCells {
  strip::Strip st;
  const int* in_toks;
  const int* out_toks;
  int* bad;
  int w;
  __device__ CellInfo at(int t, int i) const {
    int k, o;
    if (!strip::cell(st, t, i, k, o))
      return CellInfo{CELL_DEAD, 0, nullptr, nullptr, nullptr};
    const int n = strip::pair(st, k, w);
    return CellInfo{i == 0 && o == 0 ? CELL_START : CELL_LIVE, o,
                    in_toks + (size_t)n * st.Li, out_toks + (size_t)n * st.Lo,
                    bad + n};
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ Smem smem_layout(float4* smem4, int CC, int k_total) {
  Smem sm;
  sm.Z = reinterpret_cast<float*>(smem4);
  sm.w = sm.Z + (size_t)k_total * CC;
  sm.tok = reinterpret_cast<int*>(sm.w + MAX_CLS * CC);
  sm.state = sm.tok + MAX_CLS * CC;
  sm.bad = sm.state + CC;
  return sm;
}

// One diagonal (plain mode) or step (chained mode) d over columns lo..hi:
// the class products chunk by chunk, then the rescale. Every thread calls
// it; it ends synchronised.
template <class Cells>
__device__ void lr_step(const LrArgs& a, const Cells& cells, int d, int lo,
                        int hi, float* pb, float* mb, const Smem& sm) {
  const int tid = threadIdx.x;
  const int W = a.Li + 1;
  const int Sa = a.Sa, SaP = a.SaP, CC = a.CC, To = a.To;
  const Plan& plan = a.plan;
  const int slot0 = d % 3, slot1 = (d + 2) % 3, slot2 = (d + 1) % 3;
  float* p0 = pb + (size_t)slot0 * W * SaP;
  const float* p1 = pb + (size_t)slot1 * W * SaP;
  const float* p2 = pb + (size_t)slot2 * W * SaP;
  float* m0 = mb + slot0 * W;
  const float* m1 = mb + slot1 * W;
  const float* m2 = mb + slot2 * W;
  const int n_dg = SaP / TD;

  for (int cs = lo; cs <= hi; cs += CC) {
    const int ncc = min(CC, hi - cs + 1);
    const int ncc8 = (ncc + TC - 1) / TC * TC;

    // phase A: per-cell neighbour scales, tokens and the new log scale
    for (int c = tid; c < ncc; c += THREADS) {
      const int i = cs + c;
      const CellInfo ci = cells.at(d, i);
      sm.state[c] = ci.state;
      if (ci.state != CELL_LIVE) {
        for (int q = 0; q < plan.n_cls; ++q) {
          sm.w[q * CC + c] = 0.f;
          sm.tok[q * CC + c] = 0;
        }
        m0[i] = ci.state == CELL_START ? 0.f : NEG_INF;
        continue;
      }
      const int o = ci.o;
      float mc[MAX_CLS];
      float mu = NEG_INF;
      for (int q = 0; q < plan.n_cls; ++q) {
        const ClassDesc& k = plan.cls[q];
        float mv = NEG_INF;
        int tok = 0;
        if (k.kind == KIND_UP) {
          if (o >= 1) { mv = m1[i]; tok = ci.yt[o - 1]; }
        } else if (k.kind == KIND_LEFT) {
          if (i >= 1) { mv = m1[i - 1]; tok = ci.xt[i - 1]; }
        } else {
          if (i >= 1 && o >= 1) {
            mv = m2[i - 1];
            tok = ci.xt[i - 1] * To + ci.yt[o - 1];
          }
        }
        if (tok < 0 || tok >= k.n_tok) { *ci.bad = 1; tok = 0; }
        mc[q] = mv;
        sm.tok[q * CC + c] = tok;
        mu = fmaxf(mu, mv);
      }
      const float mu_safe = mu > NEG_INF / 2 ? mu : 0.f;
      for (int q = 0; q < plan.n_cls; ++q)
        sm.w[q * CC + c] = mc[q] > NEG_INF / 2 ? expf(mc[q] - mu_safe) : 0.f;
      m0[i] = mu;
    }
    __syncthreads();

    // phase B: class operands Z[k][c] in shared memory
    const int total = a.k_total * ncc8;
    for (int idx = tid; idx < total; idx += THREADS) {
      const int kr = idx / ncc8, c = idx - kr * ncc8;
      float z = 0.f;
      if (c < ncc) {
        int q = 0;
        while (q + 1 < plan.n_cls && kr >= plan.cls[q + 1].z_off) ++q;
        const ClassDesc& k = plan.cls[q];
        const float w = sm.w[q * CC + c];
        if (w != 0.f) {
          const int i = cs + c;
          const int kk = kr - k.z_off;
          const int s = k.side == SIDE_SRC ? kk % Sa : kk;
          const float* src = k.kind == KIND_UP ? p1 + (size_t)i * SaP
              : k.kind == KIND_LEFT ? p1 + (size_t)(i - 1) * SaP
              : p2 + (size_t)(i - 1) * SaP;
          z = src[s] * w;
          if (k.side == SIDE_SRC)
            z *= __ldg(a.emat + k.e_off + (size_t)kk * k.n_tok
                       + sm.tok[q * CC + c]);
        }
      }
      sm.Z[(size_t)kr * CC + c] = z;
    }
    __syncthreads();

    // phase C: per-thread 8-cell x 4-state tiles over k
    const int n_items = (ncc8 / TC) * n_dg;
    for (int item = tid; item < n_items; item += THREADS) {
      const int cg = item / n_dg, dg = item - cg * n_dg;
      float acc[TC][TD];
#pragma unroll
      for (int c = 0; c < TC; ++c)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[c][j] = 0.f;

      for (int q = 0; q < plan.n_cls; ++q) {
        const ClassDesc& k = plan.cls[q];
        const float* zc = sm.Z + (size_t)k.z_off * CC + cg * TC;
        const int n_r = k.side == SIDE_SRC ? 1 : k.rank;
        for (int r = 0; r < n_r; ++r) {
          const float* mcol = a.mt + k.mt_off + r * SaP + dg * TD;
          float t[TC][TD];
#pragma unroll
          for (int c = 0; c < TC; ++c)
#pragma unroll
            for (int j = 0; j < TD; ++j) t[c][j] = 0.f;
#pragma unroll 4
          for (int kk = 0; kk < k.K; ++kk) {
            const float4 mv = __ldg(
                reinterpret_cast<const float4*>(mcol + (size_t)kk * k.N));
            const float4 za =
                *reinterpret_cast<const float4*>(zc + (size_t)kk * CC);
            const float4 zb =
                *reinterpret_cast<const float4*>(zc + (size_t)kk * CC + 4);
            const float zv[TC] = {za.x, za.y, za.z, za.w,
                                  zb.x, zb.y, zb.z, zb.w};
            const float mvv[TD] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
            for (int c = 0; c < TC; ++c)
#pragma unroll
              for (int j = 0; j < TD; ++j)
                t[c][j] = fmaf(zv[c], mvv[j], t[c][j]);
          }
          if (k.side == SIDE_SRC) {
#pragma unroll
            for (int c = 0; c < TC; ++c)
#pragma unroll
              for (int j = 0; j < TD; ++j) acc[c][j] += t[c][j];
          } else {
#pragma unroll
            for (int c = 0; c < TC; ++c) {
              const int cc = cg * TC + c;
              if (cc >= ncc) continue;
              const int tok = sm.tok[q * CC + cc];
#pragma unroll
              for (int j = 0; j < TD; ++j) {
                const int dst = dg * TD + j;
                if (dst < Sa)
                  acc[c][j] += t[c][j] *
                      __ldg(a.emat + k.e_off
                            + (size_t)(r * Sa + dst) * k.n_tok + tok);
              }
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int cc = cg * TC + c;
        if (cc >= ncc) continue;
        float4 v = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
        if (sm.state[cc] == CELL_START)       // a chain starts: c0, m = 0
          v = *reinterpret_cast<const float4*>(a.c0 + dg * TD);
        *reinterpret_cast<float4*>(p0 + (size_t)(cs + cc) * SaP + dg * TD) =
            v;
      }
    }
    __syncthreads();
  }

  // phase D: rescale on two consecutive diagonals of every rescale_every
  if (d % a.rescale_every <= 1) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int i = lo + warp; i <= hi; i += THREADS / 32) {
      if (cells.at(d, i).state == CELL_DEAD) continue;
      float* pc = p0 + (size_t)i * SaP;
      float mx = -3.4e38f;
      for (int s = lane; s < Sa; s += 32) mx = fmaxf(mx, pc[s]);
      mx = warp_max(mx);
      const bool has = mx > 0.f;
      const float den = fmaxf(mx, 1e-37f);
      for (int s = lane; s < Sa; s += 32) pc[s] = has ? pc[s] / den : 0.f;
      if (lane == 0) m0[i] = has ? m0[i] + logf(den) : NEG_INF;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 2)
lowrank_wavefront_kernel(LrArgs a, const int* __restrict__ in_lens,
                         const int* __restrict__ out_lens) {
  extern __shared__ float4 smem4[];
  const Smem sm = smem_layout(smem4, a.CC, a.k_total);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = a.Li + 1;
  const int SaP = a.SaP;
  const int il = in_lens[b];
  const int ol = out_lens[b];
  if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) {
    if (tid == 0) a.out[b] = __int_as_float(0x7fc00000);   // NaN: bad length
    return;
  }
  float* pb = a.pbuf + (size_t)b * 3 * W * SaP;
  float* mb = a.mbuf + (size_t)b * 3 * W;
  if (tid == 0) *sm.bad = 0;

  // d = 0: only cell (0, 0), p = c0 (closure row 0), m = 0
  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  if (tid == 0) mb[0] = 0.f;
  __syncthreads();
  const int dfin = il + ol;
  const PairCells cells{a.in_toks + (size_t)b * a.Li,
                        a.out_toks + (size_t)b * a.Lo, sm.bad};
  for (int d = 1; d <= dfin; ++d)
    lr_step(a, cells, d, max(0, d - ol), min(d, il), pb, mb, sm);

  if (tid == 0) {
    const int slot = dfin % 3;
    const float e = pb[((size_t)slot * W + il) * SaP + a.Sa - 1];
    const float m = mb[slot * W + il];
    float v = e > 0.f ? m + logf(fmaxf(e, 1e-37f)) : NEG_INF;
    if (*sm.bad) v = __int_as_float(0x7fc00000);           // NaN: bad token
    a.out[b] = v;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
lowrank_chained_kernel(LrArgs a, strip::Strip st, int* bad) {
  extern __shared__ float4 smem4[];
  const Smem sm = smem_layout(smem4, a.CC, a.k_total);

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = a.Li + 1;
  const int SaP = a.SaP;
  float* pb = a.pbuf + (size_t)w * 3 * W * SaP;
  float* mb = a.mbuf + (size_t)w * 3 * W;

  // t = 0: chain 0's cell (0, 0), p = c0, m = 0
  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  if (tid == 0) mb[0] = 0.f;
  __syncthreads();
  const StripCells cells{st, a.in_toks, a.out_toks, bad, w};
  const int n_steps = strip::steps(st);
  for (int t = 1; t < n_steps; ++t) {
    lr_step(a, cells, t, strip::col_lo(st, t), strip::col_hi(st, t), pb, mb,
            sm);
    const int k = strip::readout_chain(st, t);
    if (k >= 0 && tid == 0) {
      const int n = strip::pair(st, k, w);
      const int slot = t % 3;
      const float e = pb[((size_t)slot * W + a.Li) * SaP + a.Sa - 1];
      const float m = mb[slot * W + a.Li];
      float v = e > 0.f ? m + logf(fmaxf(e, 1e-37f)) : NEG_INF;
      if (bad[n]) v = __int_as_float(0x7fc00000);          // NaN: bad token
      a.out[n] = v;
    }
  }
}

bool make_lr_args(LrArgs& a, const void* in_toks, const void* out_toks,
                  const void* c0, const void* mt, const void* emat,
                  void* pbuf, void* mbuf, void* out, int Li, int Lo, int Sa,
                  int SaP, int To, int rescale_every, int n_cls,
                  const int* desc, int chunk_cells, int k_total) {
  if (n_cls < 0 || n_cls > MAX_CLS || rescale_every < 1 || chunk_cells < TC ||
      chunk_cells % TC != 0)
    return false;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.c0 = (const float*)c0;
  a.mt = (const float*)mt;
  a.emat = (const float*)emat;
  a.pbuf = (float*)pbuf;
  a.mbuf = (float*)mbuf;
  a.out = (float*)out;
  a.Li = Li; a.Lo = Lo; a.Sa = Sa; a.SaP = SaP; a.To = To;
  a.rescale_every = rescale_every;
  a.plan.n_cls = n_cls;
  for (int q = 0; q < n_cls; ++q) {
    const int* v = desc + q * DESC_LEN;
    a.plan.cls[q] = ClassDesc{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7],
                              v[8]};
  }
  a.CC = chunk_cells;
  a.k_total = k_total;
  return true;
}

}  // namespace

extern "C" int lowrank_wavefront_smem_bytes(int chunk_cells, int k_total) {
  return (int)(((size_t)k_total * chunk_cells + 2 * MAX_CLS * chunk_cells
                + chunk_cells + 4) * sizeof(float));
}

// Launches the plain-mode kernel on `stream` (one block per pair) and
// returns cudaGetLastError(): nonzero means the launch was refused.
extern "C" int lowrank_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* mt, const void* emat,
    void* pbuf, void* mbuf, void* out, int B, int Li, int Lo, int Sa, int SaP,
    int To, int rescale_every, int n_cls, const int* desc, int chunk_cells,
    int k_total, void* stream) {
  LrArgs a;
  if (!make_lr_args(a, in_toks, out_toks, c0, mt, emat, pbuf, mbuf, out, Li,
                    Lo, Sa, SaP, To, rescale_every, n_cls, desc, chunk_cells,
                    k_total))
    return (int)cudaErrorInvalidValue;
  const int smem = lowrank_wavefront_smem_bytes(chunk_cells, k_total);
  cudaError_t err = cudaFuncSetAttribute(
      lowrank_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  lowrank_wavefront_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      a, (const int*)in_lens, (const int*)out_lens);
  return (int)cudaGetLastError();
}

// Launches the chained-mode kernel on `stream` (one block per strip of
// n_chain uniform-length pairs) and returns cudaGetLastError(). `bad` holds
// B ints that the caller has set to 0.
extern "C" int lowrank_chained_launch(
    const void* in_toks, const void* out_toks, const void* c0, const void* mt,
    const void* emat, void* pbuf, void* mbuf, void* out, void* bad, int B,
    int Li, int Lo, int Sa, int SaP, int To, int rescale_every, int n_cls,
    const int* desc, int chunk_cells, int k_total, int n_chain,
    void* stream) {
  LrArgs a;
  strip::Strip st;
  if (!strip::make_strip(st, B, Li, Lo, n_chain) ||
      !make_lr_args(a, in_toks, out_toks, c0, mt, emat, pbuf, mbuf, out, Li,
                    Lo, Sa, SaP, To, rescale_every, n_cls, desc, chunk_cells,
                    k_total))
    return (int)cudaErrorInvalidValue;
  const int smem = lowrank_wavefront_smem_bytes(chunk_cells, k_total);
  cudaError_t err = cudaFuncSetAttribute(
      lowrank_chained_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  lowrank_chained_kernel<<<st.n_strips, THREADS, smem,
                           (cudaStream_t)stream>>>(a, st, (int*)bad);
  return (int)cudaGetLastError();
}
