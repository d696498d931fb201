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
// and readout. prot2dna's ranks are 1 (left), 4 (up) and 0 (diag: absent).
//
// Design: the merged kernel's walk (one block walks whole pairs, three
// rotating (W, SaP) slots per block; wavefront_common.cuh) with two product
// phases per diagonal. Phase 1: a thread owns 4 destination states of one
// cell; for each class it reads the neighbour's p once per group of 4 ranks
// (once for all of them at prot2dna's ranks) and accumulates the R shared
// products T_r^T p side by side, then scales each by its E column of the
// cell's token: the token's full block is never built (that would be the
// merged kernel). pre goes to a fourth (W, SaP) slot. Phase 2 takes C^T pre.
// T is stored [s][r][SaP] and E [tok][r][SaP], so one float4 load serves 4
// destination states. TPU tricks dropped: the one-hot token matrices (a
// thread reads its token's E row), the bf16 hi/lo passes, the (R*S, chunk)
// stacked products.
//
// What bounds it on this card: f32 FMAs, sum_c (R_c*Sa*Sa + R_c*Sa) + Sa*Sa
// per cell, against the f32 non-tensor rate; T, E and C^T are read through
// L1/L2.

#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

constexpr int RB = 4;        // ranks accumulated side by side

struct FacClass {
  int kind;    // KIND_*
  int n_tok;
  int rank;
  int t_off;   // float offset of this class's [SaP][rank][SaP] factors T
  int e_off;   // float offset of its [n_tok][rank][SaP] token scales E
};
constexpr int FDESC_LEN = 5;

struct FacPlan {
  FacClass cls[MAX_CLS];
  int n_cls;
};

struct FacArgs {
  Args a;                    // tokens, lengths, c0, w, slots, out, shapes
  FacPlan plan;
  const float* tk;
  const float* ek;
  const float* ct;           // C^T source-major, (SaP, SaP)
  float* ubuf;               // blocks * W * SaP
};

// pre for 4 destination states of cell (i, o); mu as cell_update's
__device__ __forceinline__ float4 factored_terms(const FacArgs& f, int i,
                                                 int o, const int* xt,
                                                 const int* yt, int dg,
                                                 const float* p1,
                                                 const float* p2,
                                                 const float* m1,
                                                 const float* m2, int* bad,
                                                 float& mu) {
  const int SaP = f.a.SaP;
  float mc[MAX_CLS];
  const float* src[MAX_CLS];
  int toks[MAX_CLS];
  mu = NEG_INF;
  for (int q = 0; q < f.plan.n_cls; ++q) {
    const FacClass& k = f.plan.cls[q];
    float mv = NEG_INF;
    int tok = 0;
    bool in_lattice = false;
    const float* sp = p1;
    if (k.kind == KIND_UP) {
      if (o >= 1) {
        in_lattice = true;
        mv = m1[i]; tok = __ldg(yt + o - 1);
        sp = p1 + (size_t)i * SaP;
      }
    } else if (k.kind == KIND_LEFT) {
      if (i >= 1) {
        in_lattice = true;
        mv = m1[i - 1]; tok = __ldg(xt + i - 1);
        sp = p1 + (size_t)(i - 1) * SaP;
      }
    } else {
      if (i >= 1 && o >= 1) {
        in_lattice = true;
        mv = m2[i - 1];
        tok = __ldg(xt + i - 1) * f.a.To + __ldg(yt + o - 1);
        sp = p2 + (size_t)(i - 1) * SaP;
      }
    }
    if (in_lattice && (tok < 0 || tok >= k.n_tok)) {
      *bad = 1;
      tok = 0;
      mv = NEG_INF;
    }
    mc[q] = mv;
    src[q] = sp;
    toks[q] = tok;
    mu = fmaxf(mu, mv);
  }
  const float mu_safe = mu > NEG_INF / 2 ? mu : 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = 0; q < f.plan.n_cls; ++q) {
    if (!(mc[q] > NEG_INF / 2)) continue;
    const FacClass& k = f.plan.cls[q];
    const float w = expf(mc[q] - mu_safe);
    const float* sp = src[q];
    const size_t row = (size_t)k.rank * SaP;      // floats per source state
    for (int r0 = 0; r0 < k.rank; r0 += RB) {
      const int nr = min(RB, k.rank - r0);
      float4 t[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) t[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* tp = f.tk + k.t_off + (size_t)r0 * SaP + dg * TD;
      for (int s = 0; s < SaP; s += 4) {
        const float4 pv = *reinterpret_cast<const float4*>(sp + s);
        const float ps[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* tr = tp + (size_t)(s + j) * row;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < nr) {
              const float4 m = __ldg(
                  reinterpret_cast<const float4*>(tr + (size_t)r * SaP));
              t[r].x = fmaf(ps[j], m.x, t[r].x);
              t[r].y = fmaf(ps[j], m.y, t[r].y);
              t[r].z = fmaf(ps[j], m.z, t[r].z);
              t[r].w = fmaf(ps[j], m.w, t[r].w);
            }
          }
        }
      }
      const float* ep = f.ek + k.e_off + ((size_t)toks[q] * k.rank + r0) * SaP
          + dg * TD;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          const float4 e = __ldg(
              reinterpret_cast<const float4*>(ep + (size_t)r * SaP));
          acc.x = fmaf(w, t[r].x * e.x, acc.x);
          acc.y = fmaf(w, t[r].y * e.y, acc.y);
          acc.z = fmaf(w, t[r].z * e.z, acc.z);
          acc.w = fmaf(w, t[r].w * e.w, acc.w);
        }
      }
    }
  }
  return acc;
}

__device__ float walk_factored(const FacArgs& f, int b, int* s_bad) {
  const Args& a = f.a;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.Li + 1;
  const int Sa = a.Sa, SaP = a.SaP;
  const int il = a.in_lens[b];
  const int ol = a.out_lens[b];
  __syncthreads();           // the previous pair's readout is done
  if (il < 0 || il > a.Li || ol < 0 || ol > a.Lo) return quiet_nan();
  const int* xt = a.in_toks + (size_t)b * a.Li;
  const int* yt = a.out_toks + (size_t)b * a.Lo;
  float* pb = a.pbuf + (size_t)blockIdx.x * 3 * W * SaP;
  float* mb = a.mbuf + (size_t)blockIdx.x * 3 * W;
  float* ub = f.ubuf + (size_t)blockIdx.x * W * SaP;
  if (tid == 0) *s_bad = 0;

  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  if (tid == 0) mb[0] = 0.f;
  __syncthreads();

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
    const int n_items = (hi - lo + 1) * n_dg;

    for (int item = tid; item < n_items; item += THREADS) {
      const int c = item / n_dg, dg = item - c * n_dg;
      const int i = lo + c;
      float mu;
      const float4 pre = factored_terms(f, i, d - i, xt, yt, dg, p1, p2, m1,
                                        m2, s_bad, mu);
      *reinterpret_cast<float4*>(ub + (size_t)i * SaP + dg * TD) = pre;
      if (dg == 0) m0[i] = mu;
    }
    __syncthreads();

    for (int item = tid; item < n_items; item += THREADS) {
      const int c = item / n_dg, dg = item - c * n_dg;
      const int i = lo + c;
      *reinterpret_cast<float4*>(p0 + (size_t)i * SaP + dg * TD) =
          block_dot(ub + (size_t)i * SaP, f.ct + dg * TD, SaP);
    }
    __syncthreads();

    if (d % a.rescale_every <= 1) {
      for (int i = lo + warp; i <= hi; i += THREADS / 32)
        rescale_cell(p0 + (size_t)i * SaP, m0 + i, Sa, lane);
      __syncthreads();
    }
  }

  float v = NEG_INF;
  if (tid < 32) {
    const int slot = dfin % 3;
    v = readout_warp(pb + ((size_t)slot * W + il) * SaP, mb[slot * W + il],
                     a.wvec, Sa, a.sink, tid);
    if (*s_bad) v = quiet_nan();                           // bad token
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
factored_wavefront_kernel(FacArgs f) {
  __shared__ int s_bad;
  for (int b = blockIdx.x; b < f.a.B; b += gridDim.x) {
    const float v = walk_factored(f, b, &s_bad);
    if (threadIdx.x == 0) f.a.out[b] = v;
  }
}

}  // namespace

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(). desc: FDESC_LEN ints per class (kind, n_tok, rank,
// t_off, e_off); `ubuf` holds grid * (Li + 1) * SaP floats.
extern "C" int factored_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* wvec, const void* tk,
    const void* ek, const void* ct, void* pbuf, void* mbuf, void* ubuf,
    void* out, int B, int Li, int Lo, int Sa, int SaP, int To,
    int rescale_every, int sink, int n_cls, const int* desc, int grid,
    void* stream) {
  FacArgs f;
  if (grid < 1 ||
      !make_args(f.a, in_toks, out_toks, in_lens, out_lens, c0, wvec,
                 nullptr, pbuf, mbuf, out, B, Li, Lo, Sa, SaP, To,
                 rescale_every, sink, 0, nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_cls < 0 || n_cls > MAX_CLS) return (int)cudaErrorInvalidValue;
  f.plan.n_cls = n_cls;
  for (int q = 0; q < n_cls; ++q) {
    const int* v = desc + q * FDESC_LEN;
    if (v[2] < 1) return (int)cudaErrorInvalidValue;
    f.plan.cls[q] = FacClass{v[0], v[1], v[2], v[3], v[4]};
  }
  f.tk = (const float*)tk;
  f.ek = (const float*)ek;
  f.ct = (const float*)ct;
  f.ubuf = (float*)ubuf;
  if (B == 0) return 0;
  factored_wavefront_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(f);
  return (int)cudaGetLastError();
}
