// Batched 1D Forward scan for generator / recognizer machines, for Hopper
// (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/scan1d_kernel.py::_scan1d_kernel.
// What it computes, per sequence b, over its tokens tok[0..len):
//   p <- p @ EM[tok]        EM[t] = exp(trans[t] - g), one global shift g,
//                           p starts as the closure's row 0;
// a position with tok < 0 is skipped and a token outside the alphabet zeroes
// p. On every renorm_every-th position ((d+1) % renorm_every == 0) p is
// multiplied by the exact power of two 2^-(e) of its max's binary exponent e,
// and e is added to an integer exponent: the loop carries no log and no
// division, so the scaling commutes exactly with the recurrence (a log per
// step biases the result by a few 1e-6 nats per step, which adds up over
// 10,000 steps). A sequence whose max is not positive at a renormalisation
// is flagged dead. Out: the mantissa p[S-1], the exponent sum and the dead
// flag; the caller takes log(mantissa) + exponent*ln2 + len*g in float64.
//
// What the TPU kernel did that this one does not: it multiplied p by the
// stacked blocks of ALL tokens and selected one with a one-hot mask, n_tok
// times the work, to fill the matrix unit; several positions were unrolled
// per grid step to amortise the grid's step cost; sequences sat on lanes, so
// the tokens were transposed to (L, B). Here a sequence reads the block of
// its own token, and tokens stay (B, L).
//
// What bounds it on this card: the L steps of one sequence depend on each
// other, so the run time is L times one step's latency unless a step's work
// fills the multiprocessor; the multiply-adds a step needs are the nonzero
// entries of EM[tok] (a 64-state generator has 128 of 4,225), and the
// tokens (4 bytes a position) are the only bytes that grow with L. A step
// is one warp's chain of dependent instructions (about 500 SM cycles at
// dense1d), so the design cuts instructions and waits, not bytes.
//
// Design (the layout comes from ops/kernels/scan1d_kernel.py::
// scan1d_launch_plan):
//  * One sequence to one warp, or to the fewest warps the plan needs
//    (`lanes`), which wait on each other with a named barrier (bar.sync id,
//    lanes) and never on the block; several sequences share a block and one
//    copy of the plan in shared memory. p lives in shared memory private to
//    the sequence, double buffered, so a step costs one warp-level barrier.
//  * Exact zeros skipped (mode CSR): the host lists, per token, each
//    destination's nonzero sources in source order and cuts a long list
//    into segments of `terms` entries, one segment a lane; a destination's
//    segments sit on an aligned group of lanes of one warp and are summed
//    by xor shuffles. Rows of lanes: each lane takes `rows` segments a step.
//    Entries are (source, value) pairs. The rows of the source-free states
//    (End in a generator: no entry reads them) come last and are summed
//    only on the steps whose max or readout needs them. When the plan fits
//    one of three register blocks (CSR_PF24/36/48: 2 x 4, 3 x 6, 4 x 8
//    entries a lane) a step's entries are loaded one step ahead, two a
//    16-byte load, and a step has no branch but the loop's and the
//    renormalisation's. Mode DENSE: whole destination columns of the
//    (S, SP) matrix, one a lane (SP lanes a sequence), p read as float4
//    broadcasts (the plan picks it where the matrix has few zeros).
//  * The tokens are staged in shared memory by cp.async, chunks of CH two
//    ahead in a ring of four, so no step waits on a global load and the
//    step loop has no branch for them.
//  * The renormalisation inside the step: a one-warp sequence takes the max
//    with one integer reduction of the values' bits (non-negative floats
//    order as their bits do) and scales its values before storing them; a
//    sequence of several warps trades the warps' maxima through shared
//    memory across the step's own barrier and applies the exact scale in
//    the next step, to p as it is read (CSR) or to the column sums (DENSE):
//    a power of two, it rounds as it would have when stored.
//
// Variants (timed by chip_smoke.py, each undoing one choice): V_BLOCK_BARRIER
// (the whole block waits each step), V_TOKENS_GLOBAL (tokens read from
// global memory, one step ahead), V_RENORM_BARRIER (the max through shared
// memory, the scale written back behind a second barrier); mode DENSE on a
// sparse machine undoes the skipped zeros, mode CSR on a dense one the
// dense columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 128;        // tokens a staged chunk (a power of two)
constexpr int RMAX = 8;        // CSR: rows a lane
// CSR_PF*: the entries of a lane held in registers, rows x terms
template <int MODE> struct PfShape { static constexpr int R = 1, K = 1; };
constexpr int DMAX = 4;        // DENSE: destination columns a lane
constexpr int WMAX = 32;       // warps a sequence: slots of the max exchange
constexpr int NO_DEST = 0xFFFF;

enum { CSR = 0, DENSE = 2, CSR_PF24 = 3, CSR_PF36 = 4, CSR_PF48 = 5 };
template <> struct PfShape<CSR_PF24> { static constexpr int R = 2, K = 4; };
template <> struct PfShape<CSR_PF36> { static constexpr int R = 3, K = 6; };
template <> struct PfShape<CSR_PF48> { static constexpr int R = 4, K = 8; };
enum { V_NONE = 0, V_BLOCK_BARRIER = 1, V_TOKENS_GLOBAL = 2,
       V_RENORM_BARRIER = 3 };

struct Params {
  const void* plan;   // CSR: int2 [n_tok][rows][terms][lanes] (source, value
                      // bits); DENSE: float [n_tok][S][SP] source-major
  const int* meta;    // CSR: int [rows][lanes]: destination (low 16 bits,
                      // NO_DEST: none), log2 of the lane's group (bits
                      // 16-19)
  const float* c0;    // (SP,) start vector, zero padded
  const int* toks;    // (B, L)
  const int* lens;    // (B,)
  float* out;         // (3, B)
  int B, L, n_tok, S, SP, renorm_every;
  int lanes, rows, terms, groups;  // lanes a sequence; CSR rows and terms;
                                   // sequences a block
  int live_rows;      // CSR: rows [0, live_rows) hold the destinations that
                      // are some entry's source; the others (sinks, such as
                      // End) only matter for the max and the readout
  int lv_live, lv_sink;  // CSR: levels of the segment trees in those rows
  int plan_words;     // 4-byte words of the plan, a multiple of 4
};

// floats of shared memory a sequence takes: p twice, four token chunks,
// the warps' maxima twice
__host__ __device__ constexpr int group_floats(int SP) {
  return 2 * SP + 4 * CH + 2 * WMAX;
}

// The warp's max of non-negative floats: their bit patterns order as the
// values do, so one integer reduction gives the max exactly.
__device__ __forceinline__ float warp_max(float v) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The lanes of one sequence wait for each other: a warp, a named barrier
// for a group of warps, or (V_BLOCK_BARRIER) the whole block.
template <int VAR>
__device__ __forceinline__ void seq_sync(int id, int n) {
  if (VAR == V_BLOCK_BARRIER)
    __syncthreads();
  else if (n == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The exact power of two that brings max mx into [1, 2): its exponent goes
// to the sum, its inverse is the scale. A max that is not positive marks
// the sequence dead and scales by 1.
__device__ __forceinline__ float renorm_scale(float mx, int& expo,
                                              bool& dead) {
  const float msafe = mx > 0.f ? mx : 1.f;
  const int kexp = (__float_as_int(msafe) >> 23) & 0xFF;
  expo += kexp - 127;
  dead = dead || !(mx > 0.f);
  return __int_as_float((254 - kexp) << 23);
}

template <int MODE, bool SMEM_PLAN, int VAR>
__global__ void __launch_bounds__(MODE >= CSR_PF24 ? 256 : 512)
scan1d_kernel(const Params a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_steps;
  constexpr bool PF = MODE >= CSR_PF24;
  constexpr int PFR = PfShape<MODE>::R, PFK = PfShape<MODE>::K;
  constexpr int NV = MODE == DENSE ? DMAX : (PF ? PFR : RMAX);
  const int T = PF ? 32 : a.lanes;       // CSR_PF*: one warp
  const int NW = T >> 5;
  const int g = threadIdx.x / T, lt = threadIdx.x - g * T;
  const int lane = threadIdx.x & 31, wg = lt >> 5;
  const int bar = g + 1;                // named barrier 0 is the block's
  const int b = blockIdx.x * a.groups + g;
  const int S = a.S, SP = a.SP, n_tok = a.n_tok;

  // the plan, once a block
  const int plan_floats = SMEM_PLAN ? a.plan_words : 0;
  if (SMEM_PLAN) {
    const float4* src = reinterpret_cast<const float4*>(a.plan);
    for (int k = threadIdx.x; k < plan_floats / 4; k += blockDim.x)
      smem4[k] = src[k];
  }
  const int2* ents = reinterpret_cast<const int2*>(SMEM_PLAN ? smem : a.plan);
  const float* ems = SMEM_PLAN ? smem : reinterpret_cast<const float*>(a.plan);
  float* grp = smem + plan_floats + g * group_floats(SP);
  float* pin = grp;
  float* pout = grp + SP;
  int* tbuf = reinterpret_cast<int*>(grp + 2 * SP);
  float* wmax = grp + 2 * SP + 4 * CH;
  const int len = b < a.B ? min(max(a.lens[b], 0), a.L) : 0;
  const int* tk = a.toks + (size_t)(b < a.B ? b : 0) * a.L;
  for (int k = lt; k < SP; k += T) pin[k] = a.c0[k];
  if (VAR == V_BLOCK_BARRIER) {
    if (threadIdx.x == 0) s_steps = 0;
    __syncthreads();
    if (lt == 0) atomicMax(&s_steps, len);
  }
  __syncthreads();
  const int n_steps = VAR == V_BLOCK_BARRIER ? s_steps : len;

  // where the lane's values go: CSR a row's group (meta), DENSE a column
  int dest[NV], lg[NV];
#pragma unroll
  for (int r = 0; r < NV; ++r) {
    const int m = MODE == DENSE ? (lt + r * T < SP ? lt + r * T : NO_DEST)
                  : r < a.rows  ? a.meta[r * T + lt]
                                : NO_DEST;
    dest[r] = (m & 0xFFFF) == NO_DEST ? -1 : m & 0xFFFF;
    lg[r] = MODE == DENSE ? 0 : (m >> 16) & 15;
  }

  // tokens [c * CH, (c + 1) * CH) of this sequence into buffer c % 4
  auto stage = [&](int c) {
    const int base = c * CH;
    int* dst = tbuf + (c & 3) * CH;
    for (int j = lt; j < CH && base + j < len; j += T)
      cp_async4(dst + j, tk + base + j);
    cp_async_commit();
  };
  auto token = [&](int d) -> int {
    return VAR == V_TOKENS_GLOBAL ? __ldg(tk + d) : tbuf[d & (4 * CH - 1)];
  };
  if (VAR != V_TOKENS_GLOBAL) {
    stage(0);
    stage(1);
  }

  // CSR_PF*: the step's entries, PFR x PFK a lane, loaded one step ahead,
  // two a 16-byte load (a token outside the alphabet is clamped, and its
  // step zeroed)
  int2 ent[PF ? PFR * PFK : 2];
  auto load_entries = [&](int t) {
    const int4* e = reinterpret_cast<const int4*>(ents) +
                    min(max(t, 0), max(n_tok - 1, 0)) * (PFR * PFK * 16) +
                    lane;
#pragma unroll
    for (int i = 0; i < PFR * PFK / 2; ++i) {
      const int4 q = e[i * 32];
      ent[2 * i] = make_int2(q.x, q.y);
      ent[2 * i + 1] = make_int2(q.z, q.w);
    }
  };
  float pend = 1.f;        // a scale the next step applies as it reads p

  // a CSR row's segment: the lane's entries in source order
  auto csr_row = [&](int r, int t) -> float {
    const int K = a.terms;
    const int2* e = ents + (t * a.rows + r) * K * T + lt;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int2 q = SMEM_PLAN ? e[k * T] : __ldg(e + k * T);
      acc = fmaf(pin[q.x] * pend, __int_as_float(q.y), acc);
    }
    return acc;
  };
  // the columns' segments summed over the lanes of their groups, `levels`
  // xor levels, in the rows below live_rows (sink = false) or from it on;
  // a lane adds only inside its own group, and no branch but the levels'
  auto trees = [&](float* v, bool sink, int levels) {
    for (int o = 0; o < levels; ++o) {
#pragma unroll
      for (int r = 0; r < NV; ++r) {
        const float u = __shfl_xor_sync(0xffffffffu, v[r], 1 << o);
        const bool mine = (r >= a.live_rows) == sink && o < lg[r];
        v[r] += mine ? u : 0.f;
      }
    }
  };

  int expo = 0;
  bool dead = false;
  int rc = 0;              // (d + 1) % renorm_every
  int tok = -1;
  for (int base = 0; base < n_steps; base += CH) {
    if (VAR != V_TOKENS_GLOBAL) {
      // chunks c and c + 1 are in; the buffer of chunk c - 2 is free
      cp_async_wait_all();
      seq_sync<VAR>(bar, T);
      stage(base / CH + 2);
    }
    if (base == 0) {
      tok = len > 0 ? token(0) : -1;
      if (PF) load_entries(tok);
    }
    const int end = min(base + CH, n_steps);
    for (int d = base; d < end; ++d) {
      if (++rc == a.renorm_every) rc = 0;
      const int tok_n = d + 1 < len ? token(d + 1) : -1;
      const bool active = d < len && tok >= 0;
      const bool renorm = rc == 0;
      // the sink rows are needed for the max and, after the last step,
      // for the readout; no step reads them otherwise
      const bool sinks = renorm || tok_n < 0;
      // a token outside the alphabet reads token 0's entries, zeroed; a
      // skipped position computes and stores nothing
      const float z = tok < n_tok ? 1.f : 0.f;
      const int t = tok >= 0 && tok < n_tok ? tok : 0;
      float v[NV];
      if (PF) {
        // every entry of the register block at once (the padding reads
        // p[0] times 0), one chain a row
        float x[PFR * PFK];
#pragma unroll
        for (int i = 0; i < PFR * PFK; ++i) x[i] = pin[ent[i].x];
#pragma unroll
        for (int r = 0; r < PFR; ++r) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < PFK; ++k)
            acc = fmaf(x[r * PFK + k], __int_as_float(ent[r * PFK + k].y),
                       acc);
          v[r] = acc;
        }
      } else if (MODE == CSR) {
#pragma unroll
        for (int r = 0; r < NV; ++r)
          v[r] = r < a.live_rows || (sinks && r < a.rows) ? csr_row(r, t)
                                                          : 0.f;
      } else {
        // whole columns: destination lt + j * T, four partial sums each;
        // a lane past the last column reads the last one, unstored
        const float* col = ems + t * (S * SP);
        const int S4 = S & ~3;
        float acc[DMAX][4];
#pragma unroll
        for (int j = 0; j < DMAX; ++j) {
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
          if (j * T < SP) {
            const float* c = col + min(lt + j * T, SP - 1);
#pragma unroll 4
            for (int s = 0; s < S4; s += 4) {
              const float4 pv = *reinterpret_cast<const float4*>(pin + s);
              const float* cs = c + s * SP;
              float m0, m1, m2, m3;
              if (SMEM_PLAN) {
                m0 = cs[0]; m1 = cs[SP]; m2 = cs[2 * SP]; m3 = cs[3 * SP];
              } else {
                m0 = __ldg(cs); m1 = __ldg(cs + SP);
                m2 = __ldg(cs + 2 * SP); m3 = __ldg(cs + 3 * SP);
              }
              acc[j][0] = fmaf(pv.x, m0, acc[j][0]);
              acc[j][1] = fmaf(pv.y, m1, acc[j][1]);
              acc[j][2] = fmaf(pv.z, m2, acc[j][2]);
              acc[j][3] = fmaf(pv.w, m3, acc[j][3]);
            }
            for (int s = S4; s < S; ++s) {
              const float* cs = c + s * SP;
              acc[j][0] = fmaf(pin[s], SMEM_PLAN ? *cs : __ldg(cs),
                               acc[j][0]);
            }
          }
        }
        // a pending scale is an exact power of two: applied to the sums,
        // it gives the products of the scaled p
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          v[j] = ((acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3])) * pend;
      }
      if (MODE != DENSE) {
        if (a.lv_live > 0) trees(v, false, a.lv_live);
        if (sinks) trees(v, true, a.lv_sink);
      }
#pragma unroll
      for (int r = 0; r < NV; ++r) v[r] *= z;
      if (active) pend = 1.f;
      if (renorm && active) {
        float mx = 0.f;                   // the padding holds zeros
#pragma unroll
        for (int r = 0; r < NV; ++r)
          if (dest[r] >= 0) mx = fmaxf(mx, v[r]);
        mx = warp_max(mx);
        if (NW == 1 && VAR != V_RENORM_BARRIER) {
          const float inv = renorm_scale(mx, expo, dead);
#pragma unroll
          for (int r = 0; r < NV; ++r) v[r] *= inv;
        } else if (lane == 0) {
          wmax[(d & 1) * WMAX + wg] = mx;
        }
      }
#pragma unroll
      for (int r = 0; r < NV; ++r)
        if (active && dest[r] >= 0 &&
            (MODE == DENSE || r < a.live_rows || sinks))
          pout[dest[r]] = v[r];
      if (PF) load_entries(tok_n);
      seq_sync<VAR>(bar, T);
      if (renorm && active && (NW > 1 || VAR == V_RENORM_BARRIER)) {
        float mx = wmax[(d & 1) * WMAX];
        for (int w = 1; w < NW; ++w)
          mx = fmaxf(mx, wmax[(d & 1) * WMAX + w]);
        const float inv = renorm_scale(mx, expo, dead);
        if (VAR == V_RENORM_BARRIER) {
#pragma unroll
          for (int r = 0; r < NV; ++r)
            if (dest[r] >= 0) pout[dest[r]] = v[r] * inv;
        } else {
          pend = inv;
        }
      }
      if (VAR == V_RENORM_BARRIER && renorm && active) seq_sync<VAR>(bar, T);
      float* const q = active ? pout : pin;
      pout = active ? pin : pout;
      pin = q;
      tok = tok_n;
    }
  }
  cp_async_wait_all();
  if (b < a.B && lt == 0) {
    a.out[b] = pin[S - 1] * pend;
    a.out[a.B + b] = (float)expo;
    a.out[2 * a.B + b] = dead ? 1.f : 0.f;
  }
}

int smem_bytes(int SP, int groups, int plan_words, int smem_plan) {
  return (int)(((size_t)(smem_plan ? plan_words : 0) +
                (size_t)groups * group_floats(SP)) *
               sizeof(float));
}

template <int MODE, bool SMEM_PLAN, int VAR>
int launch(const Params& a, int grid, int smem, cudaStream_t stream) {
  auto kern = scan1d_kernel<MODE, SMEM_PLAN, VAR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, a.lanes * a.groups, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared bytes a block of `groups` sequences takes (chip_smoke checks the
// host plan's count against it).
extern "C" int scan1d_smem_bytes(int SP, int groups, int plan_words,
                                 int smem_plan) {
  return smem_bytes(SP, groups, plan_words, smem_plan);
}

// Launches the kernel on `stream`: ceil(B / groups) blocks of groups *
// lanes threads, one sequence to `lanes` lanes. mode: 0 CSR, 2 dense
// columns, 3-5 CSR with the entries in registers (2 x 4, 3 x 6, 4 x 8 of
// them, rows x terms); smem_plan: the plan copied to shared
// memory; variant: 0 none, 1 a block barrier a step, 2 tokens from global
// memory, 3 the renormalisation behind its own barrier (variants need the
// plan in shared memory). Returns cudaGetLastError(): nonzero means the
// launch was refused.
extern "C" int scan1d_launch(const void* plan, const void* meta,
                             const void* c0, const void* toks,
                             const void* lens, void* out, int B, int L,
                             int n_tok, int S, int SP, int renorm_every,
                             int lanes, int rows, int terms, int groups,
                             int live_rows, int lv_live, int lv_sink,
                             int plan_words, int mode, int smem_plan,
                             int variant, void* stream) {
  const int threads = lanes * groups;
  const bool shape_ok =
      S >= 1 && SP % 32 == 0 && SP >= S && S <= NO_DEST &&
      renorm_every >= 1 && lanes >= 32 && lanes % 32 == 0 &&
      lanes <= 512 && groups >= 1 && threads <= 512 &&
      (lanes == 32 || groups <= 15) && plan_words % 4 == 0 &&
      variant >= 0 && variant <= 3 && (variant == 0 || smem_plan) &&
      (mode == DENSE ? (SP + lanes - 1) / lanes <= DMAX
       : mode >= CSR_PF24 && mode <= CSR_PF48
           ? rows >= 1 && rows <= (mode == CSR_PF24 ? 2 : mode - 1) &&
                 terms >= 1 &&
                 terms <= (mode == CSR_PF24 ? 4 : mode == CSR_PF36 ? 6 : 8) &&
                 lanes == 32 &&
                 smem_plan && threads <= 256
       : mode == CSR ? rows >= 1 && rows <= RMAX && terms >= 1
                     : false) &&
      live_rows >= 0 && live_rows <= rows && lv_live >= 0 && lv_live <= 5 &&
      lv_sink >= 0 && lv_sink <= 5;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params a{plan, (const int*)meta, (const float*)c0, (const int*)toks,
           (const int*)lens, (float*)out, B, L, n_tok, S, SP, renorm_every,
           lanes, rows, terms, groups, live_rows, lv_live, lv_sink,
           plan_words};
  const int grid = (B + groups - 1) / groups;
  const int smem = smem_bytes(SP, groups, plan_words, smem_plan);
  cudaStream_t st = (cudaStream_t)stream;
#define SCAN1D_VARIANTS(M)                                         \
  switch (variant) {                                               \
    case 0: return launch<M, true, V_NONE>(a, grid, smem, st);     \
    case 1: return launch<M, true, V_BLOCK_BARRIER>(a, grid, smem, st); \
    case 2: return launch<M, true, V_TOKENS_GLOBAL>(a, grid, smem, st); \
    default: return launch<M, true, V_RENORM_BARRIER>(a, grid, smem, st); \
  }
  if (mode == CSR_PF24) { SCAN1D_VARIANTS(CSR_PF24) }
  if (mode == CSR_PF36) { SCAN1D_VARIANTS(CSR_PF36) }
  if (mode == CSR_PF48) { SCAN1D_VARIANTS(CSR_PF48) }
  if (mode == CSR) {
    if (!smem_plan) return launch<CSR, false, V_NONE>(a, grid, smem, st);
    SCAN1D_VARIANTS(CSR)
  }
  if (!smem_plan) return launch<DENSE, false, V_NONE>(a, grid, smem, st);
  SCAN1D_VARIANTS(DENSE)
#undef SCAN1D_VARIANTS
}
