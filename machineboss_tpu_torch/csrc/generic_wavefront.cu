// Generic (unmerged) wavefront Forward for full-rank transducers, for Hopper
// (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/wavefront_kernel.py::_wavefront_kernel,
// the factory's default (merged=False, no variant). The host prep is
// prepare_generic (ops/kernels/wavefront_kernel.py): the class tensors as
// they are, NOT closure-folded, and the closure's transpose C^T; no sink
// trim (all S states, readout at S-1). Per cell (i, o) of a pair, diagonal
// d = i + o:
//   * mu = max of the log scales of ALL THREE neighbours in the lattice
//     (up (i, o-1), left (i-1, o), diag (i-1, o-1)), whichever classes the
//     machine has;
//   * u = sum over classes of exp(m_c - mu) * (A_c[tok]^T p_c);
//   * cur = C^T u, the closure as its own product per cell;
//   * EVERY diagonal: cur is divided by its max over states and m = mu +
//     log(max); a cell whose max is not positive is zeroed (m = NEG_INF);
//   * readout at (il, ol): m + log(p[S-1]), NEG_INF where the cell's max was
//     not positive.
// The start cell (0, 0) holds C[0, :] with m = 0, unnormalised.
//
// A thread reads only its own cell's token block; the TPU kernel's products
// of every cell with every token's block, its one-hot selection and its
// 3-pass bf16 products are not carried over (plain f32 FMAs). A class whose
// tensor is all zero is left out of the products (it adds exact zeros) but
// its neighbour still enters mu. The TPU kernel miscompiled at L >= 200 on
// one runtime (dispatch.py); this one has no such limit.
//
// What bounds it on this card: f32 FMAs, S*S per present class per cell
// whose neighbour of that class is not zero, plus S*S for the closure of a
// cell that has such a class, against the f32 non-tensor rate. The token
// blocks are read through L1/L2, as in the merged kernel, whose walk this
// is (one block walks whole pairs, block g pairs g, g + gridDim.x, ...;
// three rotating (W, SP) diagonal slots per block in a global scratch,
// SP = round_up(S, 4)). On bench.py's dense machine only the diag class
// exists: a pair of 200 x 200 reaches 200 of its 40,400 cells, and the
// walk over the others is the cost.
//
// Design. The first version took three block barriers a diagonal: u went
// out to a global scratch slot, the closure read it back after a barrier,
// and the rescale was a pass of its own (a warp a cell, scalar loads) after
// another; C^T was read through L1/L2 by every item. Now a cell's closure
// and rescale stay inside the lanes that compute its class terms:
//  * a group of GL lanes owns a cell (GL = 32 or 16: one or two cells a
//    warp, the plan's `cells_per_warp`). Lane h computes the float4
//    destination chunks h, h + GL, ... of u; with GL = 16 a tail of at most
//    16 states past the last whole round of chunks is split into single
//    states, one a lane (S = 65: 16 chunks and 4 single states), so no lane
//    idles a whole round. A lane's chunks and tail state are summed in one
//    pass over the sources, their rows loaded together;
//  * the group trades u through its own SP floats of shared memory with
//    __syncwarp, takes C^T u for the same states, the cell's max over states
//    by shuffles, divides in registers (the plain version's cur / den with
//    its zero and NEG_INF rule) and writes p and m once;
//  * C^T is resident in shared memory, loaded once a block, when the plan
//    finds room for it with 4 blocks a SM (18.5 KB at S = 65); else it is
//    read through L1/L2 (CT_SMEM = false). The groups of one warp read the
//    same C^T addresses, so the shared loads broadcast;
//  * a cell none of whose classes reaches a neighbour with a log scale
//    above NEG_INF is zero: it takes neither product (the first version
//    took the closure of every cell, on u = 0) and stores only m = NEG_INF;
//    the readout of a cell with m = NEG_INF is NEG_INF without its row.
// One block barrier a diagonal remains, before d + 1 reads d. The sums keep
// the first version's order (each class source by source, the classes in
// order, the closure source by source), so the scores are the same. For
// timing, skip = 0 takes both products of the zero cells too.

#include "wavefront_common.cuh"

namespace {

using namespace wavefront;

constexpr int NWARP = THREADS / 32;
constexpr long SMEM_MAX_BYTES = 232448;  // a block's shared memory on sm_90

// Which destination states a lane of a group of GL lanes owns: the float4
// chunks dg = h, h + GL, ... below `lim`, and with GL = 16 the single state
// t0 + h when t0 + h < SP (the tail: the states past the last whole round of
// chunks, when they are no more than GL; else the chunks take them too).
struct Own {
  int lim, t0;
};

__host__ __device__ inline Own owned(int SP, int GL) {
  const int n_dg = SP / TD;
  if (GL == 32) return Own{n_dg, SP};
  const int n_full = n_dg / GL * GL;
  if ((n_dg - n_full) * TD <= GL) return Own{n_full, n_full * TD};
  return Own{n_dg, SP};
}

// The sums of one lane against rows of SP floats, source by source as
// block_dot sums them: t[k] = sum_s sp[s] * mp[s][dg_k .. dg_k + 3] for its
// chunks, ts = sum_s sp[s] * mp[s][st] for its tail state (NT = 1); mp
// through the read-only cache when LDG. One pass over the sources loads
// every chunk's and the tail's rows together.
template <bool LDG, int R, int NT>
__device__ __forceinline__ void lane_dots(const float* sp, const float* mp,
                                          int SP, int h, int GL, Own own,
                                          float4 (&t)[R], float& ts) {
#pragma unroll
  for (int k = 0; k < R; ++k) t[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  ts = 0.f;
  const int st = own.t0 + h;
#pragma unroll 2
  for (int s = 0; s < SP; s += 4) {
    const float4 pv = *reinterpret_cast<const float4*>(sp + s);
    const float* row = mp + (size_t)s * SP;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int dg = h + k * GL;
      if (dg < own.lim) {
        float4 r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4* rp = reinterpret_cast<const float4*>(
              row + (size_t)j * SP + dg * TD);
          r[j] = LDG ? __ldg(rp) : *rp;
        }
        float4& u = t[k];
        u.x = fmaf(pv.x, r[0].x, u.x); u.y = fmaf(pv.x, r[0].y, u.y);
        u.z = fmaf(pv.x, r[0].z, u.z); u.w = fmaf(pv.x, r[0].w, u.w);
        u.x = fmaf(pv.y, r[1].x, u.x); u.y = fmaf(pv.y, r[1].y, u.y);
        u.z = fmaf(pv.y, r[1].z, u.z); u.w = fmaf(pv.y, r[1].w, u.w);
        u.x = fmaf(pv.z, r[2].x, u.x); u.y = fmaf(pv.z, r[2].y, u.y);
        u.z = fmaf(pv.z, r[2].z, u.z); u.w = fmaf(pv.z, r[2].w, u.w);
        u.x = fmaf(pv.w, r[3].x, u.x); u.y = fmaf(pv.w, r[3].y, u.y);
        u.z = fmaf(pv.w, r[3].z, u.z); u.w = fmaf(pv.w, r[3].w, u.w);
      }
    }
    if (NT && st < SP) {
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* rp = row + (size_t)j * SP + st;
        r[j] = LDG ? __ldg(rp) : *rp;
      }
      ts = fmaf(pv.x, r[0], ts);
      ts = fmaf(pv.y, r[1], ts);
      ts = fmaf(pv.z, r[2], ts);
      ts = fmaf(pv.w, r[3], ts);
    }
  }
}

// A cell's class terms: per class, its weight exp(m_c - mu) (the class is
// not live when it does not reach the cell), its source row and its token's
// block; mu over all three neighbours in the lattice.
struct Terms {
  float w[MAX_CLS];
  const float* src[MAX_CLS];
  const float* blk[MAX_CLS];
  bool live[MAX_CLS];
  float mu;
};

__device__ __forceinline__ Terms cell_terms(const Args& a, int i, int o,
                                            const int* xt, const int* yt,
                                            int* bad, const float* p1,
                                            const float* p2, const float* m1,
                                            const float* m2) {
  const int SaP = a.SaP;
  Terms t;
  float mu = NEG_INF;
  if (o >= 1) mu = fmaxf(mu, m1[i]);
  if (i >= 1) mu = fmaxf(mu, m1[i - 1]);
  if (i >= 1 && o >= 1) mu = fmaxf(mu, m2[i - 1]);
  const float mu_safe = mu > NEG_INF / 2 ? mu : 0.f;
#pragma unroll
  for (int q = 0; q < MAX_CLS; ++q) {
    t.live[q] = false;
    t.w[q] = 0.f;
    t.src[q] = p1;
    t.blk[q] = a.mt;
    if (q >= a.plan.n_cls) continue;
    const ClassDesc k = a.plan.cls[q];
    float mv = NEG_INF;
    int tok = 0;
    bool in_lattice = false;
    const float* sp = p1;
    if (k.kind == KIND_UP) {
      if (o >= 1) {
        in_lattice = true;
        mv = m1[i];
        tok = __ldg(yt + o - 1);
        sp = p1 + (size_t)i * SaP;
      }
    } else if (k.kind == KIND_LEFT) {
      if (i >= 1) {
        in_lattice = true;
        mv = m1[i - 1];
        tok = __ldg(xt + i - 1);
        sp = p1 + (size_t)(i - 1) * SaP;
      }
    } else {
      if (i >= 1 && o >= 1) {
        in_lattice = true;
        mv = m2[i - 1];
        tok = __ldg(xt + i - 1) * a.To + __ldg(yt + o - 1);
        sp = p2 + (size_t)(i - 1) * SaP;
      }
    }
    if (in_lattice && (tok < 0 || tok >= k.n_tok)) {
      *bad = 1;
      continue;
    }
    if (!(mv > NEG_INF / 2)) continue;
    t.live[q] = true;
    t.w[q] = expf(mv - mu_safe);
    t.src[q] = sp;
    t.blk[q] = a.mt + k.mt_off + (size_t)tok * SaP * SaP;
  }
  t.mu = mu;
  return t;
}

__device__ __forceinline__ float max4(float m, float4 v, int s0, int Sa) {
  if (s0 < Sa) m = fmaxf(m, v.x);
  if (s0 + 1 < Sa) m = fmaxf(m, v.y);
  if (s0 + 2 < Sa) m = fmaxf(m, v.z);
  if (s0 + 3 < Sa) m = fmaxf(m, v.w);
  return m;
}

__device__ __forceinline__ float4 div4(float4 v, float den, bool has) {
  if (!has) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(v.x / den, v.y / den, v.z / den, v.w / den);
}

// One pair, the whole block: GL lanes a cell, R float4 chunks and NT tail
// states a lane, C^T in shared memory (CT_SMEM) or read through L1/L2.
// s_u holds SaP floats for each group.
template <int GL, int R, int NT, bool CT_SMEM>
__device__ float walk_generic(const Args& a, const float* ct, float* s_u,
                              int b, int* s_bad, bool skip) {
  constexpr int CPW = 32 / GL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = lane % GL, grp = lane / GL;
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
  float* su = s_u + (size_t)(warp * CPW + grp) * SaP;
  const Own own = owned(SaP, GL);
  const int st = own.t0 + h;
  if (tid == 0) *s_bad = 0;

  for (int s = tid; s < SaP; s += THREADS) pb[s] = a.c0[s];
  if (tid == 0) mb[0] = 0.f;
  __syncthreads();

  const int dfin = il + ol;
  for (int d = 1; d <= dfin; ++d) {
    const int slot0 = d % 3, slot1 = (d + 2) % 3, slot2 = (d + 1) % 3;
    float* p0 = pb + (size_t)slot0 * W * SaP;
    const float* p1 = pb + (size_t)slot1 * W * SaP;
    const float* p2 = pb + (size_t)slot2 * W * SaP;
    float* m0 = mb + slot0 * W;
    const float* m1 = mb + slot1 * W;
    const float* m2 = mb + slot2 * W;
    const int lo = max(0, d - ol), hi = min(d, il);

    // every lane of a warp runs the same number of rounds
    for (int base = lo + warp * CPW; base <= hi; base += NWARP * CPW) {
      const int i = base + grp;
      const bool active = i <= hi;
      float4 cv[R];
      float tv = 0.f;
      float mu = NEG_INF;
      Terms t;
      // a cell with no live class is zero: with `skip` it takes neither
      // product and stores only m = NEG_INF (its row is never read)
      bool busy = false;
      if (active) {
        t = cell_terms(a, i, d - i, xt, yt, s_bad, p1, p2, m1, m2);
        mu = t.mu;
        busy = !skip || t.live[0] || t.live[1] || t.live[2];
      }
      if (busy) {
        // u: the classes in order, each weighted after its own sum
#pragma unroll
        for (int k = 0; k < R; ++k) cv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < MAX_CLS; ++q) {
          if (!t.live[q]) continue;
          float4 v[R];
          float vs;
          lane_dots<true, R, NT>(t.src[q], t.blk[q], SaP, h, GL, own, v, vs);
          const float w = t.w[q];
#pragma unroll
          for (int k = 0; k < R; ++k) {
            cv[k].x = fmaf(w, v[k].x, cv[k].x);
            cv[k].y = fmaf(w, v[k].y, cv[k].y);
            cv[k].z = fmaf(w, v[k].z, cv[k].z);
            cv[k].w = fmaf(w, v[k].w, cv[k].w);
          }
          tv = fmaf(w, vs, tv);
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int dg = h + k * GL;
          if (dg < own.lim)
            *reinterpret_cast<float4*>(su + dg * TD) = cv[k];
        }
        if (NT && st < SaP) su[st] = tv;
      }
      __syncwarp();

      // cur = C^T u for the same states, and the cell's max over states
      float mx = -3.4e38f;
      if (busy) {
        lane_dots<!CT_SMEM, R, NT>(su, ct, SaP, h, GL, own, cv, tv);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int dg = h + k * GL;
          if (dg < own.lim) mx = max4(mx, cv[k], dg * TD, Sa);
        }
        if (NT && st < Sa) mx = fmaxf(mx, tv);
      }
#pragma unroll
      for (int off = GL / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      __syncwarp();          // su is read: the next round may write it

      // the rescale, as the plain version's: cur / max, or zero
      const bool has = mx > 0.f;
      const float den = fmaxf(mx, 1e-37f);
      if (busy) {
        float* pc = p0 + (size_t)i * SaP;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int dg = h + k * GL;
          if (dg < own.lim)
            *reinterpret_cast<float4*>(pc + dg * TD) = div4(cv[k], den, has);
        }
        if (NT && st < SaP) pc[st] = has ? tv / den : 0.f;
      }
      if (active && h == 0) m0[i] = has ? mu + logf(den) : NEG_INF;
    }
    __syncthreads();         // d + 1 reads d
  }

  float v = NEG_INF;
  if (tid < 32) {
    const int slot = dfin % 3;
    const float m = mb[slot * W + il];   // a zero cell's row is not stored
    v = m > NEG_INF / 2 ? readout_warp(pb + ((size_t)slot * W + il) * SaP, m,
                                       a.wvec, Sa, 0, tid)
                        : NEG_INF;
    if (*s_bad) v = quiet_nan();                           // bad token
  }
  return v;
}

template <int GL, int R, int NT, bool CT_SMEM>
__global__ void __launch_bounds__(THREADS, 4)
generic_wavefront_kernel(Args a, const float* __restrict__ ct, int skip) {
  extern __shared__ float4 s_dyn[];
  __shared__ int s_bad;
  float* s_ct = reinterpret_cast<float*>(s_dyn);
  float* s_u = s_ct + (CT_SMEM ? a.SaP * a.SaP : 0);
  if (CT_SMEM) {
    const float4* src = reinterpret_cast<const float4*>(ct);
    for (int e = threadIdx.x; e < a.SaP * a.SaP / 4; e += THREADS)
      s_dyn[e] = __ldg(src + e);
    // the first walk's opening barrier orders these stores
  }
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float v = walk_generic<GL, R, NT, CT_SMEM>(
        a, CT_SMEM ? s_ct : ct, s_u, b, &s_bad, skip != 0);
    if (threadIdx.x == 0) a.out[b] = v;
  }
}

// The dynamic shared bytes of a block: C^T when resident, SP floats for
// each of the NWARP * cells_per_warp cell groups.
long smem_bytes(int SP, int cells_per_warp, int ct_resident) {
  return ((long)SP * SP * (ct_resident ? 1 : 0) +
          (long)NWARP * cells_per_warp * SP) * (long)sizeof(float);
}

typedef void (*KernelFn)(Args, const float*, int);

template <int GL, int R, int NT>
KernelFn pick_ct(int ct_resident) {
  return ct_resident ? generic_wavefront_kernel<GL, R, NT, true>
                     : generic_wavefront_kernel<GL, R, NT, false>;
}

template <int GL, int NT>
KernelFn pick_r(int chunks, int ct_resident) {
  switch (chunks) {
    case 1: return pick_ct<GL, 1, NT>(ct_resident);
    case 2: return pick_ct<GL, 2, NT>(ct_resident);
    case 4: return pick_ct<GL, 4, NT>(ct_resident);
    default: return nullptr;
  }
}

// The kernel for a layout (one or two cells a warp, `chunks` float4 chunks
// a lane), or nullptr if the layout cannot hold SP states.
KernelFn pick(int SP, int cells_per_warp, int chunks, int ct_resident) {
  if (SP < TD || SP % TD != 0 || ct_resident < 0 || ct_resident > 1 ||
      (cells_per_warp != 1 && cells_per_warp != 2))
    return nullptr;
  const int GL = 32 / cells_per_warp;
  if (chunks * GL < owned(SP, GL).lim) return nullptr;
  return GL == 32 ? pick_r<32, 0>(chunks, ct_resident)
                  : pick_r<16, 1>(chunks, ct_resident);
}

}  // namespace

extern "C" long generic_wavefront_smem_bytes(int SP, int cells_per_warp,
                                             int ct_resident) {
  return smem_bytes(SP, cells_per_warp, ct_resident);
}

// The blocks of a layout that one multiprocessor of the current device
// holds at once (its registers, threads and shared memory), or -1 if the
// layout is refused.
extern "C" int generic_wavefront_blocks_per_sm(int SP, int cells_per_warp,
                                               int chunks, int ct_resident) {
  const KernelFn k = pick(SP, cells_per_warp, chunks, ct_resident);
  const long smem = smem_bytes(SP, cells_per_warp, ct_resident);
  if (k == nullptr || smem > SMEM_MAX_BYTES) return -1;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, THREADS,
                                                    (size_t)smem) !=
      cudaSuccess)
    return -1;
  return n;
}

// Launches the kernel on `stream` with `grid` blocks and returns
// cudaGetLastError(). `ct` is C^T source-major, (SP, SP) zero padded. The
// layout is generic_launch_plan's: cells_per_warp (1 or 2), chunks (1, 2 or
// 4 float4 destination chunks a lane at most) and ct_resident (C^T in shared
// memory). skip = 0 takes both products of every cell, the zero ones too.
extern "C" int generic_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* mt, const void* ct,
    void* pbuf, void* mbuf, void* out, int B, int Li, int Lo, int S, int SP,
    int To, int n_cls, const int* desc, int grid, int cells_per_warp,
    int chunks, int ct_resident, int skip, void* stream) {
  Args args;
  const KernelFn k = pick(SP, cells_per_warp, chunks, ct_resident);
  const long smem = smem_bytes(SP, cells_per_warp, ct_resident);
  if (grid < 1 || k == nullptr || smem > SMEM_MAX_BYTES || skip < 0 ||
      skip > 1 ||
      !make_args(args, in_toks, out_toks, in_lens, out_lens, c0, nullptr,
                 mt, pbuf, mbuf, out, B, Li, Lo, S, SP, To, 1, 0, n_cls,
                 desc))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  k<<<grid, THREADS, smem, (cudaStream_t)stream>>>(args, (const float*)ct,
                                                   skip);
  return (int)cudaGetLastError();
}
