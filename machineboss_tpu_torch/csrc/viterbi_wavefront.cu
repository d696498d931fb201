// Batched max-plus (Viterbi) wavefront fill, for Hopper (sm_90a).
//
// Replaces machineboss_tpu/ops/pallas/viterbi_kernel.py::_viterbi_kernel.
// The recurrence is described in viterbi_common.cuh. The output is
// (n_diags, B, W, S), W = Li + 1: diagonal d of pair b is one contiguous
// (W, S) row, the layout the lattice walk and lattice_from_diagonals read. A
// cell beyond its pair's (in_len, out_len) lattice holds NEG_INF.
//
// What bounds it on this card: operations, an add and a max per term, S*S
// terms per class for every cell whose neighbour lies in the lattice
// (align_prot2dna: S = 132, classes up and left, 0.83 ms at the f32 rate);
// for the 65-state ACGT machine the lattice bytes come close. What held the
// first version back (one block of 512 threads per pair, each thread reading
// its cell's own S x 4 strip of its token's block from L2 and the
// neighbours from the lattice): B = 64 pairs left half of the 132
// multiprocessors idle, and every cell re-read its token's block, 9 MB per
// diagonal at align_prot2dna, where a dozen cells share each token.
//
// Design:
//  1. A pair is walked by a cluster of `csize` blocks (1, or 2 when the
//     batch has fewer pairs than the card has multiprocessors). Block h of
//     the cluster owns half of the destination states; it writes its half
//     of diagonal d to the lattice, to its own copy of the diagonal and to
//     its partner's through distributed shared memory, and one cluster
//     barrier ends the diagonal. `grid` pair walkers (clusters) take pairs
//     b, b + grid, ...
//  2. The previous diagonals in shared memory: two (W, S) slots, three when
//     the machine has a diag class, where they fit (n_slots); otherwise the
//     neighbours are read back from the lattice, which the cluster has just
//     written (read-back).
//  3. Each class block once per token per diagonal: at the start of a
//     diagonal one warp per class buckets the diagonal's cells by that
//     class's token (a counting sort in shared memory) into pieces of up to
//     CB cells of one token. A thread then takes (piece, 4 destination
//     states), loads its token's S x 4 strip once (one float4 a source
//     state) and applies it to every cell of the piece, whose neighbour
//     states are broadcast reads from the slots.
//  4. Past the lengths where a diagonal's buckets no longer fit in shared
//     memory beside the pair's tokens (about 15 W words with three classes),
//     the tokens and the buckets of each block live in a global buffer of
//     the block's own (`gbuck`), read and written through L1/L2, with the
//     same bucketing; only the per-token counts and cursors and the slots
//     stay in shared memory. fill_launch_plan picks it by size alone, the
//     shared buckets wherever they fit; it is its own instantiation of the
//     kernel, so the shared layout's loads stay shared loads.
//  5. The classes' maxima meet in shared memory by atomicMax on an
//     order-preserving integer image of the float, which is exact; then
//     the diagonal is converted back and written out once, in coalesced
//     rows. Only float32 adds and maxes occur, so the lattice equals the
//     plain PyTorch version bit for bit, whatever the order.

#include "viterbi_common.cuh"

namespace {

using namespace viterbi;

constexpr int THREADS = 512;
constexpr int CB = 8;             // most cells a piece
constexpr int MAX_SC = 8;         // most chunks of the source states
constexpr int AUTO_SC = 3;        // most chunks the kernel picks itself
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90
enum { CLS_UP = 0, CLS_LEFT = 1, CLS_DIAG = 2 };

// An int whose order is the float's (for non-NaN floats).
__device__ __forceinline__ int fkey(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float kfloat(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

struct Args {
  const int* in_toks;   // (B, Li)
  const int* out_toks;  // (B, Lo)
  const int* in_lens;   // (B,)
  const int* out_lens;  // (B,)
  const float* c0;      // (S,)
  const float* blk[3];  // up (To, S, SP), left (Ti, S, SP), diag (Ti*To, S, SP)
  int n_tok[3];         // 0: the class is absent
  float* lat;           // (n_diags, B, W, S)
  int B, Li, Lo, S, SP, To;
  int n_slots;          // 0: read the neighbours back from the lattice
  int csize;            // blocks a pair
  int cb;               // cells a piece, 1 .. CB
  int n_sc;             // source-state chunks an item, 0: by the items
};

// Shared memory, in ints/floats, each part rounded up to 4: the slots
// (n_slots x W x S), the pair's tokens (Li, Lo), then per class the cells
// sorted by token (W), each token's first cell in that order (n_tok + 1),
// a cursor per token (n_tok), the pieces (W + n_tok int4s: first position
// in the sorted cells, cells, token, class), and 4 counts. With gbuck the
// tokens, the sorted cells and the pieces are the block's in the global
// buffer (gbuck_floats each, in that order), and shared memory holds the
// slots, the counts, and per class the first cells and cursors.
__host__ __device__ inline long up4(long n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline long smem_floats(int Li, int Lo, int S, int n_slots,
                                            const int* n_tok, int gbuck) {
  const long W = Li + 1;
  long n = up4((long)n_slots * W * S) + 4;
  if (!gbuck) n += up4(Li) + up4(Lo);
  for (int q = 0; q < 3; ++q) {
    n += up4(n_tok[q] + 1) + up4(n_tok[q]);
    if (!gbuck) n += up4(W) + 4 * (W + n_tok[q]);
  }
  return n;
}
__host__ __device__ inline long gbuck_floats(int Li, int Lo, const int* n_tok) {
  const long W = Li + 1;
  long n = up4(Li) + up4(Lo);
  for (int q = 0; q < 3; ++q) n += up4(W) + 4 * (W + n_tok[q]);
  return n;
}

struct Buckets {
  int* sorted;
  int* base;
  int* cursor;
  int4* pieces;
};

// The token class q reads at cell i of diagonal d (o = d - i), or -1 when
// the neighbour lies outside the lattice or the token outside the alphabet.
template <bool GB>
__device__ __forceinline__ int cell_token(const Args& a, const int* xs,
                                          const int* ys, int q, int i,
                                          int o) {
  if (q == CLS_UP) {
    if (o < 1) return -1;
    const int y = ys[o - 1];
    return y >= 0 && y < a.n_tok[q] ? y : -1;
  }
  if (i < 1) return -1;
  const int x = xs[i - 1];
  if (q == CLS_LEFT) return x >= 0 && x < a.n_tok[q] ? x : -1;
  if (o < 1) return -1;
  const int y = ys[o - 1];
  if (x < 0 || y < 0 || y >= a.To) return -1;
  const int t = x * a.To + y;
  return t < a.n_tok[q] ? t : -1;
}

// One warp: bucket the cells lo..hi of diagonal d by class q's token into
// pieces of at most cb cells (their first position counted from sorted0);
// the number of pieces goes to *n_pieces.
template <bool GB>
__device__ void bucket(const Args& a, const Buckets& k, const int* sorted0,
                       const int* xs, const int* ys, int q, int d, int lo,
                       int hi, int* n_pieces, int lane) {
  const int nt = a.n_tok[q];
  for (int t = lane; t < nt; t += 32) k.cursor[t] = 0;
  __syncwarp();
  for (int i = lo + lane; i <= hi; i += 32) {
    const int t = cell_token<GB>(a, xs, ys, q, i, d - i);
    if (t >= 0) atomicAdd(k.cursor + t, 1);
  }
  __syncwarp();
  // exclusive scans of the counts and of the pieces per token
  int carry_c = 0, carry_p = 0;
  for (int t0 = 0; t0 < nt; t0 += 32) {
    const int t = t0 + lane;
    const int c = t < nt ? k.cursor[t] : 0;
    const int p = (c + a.cb - 1) / a.cb;
    int ic = c, ip = p;
    for (int off = 1; off < 32; off <<= 1) {
      const int vc = __shfl_up_sync(0xffffffffu, ic, off);
      const int vp = __shfl_up_sync(0xffffffffu, ip, off);
      if (lane >= off) {
        ic += vc;
        ip += vp;
      }
    }
    if (t < nt) {
      const int b0 = carry_c + ic - c, p0 = carry_p + ip - p;
      k.base[t] = b0;
      for (int j = 0; j < p; ++j)
        k.pieces[p0 + j] = make_int4(
            (int)(k.sorted - sorted0) + b0 + j * a.cb,
            min(a.cb, c - j * a.cb), t, q);
    }
    carry_c += __shfl_sync(0xffffffffu, ic, 31);
    carry_p += __shfl_sync(0xffffffffu, ip, 31);
  }
  __syncwarp();
  if (lane == 0) {
    k.base[nt] = carry_c;
    *n_pieces = carry_p;
  }
  for (int t = lane; t < nt; t += 32) k.cursor[t] = k.base[t];
  __syncwarp();
  for (int i = lo + lane; i <= hi; i += 32) {
    const int t = cell_token<GB>(a, xs, ys, q, i, d - i);
    if (t >= 0) k.sorted[atomicAdd(k.cursor + t, 1)] = i;
  }
}

// gbuf: GB's buffer, gbuck_floats a block (a parameter of its own: a field
// more in Args changed ptxas's allocation of the whole kernel and slowed the
// shared layout; as it is, that layout compiles as it did without GB)
template <bool GB>
__global__ void __launch_bounds__(THREADS)
viterbi_wavefront_kernel(Args a, float* gbuf) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = a.csize > 1 ? cluster_rank() : 0;
  const int W = a.Li + 1;
  const int S = a.S, SP = a.SP;
  const int n_diags = a.Li + a.Lo + 1;
  const long slab = (long)a.B * W * S;
  const long wS = (long)W * S;
  // this block's destination states: column groups dg0 .. dg1 - 1
  const int n_dg = SP / TD;
  const int dg_half = (n_dg + a.csize - 1) / a.csize;
  const int dg0 = rank * dg_half, dg1 = min(n_dg, dg0 + dg_half);
  const int s0 = dg0 * TD, s1 = min(S, dg1 * TD);
  const int ns = max(0, s1 - s0);

  float* slots = sm;
  // the partner's slots, as a shared::cluster address (0: none)
  const unsigned peer = a.csize > 1 && a.n_slots > 0 ? peer_addr(slots, rank ^ 1)
                                                     : 0u;
  long o = up4((long)a.n_slots * wS);
  // gbuck: the tokens, sorted cells and pieces at g, the block's buffer
  float* g = GB ? gbuf + (long)blockIdx.x * gbuck_floats(a.Li, a.Lo, a.n_tok)
                : nullptr;
  long og = 0;
  int* xs;
  int* ys;
  if constexpr (GB) {
    xs = reinterpret_cast<int*>(g + og); og += up4(a.Li);
    ys = reinterpret_cast<int*>(g + og); og += up4(a.Lo);
  } else {
    xs = reinterpret_cast<int*>(sm + o); o += up4(a.Li);
    ys = reinterpret_cast<int*>(sm + o); o += up4(a.Lo);
  }
  int* n_pieces = reinterpret_cast<int*>(sm + o); o += 4;
  Buckets bk[3];
  int pbase[3];                    // each class's first piece, in int4s
  const int* sorted0 = reinterpret_cast<int*>(GB ? g + og : sm + o);
  const int4* pieces0 = nullptr;
  for (int q = 0; q < 3; ++q) {
    const int nt = a.n_tok[q];
    if constexpr (GB) {
      int* p = reinterpret_cast<int*>(g + og);
      bk[q].sorted = p; p += up4(W);
      bk[q].pieces = reinterpret_cast<int4*>(p); p += 4 * (W + nt);
      og = reinterpret_cast<float*>(p) - g;
      int* c = reinterpret_cast<int*>(sm + o);
      bk[q].base = c; c += up4(nt + 1);
      bk[q].cursor = c; c += up4(nt);
      o = reinterpret_cast<float*>(c) - sm;
    } else {
      int* p = reinterpret_cast<int*>(sm + o);
      bk[q].sorted = p; p += up4(W);
      bk[q].base = p; p += up4(nt + 1);
      bk[q].cursor = p; p += up4(nt);
      bk[q].pieces = reinterpret_cast<int4*>(p); p += 4 * (W + nt);
      o = reinterpret_cast<float*>(p) - sm;
    }
    if (q == 0) pieces0 = bk[0].pieces;
    pbase[q] = (int)(bk[q].pieces - pieces0);
  }
  const int n_walk = gridDim.x / a.csize;
  const int walker = blockIdx.x / a.csize;

  for (int b = walker; b < a.B; b += n_walk) {
    const int il = min(max(a.in_lens[b], 0), a.Li);
    const int ol = min(max(a.out_lens[b], 0), a.Lo);
    for (int v = tid; v < a.Li; v += THREADS)
      xs[v] = a.in_toks[(long)b * a.Li + v];
    for (int v = tid; v < a.Lo; v += THREADS)
      ys[v] = a.out_toks[(long)b * a.Lo + v];
    // the partner is done with this block's slots and tokens' last reads
    if (a.csize > 1) cluster_sync(); else __syncthreads();
    float* pair = a.lat + (long)b * wS;
    for (int d = 0; d < n_diags; ++d) {
      float* row = pair + (long)d * slab;
      const int lo = max(0, d - ol), hi = min(d, il);
      if (lo > hi) {                       // past the pair's last diagonal
        for (long v = tid; v < (long)W * ns; v += THREADS)
          row[(v / ns) * S + s0 + v % ns] = NEG_INF;
        continue;
      }
      // the current diagonal's keys: in a slot, or in the lattice row
      int* keys = reinterpret_cast<int*>(
          a.n_slots > 0 ? slots + (long)(d % a.n_slots) * wS : row);
      for (long v = tid; v < (long)(hi - lo + 1) * ns; v += THREADS) {
        const int i = lo + (int)(v / ns), s = s0 + (int)(v % ns);
        keys[(long)i * S + s] = fkey(d == 0 ? a.c0[s] : NEG_INF);
      }
      if (d > 0 && warp < 3) {
        if (a.n_tok[warp] > 0)
          bucket<GB>(a, bk[warp], sorted0, xs, ys, warp, d, lo, hi,
                 n_pieces + warp, lane);
        else if (lane == 0)
          n_pieces[warp] = 0;
      }
      __syncthreads();
      if (d > 0) {
        const float* nb1 = a.n_slots > 0
                               ? slots + (long)((d + a.n_slots - 1) % a.n_slots) * wS
                               : row - slab;
        const float* nb2 = a.n_slots > 0
                               ? slots + (long)((d + a.n_slots - 2) % a.n_slots) * wS
                               : row - 2 * slab;
        const int np0 = n_pieces[0], np1 = n_pieces[1], np2 = n_pieces[2];
        const int ndg = dg1 - dg0;
        // the source states split in n_sc chunks (as many as make two items
        // a thread, at most AUTO_SC), so that enough loads of the blocks are
        // in flight; the chunks' maxima meet exactly
        const int base = (np0 + np1 + np2) * ndg;
        const int n_sc =
            a.n_sc > 0 ? a.n_sc
                       : max(1, min(AUTO_SC, (2 * THREADS + base - 1) /
                                                 max(base, 1)));
        const int sc_len = (S + n_sc - 1) / n_sc;
        const int nitems = base * n_sc;
        for (int item = tid; item < nitems; item += THREADS) {
          const int sc = item / base;
          const int rest = item - sc * base;
          const int pc = rest / ndg;
          const int dg = dg0 + rest - pc * ndg;
          const int4 pv =
              pieces0[pc < np0 ? pc
                      : pc < np0 + np1 ? pbase[1] + pc - np0
                                       : pbase[2] + pc - np0 - np1];
          const int start = pv.x, cnt = pv.y, tok = pv.z, q = pv.w;
          const float* nb = q == CLS_DIAG ? nb2 : nb1;
          const int back = q == CLS_UP ? 0 : 1;   // neighbour cell i - back
          const int sa = sc * sc_len, sb = min(S, sa + sc_len);
          int off[CB];
          float4 acc[CB];
#pragma unroll
          for (int j = 0; j < CB; ++j) {
            off[j] = j < cnt ? (sorted0[start + j] - back) * S : 0;
            acc[j] = neg4();
          }
          const float* m = (q == 0 ? a.blk[0] : q == 1 ? a.blk[1] : a.blk[2]) +
                           (long)tok * S * SP + dg * TD;
#pragma unroll 4
          for (int s = sa; s < sb; ++s) {
            const float4 mv =
                __ldg(reinterpret_cast<const float4*>(m + (long)s * SP));
#pragma unroll
            for (int j = 0; j < CB; ++j) {
              if (j < cnt) {
                const float v = nb[off[j] + s];
                acc[j].x = fmaxf(acc[j].x, mv.x + v);
                acc[j].y = fmaxf(acc[j].y, mv.y + v);
                acc[j].z = fmaxf(acc[j].z, mv.z + v);
                acc[j].w = fmaxf(acc[j].w, mv.w + v);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < CB; ++j) {
            if (j >= cnt) continue;
            int* kc = keys + off[j] + back * S + dg * TD;
            const float r[TD] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
            for (int e = 0; e < TD; ++e)
              if (dg * TD + e < S) atomicMax(kc + e, fkey(r[e]));
          }
        }
        __syncthreads();
      }
      // the diagonal as floats: to the lattice row (every cell of this
      // block's states), this block's slot and the partner's
      float* slot = a.n_slots > 0 ? slots + (long)(d % a.n_slots) * wS : nullptr;
      const unsigned pslot =
          peer != 0u ? peer + (unsigned)((d % a.n_slots) * wS * sizeof(float))
                     : 0u;
      for (long v = tid; v < (long)W * ns; v += THREADS) {
        const int i = (int)(v / ns), s = s0 + (int)(v % ns);
        const long c = (long)i * S + s;
        float f = NEG_INF;
        if (i >= lo && i <= hi) {
          f = kfloat(keys[c]);
          if (slot != nullptr) slot[c] = f;
          if (pslot != 0u) peer_store(pslot + (unsigned)(c * sizeof(float)), f);
        }
        row[c] = f;
      }
      if (a.csize > 1) {
        if (a.n_slots == 0) __threadfence();
        cluster_sync();
      } else {
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" long viterbi_wavefront_smem_bytes(int Li, int Lo, int S,
                                             int n_slots, int n_up,
                                             int n_left, int n_diag,
                                             int gbuck) {
  const int nt[3] = {n_up, n_left, n_diag};
  return smem_floats(Li, Lo, S, n_slots, nt, gbuck) * (long)sizeof(float);
}

// The floats of the global buffer a block takes with gbuck.
extern "C" long viterbi_wavefront_gbuck_floats(int Li, int Lo, int n_up,
                                               int n_left, int n_diag) {
  const int nt[3] = {n_up, n_left, n_diag};
  return gbuck_floats(Li, Lo, nt);
}

// Launches the kernel on `stream`: `grid` pair walkers, each a cluster of
// `csize` blocks (1 or 2), with `n_slots` diagonals kept in shared memory
// (0: read back from the lattice), pieces of at most `cb` cells (1 .. 8)
// of one token, the source states in `n_sc` chunks an item (0: as many as
// make two items a thread, at most 3). n_up, n_left, n_diag: the tokens of each
// class's blocks (0: absent; the pointer is then not read). gbuck = 1 keeps
// the tokens and buckets in `gbuf`, grid * csize blocks of
// viterbi_wavefront_gbuck_floats (not read with gbuck = 0). Returns
// cudaGetLastError() (or the launch's error): nonzero means the launch was
// refused.
extern "C" int viterbi_wavefront_launch(
    const void* in_toks, const void* out_toks, const void* in_lens,
    const void* out_lens, const void* c0, const void* up, const void* left,
    const void* diag, void* lat, void* gbuf, int B, int Li, int Lo, int S,
    int SP, int To, int n_up, int n_left, int n_diag, int n_slots, int csize,
    int cb, int n_sc, int grid, int gbuck, void* stream) {
  if (grid < 1 || S < 1 || SP < S || SP % viterbi::TD != 0 || Li < 0 ||
      Lo < 0 || (csize != 1 && csize != 2) || n_slots < 0 || n_slots > 3 ||
      n_up < 0 || n_left < 0 || n_diag < 0 || (n_up > 0 && !up) ||
      (n_left > 0 && !left) || (n_diag > 0 && (!diag || To < 1)) ||
      (n_slots > 0 && n_slots < (n_diag > 0 ? 3 : 2)) || cb < 1 || cb > CB ||
      n_sc < 0 || n_sc > MAX_SC || gbuck < 0 || gbuck > 1 ||
      (gbuck && !gbuf))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.in_lens = (const int*)in_lens;
  a.out_lens = (const int*)out_lens;
  a.c0 = (const float*)c0;
  a.blk[0] = (const float*)up;
  a.blk[1] = (const float*)left;
  a.blk[2] = (const float*)diag;
  a.n_tok[0] = n_up;
  a.n_tok[1] = n_left;
  a.n_tok[2] = n_diag;
  a.lat = (float*)lat;
  a.B = B; a.Li = Li; a.Lo = Lo; a.S = S; a.SP = SP; a.To = To;
  a.n_slots = n_slots;
  a.csize = csize;
  a.cb = cb;
  a.n_sc = n_sc;
  const long smem =
      smem_floats(Li, Lo, S, n_slots, a.n_tok, gbuck) * (long)sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = gbuck ? viterbi_wavefront_kernel<true>
                    : viterbi_wavefront_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * csize);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a, (float*)gbuf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
