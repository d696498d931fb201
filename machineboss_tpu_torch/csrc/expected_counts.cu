// Expected transition counts of the E-step, for Hopper (sm_90a).
//
// Replaces the backward pass that XLA derives for machineboss_tpu's
// ops/fwdback.py:112 (jax.value_and_grad of jax.vmap(dp2d.forward_2d), the
// lax.scans of ops/dp2d.py:49 and :98; no pallas_call: the E-step is one
// jitted program). One launch takes a batch's Forward lattices F and the
// Backward lattices of its pairs' reversed prefixes Br (both from
// csrc/row_scan.cu), and returns, for every finite entry of the four
// log-space tensors (A_diag[x, y], A_left[x], A_up[y], the closure C), the
// gradient of sum_b g_b LL_b, LL_b = F_b(il, ol, S-1): a sum over each
// pair's cells (i <= il, o <= ol) of posterior terms
//   emitting  exp(F_nb(s) + A[s,t] + Bk(i,o,t) - LL)   (the neighbour the
//             matrix leads from: (i-1,o-1) diag, (i,o-1) up, (i-1,o) left)
//   closure   exp(U(i,o,s) + C[s,t] + beta(i,o,t) - LL)
// with Bk(i,o) = Br(ol-o, il-i) (pre-closure Backward), U the pre-closure
// Forward and beta the post-closure Backward, neither of which the lattices
// hold. Both come from the emitting terms' sums, with no logsumexp:
//   P_U(s)    = sum of the cell's incoming terms into s
//             = exp(U(s) + Bk(s) - LL),
//   P_beta(t) = sum over the cells (i,o) feeds of exp(F(t) + A[t,u] +
//               Bk_next(u) - LL), plus exp(F(t) - LL) at the end cell
//             = exp(F(t) + beta(t) - LL),
// so the closure term is exp((log P_U(s) - Bk(s) + C[s,t]) + (log P_beta(t)
// - F(t) + LL)). Every term is a posterior (<= 1), so each is one exp of a
// sum of finite numbers; a state with no path has P = 0 and drops out as
// exp(-inf) (IEEE -inf, never +inf, so no NaN). A pair with g_b = 0 or no
// path (LL <= NEG_INF / 2, where exp(... + 1e30) would overflow) is
// skipped.
//
// What bounds it on this card: the bytes of the two lattices (each read
// once by the cells that need it: 2 x 848 MB for prot2dna's 128 pairs of
// 64 x 192, 0.51 ms at 3.35 TB/s); its arithmetic is one exp and a few
// adds a finite term (~230 a cell at prot2dna), far below the rates. The
// cells are independent (both lattices are given), so every cell of every
// pair can run at once.
//
// Design (the plan is ops/kernels/counts_kernel.py::counts_launch_plan):
//  * A block of 16 warps takes pairs b = blockIdx, blockIdx + blocks, ...;
//    a warp takes one cell at a time (cells w, w + 16, ... of the pair in
//    row order), a lane the columns j = lane + 32 r: for the incoming terms
//    (and the closure's) the finite sources of column j, for P_beta the
//    finite destinations of row j, each from ELL lists built once per set
//    of matrices (counts_tables: (source, raw log value, entry index) a
//    lane a row, the slice's first row the lanes' counts).
//  * Ordered sums, no atomics. A lane owns its columns' entries, so a
//    warp's 32 lanes never touch one entry at once: each warp adds its
//    terms into its own float32 sums (in shared memory where the 16 warps'
//    fit, else in a global scratch a warp). At the end a block adds its 16
//    warps' sums in warp order in float64 into its partial, and the last
//    block to finish (a ticket) adds the blocks' partials in block order in
//    float64: the result is the same bits run to run. Float64 for the sums
//    across warps and blocks because each adds up to ~10^4 float32 sums of
//    a few hundred cells' terms, where float32's order-dependent rounding
//    would be ~1e-5 relative: the float32 terms (~6e-5 relative from their
//    exponents' rounding at |LL| ~ 10^3) stay the only error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;
constexpr float HALF_NEG = -5e29f;

struct Params {
  const int2* hdr_f;     // (n_mat * nsl): (offset into ent_f, rows)
  const int4* ent_f;     // column lists: (source, value bits, index, 0)
  const int2* hdr_t;     // the transposed matrices' lists
  const int4* ent_t;
  const float* F;        // (B, Lo+1, Li+1, S) Forward, post-closure
  const float* Br;       // (B, Lo+1, Li+1, S) Backward of reversed prefixes
  const int* in_toks;    // (B, Li)
  const int* out_toks;   // (B, Lo)
  const int* in_lens;    // (B,)
  const int* out_lens;   // (B,)
  const float* g;        // (B,) each pair's weight
  float* acc_g;          // (blocks, NW, n_fin) when the sums are global
  double* partial;       // (blocks, n_fin)
  double* out;           // (n_fin,)
  unsigned* ticket;      // zeroed by the caller
  int B, Li, Lo, S, n_in, n_out, n_fin, acc_shared;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// IEEE minus infinity: exp of it is 0, and it meets no +inf here
__device__ __forceinline__ float ninf() { return __int_as_float(0xff800000); }

// The lane's list of column j = 32 r + lane of matrix m: its entries are
// e[32 t], t = 1 .. e[0].x (none when the slice is empty).
__device__ __forceinline__ const int4* column(const int2* __restrict__ hdr,
                                              const int4* __restrict__ ent,
                                              int m, int nsl, int r,
                                              int lane, int* n) {
  const int2 h = hdr[m * nsl + r];
  if (h.y == 0) {
    *n = 0;
    return nullptr;
  }
  const int4* e = ent + h.x + lane;
  *n = e[0].x;
  return e;
}

// The incoming terms of column j from the stored neighbour `src` through
// matrix m: each exp((src[k] + A[k,j]) + base), base = Bk(j) - LL, added,
// times the pair's weight, into its entry's sum; returns their sum.
__device__ __forceinline__ float incoming(const int2* __restrict__ hdr,
                                          const int4* __restrict__ ent,
                                          int m, int nsl, int r, int lane,
                                          const float* __restrict__ src,
                                          float base, float gb, float* acc) {
  int n;
  const int4* e = column(hdr, ent, m, nsl, r, lane, &n);
  float s = 0.f;
  for (int t = 1; t <= n; ++t) {
    const int4 q = e[32 * t];
    const float v = expf((src[q.x] + __int_as_float(q.y)) + base);
    s += v;
    acc[q.z] += gb * v;
  }
  return s;
}

// The outgoing terms of row t into the cell whose Backward is `bk` through
// matrix m: the sum of exp((bk[u] + A[t,u]) + base), base = F(t) - LL.
__device__ __forceinline__ float outgoing(const int2* __restrict__ hdr,
                                          const int4* __restrict__ ent,
                                          int m, int nsl, int r, int lane,
                                          const float* __restrict__ bk,
                                          float base) {
  int n;
  const int4* e = column(hdr, ent, m, nsl, r, lane, &n);
  float s = 0.f;
  for (int t = 1; t <= n; ++t) {
    const int4 q = e[32 * t];
    s += expf((bk[q.x] + __int_as_float(q.y)) + base);
  }
  return s;
}

__global__ void __launch_bounds__(THREADS, 1)
expected_counts_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int S = p.S, Li = p.Li, Lo = p.Lo, nsl = (S + 31) >> 5;
  const int n_io = p.n_in * p.n_out;
  const int m_cl = n_io + p.n_in + p.n_out;
  const int2* hf = p.hdr_f;
  const int4* ef = p.ent_f;
  const int2* ht = p.hdr_t;
  const int4* et = p.ent_t;
  // a warp's workspace: lu(s) = log P_U(s) - Bk(s), lb(t) = log P_beta(t)
  // - F(t); then the warps' sums where shared
  float* lu = (float*)smem_raw + (size_t)w * 2 * S;
  float* lb = lu + S;
  float* acc_s = (float*)smem_raw + (size_t)NW * 2 * S;
  float* acc = p.acc_shared
                   ? acc_s + (size_t)w * p.n_fin
                   : p.acc_g + ((size_t)blockIdx.x * NW + w) * p.n_fin;
  for (int e = lane; e < p.n_fin; e += 32) acc[e] = 0.f;
  __syncwarp();

  const size_t plane = (size_t)(Li + 1) * S;
  const size_t lat = (size_t)(Lo + 1) * plane;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float gb = p.g[b];
    const int il = clampi(p.in_lens[b], 0, Li);
    const int ol = clampi(p.out_lens[b], 0, Lo);
    const float* Fb = p.F + (size_t)b * lat;
    const float* Rb = p.Br + (size_t)b * lat;
    const float LL = Fb[(size_t)ol * plane + (size_t)il * S + S - 1];
    if (gb == 0.f || !(LL > HALF_NEG)) continue;    // uniform in the block
    const int* xt = p.in_toks + (size_t)b * Li;
    const int* yt = p.out_toks + (size_t)b * Lo;
    const int W = il + 1;
    const int n_cells = W * (ol + 1);
    for (int c = w; c < n_cells; c += NW) {
      const int o = c / W, i = c - o * W;
      const float* Fc = Fb + (size_t)o * plane + (size_t)i * S;
      const float* Bc = Rb + (size_t)(ol - o) * plane + (size_t)(il - i) * S;
      // the tokens of this cell (x_i, y_o) and of the next (x_{i+1},
      // y_{o+1}), clamped to the alphabets as row_scan clamps them
      const int x = i > 0 ? clampi(xt[i - 1], 0, p.n_in - 1) : 0;
      const int y = o > 0 ? clampi(yt[o - 1], 0, p.n_out - 1) : 0;
      const int x1 = i < il ? clampi(xt[i], 0, p.n_in - 1) : 0;
      const int y1 = o < ol ? clampi(yt[o], 0, p.n_out - 1) : 0;
      // the neighbours' stored cells: F(i,o-1), F(i-1,o), F(i-1,o-1) and
      // Bk(i,o+1), Bk(i+1,o), Bk(i+1,o+1); each is read only where it
      // lies inside the pair
      const float* f_up = Fc - plane;
      const float* f_left = Fc - S;
      const float* f_diag = f_up - S;
      const float* b_up = Bc - plane;
      const float* b_left = Bc - S;
      const float* b_diag = b_up - S;
      const int m_up = n_io + p.n_in + y, m_left = n_io + x;
      const int m_diag = x * p.n_out + y;
      const int m_up1 = n_io + p.n_in + y1, m_left1 = n_io + x1;
      const int m_diag1 = x1 * p.n_out + y1;
      for (int r = 0; r < nsl; ++r) {
        const int j = 32 * r + lane;
        // -- the incoming terms into column j: P_U(j)
        const float bj = j < S ? Bc[j] : 0.f;
        const float base = bj - LL;
        float pu = 0.f;
        if (c == 0) {
          if (j == 0) pu = expf(base);                // U(0,0) = e_0
        } else {
          if (o > 0)
            pu += incoming(hf, ef, m_up, nsl, r, lane, f_up, base, gb, acc);
          if (o > 0 && i > 0)
            pu += incoming(hf, ef, m_diag, nsl, r, lane, f_diag, base, gb,
                           acc);
          if (i > 0)
            pu += incoming(hf, ef, m_left, nsl, r, lane, f_left, base, gb,
                           acc);
        }
        // -- the outgoing terms of row j: P_beta(j)
        const float fj = j < S ? Fc[j] : 0.f;
        const float fbase = fj - LL;
        float pb = 0.f;
        if (o < ol) pb += outgoing(ht, et, m_up1, nsl, r, lane, b_up, fbase);
        if (o < ol && i < il)
          pb += outgoing(ht, et, m_diag1, nsl, r, lane, b_diag, fbase);
        if (i < il)
          pb += outgoing(ht, et, m_left1, nsl, r, lane, b_left, fbase);
        if (o == ol && i == il && j == S - 1) pb += expf(fbase);
        if (j < S) {
          lu[j] = pu > 0.f ? logf(pu) - bj : ninf();
          lb[j] = pb > 0.f ? logf(pb) - fj : ninf();
        }
      }
      __syncwarp();
      // -- the closure terms of column t: exp((lu(s) + C[s,t]) + (lb(t) +
      // LL)) over the finite sources s
      for (int r = 0; r < nsl; ++r) {
        const int t = 32 * r + lane;
        int n;
        const int4* e = column(hf, ef, m_cl, nsl, r, lane, &n);
        const float tb = t < S ? lb[t] + LL : ninf();
        if (!(tb > ninf())) continue;
        for (int q = 1; q <= n; ++q) {
          const int4 v = e[32 * q];
          acc[v.z] += gb * expf((lu[v.x] + __int_as_float(v.y)) + tb);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // the block's sum over its warps, in warp order, then the blocks' in
  // block order by the last block to finish
  const float* accb = p.acc_shared
                          ? acc_s
                          : p.acc_g + (size_t)blockIdx.x * NW * p.n_fin;
  for (int e = tid; e < p.n_fin; e += THREADS) {
    double s = 0.0;
    for (int q = 0; q < NW; ++q) s += (double)accb[(size_t)q * p.n_fin + e];
    p.partial[(size_t)blockIdx.x * p.n_fin + e] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int e = tid; e < p.n_fin; e += THREADS) {
    double s = 0.0;
    for (unsigned q = 0; q < gridDim.x; ++q)
      s += __ldcg(p.partial + (size_t)q * p.n_fin + e);
    p.out[e] = s;
  }
}

// A block's shared bytes: the warps' workspaces (two vectors of S floats)
// and, where shared, the warps' sums (n_fin floats each).
size_t smem_bytes(int S, int n_fin, int acc_shared) {
  return (size_t)NW * (2 * (size_t)S + (acc_shared ? (size_t)n_fin : 0)) *
         sizeof(float);
}

}  // namespace

extern "C" int expected_counts_smem_bytes(int S, int n_fin, int acc_shared) {
  return (int)smem_bytes(S, n_fin, acc_shared);
}

// Launches the kernel on `stream`: `blocks` blocks of 512 threads. hdr_f,
// ent_f: the matrices' column lists (counts_tables), hdr_t, ent_t: the
// transposed matrices'; F, Br: float32 (B, Lo+1, Li+1, S); tokens,
// lengths int32; g float32 (B,); acc_g: (blocks, 16, n_fin) float32 when
// acc_shared is 0, else null; partial (blocks, n_fin) and out (n_fin)
// float64; ticket one zeroed unsigned. Returns cudaGetLastError() or the
// launch's error: nonzero means the launch was refused.
extern "C" int expected_counts_launch(
    const void* hdr_f, const void* ent_f, const void* hdr_t,
    const void* ent_t, const void* F, const void* Br, const void* in_toks,
    const void* out_toks, const void* in_lens, const void* out_lens,
    const void* g, void* acc_g, void* partial, void* out, void* ticket,
    int B, int Li, int Lo, int S, int n_in, int n_out, int n_fin, int blocks,
    int acc_shared, void* stream) {
  const bool ok = B >= 1 && Li >= 0 && Lo >= 0 && S >= 1 && S <= 512 &&
                  n_in >= 1 && n_out >= 1 && n_fin >= 1 && blocks >= 1 &&
                  (acc_shared || acc_g != nullptr) && partial != nullptr &&
                  out != nullptr && ticket != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  Params a{(const int2*)hdr_f, (const int4*)ent_f, (const int2*)hdr_t,
           (const int4*)ent_t, (const float*)F, (const float*)Br,
           (const int*)in_toks, (const int*)out_toks, (const int*)in_lens,
           (const int*)out_lens, (const float*)g, (float*)acc_g,
           (double*)partial, (double*)out, (unsigned*)ticket, B, Li, Lo, S,
           n_in, n_out, n_fin, acc_shared};
  const size_t smem = smem_bytes(S, n_fin, acc_shared);
  cudaError_t e = cudaFuncSetAttribute(
      expected_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  expected_counts_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
