// The row engine of the pairwise (2D) DP, for Hopper (sm_90a).
//
// Replaces the jitted row scans of machineboss_tpu/ops/dp2d.py (no
// pallas_call: XLA compiles each into one program): forward_2d,
// forward_2d_lattice and backward_2d_lattice (:103-127), an outer lax.scan
// over output rows (:98) around the inner lax.scan over input positions
// (_row_scan, :37-49), and forward_2d_banded (:144-200, _row_scan_banded).
// One launch computes, for every pair b of a batch (a block each),
//   row 0:  u(0,0) = start, u(i,0) = zero for i >= 1;
//   row o:  u(i,o) = cell(i,o-1) (x) A_up[y_o] (+) cell(i-1,o-1) (x)
//                    A_diag[x_i, y_o]                         (i >= 1)
//   every row:  cell(0,o) = u(0,o) (x) C,
//               cell(i,o) = (u(i,o) (+) cell(i-1,o) (x) A_left[x_i]) (x) C,
// and, with a band, cell(i,o) = zero unless in_start[o] <= i < in_end[o]
// (inside the recurrence, as _row_scan_banded does). The output is the
// score cell(in_len, out_len, S-1) of each pair (its rows up to out_len,
// its positions up to in_len: nothing past them feeds that cell) or the
// whole (Lo+1, Li+1, S) lattice of each pair (every row and position).
// Backward is the caller's: transposed matrices, reversed tokens and the
// end state's start vector, then the lattice flipped.
//
// Semirings (template MAX): max-plus takes each destination's max of the
// float32 sums of the same terms as the plain version (ops/dp2d.py's eager
// loop), so it is bit-equal to it; logsumexp takes each destination's max
// over its terms, then the sum of their exponentials (exact per
// destination; the plain version shifts by the source vector's and the
// matrix column's maxima instead, so the two differ by float32 rounding).
// A logsumexp cell whose max is below NEG_INF / 2 is NEG_INF, as the plain
// version writes it. Cells are float32, as in the JAX engine; no TF32.
//
// What bounds it on this card: the chain along i. Position i of a row
// needs position i-1 of the same row through two vecmats (A_left, then the
// closure), so a row is Li+1 dependent steps of 2*S*S terms each, and a
// pair is (Lo+1)*(Li+1) of them in sequence. The u terms (2*S*S a cell)
// depend only on the previous row and run in parallel over a whole row.
// Every term takes an exp (logsumexp), so the operations are 4*S*S adds,
// maxes and exps a cell; one block a pair keeps one SM busy a pair.
//
// Design (simple first; the launch plan is ops/kernels/row_kernel.py::
// row_launch_plan):
//  * One block of 512 threads a pair. A row: first u for every (i, s) in
//    parallel, one thread an item, written into the row buffer; then the
//    chain along i, a group of `lanes` lanes a destination state (a power
//    of two, groups inside a warp, reduced by xor shuffles), two block
//    barriers a position.
//  * The previous and the current row: in shared memory where the two fit
//    beside the closure (score mode), else in a global scratch buffer of
//    the pair's (rows "global"), or the lattice's own rows (lattice mode).
//    The closure (S*S floats) in shared memory where it fits beside the two
//    state vectors, else read from global memory/L2, as the per-token
//    matrices always are. Both reach the loops as generic pointers.
//  * Tokens outside the alphabet are clamped to it, lengths to the padded
//    shape, as the JAX package's gathers clamp their indices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG = -5e29f;

struct Params {
  const float* diag;     // (n_in, n_out, S, S)
  const float* left;     // (n_in, S, S)
  const float* up;       // (n_out, S, S)
  const float* closure;  // (S, S)
  const float* start;    // (S,)
  const int* in_toks;    // (B, Li)
  const int* out_toks;   // (B, Lo)
  const int* in_lens;    // (B,), read in score mode
  const int* out_lens;   // (B,), read in score mode
  const int* band;       // (B, 2, Lo+1): in_start rows, then in_end rows
  float* out;            // (B,) scores or (B, Lo+1, Li+1, S) lattices
  float* rows;           // (B, 2, Li+1, S) when the rows are "global"
  int B, Li, Lo, S, n_in, n_out, lanes;
  int closure_shared, rows_shared;
};

// IEEE minus infinity: the max's start, below every finite term
__device__ __forceinline__ float ninf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The semiring sum of the terms v[k] + M[k * S + j] for k = g, g + G, ...
// (a lane's share of a destination), first its max (pass 1), then, for
// logsumexp, the sum of exp(term - m) for the group's max m (pass 2).
__device__ __forceinline__ float part_max(const float* v, const float* M,
                                          int S, int j, int g, int G) {
  float m = ninf();
  for (int k = g; k < S; k += G) m = fmaxf(m, v[k] + M[(size_t)k * S + j]);
  return m;
}

__device__ __forceinline__ float part_sum(const float* v, const float* M,
                                          int S, int j, int g, int G,
                                          float m) {
  float s = 0.f;
  for (int k = g; k < S; k += G) s += expf(v[k] + M[(size_t)k * S + j] - m);
  return s;
}

__device__ __forceinline__ float group_max(float m, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float group_sum(float s, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// One destination j of a vecmat in the chain, by a group of G lanes:
// extra (+) (+)_k v[k] (x) M[k][j]; terms false takes extra alone.
// Every lane of the warp calls it (act false: a lane without a
// destination), so the shuffles see whole warps.
template <bool MAX>
__device__ __forceinline__ float chain_dest(const float* v, const float* M,
                                            int S, int j, bool act, int g,
                                            int G, float extra, bool terms) {
  float m = (act && terms) ? part_max(v, M, S, j, g, G) : ninf();
  m = fmaxf(group_max(m, G), extra);
  if (MAX) return m;
  // no lane leaves before the sum's shuffles
  const bool dead = m <= HALF_NEG;
  float s = (act && terms && !dead) ? part_sum(v, M, S, j, g, G, m) : 0.f;
  s = group_sum(s, G);
  return dead ? NEG_INF : m + logf(s + expf(extra - m));
}

// u(i, j) of row o >= 1 from the previous row, by one thread.
template <bool MAX>
__device__ __forceinline__ float u_item(const float* prev, const float* upm,
                                        const float* dg, int S, int i,
                                        int j) {
  const float* p1 = prev + (size_t)i * S;
  const float* p0 = prev + (size_t)(i - 1) * S;
  float m = part_max(p1, upm, S, j, 0, 1);
  if (i > 0) m = fmaxf(m, part_max(p0, dg, S, j, 0, 1));
  if (MAX) return m;
  if (m <= HALF_NEG) return NEG_INF;
  float s = part_sum(p1, upm, S, j, 0, 1, m);
  if (i > 0) s += part_sum(p0, dg, S, j, 0, 1, m);
  return m + logf(s);
}

template <bool MAX, bool LATTICE, bool BANDED>
__global__ void __launch_bounds__(THREADS)
row_scan_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int S = p.S, Li = p.Li, Lo = p.Lo;
  const size_t SS = (size_t)S * S;
  const size_t row_floats = (size_t)(Li + 1) * S;

  float* sp = smem;
  const float* C = p.closure;
  if (p.closure_shared) {
    for (size_t k = tid; k < SS; k += THREADS) sp[k] = p.closure[k];
    C = sp;
    sp += SS;
  }
  float* T = sp;          // the chain's pre-closure vector
  float* F = sp + S;      // the previous position's cells
  sp += 2 * S;

  const int Lp = LATTICE ? Li : clampi(p.in_lens[b], 0, Li);
  const int Lq = LATTICE ? Lo : clampi(p.out_lens[b], 0, Lo);
  const int* xt = p.in_toks + (size_t)b * Li;
  const int* yt = p.out_toks + (size_t)b * Lo;

  float* buf[2];
  if (p.rows_shared) {
    buf[0] = sp;
    buf[1] = sp + row_floats;
  } else if (!LATTICE) {
    buf[0] = p.rows + (size_t)b * 2 * row_floats;
    buf[1] = buf[0] + row_floats;
  }
  float* lat = LATTICE ? p.out + (size_t)b * (Lo + 1) * row_floats : nullptr;

  const int G = p.lanes;
  const int grp = tid / G, g = tid % G, n_grp = THREADS / G;
  const int items_per_row = (Lp + 1) * S;

  for (int o = 0; o <= Lq; ++o) {
    float* cur = LATTICE ? lat + (size_t)o * row_floats : buf[o & 1];
    if (o == 0) {
      for (int idx = tid; idx < items_per_row; idx += THREADS)
        cur[idx] = idx < S ? p.start[idx] : NEG_INF;
    } else {
      const float* prev = LATTICE ? lat + (size_t)(o - 1) * row_floats
                                  : buf[(o - 1) & 1];
      const int y = clampi(yt[o - 1], 0, p.n_out - 1);
      const float* upm = p.up + (size_t)y * SS;
      for (int idx = tid; idx < items_per_row; idx += THREADS) {
        const int i = idx / S, j = idx - i * S;
        const float* dg = p.diag;
        if (i > 0)
          dg += ((size_t)clampi(xt[i - 1], 0, p.n_in - 1) * p.n_out + y) * SS;
        cur[idx] = u_item<MAX>(prev, upm, dg, S, i, j);
      }
    }
    int lo = 0, hi = Lp + 1;
    if (BANDED) {
      const int* bs = p.band + (size_t)b * 2 * (Lo + 1);
      lo = bs[o];
      hi = bs[Lo + 1 + o];
    }
    __syncthreads();

    // the chain along i: T = u(i) (+) F (x) A_left[x_i]; cells = T (x) C
    for (int i = 0; i <= Lp; ++i) {
      const float* Lm = p.left;
      if (i > 0) Lm += (size_t)clampi(xt[i - 1], 0, p.n_in - 1) * SS;
      float* ci = cur + (size_t)i * S;
      for (int base = 0; base < S; base += n_grp) {
        const int k = base + grp;
        const bool act = k < S;
        const float u = act ? ci[k] : NEG_INF;
        const float t = chain_dest<MAX>(F, Lm, S, act ? k : 0, act, g, G, u,
                                        i > 0);
        if (act && g == 0) T[k] = t;
      }
      __syncthreads();
      const bool in_band = !BANDED || (i >= lo && i < hi);
      for (int base = 0; base < S; base += n_grp) {
        const int j = base + grp;
        const bool act = j < S;
        float f = chain_dest<MAX>(T, C, S, act ? j : 0, act, g, G, ninf(),
                                  true);
        if (!in_band) f = NEG_INF;
        if (act && g == 0) {
          F[j] = f;
          ci[j] = f;
        }
      }
      __syncthreads();
    }
  }
  if (!LATTICE && tid == 0)
    p.out[b] = buf[Lq & 1][(size_t)Lp * S + S - 1];
}

int smem_bytes(int S, int Li, int closure_shared, int rows_shared) {
  size_t n = 2 * (size_t)S;
  if (closure_shared) n += (size_t)S * S;
  if (rows_shared) n += 2 * (size_t)(Li + 1) * S;
  return (int)(n * sizeof(float));
}

template <bool MAX, bool LATTICE, bool BANDED>
int launch(const Params& p, int smem, cudaStream_t st) {
  auto kern = row_scan_kernel<MAX, LATTICE, BANDED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<p.B, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int row_scan_smem_bytes(int S, int Li, int closure_shared,
                                   int rows_shared) {
  return smem_bytes(S, Li, closure_shared, rows_shared);
}

// Launches the kernel on `stream`: B blocks of 512 threads, one pair each.
// maxplus: the semiring (0 logsumexp, 1 max-plus); lattice: write every
// pair's lattice to `out` (else its score); band: null for no band.
// rows: the global row scratch (null unless rows_shared is 0 in score
// mode). Returns cudaGetLastError(): nonzero means the launch was refused.
extern "C" int row_scan_launch(const void* diag, const void* left,
                               const void* up, const void* closure,
                               const void* start, const void* in_toks,
                               const void* out_toks, const void* in_lens,
                               const void* out_lens, const void* band,
                               void* out, void* rows, int B, int Li, int Lo,
                               int S, int n_in, int n_out, int lanes,
                               int closure_shared, int rows_shared,
                               int maxplus, int lattice, void* stream) {
  const bool shape_ok =
      B >= 0 && Li >= 0 && Lo >= 0 && S >= 1 && n_in >= 1 && n_out >= 1 &&
      lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
      (lattice ? !rows_shared : (rows_shared || rows != nullptr)) &&
      (lattice || (in_lens != nullptr && out_lens != nullptr));
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params a{(const float*)diag, (const float*)left, (const float*)up,
           (const float*)closure, (const float*)start, (const int*)in_toks,
           (const int*)out_toks, (const int*)in_lens, (const int*)out_lens,
           (const int*)band, (float*)out, (float*)rows, B, Li, Lo, S, n_in,
           n_out, lanes, closure_shared, rows_shared};
  const int smem = smem_bytes(S, Li, closure_shared, rows_shared);
  cudaStream_t st = (cudaStream_t)stream;
  const bool banded = band != nullptr;
  if (maxplus) {
    if (lattice)
      return banded ? launch<true, true, true>(a, smem, st)
                    : launch<true, true, false>(a, smem, st);
    return banded ? launch<true, false, true>(a, smem, st)
                  : launch<true, false, false>(a, smem, st);
  }
  if (lattice)
    return banded ? launch<false, true, true>(a, smem, st)
                  : launch<false, true, false>(a, smem, st);
  return banded ? launch<false, false, true>(a, smem, st)
                : launch<false, false, false>(a, smem, st);
}
