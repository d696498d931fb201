// Viterbi traceback walk over a value lattice on the device, for Hopper
// (sm_90a).
//
// Counterpart of the jitted lax.while_loop of
// machineboss_tpu/algo/traceback_device.py::make_lattice_walker (not a Pallas
// kernel there, but one device invocation). One block walks one pair from
// (li, lo, S-1) back to (0, 0, 0) at cell granularity and records, for every
// distinct cell it visits, the value vectors of the cell and of its diag,
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
// Ncap * (1 + silent depth) per pair, each a 4*S-wide argmax across one
// block: latency, not bytes or operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Args {
  const float* lat;     // (nd, B, W, S)
  const int* bases;     // (nd,)
  const int* in_toks;   // (B, Lip)
  const int* out_toks;  // (B, Lop)
  const int* in_lens;   // (B,)
  const int* out_lens;  // (B,)
  const float* ad;      // (Ti, To, S, S) [dst][src]
  const float* al;      // (Ti, S, S)
  const float* au;      // (To, S, S)
  const float* sil;     // (S, S)
  int* n_out;           // (B,)
  int* ij;              // (B, Ncap, 2), preset to -1
  float* vals;          // (B, Ncap, 4, S), preset to NEG_INF
  int* ok_out;          // (B,)
  int B, W, nd, S, Ti, To, Lip, Lop, Ncap, max_steps;
};

// lower index wins among equal values
__device__ __forceinline__ bool better(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

__global__ void __launch_bounds__(THREADS) lattice_walk_kernel(Args a) {
  __shared__ float s_val[WARPS];
  __shared__ int s_idx[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int S = a.S;
  const int li = a.in_lens[b], lo = a.out_lens[b];
  const int* xt = a.in_toks + (size_t)b * a.Lip;
  const int* yt = a.out_toks + (size_t)b * a.Lop;

  // the walk's state, kept identically by every thread
  int i = li, o = lo, s = S - 1, n = 0, step = 0, pi = -1, po = -1;
  bool done = (S == 1) && li == 0 && lo == 0;
  bool stuck = false;

  while (!done && step < a.max_steps && n < a.Ncap) {
    // the four cells of the record: [cell, diag, left, up]
    const float* cell[4];
    {
      const int ci[4] = {i, i - 1, i - 1, i};
      const int co[4] = {o, o - 1, o, o - 1};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = min(max(ci[c] + co[c], 0), a.nd - 1);
        const int w = ci[c] - a.bases[d];
        const bool ok = ci[c] >= 0 && co[c] >= 0 && ci[c] <= li &&
                        co[c] <= lo && w >= 0 && w < a.W;
        cell[c] = ok ? a.lat + (((size_t)d * a.B + b) * a.W + w) * S : nullptr;
      }
    }
    const int tx = min(max(xt[min(max(i - 1, 0), a.Lip - 1)], 0), a.Ti - 1);
    const int ty = min(max(yt[min(max(o - 1, 0), a.Lop - 1)], 0), a.To - 1);
    // incoming edge weights of state s, by candidate block
    const float* edge[4] = {
        a.ad + (((size_t)tx * a.To + ty) * S + s) * S,
        a.al + ((size_t)tx * S + s) * S,
        a.au + ((size_t)ty * S + s) * S,
        a.sil + (size_t)s * S};
    const bool open[4] = {i > 0 && o > 0, i > 0, o > 0, true};
    float* rec = a.vals + ((size_t)b * a.Ncap + n) * 4 * S;
    if (tid == 0) {
      a.ij[((size_t)b * a.Ncap + n) * 2] = i;
      a.ij[((size_t)b * a.Ncap + n) * 2 + 1] = o;
    }

    float bv = -3.4e38f;
    int bk = 4 * S;
    for (int t = tid; t < 4 * S; t += THREADS) {
      const int c = t / S, src = t - c * S;      // record block c
      const float v = cell[c] ? cell[c][src] : NEG_INF;
      rec[t] = v;
      // candidate order [diag, left, up, silent]: record blocks 1, 2, 3, 0
      const int q = (c + 3) & 3;
      const float cand = open[q] ? v + __ldg(edge[q] + src) : NEG_INF;
      const int k = q * S + src;
      if (better(cand, k, bv, bk)) { bv = cand; bk = k; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      if (better(ov, ok, bv, bk)) { bv = ov; bk = ok; }
    }
    if (lane == 0) { s_val[warp] = bv; s_idx[warp] = bk; }
    __syncthreads();
    bv = s_val[0]; bk = s_idx[0];
#pragma unroll
    for (int wv = 1; wv < WARPS; ++wv)
      if (better(s_val[wv], s_idx[wv], bv, bk)) {
        bv = s_val[wv];
        bk = s_idx[wv];
      }
    __syncthreads();   // s_val/s_idx are free for the next step

    const bool moved = (i != pi) || (o != po);
    pi = i; po = o;
    n += moved ? 1 : 0;
    const bool bad = bv <= NEG_INF / 2;
    if (!bad) {
      const int q = bk / S;
      s = bk - q * S;
      if (q == 0 || q == 1) i -= 1;
      if (q == 0 || q == 2) o -= 1;
    }
    done = (i == 0 && o == 0 && s == 0) || bad;
    stuck = stuck || bad;
    step += 1;
  }
  if (tid == 0) {
    a.n_out[b] = n;
    a.ok_out[b] = (done && !stuck && i == 0 && o == 0 && s == 0) ? 1 : 0;
  }
}

}  // namespace

// Launches one block per pair on `stream` and returns cudaGetLastError():
// nonzero means the launch was refused.
extern "C" int lattice_walk_launch(
    const void* lat, const void* bases, const void* in_toks,
    const void* out_toks, const void* in_lens, const void* out_lens,
    const void* ad, const void* al, const void* au, const void* sil,
    void* n_out, void* ij, void* vals, void* ok_out, int B, int W, int nd,
    int S, int Ti, int To, int Lip, int Lop, int Ncap, int max_steps,
    void* stream) {
  if (S < 1 || W < 1 || nd < 1 || Ti < 1 || To < 1 || Lip < 1 || Lop < 1 ||
      Ncap < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.lat = (const float*)lat;
  a.bases = (const int*)bases;
  a.in_toks = (const int*)in_toks;
  a.out_toks = (const int*)out_toks;
  a.in_lens = (const int*)in_lens;
  a.out_lens = (const int*)out_lens;
  a.ad = (const float*)ad;
  a.al = (const float*)al;
  a.au = (const float*)au;
  a.sil = (const float*)sil;
  a.n_out = (int*)n_out;
  a.ij = (int*)ij;
  a.vals = (float*)vals;
  a.ok_out = (int*)ok_out;
  a.B = B; a.W = W; a.nd = nd; a.S = S; a.Ti = Ti; a.To = To;
  a.Lip = Lip; a.Lop = Lop; a.Ncap = Ncap; a.max_steps = max_steps;
  lattice_walk_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
