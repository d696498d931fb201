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
// the tokens were transposed to (L, B). Here a block reads the block of its
// own sequence's token, and tokens stay (B, L).
//
// Design: one block per sequence, one thread per destination state (a
// thread takes several when there are more states than threads), so a step's
// S multiply-adds per destination run side by side and the L dependent steps
// cost one block barrier each. p lives in shared memory, double buffered,
// and is read four sources at a time as one broadcast; each thread keeps
// four partial sums so that its multiply-adds do not wait on one another.
// EM is copied to shared memory once per block when it fits (S=65, 4
// tokens: 100 KB, two blocks to a multiprocessor) and is read through the
// read-only cache otherwise. The next position's token is fetched before
// the current product.
//
// What bounds it on this card: S*S f32 FMAs per position against the f32
// non-tensor rate; the tokens (4 bytes a position) are the only bytes that
// grow with L. The L steps of one sequence depend on each other, so with few
// sequences the run time is L times one step's latency, which the bound does
// not see.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// em: (n_tok, S, SP) source-major, SP = round_up(S, 32), zero padded;
// c0: (SP,); toks: (B, L); lens: (B,); out: (3, B). blockDim.x is a multiple
// of 32.
__global__ void scan1d_kernel(const float* __restrict__ em,
                              const float* __restrict__ c0,
                              const int* __restrict__ toks,
                              const int* __restrict__ lens,
                              float* __restrict__ out, int B, int L,
                              int n_tok, int S, int SP, int renorm_every,
                              int em_in_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_red[32];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, n_warps = T >> 5;
  float* pin = smem;
  float* pout = smem + SP;
  const float* emat = em;
  if (em_in_smem) {
    float* em_s = smem + 2 * SP;
    const int n = n_tok * S * SP;
    for (int k = tid; k < n; k += T) em_s[k] = em[k];
    emat = em_s;
  }
  const int b = blockIdx.x;
  for (int dst = tid; dst < SP; dst += T) pin[dst] = c0[dst];
  __syncthreads();

  const int len = min(max(lens[b], 0), L);
  const int* tk = toks + (size_t)b * L;
  const int S4 = S & ~3;
  int expo = 0;
  bool dead = false;
  int tok_next = len > 0 ? __ldg(tk) : -1;
  for (int d = 0; d < len; ++d) {
    const int tok = tok_next;
    if (d + 1 < len) tok_next = __ldg(tk + d + 1);
    if (tok < 0) continue;                      // masked position
    if (tok >= n_tok) {
      for (int dst = tid; dst < SP; dst += T) pout[dst] = 0.f;
    } else {
      const float* e = emat + (size_t)tok * S * SP;
      for (int dst = tid; dst < SP; dst += T) {
        const float* col = e + dst;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int s = 0; s < S4; s += 4) {
          const float4 pv = *reinterpret_cast<const float4*>(pin + s);
          a0 = fmaf(pv.x, col[(size_t)s * SP], a0);
          a1 = fmaf(pv.y, col[(size_t)(s + 1) * SP], a1);
          a2 = fmaf(pv.z, col[(size_t)(s + 2) * SP], a2);
          a3 = fmaf(pv.w, col[(size_t)(s + 3) * SP], a3);
        }
        for (int s = S4; s < S; ++s)
          a0 = fmaf(pin[s], col[(size_t)s * SP], a0);
        pout[dst] = (a0 + a1) + (a2 + a3);
      }
    }
    if ((d + 1) % renorm_every == 0) {
      float mx = 0.f;                            // the padding holds zeros
      for (int dst = tid; dst < SP; dst += T) mx = fmaxf(mx, pout[dst]);
      mx = warp_max(mx);
      if (lane == 0) s_red[warp] = mx;
      __syncthreads();
      mx = s_red[0];
      for (int w = 1; w < n_warps; ++w) mx = fmaxf(mx, s_red[w]);
      const float msafe = mx > 0.f ? mx : 1.f;
      const int kexp = (__float_as_int(msafe) >> 23) & 0xFF;
      const float inv = __int_as_float((254 - kexp) << 23);
      for (int dst = tid; dst < SP; dst += T) pout[dst] *= inv;
      expo += kexp - 127;
      dead = dead || !(mx > 0.f);
    }
    __syncthreads();
    float* t = pin; pin = pout; pout = t;
  }
  if (tid == 0) {
    out[b] = pin[S - 1];
    out[B + b] = (float)expo;
    out[2 * B + b] = dead ? 1.f : 0.f;
  }
}

int smem_bytes(int n_tok, int S, int SP, int em_in_smem) {
  size_t n = (size_t)2 * SP;
  if (em_in_smem) n += (size_t)n_tok * S * SP;
  return (int)(n * sizeof(float));
}

}  // namespace

// Launches the kernel on `stream`, one block of `threads` per sequence, and
// returns cudaGetLastError(): nonzero means the launch was refused.
extern "C" int scan1d_launch(const void* em, const void* c0, const void* toks,
                             const void* lens, void* out, int B, int L,
                             int n_tok, int S, int SP, int renorm_every,
                             int threads, int em_in_smem, void* stream) {
  if (S < 1 || SP % 32 != 0 || SP < S || renorm_every < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(n_tok, S, SP, em_in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      scan1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  scan1d_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)em, (const float*)c0, (const int*)toks, (const int*)lens,
      (float*)out, B, L, n_tok, S, SP, renorm_every, em_in_smem);
  return (int)cudaGetLastError();
}
