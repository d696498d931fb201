// The chained schedule's coordinates, shared by chained_wavefront.cu and the
// chained entry of lowrank_wavefront.cu (sm_90a).
//
// The TPU's chained kernels (machineboss_tpu/ops/pallas/wavefront_kernel.py::
// _chained_kernel and lowrank_kernel.py::_body_chained) pack n_chain
// equal-length pairs into each lane window, staggered by sigma = Lo + 2
// diagonals: window w holds pairs w, w + n_strips, w + 2 n_strips, ...
// (n_strips = B / n_chain). Here one thread block walks one such strip. At
// absolute step t, column i (0 .. Li) holds chain k = (t - i) / sigma at
// local output coordinate o = t - i - k sigma; the cell is live while
// o <= Lo and k < n_chain. The margin o = Lo + 1 is dead: it keeps a column's
// left and diag neighbours inside the same chain, so the three rotating
// diagonal slots of the unchained kernels serve unchanged, indexed by t.
// Chain k starts at (0, 0) on step k sigma and is read out at (Li, Lo) on
// step k sigma + Li + Lo; the whole strip takes sigma (n_chain - 1) + Li +
// Lo + 1 steps, one block barrier (two on a rescale step) each.

#pragma once

#include <cuda_runtime.h>

namespace strip {

struct Strip {
  int n_chain;   // pairs per strip
  int n_strips;  // strips (blocks); pair n = k * n_strips + strip
  int sigma;     // stagger, Lo + 2
  int Li, Lo;
};

__host__ __device__ inline int steps(const Strip& s) {
  return s.sigma * (s.n_chain - 1) + s.Li + s.Lo + 1;
}

// the columns that can be live at step t
__device__ inline int col_lo(const Strip& s, int t) {
  return max(0, t - s.sigma * (s.n_chain - 1) - s.Lo);
}

__device__ inline int col_hi(const Strip& s, int t) {
  return min(t, s.Li);
}

// chain k and local output coordinate o of column i at step t; false where
// the cell is dead (not started, the margin, or past the last chain)
__device__ inline bool cell(const Strip& s, int t, int i, int& k, int& o) {
  const int u = t - i;
  if (u < 0) return false;
  k = u / s.sigma;
  o = u - k * s.sigma;
  return k < s.n_chain && o <= s.Lo;
}

// the chain whose readout cell (Li, Lo) is on step t, or -1
__device__ inline int readout_chain(const Strip& s, int t) {
  const int u = t - s.Li - s.Lo;
  if (u < 0 || u % s.sigma) return -1;
  const int k = u / s.sigma;
  return k < s.n_chain ? k : -1;
}

__device__ inline int pair(const Strip& s, int k, int strip_index) {
  return k * s.n_strips + strip_index;
}

inline bool make_strip(Strip& s, int B, int Li, int Lo, int n_chain) {
  if (n_chain < 1 || B % n_chain != 0 || Li < 1 || Lo < 1) return false;
  s.n_chain = n_chain;
  s.n_strips = B / n_chain;
  s.sigma = Lo + 2;
  s.Li = Li;
  s.Lo = Lo;
  return true;
}

}  // namespace strip
