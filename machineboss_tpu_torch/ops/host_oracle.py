"""Float64 host oracle for the device 2D Forward engines.

Computes the pairwise Forward log-likelihood in numpy float64 from the SAME
lowered tensors the device kernels consume (ops/lowering.matrices_2d), so a
bench-time comparison isolates device-kernel numerical error from any
host-layer modeling differences. Used by bench.py's on-TPU accuracy gate
and by kernel tests (device/host agreement contract: <= 0.01 nats,
mirroring the reference's own cross-backend tolerance,
ref python/machineboss/jax/API.md:396-421).

Per-anti-diagonal vectorization with token-grouped log-semiring matmuls:
each diagonal costs ~(#distinct tokens) dense (W, S) x (S, S) products,
so an S=64, 200x200 pair runs in seconds — fast enough to gate every
bench invocation on a subsample of the batch.
"""

import numpy as np

NEG_INF = -1e30


def _lse_matmul(f, m):
    """Log-semiring (N, S) x (S, S') -> (N, S'), float64 via max-shifted
    probability-space matmul (values >700 nats below the row max underflow;
    far beyond any tolerance this oracle gates)."""
    fm = f.max(axis=1, keepdims=True)
    fs = np.where(fm > NEG_INF / 2, fm, 0.0)
    mm = m.max(axis=0, keepdims=True)
    ms = np.where(mm > NEG_INF / 2, mm, 0.0)
    p = np.exp(f - fs) @ np.exp(m - ms)
    with np.errstate(divide="ignore"):
        out = np.where(p > 0, np.log(np.maximum(p, 1e-300)) + fs + ms,
                       NEG_INF)
    return out


def forward_2d_f64(a_diag, a_left, a_up, closure, in_toks, out_toks):
    """Forward log-likelihood of one (in_toks, out_toks) pair, float64.

    Tensors are log-space: a_diag (Ti, To, S, S), a_left (Ti, S, S),
    a_up (To, S, S), closure (S, S) — exactly lowering.matrices_2d's
    output. Token arrays are 0-based (no epsilon slot). Recurrence matches
    the device wavefront: cell(i,o) = C^T (D^T diag + L^T left + U^T up),
    start cell = closure row 0, readout = cell(Li, Lo)[S-1]."""
    ad = np.asarray(a_diag, np.float64)
    al = np.asarray(a_left, np.float64)
    au = np.asarray(a_up, np.float64)
    cl = np.asarray(closure, np.float64)
    S = cl.shape[0]
    x = np.asarray(in_toks, np.int64)
    y = np.asarray(out_toks, np.int64)
    Li, Lo = len(x), len(y)

    # rows indexed by i; three live diagonals
    prev2 = np.full((Li + 1, S), NEG_INF)
    prev1 = np.full((Li + 1, S), NEG_INF)
    prev1[0] = cl[0]                       # cell (0,0) = e_0^T C
    if Li == 0 and Lo == 0:
        return float(prev1[0, S - 1])
    for d in range(1, Li + Lo + 1):
        i_lo, i_hi = max(0, d - Lo), min(Li, d)
        idx = np.arange(i_lo, i_hi + 1)
        pre = np.full((len(idx), S), NEG_INF)
        o_arr = d - idx
        # up: (i, o-1) -> (i, o), consumes y[o-1]
        up_ok = o_arr >= 1
        if up_ok.any():
            ys = y[o_arr[up_ok] - 1]
            src = prev1[idx[up_ok]]
            for t in np.unique(ys):
                m = ys == t
                pre_rows = _lse_matmul(src[m], au[t])
                sel = np.where(up_ok)[0][m]
                pre[sel] = np.logaddexp(pre[sel], pre_rows)
        # left: (i-1, o) -> (i, o), consumes x[i-1]
        lf_ok = idx >= 1
        if lf_ok.any():
            xs = x[idx[lf_ok] - 1]
            src = prev1[idx[lf_ok] - 1]
            for t in np.unique(xs):
                m = xs == t
                pre_rows = _lse_matmul(src[m], al[t])
                sel = np.where(lf_ok)[0][m]
                pre[sel] = np.logaddexp(pre[sel], pre_rows)
        # diag: (i-1, o-1) -> (i, o), consumes x[i-1] and y[o-1]
        dg_ok = (idx >= 1) & (o_arr >= 1)
        if dg_ok.any() and np.max(ad) > NEG_INF / 2:
            xs = x[idx[dg_ok] - 1]
            ys = y[o_arr[dg_ok] - 1]
            src = prev2[idx[dg_ok] - 1]
            pair = xs * ad.shape[1] + ys
            for t in np.unique(pair):
                m = pair == t
                mat = ad[t // ad.shape[1], t % ad.shape[1]]
                if np.max(mat) <= NEG_INF / 2:
                    continue
                pre_rows = _lse_matmul(src[m], mat)
                sel = np.where(dg_ok)[0][m]
                pre[sel] = np.logaddexp(pre[sel], pre_rows)
        cur_rows = _lse_matmul(pre, cl)
        prev2 = prev1
        prev1 = np.full((Li + 1, S), NEG_INF)
        prev1[idx] = cur_rows
    return float(prev1[Li, S - 1])


def _maxplus_matmul(f, m):
    """Max-plus (N, S) x (S, S') -> (N, S'), float64."""
    return (f[:, :, None] + m[None, :, :]).max(axis=1)


def viterbi_2d_f64(a_diag, a_left, a_up, closure, in_toks, out_toks):
    """Viterbi (max-plus) score of one pair, float64.

    Same recurrence/layout as forward_2d_f64 with (max, +) in place of
    (logsumexp, +); `closure` must be the MAX-PLUS silent closure
    (lowering.matrices_2d("maxplus")). Gates the device Viterbi kernel
    (ops/pallas/viterbi_kernel.py) in bench.py."""
    ad = np.asarray(a_diag, np.float64)
    al = np.asarray(a_left, np.float64)
    au = np.asarray(a_up, np.float64)
    cl = np.asarray(closure, np.float64)
    S = cl.shape[0]
    x = np.asarray(in_toks, np.int64)
    y = np.asarray(out_toks, np.int64)
    Li, Lo = len(x), len(y)

    prev2 = np.full((Li + 1, S), NEG_INF)
    prev1 = np.full((Li + 1, S), NEG_INF)
    prev1[0] = cl[0]
    if Li == 0 and Lo == 0:
        return float(prev1[0, S - 1])
    for d in range(1, Li + Lo + 1):
        i_lo, i_hi = max(0, d - Lo), min(Li, d)
        idx = np.arange(i_lo, i_hi + 1)
        pre = np.full((len(idx), S), NEG_INF)
        o_arr = d - idx
        up_ok = o_arr >= 1
        if up_ok.any():
            ys = y[o_arr[up_ok] - 1]
            src = prev1[idx[up_ok]]
            for t in np.unique(ys):
                m = ys == t
                rows = _maxplus_matmul(src[m], au[t])
                sel = np.where(up_ok)[0][m]
                pre[sel] = np.maximum(pre[sel], rows)
        lf_ok = idx >= 1
        if lf_ok.any():
            xs = x[idx[lf_ok] - 1]
            src = prev1[idx[lf_ok] - 1]
            for t in np.unique(xs):
                m = xs == t
                rows = _maxplus_matmul(src[m], al[t])
                sel = np.where(lf_ok)[0][m]
                pre[sel] = np.maximum(pre[sel], rows)
        dg_ok = (idx >= 1) & (o_arr >= 1)
        if dg_ok.any() and np.max(ad) > NEG_INF / 2:
            xs = x[idx[dg_ok] - 1]
            ys = y[o_arr[dg_ok] - 1]
            src = prev2[idx[dg_ok] - 1]
            pair = xs * ad.shape[1] + ys
            for t in np.unique(pair):
                m = pair == t
                mat = ad[t // ad.shape[1], t % ad.shape[1]]
                if np.max(mat) <= NEG_INF / 2:
                    continue
                rows = _maxplus_matmul(src[m], mat)
                sel = np.where(dg_ok)[0][m]
                pre[sel] = np.maximum(pre[sel], rows)
        cur_rows = _maxplus_matmul(pre, cl)
        prev2 = prev1
        prev1 = np.full((Li + 1, S), NEG_INF)
        prev1[idx] = cur_rows
    return float(prev1[Li, S - 1])


def forward_2d_f64_batch(a_diag, a_left, a_up, closure, in_toks, out_toks,
                         in_lens, out_lens):
    """Batched convenience wrapper (loops pairs; oracle use only)."""
    out = []
    for b in range(len(in_lens)):
        out.append(forward_2d_f64(
            a_diag, a_left, a_up, closure,
            np.asarray(in_toks[b])[:int(in_lens[b])],
            np.asarray(out_toks[b])[:int(out_lens[b])]))
    return np.array(out)
