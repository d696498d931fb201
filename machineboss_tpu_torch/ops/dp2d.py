"""Pairwise (2D) DP by rows, on torch: the forward half.

Counterpart of machineboss_tpu's ops/dp2d.py. The lattice cell(i, o, s)
combines paths consuming input prefix i and emitting output prefix o,
ending in state s:

  cell(i,o) = [ cell(i-1,o-1) (x) A_diag[x_i, y_o]
              (+) cell(i-1,o) (x) A_left[x_i]
              (+) cell(i,o-1) (x) A_up[y_o] ] (x) C

where C is the silent closure. An outer loop runs over output rows and an
inner sequential scan over input positions (O(Li*Lo*S^2) work). It is the
default fill of algo/viterbi_device.DeviceViterbiMatrix.

Ported: `forward_2d` and `forward_2d_lattice` with the sequential row
solver. The associative row solver (`assoc=True`), `backward_2d_lattice`
and `forward_2d_banded` are not ported yet and raise NotImplementedError.
"""

import torch

from .semiring import LOGSUMEXP


def _e0(S, dtype, sr, device=None):
    v = torch.full((S,), sr.zero, dtype=dtype, device=device)
    v[0] = sr.one
    return v


def _row_scan(u, left_mats, closure, sr):
    """Solve f_i = (u_i (+) f_{i-1} (x) left_mats_i) (x) C for all i.

    u: (Li+1, S) pre-closure contributions; left_mats: (Li+1, S, S) where
    entry 0 is unused. Returns (Li+1, S) post-closure cells."""
    f = sr.vecmat(u[0], closure)
    rows = [f]
    for i in range(1, u.shape[0]):
        f = sr.vecmat(sr.add(u[i], sr.vecmat(f, left_mats[i])), closure)
        rows.append(f)
    return torch.stack(rows, dim=0)


def _row_assoc(u, left_mats, closure, sr):
    raise NotImplementedError(
        "the associative row solver (assoc=True) is not ported yet: "
        "ROADMAP.md queue A, item 3")


def _forward_2d(a_diag, a_left, a_up, closure, in_toks, out_toks, row_solver,
                sr, start_vec=None):
    S = closure.shape[-1]
    Li = in_toks.shape[0]
    dtype, dev = closure.dtype, closure.device
    in_toks = in_toks.long()
    out_toks = out_toks.long()

    # pre-gather per-position matrices
    left_mats = torch.cat(
        [torch.full((1, S, S), sr.zero, dtype=dtype, device=dev),
         a_left[in_toks]], dim=0)

    if start_vec is None:
        start_vec = _e0(S, dtype, sr, dev)
    u0 = torch.full((Li + 1, S), sr.zero, dtype=dtype, device=dev)
    u0[0] = start_vec
    rows = [row_solver(u0, left_mats, closure, sr)]
    for o in range(out_toks.shape[0]):
        prev_row = rows[-1]
        out_tok = out_toks[o]
        u = sr.vecmat(prev_row, a_up[out_tok][None])          # (Li+1, S)
        if Li:
            diag = a_diag[in_toks, out_tok]                   # (Li, S, S)
            u = torch.cat([u[:1], sr.add(u[1:],
                                         sr.vecmat(prev_row[:-1], diag))], 0)
        rows.append(row_solver(u, left_mats, closure, sr))
    return torch.stack(rows, dim=0)                           # (Lo+1, Li+1, S)


def forward_2d(a_diag, a_left, a_up, closure, in_toks, out_toks,
               in_len, out_len, sr=LOGSUMEXP, assoc=False):
    """Log-likelihood (or Viterbi score) of the (in, out) pair."""
    lattice = forward_2d_lattice(a_diag, a_left, a_up, closure, in_toks,
                                 out_toks, sr=sr, assoc=assoc)
    return lattice[out_len, in_len, closure.shape[-1] - 1]


def forward_2d_lattice(a_diag, a_left, a_up, closure, in_toks, out_toks,
                       sr=LOGSUMEXP, assoc=False):
    """The whole lattice, (Lo+1, Li+1, S): output rows first."""
    solver = _row_assoc if assoc else _row_scan
    return _forward_2d(a_diag, a_left, a_up, closure, in_toks, out_toks,
                       solver, sr)


def backward_2d_lattice(*args, **kwargs):
    raise NotImplementedError(
        "backward_2d_lattice is not ported yet: ROADMAP.md queue A, items 3 "
        "and 5")


def forward_2d_banded(*args, **kwargs):
    raise NotImplementedError(
        "forward_2d_banded is not ported yet: ROADMAP.md queue A, item 3")
