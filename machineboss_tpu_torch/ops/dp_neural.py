"""Neural / parameterized DP: position-dependent transition weights,
differentiable end-to-end.

Counterpart of machineboss_tpu's ops/dp_neural.py. The caller supplies
per-parameter tensors (Python numbers or tensors broadcastable to
(Li+1, Lo+1); indices are clamped, so (1,1) or (Li+1,1) shapes work).
Every DP cell (i, o) evaluates its transition weights at that cell's
coordinates; torch.autograd through the whole DP trains whatever network
produced the parameter tensors (neural transducer training).

The silent closure. A cell's value is its incoming mass times
I + N + N^2 + ... + N^n, where N is the cell's silent (epsilon, epsilon)
matrix and n = n_silent_iters: each of the n steps propagates only the
newest increment (d <- d N; c <- c + d). None means n = S, which is exact
for any acyclic silent graph (its paths have at most S - 1 edges), so the
score is the host Forward's (algo/dp_host.ForwardMatrix). The JAX package
iterates c <- c + c N instead, which computes c (I + N)^n and counts a
silent path of length j C(n, j) times; on a machine with silent
transitions (dnapsw) its score is tens of nats above the host's. The port
does not copy that.

Layout. Every cell's four transition matrices (the diagonal, left, up and
silent moves, each chosen by the cell's tokens) are built at once from the
edges' values over the (Li+1, Lo+1) grid, the closure is folded into the
three moving ones over all cells at once (n batched products), and the DP
walks the Li+Lo+1 anti-diagonals with the cells of a diagonal as one
tensor: a few operations a diagonal, not a loop over cells.
"""

import numpy as np
import torch

from .exprjit import ParameterizedMachine, log_of_probs
from .semiring import LOGSUMEXP, NEG_INF


def _grid_params(params, Li, Lo, device):
    """Every parameter at every cell (i, o) of the (Li+1, Lo+1) grid, by
    clamped index: a number stays a number, a 1-D tensor is indexed by i
    ((Li+1, 1)), a 2-D tensor by (i, o)."""
    ii = torch.arange(Li + 1, device=device)
    oo = torch.arange(Lo + 1, device=device)
    out = {}
    for k, v in params.items():
        if isinstance(v, (int, float)):
            out[k] = float(v)
            continue
        v = torch.as_tensor(v, device=device)
        if v.dim() == 0:
            out[k] = v
        elif v.dim() == 1:
            out[k] = v[ii.clamp(max=v.shape[0] - 1)][:, None]
        elif v.dim() == 2:
            out[k] = v[ii.clamp(max=v.shape[0] - 1)][
                :, oo.clamp(max=v.shape[1] - 1)]
        else:
            raise ValueError("parameter %r has %d dimensions; a field has "
                             "at most 2, (Li+1, Lo+1)" % (k, v.dim()))
    return out


def cell_log_matrices(pm, in_toks, out_toks, params, n_silent_iters=None,
                      sr=LOGSUMEXP):
    """(3, Li+1, Lo+1, S, S) log matrices of the diagonal, left and up
    moves into each cell with the cell's silent closure folded in, and
    (S,) the start cell's value."""
    dev = pm.device
    S = pm.n_states
    Li, Lo = len(in_toks), len(out_toks)
    if n_silent_iters is None:
        n_silent_iters = S
    # 0 = epsilon; a token is its 0-based id + 1; cell 0 reads epsilon
    tin = torch.zeros(Li + 1, dtype=torch.long, device=dev)
    tout = torch.zeros(Lo + 1, dtype=torch.long, device=dev)
    tin[1:] = torch.as_tensor(in_toks, dtype=torch.long, device=dev) + 1
    tout[1:] = torch.as_tensor(out_toks, dtype=torch.long, device=dev) + 1
    vals = pm.edge_values(_grid_params(params, Li, Lo, dev))
    E = vals.shape[0]
    vals = vals.reshape((E,) + (1,) * (3 - vals.dim()) + vals.shape[1:])
    vals = vals.expand(E, Li + 1, Lo + 1)
    a = pm.edge_in[:, None, None]
    b = pm.edge_out[:, None, None]
    masks = torch.stack(torch.broadcast_tensors(
        (a == tin[:, None]) & (b == tout[None, :]),        # diagonal
        (a == tin[:, None]) & (b == 0),                    # left
        (a == 0) & (b == tout[None, :]),                   # up
        (a == 0) & (b == 0)))                              # silent
    moved = torch.where(masks, vals, 0.0)                  # (4, E, Li+1, Lo+1)
    C = (Li + 1) * (Lo + 1)
    moved = moved.permute(0, 2, 3, 1).reshape(4 * C, E)
    probs = torch.zeros(4 * C, S * S, dtype=torch.float32, device=dev)
    probs = probs.index_add(1, pm.edge_entry, moved)
    logm = log_of_probs(probs).reshape(4, Li + 1, Lo + 1, S, S)

    eye = torch.eye(S, dtype=torch.bool, device=dev)
    closure = torch.where(eye, sr.one, NEG_INF)            # N^0
    step = closure
    for _ in range(n_silent_iters):
        step = sr.matmul(step, logm[3])
        closure = sr.add(closure, step)
    if closure.dim() == 2:
        closure = closure.expand(Li + 1, Lo + 1, S, S)
    moves = sr.matmul(logm[:3], closure)
    return moves, closure[0, 0, 0]


def neural_log_forward(pm: ParameterizedMachine, in_toks, out_toks, params,
                       n_silent_iters=None, sr=LOGSUMEXP):
    """Forward log-likelihood with position-dependent parameters.

    pm: ParameterizedMachine; in_toks (Li,), out_toks (Lo,) 0-based token
    ids (sequences or tensors); params: dict of numbers / tensors
    broadcastable to (Li+1, Lo+1). Returns a 0-dim float32 tensor on
    pm.device, differentiable in every parameter tensor. sr=MAXPLUS gives
    the Viterbi score."""
    dev = pm.device
    S = pm.n_states
    Li, Lo = len(in_toks), len(out_toks)
    moves, start = cell_log_matrices(pm, in_toks, out_toks, params,
                                     n_silent_iters, sr)
    if Li + Lo == 0:
        return start[S - 1]
    # the cells in anti-diagonal order, i rising within a diagonal
    ii, oo = np.meshgrid(np.arange(Li + 1), np.arange(Lo + 1), indexing="ij")
    d_of = (ii + oo).ravel()
    order = np.lexsort((ii.ravel(), d_of))
    offsets = np.concatenate([[0], np.cumsum(np.bincount(d_of))])
    moves = moves.permute(1, 2, 0, 3, 4).reshape(-1, 3, S, S)
    moves = moves[torch.as_tensor(order, device=dev)]      # (C, 3, S, S)

    # a diagonal is held as (Li+2, S): row i+1 is cell (i, d-i), row 0 and
    # the rows outside the diagonal are log(0), so the cell (i-1, .) of a
    # source diagonal is row i. Its values are held relative to a float64
    # offset (its largest value, not differentiated: the offset cancels),
    # so that float32 rounds them near 0, not at the hundreds of nats a
    # long pair's cells reach.
    neg = torch.full((Li + 2, S), NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    prev2, off2 = neg, zero
    prev1, off1 = torch.cat([neg[:1], start[None], neg[2:]]), zero
    for d in range(1, Li + Lo + 1):
        lo, hi = max(0, d - Lo), min(Li, d)
        shift = (off2 - off1).float()
        src = torch.stack([prev2[lo:hi + 1] + shift,        # (i-1, o-1)
                           prev1[lo:hi + 1],                # (i-1, o)
                           prev1[lo + 1:hi + 2]], dim=1)    # (i, o-1)
        cell = moves[offsets[d]:offsets[d + 1]]            # (n, 3, S, S)
        n = hi - lo + 1
        val = sr.vecmat(src.reshape(n, 3 * S), cell.reshape(n, 3 * S, S))
        top = val.detach().max()
        top = torch.where(top > NEG_INF / 2, top, 0.0)
        prev2, off2 = prev1, off1
        prev1 = torch.cat([neg[:lo + 1], val - top, neg[hi + 2:]])
        off1 = off1 + top.double()
    return (prev1[Li + 1, S - 1] + off1).float()
