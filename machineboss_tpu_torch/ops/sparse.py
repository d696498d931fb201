"""Sparse (COO) DP for machines too large to densify, on torch.

Counterpart of machineboss_tpu's ops/sparse.py, with the same functions,
token conventions (1-based token lists, 0 the empty side) and results.
Dense (S,S) transfer products scale as S^2 a cell; profile HMMs and large
compositions are sparse (constant out-degree), so this engine keeps the
transitions as COO edge arrays and updates cells with segment reductions
(a max scatter, then an exp-sum scatter), O(E) a cell.

The JAX engine unrolls a Python loop over every cell, and a loop over the
silent layers of each, into one compiled program. Run eagerly, that would
be some 100 small launches a cell. This engine is designed for launches
instead:

  - the lattice is walked by anti-diagonals: a cell's three neighbours lie
    on the two diagonals before it, so every cell of a diagonal is computed
    by the same few calls. A diagonal gathers each cell's class tables by
    its tokens (each (in, out) token class padded to the largest class's
    edge count, padding edges of weight NEG_INF into a dummy segment S that
    is dropped), reduces the products into the segments
    cell * (S+1) + dst, then applies the silent closure to the whole
    diagonal. The 1D forms are the same walk with one side empty, a
    position a step;
  - the silent transitions are applied as their closure, one edge set from
    each state to every state its silent paths reach (identity included),
    computed once on the host in float64 (sum or max over paths), where
    the JAX engine propagates the layers of the silent DAG one by one: one
    segment reduction a diagonal instead of one per layer (129 layers on a
    128-node Plan7 profile).

Backward runs the same walk on the reversed problem: sequences reversed,
edges traversed dst -> src, the end state as the start. Only the last three
diagonals are kept (a ring), so memory is O(min(Li, Lo) * S).

On the card the five token call forms (forward_2d_sparse,
forward_1d_sparse, backward_1d_sparse, backward_2d_sparse,
viterbi_2d_sparse) are one launch of the hand-written walk,
ops/kernels/sparse_kernel.sparse_walk (csrc/sparse_walk.cu); this eager
walk is its plain version and the CPU route. The PSWM forms walk eagerly
on both.
"""

import numpy as np
import torch

from .semiring import NEG_INF
from ..utils.device import resolve_device


def segment_max(values, segment_ids, num_segments):
    """Max of `values` into segments; -inf for an empty segment, as
    jax.ops.segment_max gives."""
    out = torch.full((num_segments,), -float("inf"), dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, segment_ids, values, "amax",
                               include_self=True)


def segment_logsumexp(values, segment_ids, num_segments):
    """Scatter-logsumexp of values into segments (NEG_INF for a segment
    without mass; no log(0) and no inf - inf reaches the result)."""
    seg_max = segment_max(values, segment_ids, num_segments)
    safe = torch.where(seg_max > NEG_INF / 2, seg_max, 0.0)
    shifted = torch.exp(values - safe[segment_ids])
    sums = torch.zeros_like(seg_max).index_add_(0, segment_ids, shifted)
    pos = sums > 0
    return torch.where(pos, torch.log(torch.where(pos, sums, 1.0)) + safe,
                       NEG_INF)


def _segment_combine(viterbi):
    return segment_max if viterbi else segment_logsumexp


def _silent_closure(n_states, silent, viterbi):
    """(src, dst, log weight) of the silent closure: for each state, every
    state its silent paths reach (itself with weight 0), the weight summed
    (Forward) or maximised (Viterbi) over the paths, in float64. Raises
    ValueError on a silent cycle."""
    out_edges = [[] for _ in range(n_states)]
    indeg = np.zeros(n_states, np.int64)
    if silent is not None:
        src, dst, _, lw = silent
        for s, d, w in zip(src, dst, lw):
            if np.isfinite(w):
                out_edges[s].append((int(d), float(w)))
                indeg[d] += 1
    order = [s for s in range(n_states) if indeg[s] == 0]
    for s in order:                     # Kahn: appends while iterating
        for d, _ in out_edges[s]:
            indeg[d] -= 1
            if indeg[d] == 0:
                order.append(d)
    if len(order) != n_states:
        raise ValueError("the machine's silent transitions form a cycle")
    rows = {}
    for s in reversed(order):
        idx = [np.array([s])]
        val = [np.array([0.0])]
        for d, w in out_edges[s]:
            idx.append(rows[d][0])
            val.append(rows[d][1] + w)
        idx = np.concatenate(idx)
        val = np.concatenate(val)
        uniq, inv = np.unique(idx, return_inverse=True)
        top = np.full(len(uniq), -np.inf)
        np.maximum.at(top, inv, val)
        if not viterbi:
            tot = np.zeros(len(uniq))
            np.add.at(tot, inv, np.exp(val - top[inv]))
            top = top + np.log(tot)
        rows[s] = (uniq, top)
    src = np.concatenate([np.full(len(rows[s][0]), s) for s in
                          range(n_states)]) if n_states else np.zeros(0)
    dst = np.concatenate([rows[s][0] for s in range(n_states)]) \
        if n_states else np.zeros(0)
    w = np.concatenate([rows[s][1] for s in range(n_states)]) \
        if n_states else np.zeros(0)
    return src.astype(np.int64), dst.astype(np.int64), w


class SparseMachine:
    """COO lowering of an EvaluatedMachine, its tables on `device` (None:
    the CUDA card, raising when CUDA is absent; "cpu" for the CPU).

    `classes` maps each (in token, out token) class, 1-based with 0 the
    empty side, to host arrays (src, dst, log weight), as in the JAX
    package; `closure(viterbi)` is the silent closure's edge set."""

    def __init__(self, ev, dtype=np.float32, device=None):
        self.device = resolve_device(device)
        self.ev = ev
        self.dtype = dtype
        self.n_states = S = ev.n_states()
        self.n_in = ev.input_tokenizer.n_tokens()
        self.n_out = ev.output_tokenizer.n_tokens()
        edges = ev.edges_by_token()
        self.classes = {}
        for (i, o), (src, dst, _, lw) in edges.items():
            lw = np.where(np.isfinite(lw), lw, NEG_INF).astype(dtype)
            self.classes[(i, o)] = (src, dst, lw)
        self._silent = edges.get((0, 0))
        self._cache = {}

        # every emitting class padded to the largest one's edge count (a
        # padding edge gathers state 0 and scatters into the dummy segment
        # S); the last row is the empty class (absent keys, bad tokens)
        keys = sorted(k for k in self.classes if k != (0, 0))
        e_max = max([len(self.classes[k][0]) for k in keys] + [1])
        n = len(keys)
        ends = np.zeros((2, 2, n + 1, e_max), np.int64)   # src/dst, g/s
        ends[:, 1] = S
        w = np.full((n + 1, e_max), NEG_INF, np.float64)
        self.class_index = np.full((self.n_in, self.n_out), n, np.int64)
        for c, k in enumerate(keys):
            s, d, lw = self.classes[k]
            ends[0, :, c, :len(s)] = s
            ends[1, :, c, :len(s)] = d
            w[c, :len(s)] = lw
            self.class_index[k] = c
        src_g, src_s, dst_g, dst_s, w = self._upload(
            ends[0, 0], ends[0, 1], ends[1, 0], ends[1, 1], w)
        # (gather, scatter, weight) for Forward and for Backward
        self._tables = {False: (src_g, dst_s, w), True: (dst_g, src_s, w)}

    def _upload(self, *arrays):
        out = []
        for a in arrays:
            if a.dtype.kind == "f":
                out.append(torch.as_tensor(np.maximum(a, NEG_INF).astype(
                    self.dtype), device=self.device))
            else:
                out.append(torch.as_tensor(a, device=self.device))
        return tuple(out)

    def closure(self, viterbi=False):
        """(src, dst, log weight) tensors of the silent closure in the
        Forward (sum) or Viterbi (max) semiring."""
        key = ("closure", viterbi)
        if key not in self._cache:
            self._cache[key] = self._upload(*_silent_closure(
                self.n_states, self._silent, viterbi))
        return self._cache[key]

    def pswm_edges(self, n_in, n_out):
        """The edges a PSWM cell mixes, (neighbour, src, dst, log weight,
        input column, output column): from the diag neighbour (0) every
        class (ti, to), 1 <= ti <= n_in and 1 <= to <= n_out; from the left
        one (1) every (t, 0) and the identity, the input's epsilon skip;
        from the up one (2) every (0, t) and the identity. A column is
        1 + the profile's column on that tape, 0 where the edge takes no
        weight from it."""
        key = ("pswm", n_in, n_out)
        if key not in self._cache:
            S = self.n_states
            eye = np.arange(S)
            parts = [(np.full(S, k), eye, eye, np.zeros(S), np.full(S, ic),
                      np.full(S, oc)) for k, ic, oc in ((1, 1, 0), (2, 0, 1))]
            for (ti, to), (src, dst, lw) in sorted(self.classes.items()):
                k = 0 if ti and to else 1 if ti else 2
                if (ti or to) and ti <= n_in and to <= n_out:
                    parts.append((np.full(len(src), k), src, dst, lw,
                                  np.full(len(src), ti + 1 if ti else 0),
                                  np.full(len(src), to + 1 if to else 0)))
            self._cache[key] = self._upload(*(
                np.concatenate([p[j] for p in parts]).astype(
                    np.float64 if j == 3 else np.int64) for j in range(6)))
        return self._cache[key]

    def apply_silent(self, cell, viterbi=False):
        """The silent closure applied to cells (..., S)."""
        return _apply_closure(cell, self.closure(viterbi), viterbi, False)

    def class_contrib(self, prev_cell, key, viterbi=False):
        """prev_cell (S,) through the class `key`'s edges, (S,)."""
        S = self.n_states
        if key not in self.classes:
            return torch.full((S,), NEG_INF, dtype=prev_cell.dtype,
                              device=prev_cell.device)
        src, dst, lw = self._upload(*self.classes[key])
        return _segment_combine(viterbi)(prev_cell[src] + lw, dst, S)


class SparseMachineRev:
    """Reverse-direction views for Backward fills (edges traversed
    dst -> src; the closure transposed)."""

    def __init__(self, sm):
        self.sm = sm
        self.n_states = sm.n_states

    def class_contrib(self, next_cell, key, viterbi=False):
        S = self.n_states
        if key not in self.sm.classes:
            return torch.full((S,), NEG_INF, dtype=next_cell.dtype,
                              device=next_cell.device)
        src, dst, lw = self.sm._upload(*self.sm.classes[key])
        return _segment_combine(viterbi)(next_cell[dst] + lw, src, S)

    def apply_silent(self, cell, viterbi=False):
        return _apply_closure(cell, self.sm.closure(viterbi), viterbi, True)


def _apply_closure(cell, closure, viterbi, reverse):
    """cell (..., S) through the closure edges (dst <- src, or src <- dst
    when reverse)."""
    src, dst, w = closure
    if reverse:
        src, dst = dst, src
    S = cell.shape[-1]
    flat = cell.reshape(-1, S)
    n = flat.shape[0]
    seg = (torch.arange(n, device=cell.device) * S)[:, None] + dst
    out = _segment_combine(viterbi)((flat[:, src] + w).reshape(-1),
                                    seg.reshape(-1), n * S)
    return out.reshape(cell.shape)


# ----------------------------------------------------------- the walk

def _diagonals(Li, Lo):
    """Host plan of the anti-diagonal walk over the (Li+1) x (Lo+1)
    lattice: per cell in walk order its (i, o), and the ring indices of its
    diag, left and up neighbours (3W, a NEG_INF row, where it has none);
    per diagonal its first cell and its width. The ring holds three
    diagonals of W = min(Li, Lo) + 1 cells."""
    W = min(Li, Lo) + 1
    n_diag = Li + Lo + 1
    d = np.arange(n_diag)
    lo = np.maximum(0, d - Lo)
    nd = np.minimum(d, Li) - lo + 1
    first = np.concatenate([[0], np.cumsum(nd)])
    cell_d = np.repeat(d, nd)
    i = np.arange(first[-1]) - first[cell_d] + lo[cell_d]
    o = cell_d - i

    def ring(ii, oo, ok):
        dd = ii + oo
        idx = (dd % 3) * W + ii - np.maximum(0, dd - Lo)
        return np.where(ok, idx, 3 * W)

    nb = np.stack([ring(i - 1, o - 1, (i >= 1) & (o >= 1)),
                   ring(i - 1, o, i >= 1),
                   ring(i, o - 1, o >= 1)], axis=1)
    return i, o, nb, first, nd, W


def _walk(sm, plan, viterbi, reverse, contrib):
    """Fill the lattice of `plan` (_diagonals) diagonal by diagonal and
    return the last cell's score at the end state (at the start state for
    Backward).

    contrib(a, n, nb, ring) -> (values (n, E), dst (n, E) or (1, E)) gives
    the emitting transitions into the n cells from cell a on, from their
    neighbours' post-closure values (rows nb (n, 3) of `ring`)."""
    S = sm.n_states
    dev = sm.device
    dtype = sm._tables[False][2].dtype
    _, _, nb, first, nd, W = plan
    nb = torch.as_tensor(nb, device=dev)
    ring = torch.full((3 * W + 1, S), NEG_INF, dtype=dtype, device=dev)
    base = torch.arange(W, device=dev)[:, None] * (S + 1)
    seg = _segment_combine(viterbi)
    pre = torch.full((1, S), NEG_INF, dtype=dtype, device=dev)
    pre[0, S - 1 if reverse else 0] = 0.0
    closure = sm.closure(viterbi)
    for d in range(len(nd)):
        a, n = int(first[d]), int(nd[d])
        if d:
            vals, dst = contrib(a, n, nb[a:a + n], ring)
            ids = (base[:n] + dst).reshape(-1)
            pre = seg(vals.reshape(-1), ids, n * (S + 1)).view(
                n, S + 1)[:, :S]
        post = _apply_closure(pre, closure, viterbi, reverse)
        ring[(d % 3) * W:(d % 3) * W + n] = post
    return float(post[0, 0 if reverse else S - 1])


def _token_walk(sm, in_toks, out_toks, viterbi, reverse):
    """Walk for 1-based token lists (0 = no token): each cell's three class
    tables gathered by its tokens."""
    g, s, w = sm._tables[reverse]
    it = np.asarray(in_toks, np.int64).reshape(-1)
    ot = np.asarray(out_toks, np.int64).reshape(-1)
    if reverse:
        it, ot = it[::-1], ot[::-1]
    plan = _diagonals(len(it), len(ot))
    n_i, n_o = sm.class_index.shape
    empty = sm.class_index[0, 0]

    def cls(a, b):
        ok = (a >= 0) & (a < n_i) & (b >= 0) & (b < n_o)
        return np.where(ok, sm.class_index[np.clip(a, 0, n_i - 1),
                                           np.clip(b, 0, n_o - 1)], empty)

    x = np.concatenate([[0], it])[plan[0]]   # the token consumed into cell i
    y = np.concatenate([[0], ot])[plan[1]]
    cell_cls = torch.as_tensor(np.stack([cls(x, y), cls(x, 0 * y),
                                         cls(0 * x, y)], axis=1),
                               device=sm.device)

    def contrib(a, n, nb, ring):
        c = cell_cls[a:a + n]                                # (n, 3)
        vals = ring[nb[:, :, None], g[c]] + w[c]             # (n, 3, E)
        return vals.reshape(n, -1), s[c].reshape(n, -1)

    return _walk(sm, plan, viterbi, reverse, contrib)


def _pswm_walk(sm, in_pswm, out_pswm, viterbi, reverse):
    """Walk for PSWM profiles on both tapes ((L, T+1) log weights, column 0
    the epsilon skip): up and left mix the tape's tokens and its skip,
    diag both tapes' tokens."""
    dev = sm.device
    dtype = sm._tables[False][2].dtype

    def profile(p):
        p = torch.as_tensor(p, device=dev).to(dtype)
        L = int(p.shape[0])
        p = p.reshape(L, -1) if L else p.new_zeros((0, 1))
        if reverse:
            p = p.flip(0)
        # column 0 for an edge that takes no weight from this tape, and a
        # last row, which a cell without the neighbour indexes harmlessly
        p = torch.cat([p.new_zeros((L, 1)), p], 1)
        return torch.cat([p, p.new_zeros((1, p.shape[1]))]), L, \
            p.shape[1] - 2

    in_p, Li, Ti = profile(in_pswm)
    out_p, Lo, To = profile(out_pswm)
    plan = _diagonals(Li, Lo)
    ci = torch.as_tensor(plan[0], device=dev)
    co = torch.as_tensor(plan[1], device=dev)
    nbk, src, dst, w, icol, ocol = sm.pswm_edges(Ti, To)
    g, s = (dst, src) if reverse else (src, dst)

    def contrib(a, n, nb, ring):
        ip = (ci[a:a + n] - 1).clamp(min=0)[:, None]
        op = (co[a:a + n] - 1).clamp(min=0)[:, None]
        vals = ring[nb[:, nbk], g] + w + in_p[ip, icol] + out_p[op, ocol]
        return vals, s[None]

    return _walk(sm, plan, viterbi, reverse, contrib)


# ----------------------------------------------------------- the API

def _token_call(sm, in_toks, out_toks, viterbi, reverse):
    """One pair's token walk through sparse_kernel.sparse_walk: one kernel
    launch on the card, the eager walk on the CPU; a float."""
    from .kernels.sparse_kernel import sparse_walk
    it = np.asarray(in_toks, np.int64).reshape(1, -1)
    ot = np.asarray(out_toks, np.int64).reshape(1, -1)
    return float(sparse_walk(sm, it, ot, [it.shape[1]], [ot.shape[1]],
                             viterbi, reverse)[0])


def forward_2d_sparse(sm: SparseMachine, in_toks, out_toks):
    """Sparse 2D Forward; in_toks/out_toks are 1-based token id lists
    (host ints). Returns the final log-likelihood (a float)."""
    return _token_call(sm, in_toks, out_toks, False, False)


def forward_1d_sparse(sm: SparseMachine, toks, output_side=True,
                      viterbi=False):
    """Sparse 1D Forward/Viterbi for a generator (output_side=True) or
    recognizer; toks are 1-based token ids (host ints)."""
    empty = []
    return _token_call(sm, empty if output_side else toks,
                       toks if output_side else empty, viterbi, False)


def backward_1d_sparse(sm: SparseMachine, toks, output_side=True,
                       viterbi=False):
    """Sparse 1D Backward: fill from the end state; returns the same total
    as Forward."""
    empty = []
    return _token_call(sm, empty if output_side else toks,
                       toks if output_side else empty, viterbi, True)


def backward_2d_sparse(sm: SparseMachine, in_toks, out_toks, viterbi=False):
    """Sparse 2D Backward fill (reverse traversal); returns the total
    log-likelihood (cell (0,0), start state)."""
    return _token_call(sm, in_toks, out_toks, viterbi, True)


def viterbi_2d_sparse(sm: SparseMachine, in_toks, out_toks):
    """Sparse 2D Viterbi (max-plus) via the Backward fill."""
    return backward_2d_sparse(sm, in_toks, out_toks, viterbi=True)


# PSWM (profile) inputs x sparse machines: a PSWM row is (n_tok+1,) log
# weights, column 0 the epsilon skip; a position's contribution is the
# weight-mixed combination of the token-conditioned classes plus the
# identity skip, the sparse analog of ops/pswm.pswm_transfer_matrices.

def _no_profile():
    return np.zeros((0, 1), np.float32)


def forward_1d_sparse_pswm(sm: SparseMachine, pswm, output_side=True,
                           viterbi=False):
    """Sparse 1D Forward/Viterbi over a PSWM profile ((L, n_tok+1) log
    weights, col 0 = eps). One-hot rows reduce exactly to
    forward_1d_sparse on the corresponding token sequence."""
    pswm = np.asarray(pswm)
    return _pswm_walk(sm, _no_profile() if output_side else pswm,
                      pswm if output_side else _no_profile(), viterbi, False)


def backward_1d_sparse_pswm(sm: SparseMachine, pswm, output_side=True,
                            viterbi=False):
    """Sparse 1D Backward over a PSWM profile (reverse traversal); total
    equals Forward."""
    pswm = np.asarray(pswm)
    return _pswm_walk(sm, _no_profile() if output_side else pswm,
                      pswm if output_side else _no_profile(), viterbi, True)


def forward_2d_sparse_pswm(sm: SparseMachine, in_pswm, out_pswm,
                           viterbi=False):
    """Sparse 2D Forward/Viterbi with PSWM profiles on both tapes.

    in_pswm: (Li, Ti+1) log weights; out_pswm: (Lo, To+1); col 0 = eps
    skip on that tape (as ops/pswm.forward_2d_pswm: left/up mixes include
    the eps-identity, the diag mix does not)."""
    return _pswm_walk(sm, in_pswm, out_pswm, viterbi, False)


def backward_2d_sparse_pswm(sm: SparseMachine, in_pswm, out_pswm,
                            viterbi=False):
    """Sparse 2D Backward with PSWM profiles on both tapes (reverse
    traversal; total equals forward_2d_sparse_pswm)."""
    return _pswm_walk(sm, in_pswm, out_pswm, viterbi, True)
