"""Length-sharded DP: the context-parallel axis for WFST scans
(counterpart of machineboss_tpu's parallel/lengthshard.py).

The 1D transfer-matrix formulation is associative, so a sequence can be
sharded along L across devices (SURVEY §2.5): each rank reduces its local
block of (S,S) transfer matrices to a single product, the per-rank
products are all-gathered over the 'len' mesh axis in mesh order (n * S *
S floats, tiny next to the local work), and every rank folds them into
the global product. One collective per forward pass.

The 2D form shards one lattice: each rank owns a band of cells of every
anti-diagonal and passes its last cell to its right neighbour each
diagonal.
"""

import torch
import torch.distributed as dist

from ..ops.semiring import LOGSUMEXP
from .mesh import MeshAxis, mesh_device


def _local_product(mats, sr):
    """Reduce (Lk, S, S) to a single product by log-depth pairwise matmuls
    (an odd level carries its last matrix up, as the JAX function does)."""
    while mats.shape[0] > 1:
        half = mats.shape[0] // 2
        paired = sr.matmul(mats[0:2 * half:2], mats[1:2 * half:2])
        if mats.shape[0] % 2:
            paired = torch.cat([paired, mats[-1:]], dim=0)
        mats = paired
    return mats[0]


def _start_vector(S, closure, sr):
    e0 = torch.full((S,), sr.zero, dtype=closure.dtype, device=closure.device)
    e0[0] = sr.one
    return sr.vecmat(e0, closure)


def length_sharded_forward_fn(mesh, sr=LOGSUMEXP, axis="len"):
    """Build fn(trans, closure, toks, length) -> final state vector (S,),
    replicated, with toks (L,) split along `axis` of the mesh (L divisible
    by its size; every rank passes the whole sequence). trans (n_tok, S,
    S) and closure (S, S) are replicated. Positions at or past `length`
    are the semiring identity."""
    ax = MeshAxis(mesh, axis)
    dev = mesh_device(mesh)

    def fn(trans, closure, toks, length):
        trans = torch.as_tensor(trans, device=dev)
        closure = torch.as_tensor(closure, device=dev)
        toks = torch.as_tensor(toks, device=dev).long()
        L = toks.shape[0]
        if L % ax.size:
            raise ValueError("a sequence of %d does not split over %d "
                             "'%s' shards" % (L, ax.size, axis))
        local_l = L // ax.size
        S = trans.shape[-1]
        eye = torch.full((S, S), sr.zero, dtype=trans.dtype, device=dev)
        eye.fill_diagonal_(sr.one)
        pos = ax.index * local_l + torch.arange(local_l, device=dev)
        mats = torch.where((pos < torch.as_tensor(length, device=dev))
                           [:, None, None], trans[toks[ax.block(L)]],
                           eye[None])
        local_prod = _local_product(mats, sr)                 # (S, S)
        # gather every shard's product (n*S*S floats) and finish the global
        # product redundantly on every rank: cheaper than a second
        # collective for the tiny (S,S) carries
        tail = _local_product(ax.all_gather(local_prod), sr)
        return sr.vecmat(_start_vector(S, closure, sr), tail)

    return fn


# ------------------------------------------------------------- 2D lattice

def diag_sharded_wavefront_fn(mesh, sr=LOGSUMEXP, axis="len"):
    """Length-shard a SINGLE 2D lattice across ranks: each rank owns a
    contiguous band of Wl = ceil((Li+1)/n) cell indices i along every
    anti-diagonal (SURVEY §2.5's 2D deliverable: pairwise alignments too
    long for one device). Per diagonal step each rank computes its band
    and passes ONE boundary cell (B, 1, S) to its right neighbour (an
    all_gather on the axis, each rank taking its left neighbour's); the
    d-2 boundary needed by the diagonal move is last step's received d-1
    boundary, so the exchange stays one per step. The owner of a pair's
    (il, ol) cell writes its result and a MAX all_reduce combines the
    ranks.

    Returns fn(a_diag, a_left, a_up, closure, in_toks (B, Li), out_toks
    (B, Lo), in_lens, out_lens) -> (B,) log-likelihoods, all inputs
    replicated (the sharding is over the lattice, not the batch)."""
    from ..ops.wavefront import _select_tokens

    ax = MeshAxis(mesh, axis)
    n, idx = ax.size, ax.index
    dev = mesh_device(mesh)

    def fn(a_diag, a_left, a_up, closure, in_toks, out_toks, in_lens,
           out_lens):
        a_diag, a_left, a_up, closure, in_toks, out_toks, in_lens, \
            out_lens = (torch.as_tensor(x, device=dev) for x in (
                a_diag, a_left, a_up, closure, in_toks, out_toks, in_lens,
                out_lens))
        Ti, To, S, _ = a_diag.shape
        B, Li = in_toks.shape
        Lo = out_toks.shape[1]
        dtype = closure.dtype
        W = Li + 1
        Wl = -(-W // n)
        start = idx * Wl
        # each class's matrices (and the closure) made ready for products
        # once: ops/wavefront._class_term's products without re-preparing
        # them every diagonal
        preps = [sr.prepare(m) if m.shape[0] else None
                 for m in (a_left, a_up, a_diag.reshape(Ti * To, S, S))]
        closure_prep = sr.prepare(closure)

        def class_term(src, k, tok):
            if preps[k] is None:         # a class without tokens
                return torch.full_like(src, sr.zero)
            y = sr.matmul_prepared(src.reshape(1, B * Wl, S), preps[k])
            return _select_tokens(y.reshape(-1, B, Wl, S), tok)

        x_tok_g = torch.zeros((B, n * Wl), dtype=torch.long, device=dev)
        x_tok_g[:, 1:W] = in_toks.long()
        x_tok = x_tok_g[:, start:start + Wl]
        x_pair = x_tok * To

        # the band's cells i have o = d - i: at diagonal d they read a
        # window of rows over o, descending, made once (a view a diagonal)
        o_hi = Li + Lo - start
        o_desc = torch.arange(o_hi, o_hi - (Li + Lo + Wl), -1, device=dev)
        y_desc = out_toks.long()[:, torch.clamp(o_desc - 1, 0, Lo - 1)] \
            if Lo else torch.zeros((B, len(o_desc)), dtype=torch.long,
                                   device=dev)
        o_ok = (o_desc >= 0) & (o_desc <= Lo)
        in_band = start + torch.arange(Wl, device=dev) <= Li    # (Wl,)

        b_idx = torch.arange(B, device=dev)
        il = in_lens.long()
        owns = (il >= start) & (il < start + Wl)               # (B,)
        il_loc = torch.clamp(il - start, 0, Wl - 1)
        d_final = (in_lens + out_lens).long()
        ends = set(d_final.tolist())     # the diagonals a pair ends on
        zero = torch.tensor(sr.zero, dtype=dtype, device=dev)
        zero_cell = torch.full((B, 1, S), sr.zero, dtype=dtype, device=dev)

        d0 = torch.full((B, Wl, S), sr.zero, dtype=dtype, device=dev)
        if start == 0:
            d0[:, 0] = _start_vector(S, closure, sr)
        res = torch.where((d_final == 0) & owns, d0[b_idx, il_loc, S - 1],
                          zero)
        prev1, prev2 = d0, torch.full_like(d0, sr.zero)
        recv_prev = zero_cell
        for d in range(1, Li + Lo + 1):
            # right-shift the boundary cell along the mesh axis; rank 0
            # has no left neighbour and takes the semiring zero (0 is log 1)
            cells = ax.all_gather(prev1[:, -1:])              # (n, B, 1, S)
            recv_cur = cells[idx - 1] if idx else zero_cell
            p0 = Li + Lo - d                  # o_desc[p0] = d - start
            y_tok = y_desc[:, p0:p0 + Wl]
            left_src = torch.cat([recv_cur, prev1[:, :-1]], dim=1)
            left = class_term(left_src, 0, x_tok)
            up = class_term(prev1, 1, y_tok)
            diag_src = torch.cat([recv_prev, prev2[:, :-1]], dim=1)
            dg = class_term(diag_src, 2, x_pair + y_tok)
            u = sr.add(sr.add(left, up), dg)
            cur = sr.vecmat_prepared(u.reshape(B * Wl, S), closure_prep) \
                .reshape(B, Wl, S)
            valid = o_ok[p0:p0 + Wl] & in_band
            cur = torch.where(valid[None, :, None], cur, zero)
            if d in ends:
                res = torch.where((d == d_final) & owns,
                                  cur[b_idx, il_loc, S - 1], res)
            prev1, prev2, recv_prev = cur, prev1, recv_cur
        return ax.all_reduce(res, op=dist.ReduceOp.MAX)

    return fn
