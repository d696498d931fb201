"""The plain PyTorch diagonal walk behind the 2D Forward kernels' plain
versions.

The merged, chained, generic and factored wavefronts of
ops/kernels/wavefront_kernel.py and the lowrank wavefront of
ops/kernels/lowrank_kernel.py carry, per pair and cell (i, o) on diagonal
d = i + o, scaled probabilities p with a per-cell log scale m, and differ
only in the class term and a few rules. `walk_plain` is that walk in
float32 torch, one diagonal of the whole batch at a time (slab (B, Li+1, Sa),
cells indexed by i); each plain version passes its class term:

- each present class reads one neighbour: up (i, o-1) by the y token and
  left (i-1, o) by the x token on d-1, diag (i-1, o-1) by the token
  x * To + y on d-2; mu = the max of those neighbours' m (or, with mu_all,
  of all three neighbours' m whichever classes are present), the neighbour
  slab is weighted by exp(m_c - mu), and `term(kind, q, tok)` gives the
  class's (B, W, Sa) contribution from the weighted slab q and the (B, W)
  tokens;
- with `closure_t` (destination x source) the summed terms are multiplied
  by it (the generic and factored kernels' closure product per cell);
- on diagonals with d % rescale_every <= 1 every cell is divided by its max
  over states and the log of the max goes to m; a cell whose max is not
  positive is zeroed (m = NEG_INF). With `diag_offset` (B,) a pair's
  diagonal d is the absolute step d + diag_offset[b] of a chained schedule:
  the rule reads the absolute step, and a pair whose start step is past 0
  has its start cell rescaled too when that step fires;
- the readout at (il, ol) is m + log(p[Sa-1]), or m + log(w . p) with
  `readout_w`;
- m is float32, or `m_dtype` (the lowrank version's float64 scales): the
  weights exp(m_c - mu) are float32 either way, and the scores come back
  in m's type.

`walk_chained` makes a chained schedule's plain version out of a plain
version that takes `diag_offset`.
"""

import torch

NEG_INF = -1e30


def walk_plain(c0, term, kinds, in_toks, out_toks, in_lens, out_lens, To,
               rescale_every=4, readout_w=None, mu_all=False, closure_t=None,
               diag_offset=None, closure_mm=None, m_dtype=torch.float32):
    """(B,) log-likelihoods in m_dtype. c0 (Sa,) is the start cell (0, 0) with
    m = 0; kinds the present classes in order; token and length tensors are
    integer tensors on c0's device. `closure_mm(x, y)`, if given, takes the
    place of x @ y in the closure product. The loop stops at the batch's
    last readout diagonal."""
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    Sa = c0.shape[0]
    W = Li + 1
    dev = c0.device
    f32 = torch.float32
    neg = torch.tensor(NEG_INF, dtype=m_dtype, device=dev)
    i_idx = torch.arange(W, device=dev)
    b_idx = torch.arange(B, device=dev)
    il = in_lens.long()
    dfin = il + out_lens.long()
    x_tok = in_toks.long()[:, torch.clamp(i_idx - 1, 0, max(Li - 1, 0))] \
        if Li else torch.zeros((B, W), dtype=torch.long, device=dev)

    def rescale(cur, m_new, fire, valid):
        """Rescale the cells of the pairs in `fire` ((B,) bool, or None for
        all)."""
        mx = cur.max(dim=-1).values
        has = (mx > 0) & valid
        den = torch.clamp(mx, min=1e-37)
        new_p = torch.where(has[:, :, None], cur / den[:, :, None],
                            torch.zeros_like(cur))
        new_m = torch.where(has, m_new + torch.log(den), neg)
        if fire is None:
            return new_p, new_m
        f = fire[:, None]
        return (torch.where(f[:, :, None], new_p, cur),
                torch.where(f, new_m, m_new))

    p1 = torch.zeros((B, W, Sa), dtype=f32, device=dev)
    p1[:, 0] = c0
    m1 = torch.full((B, W), NEG_INF, dtype=m_dtype, device=dev)
    m1[:, 0] = 0.0
    off = None
    if diag_offset is not None:
        off = diag_offset.long().to(dev)
        start = (off > 0) & (off % rescale_every <= 1)
        if bool(start.any()):
            p0, m0 = rescale(p1[:, :1], m1[:, :1], start,
                             torch.ones((1, 1), dtype=torch.bool, device=dev))
            p1[:, :1], m1[:, :1] = p0, m0
    p2 = torch.zeros_like(p1)
    m2 = torch.full_like(m1, NEG_INF)

    def readout(p, m):
        cell = p[b_idx, il]
        end = (cell * readout_w).sum(dim=-1) if readout_w is not None \
            else cell[:, Sa - 1]
        return torch.where(end > 0, m[b_idx, il]
                           + torch.log(torch.clamp(end, min=1e-37)), neg)

    res = torch.where(dfin == 0, readout(p1, m1), neg)
    zp = torch.zeros((B, 1, Sa), dtype=f32, device=dev)
    zm = torch.full((B, 1), NEG_INF, dtype=m_dtype, device=dev)
    n_diag = int(dfin.max()) if B else 0
    for d in range(1, n_diag + 1):
        o_idx = d - i_idx
        valid = ((o_idx >= 0) & (o_idx <= Lo))[None, :]
        y_tok = out_toks.long()[:, torch.clamp(o_idx - 1, 0, max(Lo - 1, 0))] \
            if Lo else torch.zeros((B, W), dtype=torch.long, device=dev)
        has_y = (o_idx >= 1)[None, :]
        has_x = (i_idx >= 1)[None, :]
        # neighbour slab, its log scale, the cell's token and whether the
        # neighbour lies in the lattice
        nb = {"up": (p1, m1, y_tok, has_y),
              "left": (torch.cat([zp, p1[:, :-1]], 1),
                       torch.cat([zm, m1[:, :-1]], 1), x_tok, has_x),
              "diag": (torch.cat([zp, p2[:, :-1]], 1),
                       torch.cat([zm, m2[:, :-1]], 1),
                       x_tok * To + y_tok, has_x & has_y)}
        mu = torch.full((B, W), NEG_INF, dtype=m_dtype, device=dev)
        for name in (("up", "left", "diag") if mu_all else kinds):
            _, m_op, _, has = nb[name]
            mu = torch.maximum(mu, torch.where(has, m_op, neg))
        mu_safe = torch.where(mu > NEG_INF / 2, mu, torch.zeros_like(mu))
        cur = torch.zeros((B, W, Sa), dtype=f32, device=dev)
        for name in kinds:
            p_op, m_op, tok, has = nb[name]
            w = torch.where(has & (m_op > NEG_INF / 2),
                            torch.exp(m_op - mu_safe), torch.zeros_like(m_op))
            w = w.to(f32)
            cur = cur + term(name, p_op * w[:, :, None], tok)
        if closure_t is not None:
            cur = closure_mm(cur, closure_t.t()) if closure_mm is not None \
                else cur @ closure_t.t()
        m_new = torch.where(valid, mu, neg)
        cur = torch.where(valid[:, :, None], cur, torch.zeros_like(cur))
        # rescale on TWO consecutive diagonals so both parities (the diag
        # class lives on one of them) are renormalised
        if off is not None:
            fire = (d + off) % rescale_every <= 1
            if bool(fire.any()):
                cur, m_new = rescale(cur, m_new, fire, valid)
        elif d % rescale_every <= 1:
            cur, m_new = rescale(cur, m_new, None, valid)
        res = torch.where(dfin == d, readout(cur, m_new), res)
        p2, m2, p1, m1 = p1, m1, cur, m_new
    return res


def check_chain(B, Li, Lo, n_chain):
    """The JAX factories' conditions on a chained schedule."""
    if n_chain < 1 or B % n_chain:
        raise ValueError("chained: B must be a multiple of chain")
    if Li < 1 or Lo < 1:
        raise ValueError("chained: needs non-empty sequences")


def walk_chained(plain, ops, in_toks, out_toks, n_chain, rescale_every):
    """The chained schedule of the JAX kernels, by `plain` (a plain version
    taking diag_offset): every pair walks its full (Li, Lo) lattice (the
    pairs' lengths are ignored, as the JAX kernels ignore them), and pair n
    is chain n // (B / n_chain), which starts on absolute diagonal
    (Lo + 2) * chain."""
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    check_chain(B, Li, Lo, n_chain)
    dev = in_toks.device
    full = [torch.full((B,), n, dtype=torch.long, device=dev)
            for n in (Li, Lo)]
    offset = (Lo + 2) * (torch.arange(B, device=dev) // (B // n_chain))
    return plain(ops, in_toks, out_toks, *full, rescale_every,
                 diag_offset=offset)
