"""Anti-diagonal wavefront 2D DP in log space, any semiring, on torch.

Counterpart of machineboss_tpu's ops/wavefront.py with the same recurrence:
the scan runs over anti-diagonals d = i + o; every cell on a diagonal
depends only on diagonals d-1 and d-2, so each step updates a whole
(batch, diagonal) slab at once. For each token value t the slab is
multiplied by the shared matrix M_t, then every cell selects its own
token's result. Sequential depth is Li + Lo instead of Li * Lo.

With MAXPLUS, `wavefront_2d_diagonals` is the Viterbi fill of the CPU path
of algo/viterbi_device.py; the closure is applied per step in float32, so
it differs from the closure-folded kernel by rounding (1e-4 nats).
"""

import numpy as np
import torch

from .semiring import LOGSUMEXP


def _apply_all_tokens(x, mats, sr):
    """x: (B, L, S); mats: (T, S, S) shared across batch.
    Returns (T, B, L, S): x (x) mats[t] for every token value t."""
    B, L, S = x.shape
    out = sr.matmul(x.reshape(1, B * L, S), mats)
    return out.reshape(mats.shape[0], B, L, S)


def _select_tokens(y, tok_idx):
    """y: (T, B, L, S); tok_idx: (B, L) -> out[b,l,s] = y[tok[b,l],b,l,s]
    (the semiring zero is never needed: a class without tokens is
    rejected by the caller)."""
    y2 = y.permute(1, 2, 0, 3)                        # (B, L, T, S)
    idx = tok_idx.long()[:, :, None, None].expand(-1, -1, 1, y2.shape[-1])
    return torch.gather(y2, 2, idx)[:, :, 0, :]


def _class_term(src, mats, tok, sr):
    """One neighbour class's contribution: (B, W, S). A class without
    tokens (an empty alphabet on its side) contributes the semiring zero."""
    if mats.shape[0] == 0:
        return torch.full_like(src, sr.zero)
    return _select_tokens(_apply_all_tokens(src, mats, sr), tok)


def _diagonal_steps(a_diag, a_left, a_up, closure, in_toks, out_toks, sr):
    """Generator of (d, slab (B, W, S)) for d = 0 .. Li + Lo."""
    Ti, To, S, _ = a_diag.shape
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    dtype, dev = closure.dtype, closure.device
    W = Li + 1

    diag_mats = a_diag.reshape(Ti * To, S, S)
    x_tok = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                       in_toks.long()], dim=1)
    e0 = torch.full((S,), sr.zero, dtype=dtype, device=dev)
    e0[0] = sr.one
    d0 = torch.full((B, W, S), sr.zero, dtype=dtype, device=dev)
    d0[:, 0, :] = sr.vecmat(e0, closure)[None, :]
    yield 0, d0

    i_idx = torch.arange(W, device=dev)
    zero_col = torch.full((B, 1, S), sr.zero, dtype=dtype, device=dev)
    zero = torch.tensor(sr.zero, dtype=dtype, device=dev)
    prev1, prev2 = d0, torch.full_like(d0, sr.zero)
    for d in range(1, Li + Lo + 1):
        o_idx = d - i_idx
        if Lo:
            y_tok = out_toks.long()[:, torch.clamp(o_idx - 1, 0, Lo - 1)]
        else:
            y_tok = torch.zeros((B, W), dtype=torch.long, device=dev)
        left_src = torch.cat([zero_col, prev1[:, :-1]], dim=1)
        left = _class_term(left_src, a_left, x_tok, sr)
        up = _class_term(prev1, a_up, y_tok, sr)
        diag_src = torch.cat([zero_col, prev2[:, :-1]], dim=1)
        dg = _class_term(diag_src, diag_mats, x_tok * To + y_tok, sr)
        u = sr.add(sr.add(left, up), dg)
        cur = sr.vecmat(u.reshape(B * W, S), closure).reshape(B, W, S)
        # out-of-lattice cells must never feed the next diagonals
        valid = (o_idx >= 0) & (o_idx <= Lo)
        cur = torch.where(valid[None, :, None], cur, zero)
        yield d, cur
        prev1, prev2 = cur, prev1


def forward_2d_wavefront(a_diag, a_left, a_up, closure, in_toks, out_toks,
                         in_lens, out_lens, sr=LOGSUMEXP):
    """Batched 2D Forward by anti-diagonal wavefront.

    a_diag: (Ti, To, S, S); a_left: (Ti, S, S); a_up: (To, S, S);
    in_toks: (B, Li) 0-based; out_toks: (B, Lo); lens: (B,). All tensors
    on one device. Returns (B,) final values at (in_len, out_len, end
    state)."""
    B = in_toks.shape[0]
    S = closure.shape[-1]
    dev = closure.device
    b_idx = torch.arange(B, device=dev)
    il = in_lens.long()
    d_final = il + out_lens.long()
    res = torch.full((B,), sr.zero, dtype=closure.dtype, device=dev)
    for d, cur in _diagonal_steps(a_diag, a_left, a_up, closure, in_toks,
                                  out_toks, sr):
        res = torch.where(d_final == d, cur[b_idx, il, S - 1], res)
    return res


def wavefront_2d_diagonals(a_diag, a_left, a_up, closure, in_toks, out_toks,
                           sr=LOGSUMEXP):
    """Batched wavefront that RETURNS every diagonal slab.

    Same recurrence as forward_2d_wavefront; output (n_diags, B, W, S)
    where slab d holds cells (i, o=d-i), W = Li + 1. With sr=MAXPLUS this
    is the Viterbi fill whose reassembled lattice feeds the host
    traceback."""
    return torch.stack([cur for _, cur in _diagonal_steps(
        a_diag, a_left, a_up, closure, in_toks, out_toks, sr)], dim=0)


def lattice_from_diagonals(diags, Li, Lo):
    """Host reassembly: (n_diags, B, W, S) -> (B, Li+1, Lo+1, S) numpy."""
    if isinstance(diags, torch.Tensor):
        diags = diags.cpu().numpy()
    diags = np.asarray(diags)
    ii = np.arange(Li + 1)[:, None]
    oo = np.arange(Lo + 1)[None, :]
    lat = diags[ii + oo, :, ii, :]            # (Li+1, Lo+1, B, S)
    return np.transpose(lat, (2, 0, 1, 3))
