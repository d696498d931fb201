"""Scaled-probability wavefront: the kernel-free batched Forward engine.

Torch counterpart of machineboss_tpu's ops/wavefront_fast.py, with the
same recurrence. Each diagonal slab is carried as (p, m): probabilities p
in [0,1] with a per-cell log-scale m, i.e. cell = p * exp(m). Because the
semiring matmul is linear in the cell row, all matrix products run in
plain probability space; exp/log appear only on the (batch, diagonal)
scalar scales, once per step. Token-conditioned matrices are concatenated
along the output dimension into one wide matmul per neighbour class.

Products run in full float32: the caller must not enable TF32 (PyTorch's
default leaves it off for matmuls), since log-semiring chains drift at
reduced precision.
"""

import torch

NEG_INF = -1e30


def _prep_prob_mats(a_diag, a_left, a_up, closure):
    """Exponentiate log matrices and concatenate token variants column-wise.

    Returns (diag_cat (S, Ti*To*S), left_cat (S, Ti*S), up_cat (S, To*S),
    closure_p (S, S)) in probability space."""
    Ti, To, S, _ = a_diag.shape
    diag_p = torch.exp(torch.clamp(a_diag, min=NEG_INF))
    left_p = torch.exp(torch.clamp(a_left, min=NEG_INF))
    up_p = torch.exp(torch.clamp(a_up, min=NEG_INF))
    closure_p = torch.exp(torch.clamp(closure, min=NEG_INF))
    diag_cat = diag_p.reshape(Ti * To, S, S).permute(1, 0, 2) \
        .reshape(S, Ti * To * S)
    left_cat = left_p.permute(1, 0, 2).reshape(S, Ti * S)
    up_cat = up_p.permute(1, 0, 2).reshape(S, To * S)
    return diag_cat, left_cat, up_cat, closure_p


def _pick(y_all, tok):
    """y_all: (B, W, T, S); tok: (B, W) -> (B, W, S) selecting the token
    block of each cell (zeros for a class without tokens, as a 1D machine's
    empty side has). Advanced indexing, not gather: under autograd it
    keeps only the indices for the backward pass, where gather would keep
    all T token products of every diagonal alive."""
    if y_all.shape[2] == 0:
        return y_all.new_zeros(y_all.shape[:2] + y_all.shape[3:])
    B, W = tok.shape
    b = torch.arange(B, device=tok.device)[:, None]
    w = torch.arange(W, device=tok.device)[None, :]
    return y_all[b, w, tok.long()]


def forward_2d_wavefront_fast(a_diag, a_left, a_up, closure, in_toks,
                              out_toks, in_lens, out_lens, precision=None):
    """Batched 2D Forward log-likelihoods.

    Log-space machine tensors a_diag (Ti, To, S, S), a_left (Ti, S, S),
    a_up (To, S, S), closure (S, S) as lowering.matrices_2d returns them,
    float32 tensors on one device; in_toks (B, Li), out_toks (B, Lo),
    in_lens/out_lens (B,) integer tensors on the same device. Returns (B,)
    float32 log-likelihoods (NEG_INF for impossible pairs).

    `precision` is the JAX engine's matrix-unit precision, accepted and
    ignored: the products here always run in float32 with TF32 off."""
    Ti, To, S, _ = a_diag.shape
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    W = Li + 1
    dev = a_diag.device
    f32 = torch.float32

    diag_cat, left_cat, up_cat, closure_p = _prep_prob_mats(
        a_diag, a_left, a_up, closure)

    x_tok = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                       in_toks.long()], dim=1)

    # initial diagonal: cell(0,0) = e0 . closure
    p0 = torch.zeros((B, W, S), dtype=f32, device=dev)
    p0[:, 0, :] = closure_p[0]
    mx0 = p0.max(dim=-1).values
    m0 = torch.where(mx0 > 0, torch.log(torch.clamp(mx0, min=1e-37)),
                     torch.full_like(mx0, NEG_INF))
    p0 = p0 / torch.clamp(mx0, min=1e-37)[:, :, None]

    i_idx = torch.arange(W, device=dev)
    b_idx = torch.arange(B, device=dev)
    d_final = (in_lens + out_lens).long()
    il = in_lens.long()

    zerop = torch.zeros((B, 1, S), dtype=f32, device=dev)
    zerom = torch.full((B, 1), NEG_INF, dtype=f32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)

    def cell_value(p, m):
        end = p[b_idx, il, S - 1]
        val = m[b_idx, il] + torch.log(torch.clamp(end, min=1e-37))
        return end, val

    end0, val0 = cell_value(p0, m0)
    res = torch.where((d_final == 0) & (end0 > 0), val0, neg)

    p1, m1 = p0, m0
    p2 = torch.zeros_like(p0)
    m2 = torch.full_like(m0, NEG_INF)
    for d in range(1, Li + Lo + 1):
        o_idx = d - i_idx
        o_safe = torch.clamp(o_idx - 1, 0, max(Lo - 1, 0))
        y_tok = out_toks[:, o_safe].long() if Lo else \
            torch.zeros((B, W), dtype=torch.long, device=dev)

        flat1 = p1.reshape(B * W, S)
        up_all = (flat1 @ up_cat).reshape(B, W, To, S)
        up = _pick(up_all, y_tok)
        up_m = m1

        left_all = (flat1 @ left_cat).reshape(B, W, Ti, S)
        # cell i reads neighbour i-1 with matrix A_left[x_i]: select the
        # DESTINATION cell's token from the neighbour's matmul results
        left = torch.cat([zerop, _pick(left_all[:, :-1], x_tok[:, 1:])],
                         dim=1)
        left_m = torch.cat([zerom, m1[:, :-1]], dim=1)

        flat2 = p2.reshape(B * W, S)
        diag_all = (flat2 @ diag_cat).reshape(B, W, Ti * To, S)
        pair = x_tok * To + y_tok
        dg = torch.cat([zerop, _pick(diag_all[:, :-1], pair[:, 1:])], dim=1)
        dg_m = torch.cat([zerom, m2[:, :-1]], dim=1)

        # combine three contributions with per-cell rescaling
        mmax = torch.maximum(torch.maximum(up_m, left_m), dg_m)
        safe = torch.where(mmax > NEG_INF / 2, mmax, torch.zeros_like(mmax))
        u = (up * torch.exp(up_m - safe)[:, :, None]
             + left * torch.exp(left_m - safe)[:, :, None]
             + dg * torch.exp(dg_m - safe)[:, :, None])
        cur = (u.reshape(B * W, S) @ closure_p).reshape(B, W, S)
        # renormalize to keep p in [0,1]
        mx = cur.max(dim=-1).values
        has = mx > 0
        cur = cur / torch.clamp(mx, min=1e-37)[:, :, None]
        m_new = torch.where(has, safe + torch.log(torch.clamp(mx, min=1e-37)),
                            neg)
        valid = (o_idx >= 0) & (o_idx <= Lo)
        keep = valid[None, :] & has
        cur = torch.where(keep[:, :, None], cur, torch.zeros_like(cur))
        m_new = torch.where(keep, m_new, neg)

        end, val = cell_value(cur, m_new)
        res = torch.where((d_final == d) & (end > 0), val,
                          torch.where(d_final == d, neg, res))
        p2, m2, p1, m1 = p1, m1, cur, m_new
    return res
