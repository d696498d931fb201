"""PSWM (profile) sequence inputs for the dense DP engines, on torch.

Counterpart of machineboss_tpu's ops/pswm.py. A PSWM sequence is a
(L, n_tokens) matrix of per-position log source weights, column 0 =
epsilon (position may be skipped with that weight), columns 1.. = alphabet
tokens: the uncertainty-aware generalization of a token sequence (one-hot
rows reduce exactly to the token case). Used for base-caller posteriors,
sequence profiles, and soft labels.

The 1D transfer matrix for a PSWM position folds the emission distribution
into the token-conditioned matrices:

    M_p = [ sum_t exp(pswm[p, t]) * E_t  (+)  exp(pswm[p, 0]) * I ] (x) C
"""

import torch

from .semiring import LOGSUMEXP, NEG_INF
from . import dp2d


def _eye(S, dtype, device):
    eye = torch.eye(S, dtype=torch.bool, device=device)
    return torch.where(eye, torch.zeros((), dtype=dtype, device=device),
                       torch.full((), NEG_INF, dtype=dtype, device=device))


def pswm_from_tokens(toks, n_tokens, dtype=torch.float32):
    """One-hot log PSWM from a 0-based token sequence (L,)."""
    toks = torch.as_tensor(toks).long()
    L = toks.shape[0]
    p = torch.full((L, n_tokens + 1), NEG_INF, dtype=dtype,
                   device=toks.device)
    p[torch.arange(L, device=toks.device), toks + 1] = 0.0
    return p


def pswm_transfer_matrices(emit, closure, pswm, sr=LOGSUMEXP):
    """Per-position transfer matrices for a PSWM sequence.

    emit: (n_tok, S, S) token-conditioned emission matrices (closure NOT
    folded); closure: (S, S); pswm: (L, n_tok+1) log weights (col 0 = eps).
    Returns (L, S, S) matrices with closure folded on the right."""
    S = closure.shape[-1]
    # weighted logsumexp over token matrices + epsilon identity
    w_tok = pswm[:, 1:, None, None] + emit[None, :, :, :]  # (L, T, S, S)
    w_eps = pswm[:, 0, None, None] + _eye(S, emit.dtype, emit.device)
    stacked = torch.cat([w_tok, w_eps[:, None]], dim=1)
    m = sr.reduce(torch.movedim(stacked, 1, -1), axis=-1)
    m = torch.clamp(m, min=NEG_INF)
    return sr.matmul(m, closure[None])


def forward_1d_pswm(emit, closure, pswm, length, sr=LOGSUMEXP):
    """1D Forward over a PSWM sequence (scan strategy)."""
    S = closure.shape[-1]
    mats = pswm_transfer_matrices(emit, closure, pswm, sr=sr)
    f = sr.vecmat(dp2d._e0(S, closure.dtype, sr, closure.device), closure)
    for m in mats[:int(length)]:
        f = sr.vecmat(f, m)
    return f[S - 1]


def forward_2d_pswm(a_diag, a_left, a_up, closure, in_pswm, out_pswm,
                    in_len, out_len, sr=LOGSUMEXP):
    """Pairwise Forward with PSWM inputs on both sides.

    in_pswm: (Li, Ti+1) log weights (col 0 = eps skip); out_pswm: (Lo, To+1).
    Per-position transfer matrices are the PSWM-weighted mixtures of the
    token-conditioned matrices; an eps column mixes in an identity 'skip'.
    As in the JAX package, every row is filled and the last row is read at
    in_len."""
    S = a_diag.shape[-1]
    dtype, dev = closure.dtype, closure.device
    eye = _eye(S, dtype, dev)

    def mix(pswm, mats):
        # logsumexp_t pswm[p, t] * mats[t] (+) pswm[p, 0] * I, all positions
        stacked = torch.cat([pswm[:, 1:, None, None] + mats[None],
                             (pswm[:, 0, None, None] + eye)[:, None]], 1)
        return sr.reduce(torch.movedim(stacked, 1, -1), axis=-1)

    left_mats = mix(in_pswm, a_left)                      # (Li, S, S)
    up_mats = mix(out_pswm, a_up)                         # (Lo, S, S)
    # diag: mix over input tokens first -> (Li, To, S, S)
    dx = sr.reduce(torch.movedim(
        in_pswm[:, 1:, None, None, None] + a_diag[None], 1, -1), axis=-1)
    Li = in_pswm.shape[0]
    left_full = torch.cat([torch.full((1, S, S), sr.zero, dtype=dtype,
                                      device=dev), left_mats], 0)

    prep = dp2d._prepare(left_full, closure, sr)
    u0 = torch.full((Li + 1, S), sr.zero, dtype=dtype, device=dev)
    u0[0] = dp2d._e0(S, dtype, sr, dev)
    row = dp2d._row_scan(u0, left_full, closure, sr, prep)
    for o in range(out_pswm.shape[0]):
        diag_m = sr.reduce(torch.movedim(
            out_pswm[o, None, 1:, None, None] + dx, 1, -1), axis=-1)
        u = sr.vecmat(row, up_mats[o][None])
        u = torch.cat([u[:1], sr.add(u[1:], sr.vecmat(row[:-1], diag_m))], 0)
        row = dp2d._row_scan(u, left_full, closure, sr, prep)
    return row[in_len, S - 1]


def backward_1d_pswm(emit, closure, pswm, length, sr=LOGSUMEXP):
    """1D Backward over a PSWM sequence: reversed matvec scan. The total
    equals Forward (test invariant)."""
    S = closure.shape[-1]
    mats = pswm_transfer_matrices(emit, closure, pswm, sr=sr)
    b = dp2d._e0(S, closure.dtype, sr, closure.device, state=S - 1)
    for m in mats[:int(length)].flip(0):
        b = sr.matvec(m, b)
    return sr.matvec(closure, b)[0]


def reverse_tensors(a_diag, a_left, a_up, closure):
    """State-reversed machine tensors: transpose each matrix and flip the
    state order so end becomes start: Backward(M) = Forward(reverse(M))."""
    def rev(m):
        return torch.flip(m.transpose(-1, -2), dims=(-1, -2))
    return rev(a_diag), rev(a_left), rev(a_up), rev(closure)


def backward_2d_pswm(a_diag, a_left, a_up, closure, in_pswm, out_pswm,
                     in_len, out_len, sr=LOGSUMEXP):
    """Pairwise Backward with PSWM inputs: Forward on the state-reversed
    machine over the reversed profiles. Padding rows must sit at the END
    of the pswm arrays (as in forward); they are rolled to keep the live
    positions adjacent after reversal."""
    ad, al, au, cl = reverse_tensors(a_diag, a_left, a_up, closure)
    Li = in_pswm.shape[0]
    Lo = out_pswm.shape[0]
    ip = torch.roll(torch.flip(in_pswm, (0,)), Li - int(in_len), 0) \
        if Li else in_pswm
    op = torch.roll(torch.flip(out_pswm, (0,)), Lo - int(out_len), 0) \
        if Lo else out_pswm
    return forward_2d_pswm(ad, al, au, cl, ip, op, in_len, out_len, sr=sr)
