"""1D DP engine (generator or recognizer machines), the routed part.

Counterpart of machineboss_tpu's ops/dp1d.py for what
CompiledMachine.log_forward_batch runs off the card: the sequential scan
of vector (x) matrix steps over token-conditioned transfer matrices
(lowering.emit_matrices_1d), O(L*S^2) work at depth L, and its batched
form. The associative scan, the lattices, the probability-space batch scan
and the blocked tables of the JAX module are on no route of that entry
point and are not ported yet.
"""

import torch

from .semiring import LOGSUMEXP, NEG_INF


def _start_vector(S, closure, sr, dtype):
    e0 = torch.full((S,), sr.zero, dtype=dtype, device=closure.device)
    e0[0] = sr.one
    return sr.vecmat(e0, closure)


def forward_1d_scan(trans, closure, toks, length, sr=LOGSUMEXP):
    """Sequential scan. trans: (n_tok, S, S) with closure folded; toks:
    (L,) 0-based token ids (tok-1), or (B, L) for a batch; length: the
    actual length (scalar, or (B,)) for the padding mask. Returns the
    log-likelihood read at state S-1, shaped like `length`.

    The batch dimension is written out: every sequence of a batch goes
    through the same arithmetic as a single one. The carry is renormalized
    each step (running max subtracted into a Kahan-compensated scale
    accumulator): carrying absolute log values in f32 loses ~|LL|*eps per
    step, which at L=10000 accumulates far outside the 0.01-nat
    device/host contract."""
    S = trans.shape[-1]
    toks = torch.as_tensor(toks, device=trans.device).long()
    length = torch.as_tensor(length, device=trans.device)
    batched = toks.dim() == 2
    if not batched:
        toks, length = toks[None], length[None]
    B, L = toks.shape
    f = _start_vector(S, closure, sr, trans.dtype)[None].repeat(B, 1)
    scale = torch.zeros(B, dtype=trans.dtype, device=trans.device)
    comp = torch.zeros_like(scale)
    for pos in range(L):
        m = trans[toks[:, pos]]                              # (B, S, S)
        f_new = sr.vecmat(f, m)
        norm = f_new.max(dim=-1).values
        norm = torch.where(norm > NEG_INF / 2, norm, torch.zeros_like(norm))
        f_new = f_new - norm[:, None]
        # Kahan-compensated scale += norm
        y = norm - comp
        t = scale + y
        comp_new = (t - scale) - y
        keep = pos < length
        f = torch.where(keep[:, None], f_new, f)
        scale = torch.where(keep, t, scale)
        comp = torch.where(keep, comp_new, comp)
    res = f[:, S - 1] + scale
    return res if batched else res[0]


def make_batched(fn, sr=LOGSUMEXP):
    """Batched variant of a 1D engine: call(trans, closure, toks (B, L),
    lens (B,)) -> (B,)."""
    def call(trans, closure, toks, length):
        return fn(trans, closure, toks, length, sr=sr)
    return call
