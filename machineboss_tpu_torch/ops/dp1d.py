"""1D DP engines (generator or recognizer machines), on torch.

Counterpart of machineboss_tpu's ops/dp1d.py, over token-conditioned
transfer matrices (lowering.emit_matrices_1d):

  forward_1d_scan  vector (x) matrix steps, O(L*S^2) work at depth L
                   (what CompiledMachine.log_forward_batch runs off the
                   card, and log_forward's "scan");
  forward_1d_assoc the product of the (S,S) transfer matrices by a
                   pairwise tree, O(L*S^3) work at depth log L
                   (log_forward's "assoc");
  forward_1d_all / backward_1d_all  the (L+1, S) lattices;
  forward_1d_scan_probs_batch  a batch-major probability-space scan, one
                   (B,S) x (S,n_tok*S) matmul a step;
  make_forward_1d_blocked  host-f64 k-token block tables folded pairwise
                   on the device, L/(k*chunk) sequential steps.

Token arrays may carry a leading batch dimension ((B, L) tokens, (B,)
lengths): every sequence of a batch goes through the same arithmetic.
Matrix products run in full float32 (no TF32): these chains multiply up
to thousands of semiring products.
"""

import numpy as np
import torch

from .semiring import LOGSUMEXP, NEG_INF, fold_pairwise
from ..utils.device import resolve_device


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


def forward_1d_scan_probs_batch(trans, closure, toks, lens):
    """Batch-major prob-space 1D Forward scan (LOGSUMEXP only).

    The carry is a probability-space vector p (B, S), kept near unit scale
    by a per-step renormalization whose log goes into a Kahan-compensated
    per-sequence scale; each step is ONE real (B, S) x (S, n_tok*S) matmul
    against the precomputed exp-shifted wide transfer matrix (all tokens at
    once) followed by a one-hot block select, so there is no per-sequence
    (S, S) matrix gather in the loop. Entries more than ~80 nats below a
    token block's max underflow.

    trans (n_tok, S, S) log, closure (S, S) log; toks (B, L) 0-based;
    lens (B,). Returns (B,) log-likelihoods read at state S-1.

    The same exp'd matrix is re-rounded identically every step, so a
    rounding bias accumulates linearly with L (the JAX package measured
    ~1e-4 nat/step at worst on its accelerator); beyond ~3000 steps this
    warns, as the JAX engine does: use forward_1d_scan or the blocked
    engine for long scans."""
    n_tok, S, _ = trans.shape
    B, L = toks.shape
    dev, dtype = trans.device, trans.dtype
    if L > 3000:
        import warnings
        warnings.warn(
            "forward_1d_scan_probs_batch: L=%d exceeds the ~3000-step "
            "safe bound for the per-step rounding bias (~1e-4 nat/step "
            "worst case); use forward_1d_scan or the blocked engine for "
            "long scans" % L, stacklevel=2)
    toks = torch.as_tensor(toks, device=dev).long()
    lens = torch.as_tensor(lens, device=dev)
    gmax = trans.reshape(n_tok, S * S).max(dim=1).values      # (n_tok,)
    gsafe = torch.where(gmax > NEG_INF / 2, gmax, torch.zeros_like(gmax))
    wide = torch.exp((trans - gsafe[:, None, None]).permute(1, 0, 2)
                     .reshape(S, n_tok * S))

    f0 = _start_vector(S, closure, LOGSUMEXP, dtype)
    m0 = f0.max()
    m0 = torch.where(m0 > NEG_INF / 2, m0, torch.zeros_like(m0))
    p = torch.exp(f0 - m0).expand(B, S)
    scale = m0.expand(B).clone()
    comp = torch.zeros(B, dtype=dtype, device=dev)
    ones = torch.ones(B, dtype=dtype, device=dev)
    for pos in range(L):
        tok = toks[:, pos]
        q = torch.matmul(p, wide)                              # (B, nT*S)
        qs = torch.gather(q.reshape(B, n_tok, S), 1,
                          tok[:, None, None].expand(B, 1, S))[:, 0]
        m = qs.max(dim=-1).values                              # (B,)
        dead = m <= 0                                          # no mass left
        msafe = torch.where(dead, ones, m)
        p_new = qs / msafe[:, None]
        inc = torch.log(msafe) + gsafe[tok]
        # Kahan-compensated scale += inc (dead lanes pin to log-zero so
        # the compensation never sees inf - inf)
        y = inc - comp
        t = scale + y
        comp_new = (t - scale) - y
        t = torch.where(dead, torch.full_like(t, NEG_INF), t)
        comp_new = torch.where(dead, torch.zeros_like(comp_new), comp_new)
        keep = pos < lens
        p = torch.where(keep[:, None], p_new, p)
        scale = torch.where(keep, t, scale)
        comp = torch.where(keep, comp_new, comp)
    last = p[:, S - 1]
    return torch.where(last > 0, torch.log(torch.where(last > 0, last, ones)),
                       torch.full_like(last, NEG_INF)) + scale


def forward_1d_assoc(trans, closure, toks, length, sr=LOGSUMEXP):
    """The product of the position matrices by a pairwise tree (log depth):
    positions past `length` and the padding up to a power of two are
    identity matrices, so the product is the JAX package's last prefix
    product. toks (L,) or (B, L), length a scalar or (B,)."""
    S = trans.shape[-1]
    dev = trans.device
    toks = torch.as_tensor(toks, device=dev).long()
    length = torch.as_tensor(length, device=dev)
    L = toks.shape[-1]
    n = 1
    while n < L:
        n *= 2
    eye = torch.full((S, S), sr.zero, dtype=trans.dtype, device=dev)
    eye.fill_diagonal_(sr.one)
    pos = torch.arange(n, device=dev)
    mats = torch.cat([trans[toks], eye.expand(toks.shape[:-1] + (n - L, S, S))],
                     dim=-3)
    mats = torch.where((pos < length[..., None])[..., None, None], mats, eye)
    prod = fold_pairwise(sr.matmul, mats, dim=-3)
    f0 = _start_vector(S, closure, sr, trans.dtype)
    return sr.vecmat(f0, prod)[..., S - 1]


def forward_1d_all(trans, closure, toks, length, sr=LOGSUMEXP):
    """Sequential scan returning the full (..., L+1, S) lattice (for
    counts)."""
    S = trans.shape[-1]
    dev = trans.device
    toks = torch.as_tensor(toks, device=dev).long()
    length = torch.as_tensor(length, device=dev)
    f = _start_vector(S, closure, sr, trans.dtype).expand(
        toks.shape[:-1] + (S,))
    rows = [f]
    for pos in range(toks.shape[-1]):
        f_new = sr.vecmat(f, trans[toks[..., pos]])
        f = torch.where((pos < length)[..., None], f_new, f)
        rows.append(f)
    return torch.stack(rows, dim=-2)


def backward_1d_all(trans, closure, toks, length, sr=LOGSUMEXP):
    """Backward lattice b[p, s] = weight of emitting toks[p:] from state s,
    (..., L+1, S).

    b_L is one at the end state: the silent closure is folded on the right
    of each transfer matrix, so the final silent run is inside the last
    step's matrix."""
    S = trans.shape[-1]
    dev = trans.device
    toks = torch.as_tensor(toks, device=dev).long()
    length = torch.as_tensor(length, device=dev)
    bL = torch.full(toks.shape[:-1] + (S,), sr.zero, dtype=trans.dtype,
                    device=dev)
    bL[..., S - 1] = sr.one
    b = bL
    rows = [bL]
    for pos in range(toks.shape[-1] - 1, -1, -1):
        b_new = sr.matvec(trans[toks[..., pos]], b)
        b = torch.where((pos < length)[..., None], b_new, b)
        rows.append(b)
    return torch.stack(rows[:0:-1] + [bL], dim=-2)


# --------------------------------------------------------------- blocked

def _np_log_matmul_batch(a, b):
    """Batched f64 log-space matmul (host, exact shift)."""
    import numpy as np
    amax = np.max(a, axis=-1, keepdims=True)
    bmax = np.max(b, axis=-2, keepdims=True)
    asafe = np.where(amax > NEG_INF / 2, amax, 0.0)
    bsafe = np.where(bmax > NEG_INF / 2, bmax, 0.0)
    prod = np.exp(a - asafe) @ np.exp(b - bsafe)
    with np.errstate(divide="ignore"):
        out = np.where(prod > 0, np.log(np.maximum(prod, 1e-300))
                       + asafe + bsafe, NEG_INF)
    return out


def build_token_block_table(trans, k=None, budget_mb=40):
    """Host-exact f64 transfer table over k-token blocks.

    trans: (n_tok, S, S) log transfer matrices (token-conditioned, silent
    closure folded — lowering.emit_matrices_1d). Returns (table, k) where
    table[(…(t0*(n+1)+t1)*(n+1)…)+t_{k-1}] = M_{t0} (x) … (x) M_{t_{k-1}}
    in the log semiring, with the extra token id n_tok = identity (pad).

    This is the numerics-first answer to the long-scan MXU bias
    (see forward_1d_scan_probs_batch's caveat): block products are folded
    ONCE on the host in float64, so the device scan takes L/k steps
    instead of L — both the per-step rounding exposure and the sequential
    depth drop by k. k auto-sizes to keep the table under budget_mb."""
    import numpy as np
    n_tok, S, _ = trans.shape
    base = n_tok + 1
    if k is None:
        k = 1
        while k < 8 and base ** (k + 1) * S * S * 4 <= budget_mb * (1 << 20):
            k += 1
    t64 = np.asarray(trans, np.float64)
    eye = np.where(np.eye(S, dtype=bool), 0.0, NEG_INF)
    level = np.concatenate([t64, eye[None]], axis=0)        # (base, S, S)
    table = level
    for _ in range(k - 1):
        # table_{j+1}[c*base + t] = table_j[c] (x) level[t]
        table = _np_log_matmul_batch(
            table[:, None], level[None])                    # (C, base, S, S)
        table = table.reshape(-1, S, S)
    return table, k


def make_forward_1d_blocked(trans, closure, k=None, chunk_combos=64,
                            dtype=None, device=None):
    """Batch-major blocked 1D Forward: fn(toks (B, L) 0-based, lens (B,))
    -> (B,) log-likelihoods.

    Per step over macro-chunks of the sequence: gather the chunk's block
    matrices from the host-exact table (resident on the device), fold them
    pairwise with log-depth semiring matmuls (full float32), then advance
    the renormalized Kahan-scaled carry once per chunk: the sequential
    depth is L/(k*chunk_combos) instead of L, and every matmul's operands
    differ step to step (no correlated-rounding bias, unlike the wide
    prob-space scan). The table lives on `device` (None: trans's device
    when trans is a tensor, else the card)."""
    if device is None and isinstance(trans, torch.Tensor):
        dev = trans.device
    else:
        dev = resolve_device(device)
    trans_np = trans.detach().cpu().numpy() if isinstance(
        trans, torch.Tensor) else np.asarray(trans)
    closure_np = closure.detach().cpu().numpy() if isinstance(
        closure, torch.Tensor) else np.asarray(closure)
    n_tok, S, _ = trans_np.shape
    table_np, k = build_token_block_table(trans_np, k=k)
    base = n_tok + 1
    dtype = torch.float32 if dtype is None else dtype
    table = torch.as_tensor(np.maximum(table_np, NEG_INF), dtype=dtype,
                            device=dev)
    closure_t = torch.as_tensor(np.maximum(np.asarray(closure_np, np.float64),
                                           NEG_INF), dtype=dtype, device=dev)
    # chunk_combos must be a power of two for the fold tree
    cc = 1
    while cc * 2 <= chunk_combos:
        cc *= 2
    powers = torch.tensor([base ** (k - 1 - j) for j in range(k)],
                          dtype=torch.long, device=dev)
    f0 = _start_vector(S, closure_t, LOGSUMEXP, dtype)

    def fwd(toks, lens):
        toks = torch.as_tensor(toks, device=dev).long()
        lens = torch.as_tensor(lens, device=dev)
        B, L = toks.shape
        nC = -(-L // k)
        nMacro = -(-nC // cc)
        Lp = nMacro * cc * k
        t = torch.where(torch.arange(L, device=dev)[None, :] < lens[:, None],
                        toks, n_tok)
        t = torch.cat([t, torch.full((B, Lp - L), n_tok, dtype=torch.long,
                                     device=dev)], dim=1)
        ids = (t.reshape(B, nMacro * cc, k) * powers).sum(-1)
        ids = ids.reshape(B, nMacro, cc)
        f = f0.expand(B, S)
        scale = torch.zeros(B, dtype=dtype, device=dev)
        comp = torch.zeros(B, dtype=dtype, device=dev)
        for c in range(nMacro):
            mats = fold_pairwise(LOGSUMEXP.matmul, table[ids[:, c]], dim=1)
            f_new = LOGSUMEXP.vecmat(f, mats)
            norm = f_new.max(dim=-1).values
            norm = torch.where(norm > NEG_INF / 2, norm,
                               torch.zeros_like(norm))
            f = f_new - norm[:, None]
            y = norm - comp
            tt = scale + y
            comp = (tt - scale) - y
            scale = tt
        return f[:, S - 1] + scale

    return fwd
