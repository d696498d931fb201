"""Closure-folded, liveness-pruned, min-rank-factored wavefront Forward.

Counterpart of machineboss_tpu's ops/pallas/lowrank_kernel.py. The host
prep (`prepare_lowrank`, `lowrank_cost_ratio`) is a numpy copy of the JAX
package's and gives the same plan:

1. the silent closure is folded into each neighbour class tensor
   (A_class @ C), so no per-cell closure product remains;
2. states that can never hold mass or never feed the readout are pruned
   (prot2dna: 132 -> 100 live states);
3. each class A[t, s, d] is factored at its minimum rank, on the
   destination side (A = sum_r T_r[s, d] E_r[t, d], scale after the
   product) or the source side (A = sum_r T_r[s, d] E_r[t, s], scale
   before it).

The Forward itself has two versions with one recurrence, rescale schedule,
NEG_INF convention and readout:

- `lowrank_forward_plain`: a straightforward torch loop over diagonals in
  float32, used on the CPU and as the card's comparison;
- `lowrank_wavefront`: the wrapper of the hand-written CUDA kernel
  (csrc/lowrank_wavefront.cu). A CUDA tensor launches the kernel or raises;
  only a CPU tensor takes the plain version.

`make_lowrank_forward` keeps the JAX factory's signature and return
contract, fn(in_toks, out_toks, in_lens, out_lens) -> (B,).
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.device import resolve_device
from ._build import load
from .factorize import factorize_token_tensor

NEG_INF = -1e30

# shared memory the kernel's class operands may take per block: two blocks
# fit on one SM with room left for the L1 cache that serves M and E
SMEM_BUDGET = 100 * 1024
_TC = 8          # cells per thread tile (csrc/lowrank_wavefront.cu)
_TD = 4          # destination states per thread tile
_KINDS = {"up": 0, "left": 1, "diag": 2}
_SIDES = {"src": 0, "dest": 1}


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class _ClassSpec:
    name: str     # 'up' | 'left' | 'diag'
    side: str     # 'src' | 'dest'
    rank: int
    n_tok: int
    static_sc: bool  # sc precomputed outside the kernel (plain mode only)


def prepare_lowrank(a_diag, a_left, a_up, closure, chained=False):
    """Host prep: fold closure, prune states, factor each class min-rank.

    Returns (plan, mats) where plan is a dict with Sa/idx/classes/c0 and
    mats the list of (M (f32), E (f32)) device matrices per class, in
    class order (up, left, diag skipping absent classes)."""
    def pz(a):
        a64 = np.asarray(a, np.float64)
        return np.where(a64 > -1e29, np.exp(np.minimum(a64, 700.0)), 0.0)

    dz, lz, uz, cz = pz(a_diag), pz(a_left), pz(a_up), pz(closure)
    Ti, To = dz.shape[0], dz.shape[1]
    S = cz.shape[0]
    # fold closure into every class (dest side): A~ = A @ C
    uzc = np.einsum("tsd,de->tse", uz, cz) if uz.size else uz
    lzc = np.einsum("tsd,de->tse", lz, cz) if lz.size else lz
    dzc = (np.einsum("xysd,de->xyse", dz, cz).reshape(Ti * To, S, S)
           if dz.size else dz.reshape(Ti * To, S, S))
    c0 = cz[0].copy()                          # init row C[0, :]

    # liveness fixpoint over the folded system; readout state forced alive
    alive = np.ones(S, bool)
    changed = True
    while changed:
        changed = False
        for s in range(S):
            if not alive[s]:
                continue
            has_in = (c0[s] > 0
                      or (uzc.size and uzc[:, alive, s].sum() > 0)
                      or (lzc.size and lzc[:, alive, s].sum() > 0)
                      or (dzc.size and dzc[:, alive, s].sum() > 0))
            feeds = (s == S - 1
                     or (uzc.size and uzc[:, s, alive].sum() > 0)
                     or (lzc.size and lzc[:, s, alive].sum() > 0)
                     or (dzc.size and dzc[:, s, alive].sum() > 0))
            if not (has_in and feeds):
                alive[s] = False
                changed = True
    idx = np.where(alive)[0]
    Sa = len(idx)
    sel = np.ix_(idx, idx)

    classes = []
    mats = []
    for name, tensor, n_tok in (("up", uzc, To), ("left", lzc, Ti),
                                ("diag", dzc, Ti * To)):
        if not tensor.size or not tensor.any():
            continue
        a = tensor[:, idx, :][:, :, idx]       # (T, Sa, Sa) pruned
        td, ed, rd = factorize_token_tensor(a)
        ts, es, rs = factorize_token_tensor(np.transpose(a, (0, 2, 1)))
        if rs < rd:
            side, R = "src", rs
            # A[t,s,d] = sum_r ts[r,d,s] * es[r,t,s]
            # M[d, (r,s)] = ts[r,d,s]; E[(r,s), t] = es[r,t,s]
            M = np.ascontiguousarray(
                np.transpose(ts, (1, 0, 2)).reshape(Sa, R * Sa))
            E = np.ascontiguousarray(
                np.transpose(es, (0, 2, 1)).reshape(R * Sa, n_tok))
        else:
            side, R = "dest", rd
            # A[t,s,d] = sum_r td[r,s,d] * ed[r,t,d]
            # M[(r,d), s] = td[r,s,d]; E[(r,d), t] = ed[r,t,d]
            M = np.ascontiguousarray(
                np.transpose(td, (0, 2, 1)).reshape(R * Sa, Sa))
            E = np.ascontiguousarray(
                np.transpose(ed, (0, 2, 1)).reshape(R * Sa, n_tok))
        # static sc: token never changes for a lane across diagonals.
        # Only the input-consuming (left) class in plain mode qualifies.
        static_sc = (name == "left") and not chained
        classes.append(_ClassSpec(name, side, R, n_tok, static_sc))
        mats.append((M.astype(np.float32), E.astype(np.float32)))

    plan = {"Sa": Sa, "idx": idx, "classes": tuple(classes),
            "c0": np.ascontiguousarray(c0[idx].reshape(Sa, 1))
            .astype(np.float32), "sel": sel}
    return plan, mats


def lowrank_cost_ratio(a_diag, a_left, a_up, closure):
    """Estimated padded-MAC cost of the lowrank kernel relative to the
    merged wide-dot kernel (both per lane per diagonal). Used by dispatch
    to auto-route structured machines (profile HMMs, GeneWise
    compositions, PSWs) to the lowrank kernel; full-rank random machines
    come out >= 1 and stay on merged. Returns (ratio, plan)."""
    def pad(x, m):
        return ((x + m - 1) // m) * m

    Ti, To = a_diag.shape[0], a_diag.shape[1]
    S = closure.shape[0]
    plan, _ = prepare_lowrank(a_diag, a_left, a_up, closure)
    Sa = plan["Sa"]
    lr = 0
    for cs in plan["classes"]:
        if cs.side == "src":
            lr += 3 * pad(Sa, 8) * pad(cs.rank * Sa, 128)
        else:
            lr += 3 * pad(cs.rank * Sa, 8) * pad(Sa, 128)
        if not cs.static_sc and cs.n_tok > 8:
            lr += 2 * pad(cs.rank * Sa, 8) * pad(cs.n_tok, 128)
    # merged unified: one wide dot (n_blk*S rows) against the stacked
    # [up S][diag Ti*S][left Ti*S] columns (class-present terms only)
    has_up = bool(np.any(np.asarray(a_up) > -1e29)) if a_up.size else False
    has_left = bool(np.any(np.asarray(a_left) > -1e29)) \
        if a_left.size else False
    has_diag = bool(np.any(np.asarray(a_diag) > -1e29)) \
        if a_diag.size else False
    unify = has_left and (has_up or has_diag)
    n_blk = To + 1 if unify else max(To, 1)
    cols = (S if has_up else 0) + (Ti * S if has_diag else 0) \
        + (Ti * S if (has_left and unify) else 0)
    merged = 3 * pad(n_blk * S, 8) * pad(max(cols, 1), 128)
    if has_left and not unify:
        merged += 3 * pad(S, 8) * pad(Ti * S, 128)
    return (lr / merged if merged else 1.0), plan


@dataclass
class LowrankOperands:
    """One machine's prepared lowrank plan as tensors on one device.

    `mats` holds each class's (M, E) as prepare_lowrank returns them (the
    plain version's operands). On a CUDA device the kernel's layout is
    added: every M transposed to k-major (MT, K x N) with the destination
    states padded to SaP = round_up(Sa, 4), all classes packed into `mt`,
    their E blocks into `e`, and one descriptor row per class in `desc`
    (kind, side, rank, n_tok, K, N, mt_off, e_off, z_off)."""
    Sa: int
    To: int
    classes: tuple
    c0: torch.Tensor
    mats: list
    SaP: int = 0
    k_total: int = 0
    c0_pad: torch.Tensor = None
    mt: torch.Tensor = None
    e: torch.Tensor = None
    desc: np.ndarray = None


def lowrank_operands(plan, mats, To, device):
    """Move a prepare_lowrank result to `device` (a torch.device); To is
    the output alphabet size (the diag class's token is x*To + y)."""
    Sa = plan["Sa"]
    ops = LowrankOperands(
        Sa=Sa, To=To, classes=plan["classes"],
        c0=torch.tensor(plan["c0"][:, 0], device=device),
        mats=[(torch.tensor(M, device=device), torch.tensor(E, device=device))
              for M, E in mats])
    if device.type != "cuda":
        return ops
    SaP = _round_up(max(Sa, 1), _TD)
    mt_parts, e_parts, desc = [], [], []
    mt_off = e_off = z_off = 0
    for cs, (M, E) in zip(plan["classes"], mats):
        R = cs.rank
        if cs.side == "src":
            K, N = R * Sa, SaP
            mt_c = np.zeros((K, N), np.float32)
            mt_c[:, :Sa] = M.T                     # MT[(r,s), d] = M[d, (r,s)]
        else:
            K, N = Sa, R * SaP
            mt_c = np.zeros((K, R, SaP), np.float32)
            # MT[s, (r, d)] = M[(r, d), s]
            mt_c[:, :, :Sa] = M.reshape(R, Sa, Sa).transpose(2, 0, 1)
            mt_c = mt_c.reshape(K, N)
        desc.append([_KINDS[cs.name], _SIDES[cs.side], R, cs.n_tok, K, N,
                     mt_off, e_off, z_off])
        mt_parts.append(mt_c.ravel())
        e_parts.append(np.ascontiguousarray(E, np.float32).ravel())
        mt_off += mt_c.size
        e_off += E.size
        z_off += K
    c0_pad = np.zeros(SaP, np.float32)
    c0_pad[:Sa] = plan["c0"][:, 0]
    empty = np.zeros(4, np.float32)
    ops.SaP = SaP
    ops.k_total = z_off
    ops.c0_pad = torch.tensor(c0_pad, device=device)
    ops.mt = torch.tensor(np.concatenate(mt_parts) if mt_parts else empty,
                          device=device)
    ops.e = torch.tensor(np.concatenate(e_parts) if e_parts else empty,
                         device=device)
    ops.desc = np.ascontiguousarray(desc, np.int32).reshape(-1)
    return ops


def lowrank_forward_plain(ops, in_toks, out_toks, in_lens, out_lens,
                          rescale_every=4):
    """Plain PyTorch version of the lowrank wavefront, float32.

    in_toks (B, Li), out_toks (B, Lo), in_lens/out_lens (B,) integer
    tensors on the device of `ops`. Cells are indexed by i on each
    diagonal d = i + o, slab (B, Li+1, Sa); the loop stops at the batch's
    last readout diagonal. Returns (B,) log-likelihoods."""
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    Sa, To = ops.Sa, ops.To
    W = Li + 1
    dev = ops.c0.device
    f32 = torch.float32
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    i_idx = torch.arange(W, device=dev)
    b_idx = torch.arange(B, device=dev)
    il = in_lens.long()
    dfin = il + out_lens.long()
    x_tok = in_toks.long()[:, torch.clamp(i_idx - 1, 0, max(Li - 1, 0))] \
        if Li else torch.zeros((B, W), dtype=torch.long, device=dev)

    p1 = torch.zeros((B, W, Sa), dtype=f32, device=dev)
    p1[:, 0] = ops.c0
    m1 = torch.full((B, W), NEG_INF, dtype=f32, device=dev)
    m1[:, 0] = 0.0
    p2 = torch.zeros_like(p1)
    m2 = torch.full_like(m1, NEG_INF)

    def readout(p, m):
        end = p[b_idx, il, Sa - 1]
        return torch.where(end > 0, m[b_idx, il]
                           + torch.log(torch.clamp(end, min=1e-37)), neg)

    res = torch.where(dfin == 0, readout(p1, m1), neg)
    zp = torch.zeros((B, 1, Sa), dtype=f32, device=dev)
    zm = torch.full((B, 1), NEG_INF, dtype=f32, device=dev)
    n_diag = int(dfin.max()) if B else 0
    for d in range(1, n_diag + 1):
        o_idx = d - i_idx
        valid = (o_idx >= 0) & (o_idx <= Lo)
        y_tok = out_toks.long()[:, torch.clamp(o_idx - 1, 0, max(Lo - 1, 0))] \
            if Lo else torch.zeros((B, W), dtype=torch.long, device=dev)
        nb = {"up": (p1, m1),
              "left": (torch.cat([zp, p1[:, :-1]], 1),
                       torch.cat([zm, m1[:, :-1]], 1)),
              "diag": (torch.cat([zp, p2[:, :-1]], 1),
                       torch.cat([zm, m2[:, :-1]], 1))}
        tok = {"up": y_tok, "left": x_tok, "diag": x_tok * To + y_tok}
        mu = torch.full((B, W), NEG_INF, dtype=f32, device=dev)
        for cs in ops.classes:
            mu = torch.maximum(mu, nb[cs.name][1])
        mu_safe = torch.where(mu > NEG_INF / 2, mu, torch.zeros_like(mu))
        cur = torch.zeros((B, W, Sa), dtype=f32, device=dev)
        for cs, (M, E) in zip(ops.classes, ops.mats):
            p_op, m_op = nb[cs.name]
            w = torch.where(m_op > NEG_INF / 2, torch.exp(m_op - mu_safe),
                            torch.zeros_like(m_op))
            sc = E.t()[tok[cs.name]]               # (B, W, R*Sa)
            q = p_op * w[:, :, None]
            if cs.side == "src":
                z = q.repeat(1, 1, cs.rank) * sc
                cur = cur + z @ M.t()
            else:
                out = (q @ M.t()) * sc
                cur = cur + out.reshape(B, W, cs.rank, Sa).sum(dim=2)
        m_new = torch.where(valid[None, :], mu, neg)
        cur = torch.where(valid[None, :, None], cur, torch.zeros_like(cur))
        # rescale on TWO consecutive diagonals so both parities (the diag
        # class lives on one of them) are renormalised
        if d % rescale_every <= 1:
            mx = cur.max(dim=-1).values
            has = (mx > 0) & valid[None, :]
            den = torch.clamp(mx, min=1e-37)
            cur = torch.where(has[:, :, None], cur / den[:, :, None],
                              torch.zeros_like(cur))
            m_new = torch.where(has, m_new + torch.log(den), neg)
        res = torch.where(dfin == d, readout(cur, m_new), res)
        p2, m2, p1, m1 = p1, m1, cur, m_new
    return res


def _chunk_cells(Li, k_total):
    per_cell = (k_total + 6) * 4
    cap = (SMEM_BUDGET - 16) // per_cell // _TC * _TC
    if cap < _TC:
        raise ValueError(
            "lowrank kernel: the class operands take %d rows per cell; "
            "shared memory (%d bytes a block) holds at most %d"
            % (k_total, SMEM_BUDGET, (SMEM_BUDGET - 16) // (_TC * 4) - 6))
    return min(_round_up(Li + 1, _TC), cap)


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s has dtype %s, expected %s"
                        % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def lowrank_wavefront(ops, in_toks, out_toks, in_lens, out_lens,
                      rescale_every=4):
    """Lowrank wavefront Forward: (B,) float32 log-likelihoods.

    A CUDA tensor launches csrc/lowrank_wavefront.cu (one block per pair)
    and counts one launch in `lowrank_wavefront.launches`; a CPU tensor
    takes lowrank_forward_plain. Token and length tensors are int32 and
    contiguous, on the device of `ops`. A pair whose length exceeds the
    padded shape or whose token lies outside its alphabet comes back NaN."""
    if in_toks.device.type == "cpu":
        return lowrank_forward_plain(ops, in_toks, out_toks, in_lens,
                                     out_lens, rescale_every)
    if in_toks.device.type != "cuda":
        raise ValueError("lowrank_wavefront runs on cuda or cpu tensors, "
                         "not %s" % in_toks.device)
    if ops.mt is None:
        raise ValueError("operands were prepared for %s, not the card"
                         % ops.c0.device)
    if rescale_every < 1:
        raise ValueError("rescale_every must be >= 1")
    dev = ops.c0.device
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    _check(in_toks, "in_toks", torch.int32, (B, Li), dev)
    _check(out_toks, "out_toks", torch.int32, (B, Lo), dev)
    _check(in_lens, "in_lens", torch.int32, (B,), dev)
    _check(out_lens, "out_lens", torch.int32, (B,), dev)
    CC = _chunk_cells(Li, ops.k_total)
    W = Li + 1
    out = torch.empty(B, dtype=torch.float32, device=dev)
    pbuf = torch.empty(max(B * 3 * W * ops.SaP, 1), dtype=torch.float32,
                       device=dev)
    mbuf = torch.empty(max(B * 3 * W, 1), dtype=torch.float32, device=dev)
    lib = load("lowrank_wavefront")
    fn = lib.lowrank_wavefront_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 10 + [I] * 8 + [ctypes.POINTER(I), I, I, P]
    fn.restype = I
    desc = ops.desc
    rc = fn(in_toks.data_ptr(), out_toks.data_ptr(), in_lens.data_ptr(),
            out_lens.data_ptr(), ops.c0_pad.data_ptr(), ops.mt.data_ptr(),
            ops.e.data_ptr(), pbuf.data_ptr(), mbuf.data_ptr(),
            out.data_ptr(), B, Li, Lo, ops.Sa, ops.SaP, ops.To,
            rescale_every, len(ops.classes),
            desc.ctypes.data_as(ctypes.POINTER(I)), CC, ops.k_total,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("lowrank_wavefront launch failed: CUDA error %d"
                           % rc)
    lowrank_wavefront.launches += 1
    return out


lowrank_wavefront.launches = 0


def make_lowrank_forward(a_diag, a_left, a_up, closure, B, Li, Lo,
                         device=None, rescale_every=4, chain=None):
    """Build the low-rank wavefront Forward for fixed tensors/shapes.

    Log-space numpy tensors as lowering.matrices_2d returns them. Returns
    fn(in_toks (B,Li), out_toks (B,Lo), in_lens, out_lens) -> (B,) float32
    log-likelihoods on `device` (None: the card). Chained mode (chain=N)
    is not ported yet."""
    if chain is not None:
        raise NotImplementedError(
            "lowrank chained mode (chain=%r) is not ported yet: ROADMAP.md "
            "queue A, item 10" % (chain,))
    dev = resolve_device(device)
    plan, mats = prepare_lowrank(a_diag, a_left, a_up, closure)
    ops = lowrank_operands(plan, mats, a_diag.shape[1], dev)

    def forward(in_toks, out_toks, in_lens, out_lens):
        args = [torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
                for x in (in_toks, out_toks, in_lens, out_lens)]
        if tuple(args[0].shape) != (B, Li) or tuple(args[1].shape) != (B, Lo):
            raise ValueError("expected tokens of shape (%d, %d) and (%d, %d)"
                             % (B, Li, B, Lo))
        return lowrank_wavefront(ops, *args, rescale_every=rescale_every)

    return forward
