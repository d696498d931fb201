"""Wavefront 2D Forward for full-rank machines: every kernel of the JAX
factory.

Counterpart of machineboss_tpu's ops/pallas/wavefront_kernel.py. Each
variant of `make_wavefront_forward` has a host prep (numpy, giving the
numbers the JAX factory hands its kernel), a plain PyTorch version (float32
torch, used on the CPU and as the card's comparison) and the counted wrapper
of a hand-written CUDA kernel (a CUDA tensor launches the kernel or raises;
only a CPU tensor takes the plain version):

- merged=True: prepare_merged, merged_forward_plain, merged_wavefront;
- variant="chained_ragged": prepare_merged, chained_ragged_forward_plain,
  chained_ragged_wavefront;
- variant="chained": prepare_merged, chained_forward_plain,
  chained_wavefront;
- merged=False (generic): prepare_generic, generic_forward_plain,
  generic_wavefront;
- variant="seqscale": prepare_seqscale, seqscale_forward_plain,
  seqscale_wavefront;
- variant="factored": prepare_factored, factored_forward_plain,
  factored_wavefront.

Each wrapper `x_wavefront` launches csrc/x_wavefront.cu.
"lowrank" delegates to ops/kernels/lowrank_kernel.py.

The merged family's prep (`prepare_merged`):

1. the log-space class tensors go to probability space in float64;
2. absent transition classes (up / left / diag) are dropped; a machine with
   no symbol transitions at all keeps an (all-zero) up class;
3. the silent closure C is folded into every neighbour matrix,
   F[tok] = C^T @ A[tok]^T (destination x source), so no per-cell closure
   product remains;
4. trailing silent sink states (e.g. End) are trimmed from the state
   vector when the readout state has only silent incoming transitions; the
   readout is then w . p_active with w = solve(C_aa, C[active, End]).

What the merged recurrence computes, per pair, on the cells (i, o) of its
own lattice, diagonal d = i + o, in scaled probability p (Sa floats) with a
per-cell log scale m: each present class reads one neighbour (up (i, o-1)
by the y token and left (i-1, o) by the x token on d-1, diag (i-1, o-1) by
(x, y) on d-2); mu = max of the neighbours' m; cur = sum over classes of
F_class[tok] @ (p_nb * exp(m_nb - mu)). On diagonals with
d % rescale_every <= 1 (both parities: diag-class mass lives on one) p is
divided by its max over states and the log of the max goes to m; a cell
whose max is not positive is zeroed. The readout at (il, ol) is
m + log(p[Sa-1]), or m + log(w . p) when sink-trimmed (ops/kernels/
plain_walk.py has this walk in torch).

What the other variants change:

- chained_ragged: scheduling only. The TPU kernel sorts a ragged batch by
  length and chains sequences back to back in each lane window; the CUDA
  counterpart is a persistent kernel with a work queue (the pairs in the
  same sorted order, stable, descending output length, each block taking
  the next pair from an atomic counter).
- chained: `chain` uniform-length pairs per lane window, staggered by
  sigma = Lo + 2 diagonals; lengths are ignored (every pair is read out at
  (Li, Lo)); pair n = k * (B / chain) + w is chain k of window w, and the
  rescale rule reads the absolute diagonal sigma * k + d.
- generic (merged=False): the class tensors NOT folded, the closure as its
  own product per cell (cur = C^T u), mu over all three neighbours, the
  rescale on every diagonal, no sink trim (readout at S-1).
- seqscale: the closure folded over the full state vector (no sink trim),
  ONE log scale per pair: no per-neighbour weights, and on
  d % rescale_every <= 1 both live diagonals are multiplied by the
  reciprocal of the pair's max.
- factored: each class factored per destination column,
  A[t, s, s'] = sum_r T_r[s, s'] E_r[t, s'] (factorize.py); per cell R
  shared products scaled by the token's E, then the closure product; the
  merged kernel's sink trim, scales and rescale.
"""

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ...utils.device import resolve_device
from .factorize import factorize_token_tensor
from ._build import load
from .lowrank_kernel import (_call, _check_batch, _round_up,
                             make_lowrank_forward)
from .plain_walk import NEG_INF, check_chain, walk_chained, walk_plain

_TD = 4          # destination states per thread (csrc/wavefront_common.cuh)
_KINDS = {"up": 0, "left": 1, "diag": 2}
# blocks the kernels' grids take per multiprocessor when the caller names
# no grid: enough resident warps to hide the L2 latency of the class blocks
_BLOCKS_PER_SM = 4
_ZTOL = 1e-290   # a class whose probability mass sums below this is absent


def ragged_span(in_lens, out_lens, n_chain):
    """Exact diagonal span of the sorted shared-stagger ragged schedule
    (host-side; pass as n_abs_hint to make_wavefront_forward)."""
    ol = np.sort(np.asarray(out_lens))[::-1]
    il_by = np.asarray(in_lens)[np.argsort(-np.asarray(out_lens),
                                           kind="stable")]
    B = len(ol) // n_chain
    lomax = [int(ol[k * B:(k + 1) * B].max()) for k in range(n_chain)]
    limax = [int(il_by[k * B:(k + 1) * B].max()) for k in range(n_chain)]
    D = 0
    span = 0
    for k in range(n_chain):
        span = max(span, D + limax[k] + lomax[k] + 1)
        D += lomax[k] + 2
    return span


def _prob(a_diag, a_left, a_up, closure):
    """The log-space tensors in probability space, float64, as the JAX
    factory takes them (exp of the log clamped at -700)."""
    return tuple(np.exp(np.maximum(np.asarray(x, np.float64), -700))
                 for x in (a_diag, a_left, a_up, closure))


def _classes(diag_p, left_p, up_p):
    """(has_up, has_left, has_diag): which classes carry mass."""
    return (float(up_p.sum()) > _ZTOL, float(left_p.sum()) > _ZTOL,
            float(diag_p.sum()) > _ZTOL)


def prepare_merged(a_diag, a_left, a_up, closure):
    """Host prep of the merged kernel family: fold the closure into every
    present class, trim trailing sink states.

    Log-space numpy tensors as lowering.matrices_2d returns them. Returns a
    plan dict: Ti, To, Sa (states kept), sink (bool), classes (has_up,
    has_left, has_diag), mats {name: (n_tok, Sa, Sa) float32, destination x
    source, token x*To + y for diag} for the present classes, c0 (Sa,)
    start vector and w (Sa,) sink readout vector (zeros when not
    trimmed)."""
    diag_p, left_p, up_p, closure_p = _prob(a_diag, a_left, a_up, closure)
    Ti, To, S, _ = a_diag.shape
    closure_t = np.ascontiguousarray(closure_p.T).astype(np.float32)

    # class presence: absent transition classes are specialized away
    has_up, has_left, has_diag = _classes(diag_p, left_p, up_p)
    if not (has_up or has_left or has_diag):
        # degenerate (no symbol transitions): keep the UP class, whose
        # path needs no input tokens
        has_up = True

    def fold(Sa, c_aa):
        mats = {}
        if has_up:
            mats["up"] = np.array(
                [c_aa.T @ np.asarray(up_p[t, :Sa, :Sa], np.float64).T
                 for t in range(To)]).reshape(To, Sa, Sa)
        if has_left:
            mats["left"] = np.array(
                [c_aa.T @ np.asarray(left_p[t, :Sa, :Sa], np.float64).T
                 for t in range(Ti)]).reshape(Ti, Sa, Sa)
        if has_diag:
            mats["diag"] = np.array(
                [c_aa.T @ np.asarray(diag_p[ti, to, :Sa, :Sa], np.float64).T
                 for ti in range(Ti) for to in range(To)]) \
                .reshape(Ti * To, Sa, Sa)
        return {k: np.ascontiguousarray(v).astype(np.float32)
                for k, v in mats.items()}

    # sink trim: a trailing block of states with no outgoing transitions
    # (symbol rows all zero, closure row = identity) never feeds the DP; if
    # additionally the readout state S-1 has only silent incoming
    # transitions, its value is w^T p_active
    Sa, sink, w_vec = S, False, np.zeros(S, np.float32)
    c_aa = closure_p
    eye = np.eye(S)
    is_sink = np.array([
        float(diag_p[:, :, s, :].sum() + left_p[:, s, :].sum()
              + up_p[:, s, :].sum()) < _ZTOL
        and float(np.abs(closure_p[s] - eye[s]).sum()) < _ZTOL
        for s in range(S)])
    n_trail = 0
    while n_trail < S - 1 and is_sink[S - 1 - n_trail]:
        n_trail += 1
    readout_silent_in = (
        float(diag_p[:, :, :, S - 1].sum() + left_p[:, :, S - 1].sum()
              + up_p[:, :, S - 1].sum()) < _ZTOL)
    if n_trail > 0 and readout_silent_in:
        Sa, sink = S - n_trail, True
        c_aa = np.asarray(closure_p[:Sa, :Sa], np.float64)
        c_ae = np.asarray(closure_p[:Sa, S - 1], np.float64)
        w_vec = np.linalg.solve(c_aa, c_ae).astype(np.float32)
    return {"Ti": Ti, "To": To, "Sa": Sa, "sink": sink,
            "classes": (has_up, has_left, has_diag),
            "mats": fold(Sa, c_aa),
            "c0": np.ascontiguousarray(closure_t[:Sa, 0]),
            "w": w_vec}


def prepare_generic(a_diag, a_left, a_up, closure):
    """Host prep of the generic (unmerged) kernel: the class tensors as
    they are, not closure-folded, and the closure's transpose, over all S
    states (no sink trim), float32 as the JAX factory builds diag2,
    left_cat, up_cat and closure_t.

    Returns a plan dict in prepare_merged's form (Sa = S, sink False, mats
    of the present classes as destination x source blocks A[tok]^T, c0 =
    C[0, :]) plus `closure`, the (S, S) destination x source C^T."""
    diag_p, left_p, up_p, closure_p = _prob(a_diag, a_left, a_up, closure)
    Ti, To, S, _ = a_diag.shape
    present = dict(zip(("up", "left", "diag"),
                       _classes(diag_p, left_p, up_p)))
    blocks = {"up": np.transpose(up_p, (0, 2, 1)),
              "left": np.transpose(left_p, (0, 2, 1)),
              "diag": np.transpose(diag_p, (0, 1, 3, 2))
              .reshape(Ti * To, S, S)}
    closure_t = np.ascontiguousarray(closure_p.T).astype(np.float32)
    return {"Ti": Ti, "To": To, "Sa": S, "sink": False,
            "classes": (present["up"], present["left"], present["diag"]),
            "mats": {k: np.ascontiguousarray(v).astype(np.float32)
                     for k, v in blocks.items() if present[k]},
            "c0": np.ascontiguousarray(closure_t[:, 0]),
            "w": np.zeros(S, np.float32), "closure": closure_t}


def prepare_seqscale(a_diag, a_left, a_up, closure):
    """Host prep of the seqscale kernel: the closure folded into every
    class over the full state vector (no sink trim), as the JAX factory
    builds m_ud (To*S, S + Ti*S) and m_left (S, Ti*S) for it.

    Returns a plan dict in prepare_merged's form (Sa = S, sink False) whose
    mats are the present classes' blocks cut from m_ud and m_left, plus
    `m_ud` and `m_left` themselves (float32)."""
    diag_p, left_p, up_p, closure_p = _prob(a_diag, a_left, a_up, closure)
    Ti, To, S, _ = a_diag.shape
    ct64 = np.asarray(closure_p, np.float64).T
    cu_blocks = [ct64 @ np.asarray(up_p[t], np.float64).T for t in range(To)]
    cd = np.zeros((To * S, Ti * S))
    for to in range(To):
        for ti in range(Ti):
            cd[to * S:(to + 1) * S, ti * S:(ti + 1) * S] = \
                ct64 @ np.asarray(diag_p[ti, to], np.float64).T
    m_ud = np.concatenate([np.concatenate(cu_blocks, axis=0), cd], axis=1) \
        if To else np.zeros((0, S + Ti * S))
    m_left = np.concatenate(
        [ct64 @ np.asarray(left_p[t], np.float64).T for t in range(Ti)],
        axis=1) if Ti else np.zeros((S, 0))
    m_ud = np.ascontiguousarray(m_ud).astype(np.float32)
    m_left = np.ascontiguousarray(m_left).astype(np.float32)
    has_up, has_left, has_diag = _classes(diag_p, left_p, up_p)
    mats = {}
    if has_up:
        mats["up"] = np.array([m_ud[t * S:(t + 1) * S, :S]
                               for t in range(To)]).reshape(To, S, S)
    if has_left:
        mats["left"] = np.array([m_left[:, t * S:(t + 1) * S]
                                 for t in range(Ti)]).reshape(Ti, S, S)
    if has_diag:
        mats["diag"] = np.array(
            [m_ud[to * S:(to + 1) * S, S + ti * S:S + (ti + 1) * S]
             for ti in range(Ti) for to in range(To)]).reshape(Ti * To, S, S)
    closure_t = np.ascontiguousarray(closure_p.T).astype(np.float32)
    return {"Ti": Ti, "To": To, "Sa": S, "sink": False,
            "classes": (has_up, has_left, has_diag),
            "mats": {k: np.ascontiguousarray(v) for k, v in mats.items()},
            "c0": np.ascontiguousarray(closure_t[:, 0]),
            "w": np.zeros(S, np.float32), "m_ud": m_ud, "m_left": m_left}


@dataclass
class MergedOperands:
    """One machine's prepare_merged (or prepare_generic, prepare_seqscale)
    plan as tensors on one device.

    `mats` holds each present class's (n_tok, Sa, Sa) destination x source
    blocks (the plain version's operands), `closure` the generic plan's
    (Sa, Sa) destination x source C^T (None otherwise). On a CUDA device the
    kernel's layout is added: every block transposed to source-major and
    zero-padded to (SaP, SaP), SaP = round_up(Sa, 4), all classes packed
    into `mt`, with one descriptor row per class in `desc` (kind, n_tok,
    mt_off), and the closure source-major and padded in `ct`."""
    Sa: int
    Ti: int
    To: int
    sink: bool
    c0: torch.Tensor
    w: torch.Tensor
    mats: dict = field(default_factory=dict)
    closure: torch.Tensor = None
    SaP: int = 0
    c0_pad: torch.Tensor = None
    w_pad: torch.Tensor = None
    mt: torch.Tensor = None
    desc: np.ndarray = None
    ct: torch.Tensor = None

    @property
    def names(self):
        return [k for k in ("up", "left", "diag") if k in self.mats]


def _padded(m, SaP):
    """(..., n, n) float32 blocks zero-padded to (..., SaP, SaP)."""
    out = np.zeros(m.shape[:-2] + (SaP, SaP), np.float32)
    out[..., :m.shape[-2], :m.shape[-1]] = m
    return out


def merged_operands(plan, device):
    """Move a prepare_merged, prepare_generic or prepare_seqscale plan to
    `device` (a torch.device)."""
    Sa = plan["Sa"]
    closure = plan.get("closure")
    ops = MergedOperands(
        Sa=Sa, Ti=plan["Ti"], To=plan["To"], sink=bool(plan["sink"]),
        c0=torch.tensor(np.asarray(plan["c0"], np.float32), device=device),
        w=torch.tensor(np.asarray(plan["w"], np.float32)[:Sa],
                       device=device),
        mats={k: torch.tensor(plan["mats"][k], device=device)
              for k in ("up", "left", "diag") if k in plan["mats"]},
        closure=None if closure is None
        else torch.tensor(closure, device=device))
    if device.type != "cuda":
        return ops
    SaP = _round_up(max(Sa, 1), _TD)
    parts, desc, off = [], [], 0
    for name in ops.names:
        m = plan["mats"][name]
        n_tok = m.shape[0]
        mt = _padded(np.transpose(m, (0, 2, 1)), SaP)  # [tok, src, dest]
        desc.append([_KINDS[name], n_tok, off])
        parts.append(mt.ravel())
        off += mt.size
    pad = np.zeros((2, SaP), np.float32)
    pad[0, :Sa] = plan["c0"]
    pad[1, :Sa] = np.asarray(plan["w"])[:Sa]
    ops.SaP = SaP
    ops.c0_pad = torch.tensor(pad[0], device=device)
    ops.w_pad = torch.tensor(pad[1], device=device)
    ops.mt = torch.tensor(np.concatenate(parts + [np.zeros(4, np.float32)]),
                          device=device)
    ops.desc = np.ascontiguousarray(desc, np.int32).reshape(-1)
    if closure is not None:
        ops.ct = torch.tensor(_padded(np.asarray(closure).T, SaP),
                              device=device)
    return ops


def _merged_term(ops):
    """The class term of the merged layout for walk_plain: a class's token
    block is selected after one wide product against all of its blocks."""
    Sa = ops.Sa
    # [src, (tok, dest)] per class: one product serves every token
    wide = {k: m.permute(2, 0, 1).reshape(Sa, -1) for k, m in ops.mats.items()}

    def term(name, q, tok):
        B, W = tok.shape
        n_tok = ops.mats[name].shape[0]
        if n_tok == 0:
            return torch.zeros_like(q)
        out_all = (q @ wide[name]).reshape(B, W, n_tok, Sa)
        idx = tok[:, :, None, None].expand(-1, -1, 1, Sa)
        return torch.gather(out_all, 2, idx)[:, :, 0]
    return term


def merged_forward_plain(ops, in_toks, out_toks, in_lens, out_lens,
                         rescale_every=4, diag_offset=None):
    """Plain PyTorch version of the merged wavefront, float32.

    in_toks (B, Li), out_toks (B, Lo), in_lens/out_lens (B,) integer
    tensors on the device of `ops`. `diag_offset` (B,), if given, is the
    absolute diagonal each pair starts on, which the rescale rule reads
    (the chained schedule). Returns (B,) log-likelihoods."""
    return walk_plain(ops.c0, _merged_term(ops), ops.names, in_toks,
                      out_toks, in_lens, out_lens, ops.To, rescale_every,
                      readout_w=ops.w if ops.sink else None,
                      diag_offset=diag_offset)


def sorted_order(out_lens):
    """The order the ragged schedule takes pairs in: stable, descending
    output length. An int32 tensor on the device of `out_lens`."""
    return torch.argsort(out_lens.long(), descending=True, stable=True) \
        .to(torch.int32)


def chained_ragged_forward_plain(ops, in_toks, out_toks, in_lens, out_lens,
                                 rescale_every=4):
    """Plain PyTorch version of the ragged schedule: the pairs are taken
    longest first, each walks its own lattice by the merged recurrence
    from its own diagonal 0, and every score goes back to the pair's
    original index."""
    order = sorted_order(out_lens).long()
    res_sorted = merged_forward_plain(
        ops, in_toks[order], out_toks[order], in_lens[order],
        out_lens[order], rescale_every)
    res = torch.empty_like(res_sorted)
    res[order] = res_sorted
    return res


def chained_forward_plain(ops, in_toks, out_toks, in_lens=None,
                          out_lens=None, n_chain=4, rescale_every=4):
    """Plain PyTorch version of the chained schedule
    (plain_walk.walk_chained over merged_forward_plain): every pair read
    out at (Li, Lo), the rescale rule on the absolute diagonal."""
    return walk_chained(merged_forward_plain, ops, in_toks, out_toks,
                        n_chain, rescale_every)


def generic_forward_plain(ops, in_toks, out_toks, in_lens, out_lens):
    """Plain PyTorch version of the generic kernel (a prepare_generic
    plan): mu over all three neighbours, the unfolded class terms, the
    closure product C^T u per cell, the rescale on every diagonal, readout
    at S-1. Returns (B,) log-likelihoods."""
    return walk_plain(ops.c0, _merged_term(ops), ops.names, in_toks,
                      out_toks, in_lens, out_lens, ops.To, rescale_every=1,
                      mu_all=True, closure_t=ops.closure)


def seqscale_forward_plain(ops, in_toks, out_toks, in_lens, out_lens,
                           rescale_every=4):
    """Plain PyTorch version of the seqscale kernel (a prepare_seqscale
    plan), float32: ONE log scale M per pair, no per-neighbour weights;
    cur = sum over classes of F_class[tok] @ p_nb on the pair's own cells
    (i <= il, o <= ol); on d % rescale_every <= 1 both live diagonals are
    multiplied by the reciprocal of the pair's max over them (a factor of 1
    when it is 0) and M absorbs its log. Readout M + log(p[S-1]). Returns
    (B,)."""
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
    ol = out_lens.long()
    dfin = il + ol
    x_tok = in_toks.long()[:, torch.clamp(i_idx - 1, 0, max(Li - 1, 0))] \
        if Li else torch.zeros((B, W), dtype=torch.long, device=dev)
    term = _merged_term(ops)

    p1 = torch.zeros((B, W, Sa), dtype=f32, device=dev)
    p1[:, 0] = ops.c0
    p2 = torch.zeros_like(p1)
    M = torch.zeros(B, dtype=f32, device=dev)

    def readout(p):
        end = p[b_idx, il, Sa - 1]
        return torch.where(end > 0, M + torch.log(torch.clamp(end, min=1e-37)),
                           neg)

    res = torch.where(dfin == 0, readout(p1), neg)
    zp = torch.zeros((B, 1, Sa), dtype=f32, device=dev)
    n_diag = int(dfin.max()) if B else 0
    for d in range(1, n_diag + 1):
        o_idx = d - i_idx
        in_pair = ((o_idx >= 0)[None, :] & (i_idx[None, :] <= il[:, None])
                   & (o_idx[None, :] <= ol[:, None]))
        y_tok = out_toks.long()[:, torch.clamp(o_idx - 1, 0, max(Lo - 1, 0))] \
            if Lo else torch.zeros((B, W), dtype=torch.long, device=dev)
        has_y = (o_idx >= 1)[None, :, None]
        has_x = (i_idx >= 1)[None, :, None]
        nb = {"up": (p1 * has_y, y_tok),
              "left": (torch.cat([zp, p1[:, :-1]], 1) * has_x, x_tok),
              "diag": (torch.cat([zp, p2[:, :-1]], 1) * (has_x & has_y),
                       x_tok * To + y_tok)}
        cur = torch.zeros((B, W, Sa), dtype=f32, device=dev)
        for name in ops.names:
            cur = cur + term(name, *nb[name])
        cur = torch.where(in_pair[:, :, None], cur, torch.zeros_like(cur))
        if d % rescale_every <= 1:
            mx = torch.maximum(cur.amax(dim=(1, 2)), p1.amax(dim=(1, 2)))
            f = torch.where(mx > 0, mx, torch.ones_like(mx))
            inv = (1.0 / f)[:, None, None]
            cur = cur * inv
            p1 = p1 * inv
            M = M + torch.log(f)
        res = torch.where(dfin == d, readout(cur), res)
        p2, p1 = p1, cur
    return res


def prepare_factored(a_diag, a_left, a_up, closure):
    """Host prep of the factored kernel, as the JAX factory's: sink-state
    trim (exact-zero criterion), then each class tensor factored per
    destination column, A[t, s, s'] = sum_r T_r[s, s'] E_r[t, s'].

    Returns a dict: Ti, To, Sa, sink, w (Sa,) sink readout vector (zeros
    when not trimmed), c0 (Sa,), closure (Sa, Sa) C^T (destination x
    source), and classes: [(name, mt (r*Sa, Sa) with mt[(r, s'), s] =
    T_r[s, s'], e (r*Sa, n_tok) with e[(r, s'), t] = E_r[t, s'], r)] for
    the classes of rank > 0, in the order up, left, diag. Every array is
    float32."""
    def pz(a):
        a64 = np.asarray(a, np.float64)
        return np.where(a64 > -1e29, np.exp(np.minimum(a64, 700.0)), 0.0)

    diag_z, left_z, up_z, clo_z = (pz(a_diag), pz(a_left), pz(a_up),
                                   pz(closure))
    Ti, To, S, _ = diag_z.shape
    eye = np.eye(S)
    is_sink = np.array([
        float(diag_z[:, :, s, :].sum() + left_z[:, s, :].sum()
              + up_z[:, s, :].sum()) == 0.0
        and float(np.abs(clo_z[s] - eye[s]).sum()) == 0.0
        for s in range(S)])
    n_trail = 0
    while n_trail < S - 1 and is_sink[S - 1 - n_trail]:
        n_trail += 1
    readout_silent_in = (
        float(diag_z[:, :, :, S - 1].sum() + left_z[:, :, S - 1].sum()
              + up_z[:, :, S - 1].sum()) == 0.0)
    Sa, sink = S, False
    w_vec = np.zeros(S, np.float32)
    if n_trail > 0 and readout_silent_in:
        Sa, sink = S - n_trail, True
        w_vec = np.linalg.solve(clo_z[:Sa, :Sa], clo_z[:Sa, S - 1]) \
            .astype(np.float32)
        diag_z = diag_z[:, :, :Sa, :Sa]
        left_z = left_z[:, :Sa, :Sa]
        up_z = up_z[:, :Sa, :Sa]
        clo_z = clo_z[:Sa, :Sa]
    classes = []
    for name, tensor, n_tok in (("up", up_z, To), ("left", left_z, Ti),
                                ("diag", diag_z.reshape(Ti * To, Sa, Sa),
                                 Ti * To)):
        ts, es, r = factorize_token_tensor(tensor)
        if not r:
            continue
        mt = np.ascontiguousarray(
            np.transpose(ts, (0, 2, 1)).reshape(r * Sa, Sa)).astype(np.float32)
        e = np.ascontiguousarray(
            np.transpose(es, (0, 2, 1)).reshape(r * Sa, n_tok)) \
            .astype(np.float32)
        classes.append((name, mt, e, r))
    clo_t = np.ascontiguousarray(clo_z.T).astype(np.float32)
    return {"Ti": Ti, "To": To, "Sa": Sa, "sink": sink, "w": w_vec,
            "c0": np.ascontiguousarray(clo_t[:, 0]), "closure": clo_t,
            "classes": classes}


@dataclass
class FactoredOperands:
    """A prepare_factored plan as tensors on one device.

    `classes` holds (name, Tm (Sa, r*Sa) with Tm[s, (r, s')] = T_r[s, s'],
    Et (n_tok, r, Sa) with Et[t, r, s'] = E_r[t, s'], r) for the plain
    version. On a CUDA device the kernel's layout (`pack_factored`) is
    added: the units of A tiles `tab`, the token scales `ek`
    ([n_tok][r][SaP] per class, SaP = round_up(Sa, 4)), one descriptor row
    per class in `desc` (kind, n_tok, rank, e_off), the unit counts and
    the padded start and readout vectors."""
    Sa: int
    To: int
    sink: bool
    c0: torch.Tensor
    w: torch.Tensor
    closure: torch.Tensor
    classes: list
    SaP: int = 0
    NR: int = 0
    KT: int = 0
    n_mt: int = 0
    nbp: int = 0
    e_floats: int = 0
    c0_pad: torch.Tensor = None
    w_pad: torch.Tensor = None
    tab: torch.Tensor = None
    ek: torch.Tensor = None
    desc: np.ndarray = None

    @property
    def names(self):
        return [c[0] for c in self.classes]


# csrc/factored_wavefront.cu: the class descriptor's length, the most ranks
# summed over the classes, the least streamed group (in units) worth a
# second walker in a block, and a block's shared memory on sm_90
FDESC_LEN = 4
_FAC_MAX_NR = 128
_FAC_MIN_SEG_TWO = 2
# the chunked factored layout: the least group of units it takes a smaller
# chunk for (each chunk streams every unit once)
_FAC_MIN_SEG_CHUNK = 4
SMEM_MAX = 232448


def _frag_tiles(mats, Sa):
    """(n, Sa, Sa) destination-major matrices -> (n_mt, n, KT, 128): each
    16 x 8 tile in the A fragment order of mma.m16n8k8 (lane g*4 + t holds
    A[g, t], A[g+8, t], A[g, t+4], A[g+8, t+4])."""
    n = len(mats)
    n_mt, KT = -(-Sa // 16), -(-Sa // 8)
    pad = np.zeros((n, n_mt * 16, KT * 8), np.float32)
    pad[:, :Sa, :Sa] = mats
    # (n, mt, h, g, kt, c, t) -> (mt, n, kt, g, t, c, h)
    return pad.reshape(n, n_mt, 2, 8, KT, 2, 4) \
        .transpose(1, 0, 4, 3, 6, 5, 2).reshape(n_mt, n, KT, 128)


def _unfrag_tiles(tiles, n, Sa):
    """The inverse of _frag_tiles: (n_mt, n, KT, 128) -> (n, Sa, Sa)."""
    n_mt, KT = -(-Sa // 16), -(-Sa // 8)
    pad = np.asarray(tiles).reshape(n_mt, n, KT, 8, 4, 2, 2) \
        .transpose(1, 0, 6, 3, 2, 5, 4).reshape(n, n_mt * 16, KT * 8)
    return pad[:, :Sa, :Sa]


def pack_factored(plan):
    """The kernel's layout of a prepare_factored plan (numpy).

    The tables are "units" of 16 destination rows by every source state,
    KT * 128 floats each (KT = ceil(Sa / 8)): first the stage-A units of
    the matrices T_r^T (destination x source), rank row k (the classes'
    ranks in class order) of destination tile m at index k * n_mt + m,
    each source-major ([KT * 8 source states][16 rows], for the f32
    register tiles); then the n_mt stage-B units of C^T, each KT A tiles
    in mma.m16n8k8 fragment order. E is stored per class as
    [n_tok][r][SaP]. Returns (tab (NU * KT * 128,), ek, desc (n_cls,
    FDESC_LEN) int32 rows (kind, n_tok, rank, e_off), n_mt, KT, NR,
    SaP)."""
    Sa = plan["Sa"]
    SaP = _round_up(max(Sa, 1), _TD)
    mats, e_parts, desc = [], [], []
    e_off = 0
    for name, mt, e, r in plan["classes"]:
        n_tok = e.shape[1]
        mats.append(np.asarray(mt, np.float32).reshape(r, Sa, Sa))
        ek = np.zeros((n_tok, r, SaP), np.float32)
        ek[:, :, :Sa] = np.transpose(e.reshape(r, Sa, n_tok), (2, 0, 1))
        desc.append([_KINDS[name], n_tok, r, e_off])
        e_parts.append(ek.ravel())
        e_off += ek.size
    rows = np.concatenate(mats) if mats else np.zeros((0, Sa, Sa), np.float32)
    NR = len(rows)
    n_mt, KP = -(-Sa // 16), -(-Sa // 8) * 8
    pad = np.zeros((NR, n_mt * 16, KP), np.float32)
    pad[:, :Sa, :Sa] = rows
    # (NR, mt, 16 rows, KP) -> (NR, mt, KP, 16): source-major units
    stage_a = pad.reshape(NR, n_mt, 16, KP).transpose(0, 1, 3, 2)
    stage_b = _frag_tiles(np.asarray(plan["closure"], np.float32)[None], Sa)
    tab = np.concatenate([stage_a.ravel(), stage_b.ravel()])
    ek = np.concatenate(e_parts) if e_parts else np.zeros(0, np.float32)
    return (tab, ek, np.asarray(desc, np.int32).reshape(-1, FDESC_LEN),
            -(-Sa // 16), -(-Sa // 8), NR, SaP)


def unpack_factored(tab, ek, desc, Sa):
    """The inverse of pack_factored: (classes, closure) with each class's
    (mt, e, r) and C^T as prepare_factored gave them."""
    n_mt, KT = -(-Sa // 16), -(-Sa // 8)
    SaP = _round_up(max(Sa, 1), _TD)
    NR = int(np.asarray(desc)[:, 2].sum()) if len(desc) else 0
    tab = np.asarray(tab)
    n_a = NR * n_mt * KT * 128
    rows = tab[:n_a].reshape(NR, n_mt, KT * 8, 16).transpose(0, 1, 3, 2) \
        .reshape(NR, n_mt * 16, KT * 8)[:, :Sa, :Sa]
    closure = _unfrag_tiles(tab[n_a:], 1, Sa)[0]
    classes, k = [], 0
    for _, n_tok, r, e_off in desc:
        mt = rows[k:k + r].reshape(r * Sa, Sa)
        e4 = np.asarray(ek)[e_off:e_off + n_tok * r * SaP] \
            .reshape(n_tok, r, SaP)[:, :, :Sa]
        e = np.transpose(e4, (1, 2, 0)).reshape(r * Sa, n_tok)
        classes.append((np.ascontiguousarray(mt), np.ascontiguousarray(e),
                        int(r)))
        k += r
    return classes, np.ascontiguousarray(closure)


def factored_operands(plan, device):
    """Move a prepare_factored plan to `device` (a torch.device)."""
    Sa = plan["Sa"]
    classes = []
    for name, mt, e, r in plan["classes"]:
        n_tok = e.shape[1]
        classes.append((name, torch.tensor(np.ascontiguousarray(mt.T),
                                           device=device),
                        torch.tensor(np.ascontiguousarray(
                            e.T.reshape(n_tok, r, Sa)), device=device), r))
    ops = FactoredOperands(
        Sa=Sa, To=plan["To"], sink=bool(plan["sink"]),
        c0=torch.tensor(plan["c0"], device=device),
        w=torch.tensor(np.asarray(plan["w"], np.float32)[:Sa], device=device),
        closure=torch.tensor(plan["closure"], device=device), classes=classes)
    if device.type != "cuda":
        return ops
    tab, ek, desc, ops.n_mt, ops.KT, ops.NR, ops.SaP = pack_factored(plan)
    ops.nbp = 2 if any(c[0] == "diag" for c in plan["classes"]) else 1
    ops.e_floats = _round_up(max(ek.size, 1), 4)
    ek_pad = np.zeros(ops.e_floats, np.float32)
    ek_pad[:ek.size] = ek
    pad = np.zeros((2, ops.SaP), np.float32)
    pad[0, :Sa] = plan["c0"]
    pad[1, :Sa] = np.asarray(plan["w"])[:Sa]
    ops.c0_pad = torch.tensor(pad[0], device=device)
    ops.w_pad = torch.tensor(pad[1], device=device)
    ops.tab = torch.tensor(tab, device=device)
    ops.ek = torch.tensor(ek_pad, device=device)
    ops.desc = np.ascontiguousarray(desc, np.int32).reshape(-1)
    return ops


def _bank_stride(n):
    s = _round_up(n, 8)
    while s % 32 not in (8, 24):
        s += 8
    return s


def factored_smem_bytes(Sa, NR, Li, Lo, ns, nbp, seg, e_floats, CC=0):
    """The shared bytes of the factored kernel's block (the layout of
    csrc/factored_wavefront.cu): the tables (all units, or a ring of two
    groups of `seg`), E (e_floats, 0 when read from global memory), nbp
    state operands and pre, and per walker its cells' weights, tokens, log
    scales and maxima, its pair's tokens and its state. CC > 0 is the
    chunked layout (one walker): operands, pre, weights, tokens and maxima
    of CC cells, and no log scales or pair tokens (in global memory,
    factored_chunk_gbytes)."""
    KT, n_mt = -(-Sa // 8), -(-Sa // 16)
    U = KT * 128
    NU = n_mt * (NR + 1)
    W = Li + 1
    CQ = CC if CC else _round_up(W, 8)
    KP = KT * 8
    PS, QS = _bank_stride(ns * (CQ + 4)), _bank_stride(ns * CQ)
    n = (NU * U if seg >= NU else 2 * seg * U) + _round_up(e_floats, 4) \
        + nbp * KP * PS + KP * QS + 2 * _round_up(3 * ns * CQ, 4) \
        + 16 * ns + _round_up(ns * CQ // 8, 4)
    if CC:
        n += _round_up(ns * CQ, 4)
    else:
        n += _round_up(3 * ns * W, 4) + _round_up(ns * W, 4) \
            + _round_up(ns * Li, 4) + _round_up(ns * Lo, 4)
    return 4 * n


def factored_chunk_gbytes(Sa, Li):
    """The global bytes a block of the chunked factored layout takes: its
    cells' log scales of three diagonals and three diagonals of states (KP
    rows of round_up(Li + 1, 4) cells)."""
    W, KP = Li + 1, -(-Sa // 8) * 8
    return 4 * (_round_up(3 * W, 4) + 3 * KP * _round_up(W, 4))


def factored_launch_plan(ops, Li, Lo, walkers=None, chunk=None):
    """How the factored kernel lays out a block for this plan and padded
    lengths: a dict with `walkers` (pairs a block walks in lockstep, 1 or
    2), `seg` (units per streamed group; all units when `resident`),
    `resident`, `e_floats` (E in shared memory, 0 when read from global
    memory), `CC` (0: a whole diagonal in shared memory; else the chunked
    layout's cells a chunk) and `smem` (bytes).

    The tables stay resident when they fit, else they stream in the
    largest groups that fit. `walkers` None takes two where the tables are
    resident or stream in groups of at least 2 units (each streamed byte
    then serves both walkers' cells), else one. E goes to shared memory
    unless that costs the tables residency or group size. Where a whole
    diagonal fits no way, the chunked layout (one walker): the largest
    chunk of cells beside which the tables stream in groups of at least
    _FAC_MIN_SEG_CHUNK units (or all of them), else the largest chunk that
    fits. `chunk` forces the layout: 0 a whole diagonal, a multiple of 8
    the chunked layout with that many cells a chunk. A plan that fits no
    way raises ValueError."""
    if walkers not in (None, 1, 2):
        raise ValueError("walkers must be 1 or 2")
    if chunk is not None and (chunk < 0 or chunk % 8):
        raise ValueError("chunk must be 0 or a positive multiple of 8, not "
                         "%r" % (chunk,))
    if ops.NR > _FAC_MAX_NR:
        raise ValueError("factored kernel: %d ranks, at most %d"
                         % (ops.NR, _FAC_MAX_NR))
    NU = ops.n_mt * (ops.NR + 1)

    def best(ns, cc=0):
        """The largest group of units that fits, E shared if it can be."""
        out = None
        for e in (ops.e_floats, 0):
            def size(seg):
                return factored_smem_bytes(ops.Sa, ops.NR, Li, Lo, ns,
                                           ops.nbp, seg, e, cc)
            seg = next((c for c in range(NU, 0, -1)
                        if size(c) <= SMEM_MAX), 0)
            if seg and (out is None or seg > out["seg"]):
                out = {"walkers": ns, "seg": seg, "resident": seg >= NU,
                       "e_floats": e, "CC": cc, "smem": size(seg)}
        return out

    if not chunk:
        for ns in ((walkers,) if walkers else (2, 1)):
            cfg = best(ns)
            if cfg is not None and (walkers or ns == 1 or cfg["resident"]
                                    or cfg["seg"] >= _FAC_MIN_SEG_TWO):
                return cfg
    if chunk != 0 and walkers != 2:
        least = min(NU, _FAC_MIN_SEG_CHUNK)
        fits = None
        # the largest chunk that fits at all (one unit a group, E global)
        lo, hi = 0, _round_up(Li + 1, 8) // 8
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if factored_smem_bytes(ops.Sa, ops.NR, Li, Lo, 1, ops.nbp, 1, 0,
                                   8 * mid) <= SMEM_MAX:
                lo = mid
            else:
                hi = mid - 1
        for cc in ((chunk,) if chunk else range(8 * lo, 7, -8)):
            cfg = best(1, cc)
            if cfg is None:
                continue
            fits = fits or cfg
            if cfg["seg"] >= least:
                return cfg
        if fits is not None:
            return fits
    raise ValueError(
        "factored kernel: %d states, %d ranks and %d cells a diagonal do not "
        "fit a block's %d bytes of shared memory%s (a whole diagonal of one "
        "walker takes %d bytes with E in global memory and 1 unit a group)"
        % (ops.Sa, ops.NR, Li + 1, SMEM_MAX,
           " with two walkers" if walkers == 2 else
           " in chunks of %d cells" % chunk if chunk else
           " in a whole diagonal" if chunk == 0 else "",
           factored_smem_bytes(ops.Sa, ops.NR, Li, Lo, 1, ops.nbp, 1, 0)))


def factored_launch_config(ops, B, Li, Lo, grid=None, walkers=None,
                           chunk=None, mem_bytes=None):
    """factored_launch_plan's layout plus the grid a launch takes: `grid`
    blocks (default one per multiprocessor, no more than the batch
    needs), and `bytes`, the chunked layout's global buffers (0 for a
    whole diagonal). Bytes over `mem_bytes` (the card's memory; default:
    the card's own, on the card) raise ValueError."""
    plan = factored_launch_plan(ops, Li, Lo, walkers, chunk)
    if grid is None or mem_bytes is None:
        props = torch.cuda.get_device_properties(ops.c0.device)
    if grid is None:
        grid = max(1, min(props.multi_processor_count,
                          -(-B // plan["walkers"])))
    if int(grid) < 1:
        raise ValueError("grid must be >= 1")
    plan["grid"] = int(grid)
    plan["bytes"] = grid * factored_chunk_gbytes(ops.Sa, Li) \
        if plan["CC"] else 0
    mem = props.total_memory if mem_bytes is None else mem_bytes
    if plan["bytes"] > mem:
        raise ValueError(
            "factored kernel: %d x %d takes %d bytes of device memory for %d "
            "blocks, over the card's %d" % (Li, Lo, plan["bytes"], grid, mem))
    return plan


def factored_smem_bytes_on_card(ops, cfg, Li, Lo):
    """The shared bytes the kernel's own layout takes for `cfg` (a
    factored_launch_plan for padded lengths Li, Lo), from the built
    library: must equal cfg["smem"]."""
    fn = load("factored_wavefront").factored_wavefront_smem_bytes
    fn.argtypes = [ctypes.c_int] * 9
    fn.restype = ctypes.c_long
    return fn(ops.Sa, ops.NR, Li, Lo, cfg["walkers"], ops.nbp, cfg["seg"],
              cfg["e_floats"], cfg["CC"])


def factored_chunk_gbytes_on_card(ops, Li):
    """The chunked layout's global bytes a block, from the built library:
    must equal factored_chunk_gbytes."""
    fn = load("factored_wavefront").factored_wavefront_chunk_gfloats
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_long
    return 4 * fn(ops.Sa, Li)


def factored_forward_plain(ops, in_toks, out_toks, in_lens, out_lens,
                           rescale_every=4):
    """Plain PyTorch version of the factored kernel (a prepare_factored
    plan), float32: per class sum_r (T_r^T q) * E_r[tok], then the closure
    C^T per cell, with the merged kernel's scales, rescale and readout.
    Returns (B,) log-likelihoods."""
    by_name = {c[0]: c for c in ops.classes}
    Sa = ops.Sa

    def term(name, q, tok):
        _, Tm, Et, r = by_name[name]
        B, W = tok.shape
        out = (q @ Tm).reshape(B, W, r, Sa)
        return (out * Et[tok]).sum(dim=2)

    return walk_plain(ops.c0, term, ops.names, in_toks, out_toks, in_lens,
                      out_lens, ops.To, rescale_every,
                      readout_w=ops.w if ops.sink else None,
                      closure_t=ops.closure)


# csrc/generic_wavefront.cu: warps a block, the cells a warp takes by
# default, the float4 destination chunks a lane may hold; and what one
# sm_90 multiprocessor holds (shared bytes, threads, shared bytes the
# runtime keeps per block)
_GENERIC_NWARP = 8
_GENERIC_CELLS_PER_WARP = 2
_GENERIC_CHUNKS = (1, 2, 4)
_SM_SMEM = 233472
_SM_THREADS = 2048
_BLOCK_RESERVED = 1024


def generic_smem_bytes(SaP, cells_per_warp, ct_resident):
    """The dynamic shared bytes of a generic kernel block: C^T (SaP x SaP)
    when resident, and SaP floats for each cell a block's warps hold."""
    return 4 * (SaP * SaP * int(bool(ct_resident))
                + _GENERIC_NWARP * cells_per_warp * SaP)


def _generic_chunks(SaP, cells_per_warp):
    """The float4 chunks a lane of the generic kernel holds when a warp
    takes `cells_per_warp` cells (csrc/generic_wavefront.cu, owned()):
    the lanes of a cell's group own its chunks round-robin; with two cells
    a warp a tail of at most 16 states is split one state a lane. None if
    more than the kernel's most."""
    gl = 32 // cells_per_warp
    n_dg = SaP // _TD
    lim = n_dg
    if gl < 32 and (n_dg - n_dg // gl * gl) * _TD <= gl:
        lim = n_dg // gl * gl
    return next((c for c in _GENERIC_CHUNKS if c * gl >= lim), None)


def generic_launch_plan(ops, cells_per_warp=None, ct_resident=None):
    """How the generic kernel lays out a block for this plan (the layout
    does not depend on the lengths): a dict with `cells_per_warp` (1 or 2:
    a group of 32 or 16 lanes takes a cell), `chunks` (float4 destination
    chunks a lane holds at most), `ct_resident` (C^T in shared memory, else
    read through L1/L2), `smem` (bytes) and `blocks_per_sm` (the blocks a
    multiprocessor holds by its shared memory, threads and registers: the
    kernel's launch bounds give a thread the registers of 4 blocks).

    `cells_per_warp` None takes two, or one where two a warp cannot hold
    the states; `ct_resident` None keeps C^T resident where that still
    leaves room for 4 blocks a multiprocessor, the default grid's one wave.
    A layout that cannot hold the states, or does not fit a block's shared
    memory, raises ValueError."""
    SaP = _round_up(max(ops.Sa, 1), _TD)
    if cells_per_warp is None:
        cells_per_warp = _GENERIC_CELLS_PER_WARP
        if _generic_chunks(SaP, cells_per_warp) is None:
            cells_per_warp = 1
    if cells_per_warp not in (1, 2):
        raise ValueError("cells_per_warp must be 1 or 2")
    chunks = _generic_chunks(SaP, cells_per_warp)
    if chunks is None:
        raise ValueError(
            "generic kernel: %d states need more than %d float4 chunks a "
            "lane at %d cells a warp" % (ops.Sa, _GENERIC_CHUNKS[-1],
                                         cells_per_warp))
    if ct_resident is None:
        ct_resident = generic_smem_bytes(SaP, cells_per_warp, True) <= \
            _SM_SMEM // _BLOCKS_PER_SM - _BLOCK_RESERVED
    smem = generic_smem_bytes(SaP, cells_per_warp, ct_resident)
    if smem > SMEM_MAX:
        raise ValueError(
            "generic kernel: %d states%s need %d shared bytes, a block has "
            "%d" % (ops.Sa, " with C^T resident" if ct_resident else "",
                    smem, SMEM_MAX))
    return {"cells_per_warp": cells_per_warp, "chunks": chunks,
            "ct_resident": bool(ct_resident), "smem": smem,
            "blocks_per_sm": min(_SM_THREADS // 256, _BLOCKS_PER_SM,
                                 _SM_SMEM // (smem + _BLOCK_RESERVED))}


def generic_smem_bytes_on_card(ops, cfg):
    """The shared bytes the kernel's own layout takes for `cfg` (a
    generic_launch_plan), from the built library: must equal cfg["smem"]."""
    fn = load("generic_wavefront").generic_wavefront_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_long
    return fn(ops.SaP, cfg["cells_per_warp"], int(cfg["ct_resident"]))


def generic_blocks_per_sm_on_card(ops, cfg):
    """The blocks of `cfg`'s layout one multiprocessor of the current card
    holds at once, by its registers, threads and shared memory (the CUDA
    occupancy calculator on the built kernel)."""
    fn = load("generic_wavefront").generic_wavefront_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = fn(ops.SaP, cfg["cells_per_warp"], cfg["chunks"],
           int(cfg["ct_resident"]))
    if n < 0:
        raise RuntimeError("generic_wavefront refused the layout %r" % cfg)
    return n


# ------------------------------------------------------------ the wrappers

def _default_grid(dev, B):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(B, _BLOCKS_PER_SM * sms))


def _grid(dev, B, grid):
    grid = _default_grid(dev, B) if grid is None else int(grid)
    if grid < 1:
        raise ValueError("grid must be >= 1")
    return grid


def _slots(n_blocks, W, SaP, dev):
    """The diagonal state of the pairs `n_blocks` blocks are walking: three
    rotating (W, SaP) slots and their log scales per block."""
    f32 = torch.float32
    return [torch.empty(max(n_blocks * 3 * W * SaP, 1), dtype=f32,
                        device=dev),
            torch.empty(max(n_blocks * 3 * W, 1), dtype=f32, device=dev)]


# walk_pair's layout bits (csrc/wavefront_common.cuh)
_WALK_NO_RANGE, _WALK_RESCALE_PASS, _WALK_SMEM_SLOTS = 1, 2, 4
_WALK_STATIC_SMEM = 1024   # the walk's own shared state, with room to spare


def walk_slot_bytes(W, SaP):
    """Shared bytes of walk_pair's three diagonal slots of W cells."""
    return 3 * W * (SaP + 1) * 4


def walk_launch_plan(SaP, Li, B, sms=132, live_range=True,
                     rescale_pass=None, slots=None):
    """The merged family's walk (walk_pair) for states padded to SaP,
    pairs padded to Li inputs and a batch of B, on `sms`
    multiprocessors. A pure function of the shape:

    - live_range: only the cells a live neighbour reaches get lanes (the
      design; False walks every lattice cell, a variant for timing);
    - rescale_pass: False keeps the rescale inside the product phase,
      which needs a cell's SaP / 4 lanes in one warp; wider state vectors
      take the separate pass;
    - slots: "global" (a scratch in L2, four blocks a multiprocessor;
      the default) or "shared" (the block's shared memory, as many
      blocks as fit: a variant, slower per pair on the card because the
      class blocks then lose L1);
    - blocks_per_sm and grid: one block a pair up to the blocks that fit.

    `opts` is the layout as the kernels take it. Raises ValueError for a
    layout the kernels cannot take."""
    wide = SaP // _TD > 32
    if rescale_pass is None:
        rescale_pass = wide
    if wide and not rescale_pass:
        raise ValueError("the rescale inside the product phase needs "
                         "SaP / 4 <= 32 (SaP %d)" % SaP)
    smem = walk_slot_bytes(Li + 1, SaP)
    per_sm = min(_BLOCKS_PER_SM, _SM_SMEM // (smem + _WALK_STATIC_SMEM))
    slots = slots or "global"
    if slots not in ("shared", "global"):
        raise ValueError("slots must be 'shared' or 'global'")
    if slots == "shared" and (per_sm < 1 or smem > SMEM_MAX):
        raise ValueError("%d bytes of slots do not fit a block" % smem)
    blocks = _BLOCKS_PER_SM if slots == "global" else per_sm
    opts = ((0 if live_range else _WALK_NO_RANGE)
            | (_WALK_RESCALE_PASS if rescale_pass else 0)
            | (_WALK_SMEM_SLOTS if slots == "shared" else 0))
    return {"live_range": bool(live_range), "rescale_pass": bool(rescale_pass),
            "slots": slots, "slot_bytes": smem, "blocks_per_sm": blocks,
            "grid": max(1, min(B, blocks * sms)), "opts": opts}


def walk_launch_config(ops, B, Li, grid=None, **layout):
    """walk_launch_plan for these operands on their card; `grid` (if
    given) overrides the plan's."""
    sms = torch.cuda.get_device_properties(ops.c0.device) \
        .multi_processor_count
    cfg = walk_launch_plan(ops.SaP, Li, B, sms=sms, **layout)
    if grid is not None:
        if int(grid) < 1:
            raise ValueError("grid must be >= 1")
        cfg["grid"] = int(grid)
    return cfg


def live_terms(names, il, ol):
    """The class terms these pairs' data needs: for each present class, the
    cells whose neighbour of that class can be reached from (0, 0) through
    the present classes (the others hold exact zeros), summed over the
    pairs; and the reachable cells but (0, 0). The 64-state dense machine
    has the diag class only, so a pair of 200 x 200 reaches 200 of its
    40,400 cells."""
    out = dict.fromkeys(names, 0.0)
    cells = 0.0
    seen = {}
    for a, b in zip(np.asarray(il, np.int64), np.asarray(ol, np.int64)):
        key = (int(a), int(b))
        if key not in seen:
            R = np.zeros((a + 1, b + 1), bool)
            for i in range(a + 1):
                row = np.zeros(b + 1, bool)
                if i == 0:
                    row[0] = True
                else:
                    if "left" in names:
                        row |= R[i - 1]
                    if "diag" in names:
                        row[1:] |= R[i - 1, :-1]
                if "up" in names:
                    row = np.logical_or.accumulate(row)
                R[i] = row
            nb = {"up": R[:, :-1].sum(), "left": R[:-1, :].sum(),
                  "diag": R[:-1, :-1].sum()}
            seen[key] = ({k: float(nb[k]) for k in names},
                         float(R.sum() - 1))
        terms, n = seen[key]
        for k in names:
            out[k] += terms[k]
        cells += n
    return out, cells


def _walk_slots(cfg, W, SaP, dev):
    """The global slots of a walk (one float each for shared slots)."""
    return _slots(cfg["grid"] if cfg["slots"] == "global" else 0, W, SaP,
                  dev)


def _launch(kernel, ops, in_toks, out_toks, in_lens, out_lens,
            rescale_every, grid, queue, layout):
    """The merged and chained_ragged launch. `queue` is None (merged) or
    (order, counter) device tensors; `layout` walk_launch_plan's
    keywords."""
    B, Li, Lo = _check_batch(kernel, ops, in_toks, out_toks, in_lens,
                             out_lens, rescale_every, ops.mt)
    dev = ops.c0.device
    cfg = walk_launch_config(ops, B, Li, grid, **layout)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    pbuf, mbuf = _walk_slots(cfg, Li + 1, ops.SaP, dev)
    _call(kernel, kernel,
          [in_toks, out_toks, in_lens, out_lens, ops.c0_pad, ops.w_pad,
           ops.mt, pbuf, mbuf, out] + list(queue or ()),
          [B, Li, Lo, ops.Sa, ops.SaP, ops.To, rescale_every, int(ops.sink),
           len(ops.names)], ops.desc, [cfg["grid"], cfg["opts"]], dev)
    return out


def merged_wavefront(ops, in_toks, out_toks, in_lens, out_lens,
                     rescale_every=4, grid=None, **layout):
    """Merged wavefront Forward: (B,) float32 log-likelihoods.

    A CUDA tensor launches csrc/merged_wavefront.cu and counts one launch
    in `merged_wavefront.launches`; a CPU tensor takes
    merged_forward_plain. Token and length tensors are int32 and
    contiguous, on the device of `ops`. `grid` is the number of blocks
    (default: one per pair, up to the blocks that fit, walk_launch_plan);
    block g walks pairs g, g + grid, ... `layout` (live_range,
    rescale_pass, slots) overrides walk_launch_plan's choice, for timing.
    A pair whose length exceeds the padded shape or whose token lies
    outside its alphabet comes back NaN."""
    if in_toks.device.type == "cpu":
        return merged_forward_plain(ops, in_toks, out_toks, in_lens,
                                    out_lens, rescale_every)
    out = _launch("merged_wavefront", ops, in_toks, out_toks, in_lens,
                  out_lens, rescale_every, grid, None, layout)
    merged_wavefront.launches += 1
    return out


merged_wavefront.launches = 0


def chained_ragged_wavefront(ops, in_toks, out_toks, in_lens, out_lens,
                             rescale_every=4, grid=None, **layout):
    """Ragged-schedule wavefront Forward: (B,) float32 log-likelihoods in
    the batch's own order.

    A CUDA tensor launches csrc/chained_ragged_wavefront.cu (a persistent
    grid of `grid` blocks that take pairs, longest first, from an atomic
    counter which this wrapper allocates and zeroes) and counts one launch
    in `chained_ragged_wavefront.launches`; a CPU tensor takes
    chained_ragged_forward_plain. grid=1 sends every pair through one
    block, one after the other. Other arguments (and `layout`) as
    merged_wavefront."""
    if in_toks.device.type == "cpu":
        return chained_ragged_forward_plain(ops, in_toks, out_toks, in_lens,
                                            out_lens, rescale_every)
    if out_lens.device.type != "cuda":
        raise ValueError("chained_ragged_wavefront runs on cuda or cpu "
                         "tensors, not %s" % out_lens.device)
    order = sorted_order(out_lens).contiguous()
    counter = torch.zeros(1, dtype=torch.int32, device=out_lens.device)
    out = _launch("chained_ragged_wavefront", ops, in_toks, out_toks,
                  in_lens, out_lens, rescale_every, grid, (order, counter),
                  layout)
    chained_ragged_wavefront.launches += 1
    return out


chained_ragged_wavefront.launches = 0


def chained_wavefront(ops, in_toks, out_toks, in_lens=None, out_lens=None,
                      n_chain=4, rescale_every=4, grid=None, **layout):
    """Chained wavefront Forward over a uniform-length batch: (B,) float32
    log-likelihoods, every pair read out at (Li, Lo) (the lengths are
    ignored; B must be a multiple of n_chain, Li and Lo at least 1).

    A CUDA tensor launches csrc/chained_wavefront.cu and counts one launch
    in `chained_wavefront.launches`; a CPU tensor takes
    chained_forward_plain. On the card the kernel is merged's per-pair walk:
    block g walks pairs g, g + grid, ... (`grid` as merged_wavefront's,
    default one per pair, at most 4 per multiprocessor), each on its
    chain's absolute-diagonal offset (Lo + 2) * (n // (B / n_chain)), which
    is all the chain changes (the rescale steps); the strip schedule of the
    TPU kernel (a block per n_chain pairs) is gone, because on this card it
    left multiprocessors idle. Token tensors are int32 and contiguous, on
    the device of `ops` (a prepare_merged plan). A pair with a token
    outside its alphabet comes back NaN."""
    if in_toks.device.type == "cpu":
        return chained_forward_plain(ops, in_toks, out_toks, n_chain=n_chain,
                                     rescale_every=rescale_every)
    B, Li, Lo = _check_batch("chained_wavefront", ops, in_toks, out_toks,
                             None, None, rescale_every, ops.mt)
    check_chain(B, Li, Lo, n_chain)
    dev = ops.c0.device
    cfg = walk_launch_config(ops, B, Li, grid, **layout)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    pbuf, mbuf = _walk_slots(cfg, Li + 1, ops.SaP, dev)
    _call("chained_wavefront", "chained_wavefront",
          [in_toks, out_toks, ops.c0_pad, ops.w_pad, ops.mt, pbuf, mbuf, out],
          [B, Li, Lo, ops.Sa, ops.SaP, ops.To, rescale_every, int(ops.sink),
           len(ops.names)], ops.desc, [n_chain, cfg["grid"], cfg["opts"]],
          dev)
    chained_wavefront.launches += 1
    return out


chained_wavefront.launches = 0


def generic_wavefront(ops, in_toks, out_toks, in_lens, out_lens, grid=None,
                      cells_per_warp=None, ct_resident=None, skip_dead=True):
    """Generic (unmerged) wavefront Forward: (B,) float32 log-likelihoods.

    `ops` is a prepare_generic plan (merged_operands). A CUDA tensor
    launches csrc/generic_wavefront.cu (block g walks pairs g, g + grid,
    ...; default grid as merged_wavefront) in the layout of
    generic_launch_plan (`cells_per_warp` and `ct_resident` None: the
    plan's choice) and counts one launch in `generic_wavefront.launches`;
    a CPU tensor takes generic_forward_plain. The rescale runs on every
    diagonal, as in the JAX kernel. A cell none of whose classes reaches a
    live neighbour is zero and takes no product; `skip_dead=False` takes
    them anyway (the same scores, for timing). Other arguments as
    merged_wavefront."""
    if in_toks.device.type == "cpu":
        return generic_forward_plain(ops, in_toks, out_toks, in_lens,
                                     out_lens)
    B, Li, Lo = _check_batch("generic_wavefront", ops, in_toks, out_toks,
                             in_lens, out_lens, 1, ops.ct)
    dev = ops.c0.device
    cfg = generic_launch_plan(ops, cells_per_warp, ct_resident)
    grid = _grid(dev, B, grid)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    pbuf, mbuf = _slots(grid, Li + 1, ops.SaP, dev)
    _call("generic_wavefront", "generic_wavefront",
          [in_toks, out_toks, in_lens, out_lens, ops.c0_pad, ops.mt, ops.ct,
           pbuf, mbuf, out],
          [B, Li, Lo, ops.Sa, ops.SaP, ops.To, len(ops.names)], ops.desc,
          [grid, cfg["cells_per_warp"], cfg["chunks"],
           int(cfg["ct_resident"]), int(bool(skip_dead))], dev)
    generic_wavefront.launches += 1
    return out


generic_wavefront.launches = 0


def seqscale_wavefront(ops, in_toks, out_toks, in_lens, out_lens,
                       rescale_every=4, grid=None, max_pass=False,
                       skip_dead=True):
    """Per-pair-scale wavefront Forward: (B,) float32 log-likelihoods.

    `ops` is a prepare_seqscale plan (merged_operands). A CUDA tensor
    launches csrc/seqscale_wavefront.cu (block g walks pairs g, g + grid,
    ...) and counts one launch in `seqscale_wavefront.launches`; a CPU
    tensor takes seqscale_forward_plain. A cell whose class sources are
    all zero takes no product. For timing, with the same scores:
    `max_pass` finds the pair's max by a separate pass over the live cells
    (the first design), `skip_dead=False` takes the products of the zero
    sources too. Other arguments as merged_wavefront."""
    if in_toks.device.type == "cpu":
        return seqscale_forward_plain(ops, in_toks, out_toks, in_lens,
                                      out_lens, rescale_every)
    B, Li, Lo = _check_batch("seqscale_wavefront", ops, in_toks, out_toks,
                             in_lens, out_lens, rescale_every, ops.mt)
    dev = ops.c0.device
    grid = _grid(dev, B, grid)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    pbuf, tags = _slots(grid, Li + 1, ops.SaP, dev)
    _call("seqscale_wavefront", "seqscale_wavefront",
          [in_toks, out_toks, in_lens, out_lens, ops.c0_pad, ops.mt, pbuf,
           tags, out],
          [B, Li, Lo, ops.Sa, ops.SaP, ops.To, rescale_every,
           len(ops.names)], ops.desc,
          [grid, int(bool(max_pass)), int(bool(skip_dead))], dev)
    seqscale_wavefront.launches += 1
    return out


seqscale_wavefront.launches = 0


def factored_wavefront(ops, in_toks, out_toks, in_lens, out_lens,
                       rescale_every=4, grid=None, walkers=None,
                       chunk=None):
    """Destination-factored wavefront Forward: (B,) float32
    log-likelihoods.

    `ops` is a FactoredOperands. A CUDA tensor launches
    csrc/factored_wavefront.cu (a persistent grid of `grid` blocks, default
    one per multiprocessor, each walking `walkers` pairs in lockstep
    (factored_launch_plan; `chunk` forces its layout), the pairs taken
    longest first from an atomic counter) and counts one launch in
    `factored_wavefront.launches`; a CPU
    tensor takes factored_forward_plain. Token and length tensors are int32
    and contiguous, on the device of `ops`. A pair whose length exceeds the
    padded shape or whose token lies outside its alphabet comes back NaN. A
    plan that does not fit a block raises ValueError."""
    if in_toks.device.type == "cpu":
        return factored_forward_plain(ops, in_toks, out_toks, in_lens,
                                      out_lens, rescale_every)
    B, Li, Lo = _check_batch("factored_wavefront", ops, in_toks, out_toks,
                             in_lens, out_lens, rescale_every, ops.tab)
    dev = ops.c0.device
    cfg = factored_launch_config(ops, B, Li, Lo, grid, walkers, chunk)
    order = torch.argsort((in_lens + out_lens).long(), descending=True,
                          stable=True).to(torch.int32).contiguous()
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    gbuf = torch.empty(max(cfg["bytes"] // 4, 1), dtype=torch.float32,
                       device=dev)
    _call("factored_wavefront", "factored_wavefront",
          [in_toks, out_toks, in_lens, out_lens, order, counter, ops.c0_pad,
           ops.w_pad, ops.tab, ops.ek, out, gbuf],
          [B, Li, Lo, ops.Sa, ops.To, rescale_every, int(ops.sink),
           len(ops.classes)], ops.desc,
          [ops.NR, ops.KT, ops.n_mt, ops.SaP, cfg["walkers"], ops.nbp,
           cfg["seg"], cfg["e_floats"], cfg["grid"], cfg["CC"]], dev)
    factored_wavefront.launches += 1
    return out


factored_wavefront.launches = 0


def make_wavefront_forward(a_diag, a_left, a_up, closure, B, Li, Lo,
                           precision="highest", n_chunks=None,
                           interpret=False, split=True, merged=False,
                           rescale_every=4, variant=None, n_abs_hint=None,
                           chain=None, device=None):
    """Build the wavefront Forward for fixed machine tensors and shapes.

    Log-space numpy tensors as lowering.matrices_2d returns them. Returns
    fn(in_toks (B,Li), out_toks (B,Lo), in_lens (B,), out_lens (B,)) ->
    (B,) float32 log-likelihoods on `device` (None: the card).

    As the JAX factory: variant=None builds the merged kernel with
    merged=True and the generic kernel with merged=False (the default);
    variant="chained" the chained schedule over uniform lengths (`chain`
    pairs per window, default 4; B a multiple of it, Li and Lo at least 1;
    the lengths are ignored; `merged` is ignored); variant="chained_ragged"
    the ragged schedule (the same conditions on B, Li, Lo; `chain` and
    `n_abs_hint` size the TPU kernel's lane windows and grid and are
    accepted and unused here, where a work queue takes their place);
    variant="seqscale" the one-scale-per-pair kernel; variant="factored"
    the destination-factored kernel; variant="lowrank" delegates to
    make_lowrank_forward (with `chain`).

    `precision` (the matrix unit's, HIGHEST in the JAX factory), `n_chunks`
    (VMEM chunks), `interpret` (Pallas interpret mode off the TPU) and
    `split` (the bf16 hi/lo products) are the JAX factory's knobs of the
    TPU layout: accepted with its defaults and unused. The full-rank
    kernels' products are float32 multiply-adds, the lowrank kernel's
    3xTF32 on the tensor cores."""
    if variant == "lowrank":
        return make_lowrank_forward(a_diag, a_left, a_up, closure, B, Li, Lo,
                                    device=device,
                                    rescale_every=rescale_every, chain=chain)
    if variant not in (None, "chained", "chained_ragged", "seqscale",
                       "factored"):
        raise ValueError("unknown wavefront variant %r" % (variant,))
    if variant in ("chained", "chained_ragged"):
        n_chain = chain or 4
        check_chain(B, Li, Lo, n_chain)
    dev = resolve_device(device)
    kw = {"rescale_every": rescale_every}
    if variant == "factored":
        ops = factored_operands(
            prepare_factored(a_diag, a_left, a_up, closure), dev)
        wrapper = factored_wavefront
    elif variant == "seqscale":
        ops = merged_operands(
            prepare_seqscale(a_diag, a_left, a_up, closure), dev)
        wrapper = seqscale_wavefront
    elif variant is None and not merged:
        ops = merged_operands(
            prepare_generic(a_diag, a_left, a_up, closure), dev)
        wrapper, kw = generic_wavefront, {}
    else:
        ops = merged_operands(
            prepare_merged(a_diag, a_left, a_up, closure), dev)
        wrapper = {None: merged_wavefront, "chained": chained_wavefront,
                   "chained_ragged": chained_ragged_wavefront}[variant]
        if variant == "chained":
            kw["n_chain"] = n_chain

    def forward(in_toks, out_toks, in_lens, out_lens):
        args = [torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
                for x in (in_toks, out_toks, in_lens, out_lens)]
        if tuple(args[0].shape) != (B, Li) or tuple(args[1].shape) != (B, Lo):
            raise ValueError("expected tokens of shape (%d, %d) and (%d, %d)"
                             % (B, Li, B, Lo))
        return wrapper(ops, *args, **kw)

    return forward
