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
NEG_INF convention and readout, in each of two modes:

- `lowrank_forward_plain` (plain mode) and `lowrank_chained_forward_plain`
  (chained mode: `chain` uniform-length pairs per strip, staggered by
  Lo + 2 diagonals, the lengths ignored): the torch walk of
  ops/kernels/plain_walk.py in float32 with the cells' log scales in
  float64 (as the kernel keeps them: a float32 scale drifts past the
  0.01-nat gate on a pair against tens of kilobases), used on the CPU and
  as the card's comparison;
- `lowrank_wavefront` and `lowrank_chained_wavefront`: the wrappers of the
  hand-written CUDA kernel (csrc/lowrank_wavefront.cu), one persistent
  per-pair walk that serves both modes, each wrapper with its own launch
  count. A CUDA tensor launches the kernel or raises; only a CPU tensor
  takes the plain version. `pack_lowrank` lays the plan out for the
  kernel (factors in mma.m16n8k8 fragment order) and `launch_plan` the
  block (walkers, chunk, resident or streamed factors, the pair's tokens
  and cells in shared or global memory, shared bytes).

`make_lowrank_forward` keeps the JAX factory's signature and return
contract, fn(in_toks, out_toks, in_lens, out_lens) -> (B,) (float64 here,
float32 in the JAX factory); chain > 1 is
chained mode, chain None, 0 or 1 plain mode, as in the JAX factory.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.device import resolve_device
from ._build import load
from .factorize import factorize_token_tensor
from .plain_walk import check_chain, walk_chained, walk_plain

# csrc/lowrank_wavefront.cu: the shared memory a block may take on sm_90,
# the class descriptor's length, and the least cells per chunk worth a
# second walker in a block
SMEM_MAX = 232448
DESC_LEN = 9
_MIN_CC_TWO_WALKERS = 16
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
    plain version's operands). On a CUDA device the kernel's layout
    (`pack_lowrank`) is added: the A tiles `a` (n_mt slabs of `slab`
    floats), the transposed token scales `et`, one descriptor row per class
    in `desc`, the operand rows KZ, and the start vector padded to SaP.
    `et_floats` is the length of `et`, padded to a multiple of 4."""
    Sa: int
    To: int
    classes: tuple
    c0: torch.Tensor
    mats: list
    SaP: int = 0
    n_mt: int = 0
    slab: int = 0
    KZ: int = 0
    et_floats: int = 0
    c0_pad: torch.Tensor = None
    a: torch.Tensor = None
    et: torch.Tensor = None
    desc: np.ndarray = None


def pack_lowrank(classes, mats, Sa):
    """The kernel's layout of a prepare_lowrank plan (numpy).

    Every class is one or more A matrices with the destination states as
    rows, padded to n_mt tiles of 16, and the class's operand rows as
    columns, padded to KT k-tiles of 8: a src-side class one (Sa, R*Sa)
    matrix M, a dest-side class R matrices M[r*Sa:(r+1)*Sa] of (Sa, Sa).
    Each 16x8 tile is stored in the A fragment order of mma.m16n8k8 (lane
    g*4 + t holds rows g, g+8 of columns t, t+4: A[g,t], A[g+8,t], A[g,t+4],
    A[g+8,t+4]), and the tiles of one 16-row tile are contiguous: a slab
    holds, per class, its `na` matrices' KT tiles. E is stored transposed
    (n_tok, R*Sa), so a token's column is contiguous.

    Returns (a (n_mt * slab,), et, desc (n_cls, DESC_LEN) int32, n_mt,
    slab, KZ): desc rows (kind, side, rank, n_tok, KT, na, a_off, e_off,
    z_row), z_row the class's first operand row (k-tiles of all classes
    stacked, KZ rows in all)."""
    n_mt = max(1, (Sa + 15) // 16)
    desc, parts, ets = [], [], []
    a_off = e_off = z_row = 0
    for cs, (M, E) in zip(classes, mats):
        R = cs.rank
        if cs.side == "src":
            na, K = 1, R * Sa
            mats_c = np.asarray(M, np.float32)[None]
        else:
            na, K = R, Sa
            mats_c = np.asarray(M, np.float32).reshape(R, Sa, Sa)
        KT = max(1, (K + 7) // 8)
        pad = np.zeros((na, n_mt * 16, KT * 8), np.float32)
        pad[:, :Sa, :K] = mats_c
        # (na, mt, h, g, kt, c, t) -> (mt, na, kt, g, t, c, h): row h*8+g,
        # column c*4+t, register c*2+h
        frag = pad.reshape(na, n_mt, 2, 8, KT, 2, 4) \
            .transpose(1, 0, 4, 3, 6, 5, 2).reshape(n_mt, -1)
        parts.append(frag)
        et = np.ascontiguousarray(np.asarray(E, np.float32).T)
        ets.append(et.ravel())
        desc.append([_KINDS[cs.name], _SIDES[cs.side], R, cs.n_tok, KT, na,
                     a_off, e_off, z_row])
        a_off += frag.shape[1]
        e_off += et.size
        z_row += KT * 8
    slab = a_off
    a = (np.concatenate(parts, axis=1) if parts
         else np.zeros((n_mt, 0), np.float32))
    return (np.ascontiguousarray(a).reshape(-1),
            np.concatenate(ets) if ets else np.zeros(0, np.float32),
            np.asarray(desc, np.int32).reshape(-1, DESC_LEN), n_mt, slab,
            z_row)


def unpack_lowrank(a, et, desc, n_mt, slab, Sa):
    """The inverse of pack_lowrank: each class's (M, E) as prepare_lowrank
    gave them."""
    a = np.asarray(a).reshape(n_mt, slab)
    out = []
    for _, side, R, n_tok, KT, na, a_off, e_off, _ in desc:
        frag = a[:, a_off:a_off + na * KT * 128] \
            .reshape(n_mt, na, KT, 8, 4, 2, 2).transpose(1, 0, 6, 3, 2, 5, 4)
        pad = frag.reshape(na, n_mt * 16, KT * 8)
        if side == _SIDES["src"]:
            M = pad[0, :Sa, :R * Sa]
        else:
            M = pad[:, :Sa, :Sa].reshape(R * Sa, Sa)
        E = et[e_off:e_off + n_tok * R * Sa].reshape(n_tok, R * Sa).T
        out.append((np.ascontiguousarray(M), np.ascontiguousarray(E)))
    return out


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
    a, et, desc, ops.n_mt, ops.slab, ops.KZ = pack_lowrank(
        plan["classes"], mats, Sa)
    ops.SaP = _round_up(max(Sa, 1), 4)
    c0_pad = np.zeros(ops.SaP, np.float32)
    c0_pad[:Sa] = plan["c0"][:, 0]
    ops.et_floats = _round_up(max(et.size, 1), 4)
    et_pad = np.zeros(ops.et_floats, np.float32)
    et_pad[:et.size] = et
    ops.c0_pad = torch.tensor(c0_pad, device=device)
    ops.a = torch.tensor(a if a.size else np.zeros(4, np.float32),
                         device=device)
    ops.et = torch.tensor(et_pad, device=device)
    ops.desc = np.ascontiguousarray(desc, np.int32).reshape(-1)
    return ops


def lowrank_forward_plain(ops, in_toks, out_toks, in_lens, out_lens,
                          rescale_every=4, diag_offset=None):
    """Plain PyTorch version of the lowrank wavefront: float32 states,
    float64 log scales and scores.

    in_toks (B, Li), out_toks (B, Lo), in_lens/out_lens (B,) integer
    tensors on the device of `ops`; the walk is plain_walk.walk_plain with
    the lowrank class term. `diag_offset` (B,), if given, is the absolute
    diagonal each pair starts on, which the rescale rule reads (the chained
    schedule). Returns (B,) float64 log-likelihoods."""
    Sa = ops.Sa
    by_name = {cs.name: (cs, M, E) for cs, (M, E) in zip(ops.classes,
                                                         ops.mats)}

    def term(name, q, tok):
        cs, M, E = by_name[name]
        B, W = tok.shape
        sc = E.t()[tok]                            # (B, W, R*Sa)
        if cs.side == "src":
            return (q.repeat(1, 1, cs.rank) * sc) @ M.t()
        out = (q @ M.t()) * sc
        return out.reshape(B, W, cs.rank, Sa).sum(dim=2)

    return walk_plain(ops.c0, term, [cs.name for cs in ops.classes],
                      in_toks, out_toks, in_lens, out_lens, ops.To,
                      rescale_every, diag_offset=diag_offset,
                      m_dtype=torch.float64)


def lowrank_chained_forward_plain(ops, in_toks, out_toks, in_lens=None,
                                  out_lens=None, n_chain=4, rescale_every=4):
    """Plain PyTorch version of the lowrank chained mode
    (plain_walk.walk_chained over lowrank_forward_plain): every pair read
    out at (Li, Lo), the rescale rule on the absolute diagonal."""
    return walk_chained(lowrank_forward_plain, ops, in_toks, out_toks,
                        n_chain, rescale_every)


PAIR_MODES = ("shared", "tokens_global", "cells_global")


def _walker_bytes(KZ, CC, Li, Lo, pair=0):
    # the operand chunk (KZ/8 k-tiles of CC/8 8x8 tiles and 8 floats of
    # padding), the chunk's tokens per class, the bad flag and the queue
    # slot, the log scales (doubles) and rescale divisors of three diagonal
    # slots and one diagonal's maxima (pair modes 0 and 1), the pair's
    # tokens (pair mode 0) (csrc/lowrank_wavefront.cu)
    n = KZ // 8 * (CC // 8 * 64 + 8) + 3 * CC + 4
    if pair < 2:
        n += 10 * (Li + 1)
    if pair == 0:
        n += Li + Lo
    return _round_up(n, 4) * 4


def launch_plan(ops, Li, Lo, walkers=None, pair=None):
    """How the kernel lays out a block for this plan and padded lengths:
    a dict with `walkers` (pair walkers per block, 1 or 2), `CC`
    (cells per operand chunk), `seg_mt` (16-row factor tiles per copy;
    n_mt when all are resident), `resident`, `et_floats` (the token scales
    kept in shared memory, 0 when they are read from global memory),
    `pair` (where a walker keeps its pair: "shared"; "tokens_global", the
    Li + Lo tokens read from global memory; "cells_global", the cells' 10
    (Li + 1) words of log scales, divisors and maxima in a global buffer
    too) and
    `smem` (bytes).

    The factor tiles stay resident when they fit beside the operand chunk;
    otherwise they stream through a ring of two groups of seg_mt tiles, with
    one walker. `walkers` None takes two where each chunk holds at least 16
    cells (or the whole diagonal), else one. The token scales go to shared
    memory where they fit too. The pair modes are tried in that order, each
    with every layout above before the next: a pair that fits in shared
    memory keeps the layout it always had. `pair` forces a mode. A plan
    that fits no way raises ValueError."""
    if walkers not in (None, 1, 2):
        raise ValueError("walkers must be 1 or 2")
    if pair is not None and pair not in PAIR_MODES:
        raise ValueError("pair must be one of %s, not %r"
                         % (PAIR_MODES, pair))
    cells = _round_up(Li + 1, 8)
    a_res = ops.n_mt * ops.slab * 4
    for pm in ((PAIR_MODES.index(pair),) if pair else range(3)):
        cfg = _plan_in_mode(ops, Li, Lo, walkers, pm, cells, a_res)
        if cfg is not None:
            return dict(cfg, pair=PAIR_MODES[pm])
    raise ValueError(
        "lowrank kernel: %d factor floats per 16 states and %d operand rows "
        "do not fit a block's %d bytes of shared memory%s%s at %d x %d "
        "(the least walker takes %d bytes)"
        % (ops.slab, ops.KZ, SMEM_MAX,
           " with two walkers" if walkers == 2 else "",
           " with the pair %s" % pair.replace("_", " ") if pair else "",
           Li, Lo, _walker_bytes(ops.KZ, 8, Li, Lo,
                                 PAIR_MODES.index(pair) if pair else 2)))


def _plan_in_mode(ops, Li, Lo, walkers, pm, cells, a_res):
    """launch_plan's search in pair mode `pm`; None if nothing fits."""

    def wbytes(cc):
        return _walker_bytes(ops.KZ, cc, Li, Lo, pm)

    def fit(room):
        # wbytes grows by (KZ + 3) words a cell: start near the bound
        cc = min(cells, _round_up(max(
            (room // 4 - wbytes(0) // 4) // (ops.KZ + 3), 0), 8) + 8)
        while cc >= 8 and wbytes(cc) > room:
            cc -= 8
        return cc

    for nw in ((walkers,) if walkers else (2, 1)):
        for et in (ops.et_floats, 0):
            cc = fit((SMEM_MAX - a_res - et * 4) // nw)
            least = 8 if walkers or nw == 1 \
                else min(cells, _MIN_CC_TWO_WALKERS)
            if cc >= least:
                return {"walkers": nw, "CC": cc, "seg_mt": ops.n_mt,
                        "resident": True, "et_floats": et,
                        "smem": a_res + et * 4 + nw * wbytes(cc)}
    if walkers != 2:
        for seg in range(ops.n_mt - 1, 0, -1):
            for et in (ops.et_floats, 0):
                base = (2 * seg * ops.slab + et) * 4
                cc = fit(SMEM_MAX - base)
                if cc >= 8:
                    return {"walkers": 1, "CC": cc, "seg_mt": seg,
                            "resident": False, "et_floats": et,
                            "smem": base + wbytes(cc)}
    return None


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
                      rescale_every=4, grid=None, walkers=None, pair=None):
    """Lowrank wavefront Forward: (B,) float64 log-likelihoods.

    A CUDA tensor launches csrc/lowrank_wavefront.cu (a persistent grid of
    `grid` blocks, default one per multiprocessor, each with `walkers` pair
    walkers (launch_plan) that take the pairs longest first from an atomic
    counter; `pair` forces launch_plan's pair mode) and counts one launch
    in `lowrank_wavefront.launches`; a CPU tensor takes
    lowrank_forward_plain. Token and length tensors are int32
    and contiguous, on the device of `ops`. A pair whose length exceeds the
    padded shape or whose token lies outside its alphabet comes back NaN."""
    if in_toks.device.type == "cpu":
        return lowrank_forward_plain(ops, in_toks, out_toks, in_lens,
                                     out_lens, rescale_every)
    B, Li, Lo = _check_batch("lowrank_wavefront", ops, in_toks, out_toks,
                             in_lens, out_lens, rescale_every, ops.a)
    order = torch.argsort((in_lens + out_lens).long(), descending=True,
                          stable=True).to(torch.int32)
    out = _launch(ops, [in_toks, out_toks, in_lens, out_lens], order, B, Li,
                  Lo, rescale_every, 0, grid, walkers, pair)
    lowrank_wavefront.launches += 1
    return out


lowrank_wavefront.launches = 0


def lowrank_chained_wavefront(ops, in_toks, out_toks, in_lens=None,
                              out_lens=None, n_chain=4, rescale_every=4,
                              grid=None, walkers=None, pair=None):
    """Lowrank chained mode over a uniform-length batch: (B,) float64
    log-likelihoods, every pair read out at (Li, Lo) (the lengths are
    ignored; B must be a multiple of n_chain, Li and Lo at least 1).

    A CUDA tensor launches csrc/lowrank_wavefront.cu in chained mode: the
    persistent grid of lowrank_wavefront walks every pair on its own, pair
    n starting on absolute diagonal (Lo + 2) * (n // (B / n_chain)), which
    the rescale rule reads; it counts one launch in
    `lowrank_chained_wavefront.launches`. A CPU tensor takes
    lowrank_chained_forward_plain. A pair with a token outside its alphabet
    comes back NaN."""
    if in_toks.device.type == "cpu":
        return lowrank_chained_forward_plain(ops, in_toks, out_toks,
                                             n_chain=n_chain,
                                             rescale_every=rescale_every)
    B, Li, Lo = _check_batch("lowrank_chained_wavefront", ops, in_toks,
                             out_toks, None, None, rescale_every, ops.a)
    check_chain(B, Li, Lo, n_chain)
    order = torch.arange(B, dtype=torch.int32, device=in_toks.device)
    out = _launch(ops, [in_toks, out_toks, in_toks, out_toks], order, B, Li,
                  Lo, rescale_every, n_chain, grid, walkers, pair)
    lowrank_chained_wavefront.launches += 1
    return out


lowrank_chained_wavefront.launches = 0


def _check_batch(kernel, ops, in_toks, out_toks, in_lens, out_lens,
                 rescale_every, ready):
    """The checks every wrapper makes on a CUDA call; returns (B, Li, Lo).
    `ready` is an operand that only the card's layout has (None if the
    operands were prepared for the CPU); in_lens/out_lens None: not read."""
    if in_toks.device.type != "cuda":
        raise ValueError("%s runs on cuda or cpu tensors, not %s"
                         % (kernel, in_toks.device))
    if ready is None:
        raise ValueError("operands were prepared for %s, not the card"
                         % ops.c0.device)
    if rescale_every < 1:
        raise ValueError("rescale_every must be >= 1")
    dev = ops.c0.device
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    _check(in_toks, "in_toks", torch.int32, (B, Li), dev)
    _check(out_toks, "out_toks", torch.int32, (B, Lo), dev)
    if in_lens is not None:
        _check(in_lens, "in_lens", torch.int32, (B,), dev)
        _check(out_lens, "out_lens", torch.int32, (B,), dev)
    return B, Li, Lo


def global_bytes(ops, cfg, B, Li):
    """Device bytes a launch of layout `cfg` (with its grid) allocates:
    each walker's three diagonals of states (and its cells in the
    cells_global mode), and the scores."""
    n_walk = cfg["grid"] * cfg["walkers"]
    cells = 10 * (Li + 1) if cfg["pair"] == "cells_global" else 0
    return 4 * n_walk * (3 * (Li + 1) * ops.SaP + cells) + 8 * B


def launch_config(ops, B, Li, Lo, grid=None, walkers=None, pair=None,
                  mem_bytes=None):
    """launch_plan's layout plus the grid a launch takes: `grid` blocks
    (default one per multiprocessor, no more than the batch needs), and
    `bytes`, global_bytes. A layout whose bytes exceed `mem_bytes` (the
    card's memory; default: the card's own, on the card) raises
    ValueError."""
    plan = launch_plan(ops, Li, Lo, walkers, pair)
    if grid is None or mem_bytes is None:
        props = torch.cuda.get_device_properties(ops.c0.device)
    if grid is None:
        grid = max(1, min(props.multi_processor_count,
                          -(-B // plan["walkers"])))
    if int(grid) < 1:
        raise ValueError("grid must be >= 1")
    plan["grid"] = int(grid)
    plan["bytes"] = global_bytes(ops, plan, B, Li)
    mem = props.total_memory if mem_bytes is None else mem_bytes
    if plan["bytes"] > mem:
        raise ValueError(
            "lowrank kernel: %d x %d takes %d bytes of device memory for %d "
            "walkers, over the card's %d" % (Li, Lo, plan["bytes"],
                                             grid * plan["walkers"], mem))
    return plan


def _launch(ops, inputs, order, B, Li, Lo, rescale_every, n_chain, grid,
            walkers, pair=None):
    """Launch the lowrank kernel: `inputs` (tokens and lengths; in chained
    mode any int32 tensors, the lengths are not read), the operands, the
    diagonal states of grid x walkers walkers (and their cells' scales in
    the cells_global mode), the queue; raise if the launch was refused."""
    dev = ops.c0.device
    cfg = launch_config(ops, B, Li, Lo, grid, walkers, pair)
    n_walk = cfg["grid"] * cfg["walkers"]
    f32 = torch.float32
    pbuf = torch.empty(max(n_walk * 3 * (Li + 1) * ops.SaP, 1), dtype=f32,
                       device=dev)
    pm = PAIR_MODES.index(cfg["pair"])
    cbuf = torch.empty(n_walk * 10 * (Li + 1) if pm == 2 else 1, dtype=f32,
                       device=dev)
    out = torch.empty(B, dtype=torch.float64, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    _call("lowrank_wavefront", "lowrank_wavefront",
          inputs + [ops.c0_pad, ops.a, ops.et, pbuf, out,
                    order.contiguous(), counter, cbuf],
          [B, Li, Lo, ops.Sa, ops.SaP, ops.To, rescale_every,
           len(ops.classes)], ops.desc,
          [ops.n_mt, ops.slab, ops.KZ, cfg["CC"], cfg["seg_mt"],
           cfg["walkers"], cfg["et_floats"], cfg["grid"], n_chain, pm], dev)
    return out


def smem_bytes_on_card(ops, cfg, Li, Lo):
    """The shared bytes the kernel's own layout takes for `cfg` (a
    launch_plan for padded lengths Li, Lo), from the built library: must
    equal cfg["smem"]."""
    fn = load("lowrank_wavefront").lowrank_wavefront_smem_bytes
    fn.argtypes = [ctypes.c_int] * 10
    fn.restype = ctypes.c_long
    return fn(ops.n_mt, ops.slab, cfg["seg_mt"], ops.KZ, cfg["CC"],
              cfg["walkers"], cfg["et_floats"], Li, Lo,
              PAIR_MODES.index(cfg["pair"]))


def _call(lib, entry, ptrs, ints, desc, tail, dev):
    """Call `entry`_launch of kernel library `lib` with pointer args, int
    args, the descriptor array, more int args and the current stream;
    raise on a nonzero return (the launch was refused)."""
    fn = getattr(load(lib), entry + "_launch")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * len(ptrs) + [I] * len(ints) + [ctypes.POINTER(I)]
                   + [I] * len(tail) + [P])
    fn.restype = I
    rc = fn(*[t.data_ptr() for t in ptrs], *ints,
            desc.ctypes.data_as(ctypes.POINTER(I)), *tail,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (entry, rc))


def make_lowrank_forward(a_diag, a_left, a_up, closure, B, Li, Lo,
                         precision="highest", n_chunks=None,
                         interpret=False, split=True, rescale_every=4,
                         chain=None, sc_fma=True, device=None):
    """Build the low-rank wavefront Forward for fixed tensors/shapes.

    Log-space numpy tensors as lowering.matrices_2d returns them. Returns
    fn(in_toks (B,Li), out_toks (B,Lo), in_lens, out_lens) -> (B,) float64
    log-likelihoods on `device` (None: the card). chain=N with N > 1 walks
    the pairs on the chained schedule (B a multiple of N, Li and Lo at
    least 1, the lengths ignored); chain None, 0 or 1 is plain mode, as in
    the JAX factory.

    `precision` (HIGHEST in the JAX factory), `n_chunks`, `interpret`,
    `split` and `sc_fma` are the JAX factory's knobs of the TPU layout
    (matrix-unit precision, VMEM chunks, Pallas interpret mode, the bf16
    hi/lo split, the token-scale product): accepted with its defaults and
    unused. The card's products are 3xTF32
    on the tensor cores, the CPU's float32."""
    chained = bool(chain) and chain > 1
    if chained:
        check_chain(B, Li, Lo, chain)
    dev = resolve_device(device)
    plan, mats = prepare_lowrank(a_diag, a_left, a_up, closure,
                                 chained=chained)
    ops = lowrank_operands(plan, mats, a_diag.shape[1], dev)

    def forward(in_toks, out_toks, in_lens, out_lens):
        args = [torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
                for x in (in_toks, out_toks, in_lens, out_lens)]
        if tuple(args[0].shape) != (B, Li) or tuple(args[1].shape) != (B, Lo):
            raise ValueError("expected tokens of shape (%d, %d) and (%d, %d)"
                             % (B, Li, B, Lo))
        if chained:
            return lowrank_chained_wavefront(ops, *args, n_chain=chain,
                                             rescale_every=rescale_every)
        return lowrank_wavefront(ops, *args, rescale_every=rescale_every)

    return forward
