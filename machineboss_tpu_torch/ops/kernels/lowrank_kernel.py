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
  ops/kernels/plain_walk.py in float32, used on the CPU and as the card's
  comparison;
- `lowrank_wavefront` and `lowrank_chained_wavefront`: the wrappers of the
  hand-written CUDA kernel's two entries (csrc/lowrank_wavefront.cu). A
  CUDA tensor launches the kernel or raises; only a CPU tensor takes the
  plain version.

`make_lowrank_forward` keeps the JAX factory's signature and return
contract, fn(in_toks, out_toks, in_lens, out_lens) -> (B,); chain > 1 is
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
                          rescale_every=4, diag_offset=None):
    """Plain PyTorch version of the lowrank wavefront, float32.

    in_toks (B, Li), out_toks (B, Lo), in_lens/out_lens (B,) integer
    tensors on the device of `ops`; the walk is plain_walk.walk_plain with
    the lowrank class term. `diag_offset` (B,), if given, is the absolute
    diagonal each pair starts on, which the rescale rule reads (the chained
    schedule). Returns (B,) log-likelihoods."""
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
                      rescale_every, diag_offset=diag_offset)


def lowrank_chained_forward_plain(ops, in_toks, out_toks, in_lens=None,
                                  out_lens=None, n_chain=4, rescale_every=4):
    """Plain PyTorch version of the lowrank chained mode
    (plain_walk.walk_chained over lowrank_forward_plain): every pair read
    out at (Li, Lo), the rescale rule on the absolute diagonal."""
    return walk_chained(lowrank_forward_plain, ops, in_toks, out_toks,
                        n_chain, rescale_every)


def _chunk_cells(Li, k_total):
    # Z, two per-class rows (weights, tokens) and a state per cell
    per_cell = (k_total + 7) * 4
    cap = (SMEM_BUDGET - 16) // per_cell // _TC * _TC
    if cap < _TC:
        raise ValueError(
            "lowrank kernel: the class operands take %d rows per cell; "
            "shared memory (%d bytes a block) holds at most %d"
            % (k_total, SMEM_BUDGET, (SMEM_BUDGET - 16) // (_TC * 4) - 7))
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
    B, Li, Lo = _check_batch("lowrank_wavefront", ops, in_toks, out_toks,
                             in_lens, out_lens, rescale_every, ops.mt)
    out = torch.empty(B, dtype=torch.float32, device=ops.c0.device)
    _launch("lowrank_wavefront", ops, [in_toks, out_toks, in_lens, out_lens],
            out, [], B, Li, Lo, B, rescale_every, [])
    lowrank_wavefront.launches += 1
    return out


lowrank_wavefront.launches = 0


def lowrank_chained_wavefront(ops, in_toks, out_toks, in_lens=None,
                              out_lens=None, n_chain=4, rescale_every=4):
    """Lowrank chained mode over a uniform-length batch: (B,) float32
    log-likelihoods, every pair read out at (Li, Lo) (the lengths are
    ignored; B must be a multiple of n_chain, Li and Lo at least 1).

    A CUDA tensor launches the chained entry of csrc/lowrank_wavefront.cu
    (one block per strip of n_chain pairs n = k * (B / n_chain) + w) and
    counts one launch in `lowrank_chained_wavefront.launches`; a CPU tensor
    takes lowrank_chained_forward_plain. A pair with a token outside its
    alphabet comes back NaN."""
    if in_toks.device.type == "cpu":
        return lowrank_chained_forward_plain(ops, in_toks, out_toks,
                                             n_chain=n_chain,
                                             rescale_every=rescale_every)
    B, Li, Lo = _check_batch("lowrank_chained_wavefront", ops, in_toks,
                             out_toks, None, None, rescale_every, ops.mt)
    check_chain(B, Li, Lo, n_chain)
    dev = ops.c0.device
    out = torch.empty(B, dtype=torch.float32, device=dev)
    bad = torch.zeros(B, dtype=torch.int32, device=dev)
    _launch("lowrank_chained", ops, [in_toks, out_toks], out, [bad], B, Li,
            Lo, B // n_chain, rescale_every, [n_chain])
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


def _launch(entry, ops, inputs, out, extra, B, Li, Lo, n_blocks,
            rescale_every, tail):
    """Launch `entry` of the lowrank library: inputs, c0, M, E, the slots of
    `n_blocks` blocks, out and `extra` pointers, the shapes and plan, then
    the chunk size, k_total and the `tail` ints."""
    dev = ops.c0.device
    W = Li + 1
    pbuf = torch.empty(max(n_blocks * 3 * W * ops.SaP, 1),
                       dtype=torch.float32, device=dev)
    mbuf = torch.empty(max(n_blocks * 3 * W, 1), dtype=torch.float32,
                       device=dev)
    _call("lowrank_wavefront", entry,
          inputs + [ops.c0_pad, ops.mt, ops.e, pbuf, mbuf, out] + extra,
          [B, Li, Lo, ops.Sa, ops.SaP, ops.To, rescale_every,
           len(ops.classes)], ops.desc,
          [_chunk_cells(Li, ops.k_total), ops.k_total] + tail, dev)


def make_lowrank_forward(a_diag, a_left, a_up, closure, B, Li, Lo,
                         device=None, rescale_every=4, chain=None):
    """Build the low-rank wavefront Forward for fixed tensors/shapes.

    Log-space numpy tensors as lowering.matrices_2d returns them. Returns
    fn(in_toks (B,Li), out_toks (B,Lo), in_lens, out_lens) -> (B,) float32
    log-likelihoods on `device` (None: the card). chain=N with N > 1 packs
    N staggered equal-length pairs per strip (chained mode: B a multiple of
    N, Li and Lo at least 1, the lengths ignored); chain None, 0 or 1 is
    plain mode, as in the JAX factory."""
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
