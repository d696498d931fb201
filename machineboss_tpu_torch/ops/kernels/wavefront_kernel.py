"""Closure-folded wavefront Forward for full-rank machines.

Counterpart of machineboss_tpu's ops/pallas/wavefront_kernel.py for the two
kernels the batch router reaches: `_merged_kernel` (any batch) and
`_chained_ragged_kernel` (ragged batches). The host prep (`prepare_merged`)
is a numpy copy of the JAX factory's and gives the same numbers:

1. the log-space class tensors go to probability space in float64;
2. absent transition classes (up / left / diag) are dropped; a machine with
   no symbol transitions at all keeps an (all-zero) up class;
3. the silent closure C is folded into every neighbour matrix,
   F[tok] = C^T @ A[tok]^T (destination x source), so no per-cell closure
   product remains;
4. trailing silent sink states (e.g. End) are trimmed from the state
   vector when the readout state has only silent incoming transitions; the
   readout is then w . p_active with w = solve(C_aa, C[active, End]).

What the recurrence computes, per pair, on the cells (i, o) of its own
lattice, diagonal d = i + o, in scaled probability p (Sa floats) with a
per-cell log scale m: each present class reads one neighbour (up (i, o-1)
by the y token and left (i-1, o) by the x token on d-1, diag (i-1, o-1) by
(x, y) on d-2); mu = max of the neighbours' m; cur = sum over classes of
F_class[tok] @ (p_nb * exp(m_nb - mu)). On diagonals with
d % rescale_every <= 1 (both parities: diag-class mass lives on one) p is
divided by its max over states and the log of the max goes to m; a cell
whose max is not positive is zeroed. The readout at (il, ol) is
m + log(p[Sa-1]), or m + log(w . p) when sink-trimmed.

Each kernel has two versions with that one recurrence:

- `merged_forward_plain` / `chained_ragged_forward_plain`: torch loops over
  diagonals in float32, used on the CPU and as the card's comparison;
- `merged_wavefront` / `chained_ragged_wavefront`: the wrappers of the
  hand-written CUDA kernels (csrc/merged_wavefront.cu,
  csrc/chained_ragged_wavefront.cu, both built on
  csrc/wavefront_common.cuh). A CUDA tensor launches the kernel or raises;
  only a CPU tensor takes the plain version.

What chained_ragged adds to merged is scheduling. The TPU kernel sorts a
ragged batch by length and chains sequences back to back in each lane
window so that no lane idles behind the longest pair. The CUDA counterpart
is a persistent kernel with a work queue: a fixed grid of blocks, the pairs
in the same sorted order (stable, descending output length), each block
taking the next pair from an atomic counter when its own is finished, and
writing the score to the pair's original index.
"""

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ...utils.device import resolve_device
from ._build import load
from .lowrank_kernel import _check, _round_up, make_lowrank_forward

NEG_INF = -1e30
_TD = 4          # destination states per thread (csrc/wavefront_common.cuh)
_KINDS = {"up": 0, "left": 1, "diag": 2}
# blocks the kernels' grids take per multiprocessor when the caller names
# no grid: enough resident warps to hide the L2 latency of the class blocks
_BLOCKS_PER_SM = 4


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


def prepare_merged(a_diag, a_left, a_up, closure):
    """Host prep of the merged kernel family: fold the closure into every
    present class, trim trailing sink states.

    Log-space numpy tensors as lowering.matrices_2d returns them. Returns a
    plan dict: Ti, To, Sa (states kept), sink (bool), classes (has_up,
    has_left, has_diag), mats {name: (n_tok, Sa, Sa) float32, destination x
    source, token x*To + y for diag} for the present classes, c0 (Sa,)
    start vector and w (Sa,) sink readout vector (zeros when not
    trimmed)."""
    diag_p = np.exp(np.maximum(np.asarray(a_diag, np.float64), -700))
    left_p = np.exp(np.maximum(np.asarray(a_left, np.float64), -700))
    up_p = np.exp(np.maximum(np.asarray(a_up, np.float64), -700))
    closure_p = np.exp(np.maximum(np.asarray(closure, np.float64), -700))
    Ti, To, S, _ = a_diag.shape
    closure_t = np.ascontiguousarray(closure_p.T).astype(np.float32)

    # class presence: absent transition classes are specialized away
    ztol = 1e-290
    has_up = float(up_p.sum()) > ztol
    has_left = float(left_p.sum()) > ztol
    has_diag = float(diag_p.sum()) > ztol
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
              + up_p[:, s, :].sum()) < ztol
        and float(np.abs(closure_p[s] - eye[s]).sum()) < ztol
        for s in range(S)])
    n_trail = 0
    while n_trail < S - 1 and is_sink[S - 1 - n_trail]:
        n_trail += 1
    readout_silent_in = (
        float(diag_p[:, :, :, S - 1].sum() + left_p[:, :, S - 1].sum()
              + up_p[:, :, S - 1].sum()) < ztol)
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


@dataclass
class MergedOperands:
    """One machine's prepare_merged plan as tensors on one device.

    `mats` holds each present class's (n_tok, Sa, Sa) destination x source
    blocks (the plain version's operands). On a CUDA device the kernel's
    layout is added: every block transposed to source-major and zero-padded
    to (SaP, SaP), SaP = round_up(Sa, 4), all classes packed into `mt`,
    with one descriptor row per class in `desc` (kind, n_tok, mt_off)."""
    Sa: int
    Ti: int
    To: int
    sink: bool
    c0: torch.Tensor
    w: torch.Tensor
    mats: dict = field(default_factory=dict)
    SaP: int = 0
    c0_pad: torch.Tensor = None
    w_pad: torch.Tensor = None
    mt: torch.Tensor = None
    desc: np.ndarray = None

    @property
    def names(self):
        return [k for k in ("up", "left", "diag") if k in self.mats]


def merged_operands(plan, device):
    """Move a prepare_merged plan to `device` (a torch.device)."""
    Sa = plan["Sa"]
    ops = MergedOperands(
        Sa=Sa, Ti=plan["Ti"], To=plan["To"], sink=bool(plan["sink"]),
        c0=torch.tensor(np.asarray(plan["c0"], np.float32), device=device),
        w=torch.tensor(np.asarray(plan["w"], np.float32)[:Sa],
                       device=device),
        mats={k: torch.tensor(plan["mats"][k], device=device)
              for k in ("up", "left", "diag") if k in plan["mats"]})
    if device.type != "cuda":
        return ops
    SaP = _round_up(max(Sa, 1), _TD)
    parts, desc, off = [], [], 0
    for name in ops.names:
        m = plan["mats"][name]
        n_tok = m.shape[0]
        mt = np.zeros((n_tok, SaP, SaP), np.float32)
        mt[:, :Sa, :Sa] = np.transpose(m, (0, 2, 1))   # [tok, src, dest]
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
    return ops


def merged_forward_plain(ops, in_toks, out_toks, in_lens, out_lens,
                         rescale_every=4):
    """Plain PyTorch version of the merged wavefront, float32.

    in_toks (B, Li), out_toks (B, Lo), in_lens/out_lens (B,) integer
    tensors on the device of `ops`. Cells are indexed by i on each diagonal
    d = i + o, slab (B, Li+1, Sa); the loop stops at the batch's last
    readout diagonal. A class's token block is selected after one wide
    product against all of its blocks. Returns (B,) log-likelihoods."""
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
    # [src, (tok, dest)] per class: one product serves every token
    wide = {k: m.permute(2, 0, 1).reshape(Sa, -1) for k, m in ops.mats.items()}

    p1 = torch.zeros((B, W, Sa), dtype=f32, device=dev)
    p1[:, 0] = ops.c0
    m1 = torch.full((B, W), NEG_INF, dtype=f32, device=dev)
    m1[:, 0] = 0.0
    p2 = torch.zeros_like(p1)
    m2 = torch.full_like(m1, NEG_INF)

    def readout(p, m):
        cell = p[b_idx, il]
        end = (cell * ops.w).sum(dim=-1) if ops.sink else cell[:, Sa - 1]
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
        has_y = (o_idx >= 1)[None, :]
        has_x = (i_idx >= 1)[None, :]
        # neighbour slab, its log scale, the cell's token and whether the
        # neighbour exists for the cell
        nb = {"up": (p1, m1, y_tok, has_y),
              "left": (torch.cat([zp, p1[:, :-1]], 1),
                       torch.cat([zm, m1[:, :-1]], 1), x_tok, has_x),
              "diag": (torch.cat([zp, p2[:, :-1]], 1),
                       torch.cat([zm, m2[:, :-1]], 1),
                       x_tok * To + y_tok, has_x & has_y)}
        mu = torch.full((B, W), NEG_INF, dtype=f32, device=dev)
        for name in ops.names:
            _, m_op, _, has = nb[name]
            mu = torch.maximum(mu, torch.where(has, m_op, neg))
        mu_safe = torch.where(mu > NEG_INF / 2, mu, torch.zeros_like(mu))
        cur = torch.zeros((B, W, Sa), dtype=f32, device=dev)
        for name in ops.names:
            p_op, m_op, tok, has = nb[name]
            w = torch.where(has & (m_op > NEG_INF / 2),
                            torch.exp(m_op - mu_safe), torch.zeros_like(m_op))
            n_tok = ops.mats[name].shape[0]
            if n_tok == 0:
                continue
            out_all = ((p_op * w[:, :, None]) @ wide[name]) \
                .reshape(B, W, n_tok, Sa)
            idx = tok[:, :, None, None].expand(-1, -1, 1, Sa)
            cur = cur + torch.gather(out_all, 2, idx)[:, :, 0]
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


def _default_grid(dev, B):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(B, _BLOCKS_PER_SM * sms))


def _launch(kernel, ops, in_toks, out_toks, in_lens, out_lens,
            rescale_every, grid, queue):
    """Checks shared by both wrappers, scratch allocation and the launch.
    `queue` is None (merged) or (order, counter) device tensors."""
    if in_toks.device.type != "cuda":
        raise ValueError("%s runs on cuda or cpu tensors, not %s"
                         % (kernel, in_toks.device))
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
    grid = _default_grid(dev, B) if grid is None else int(grid)
    if grid < 1:
        raise ValueError("grid must be >= 1")
    W = Li + 1
    out = torch.empty(B, dtype=torch.float32, device=dev)
    # the diagonal state of the pair a block is walking: three rotating
    # (W, SaP) slots and their log scales, per block of the grid
    pbuf = torch.empty(grid * 3 * W * ops.SaP, dtype=torch.float32,
                       device=dev)
    mbuf = torch.empty(grid * 3 * W, dtype=torch.float32, device=dev)
    fn = getattr(load(kernel), kernel + "_launch")
    P, I = ctypes.c_void_p, ctypes.c_int
    n_ptr = 10 + (2 if queue else 0)
    fn.argtypes = [P] * n_ptr + [I] * 9 + [ctypes.POINTER(I), I, P]
    fn.restype = I
    ptrs = [in_toks, out_toks, in_lens, out_lens, ops.c0_pad, ops.w_pad,
            ops.mt, pbuf, mbuf, out] + list(queue or ())
    desc = ops.desc
    rc = fn(*[t.data_ptr() for t in ptrs], B, Li, Lo, ops.Sa, ops.SaP,
            ops.To, rescale_every, int(ops.sink), len(ops.names),
            desc.ctypes.data_as(ctypes.POINTER(I)), grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (kernel, rc))
    return out


def merged_wavefront(ops, in_toks, out_toks, in_lens, out_lens,
                     rescale_every=4, grid=None):
    """Merged wavefront Forward: (B,) float32 log-likelihoods.

    A CUDA tensor launches csrc/merged_wavefront.cu and counts one launch
    in `merged_wavefront.launches`; a CPU tensor takes
    merged_forward_plain. Token and length tensors are int32 and
    contiguous, on the device of `ops`. `grid` is the number of blocks
    (default: one per pair, at most 4 per multiprocessor); block g walks
    pairs g, g + grid, ... A pair whose length exceeds the padded shape or
    whose token lies outside its alphabet comes back NaN."""
    if in_toks.device.type == "cpu":
        return merged_forward_plain(ops, in_toks, out_toks, in_lens,
                                    out_lens, rescale_every)
    out = _launch("merged_wavefront", ops, in_toks, out_toks, in_lens,
                  out_lens, rescale_every, grid, None)
    merged_wavefront.launches += 1
    return out


merged_wavefront.launches = 0


def chained_ragged_wavefront(ops, in_toks, out_toks, in_lens, out_lens,
                             rescale_every=4, grid=None):
    """Ragged-schedule wavefront Forward: (B,) float32 log-likelihoods in
    the batch's own order.

    A CUDA tensor launches csrc/chained_ragged_wavefront.cu (a persistent
    grid of `grid` blocks that take pairs, longest first, from an atomic
    counter which this wrapper allocates and zeroes) and counts one launch
    in `chained_ragged_wavefront.launches`; a CPU tensor takes
    chained_ragged_forward_plain. grid=1 sends every pair through one
    block, one after the other. Other arguments as merged_wavefront."""
    if in_toks.device.type == "cpu":
        return chained_ragged_forward_plain(ops, in_toks, out_toks, in_lens,
                                            out_lens, rescale_every)
    if out_lens.device.type != "cuda":
        raise ValueError("chained_ragged_wavefront runs on cuda or cpu "
                         "tensors, not %s" % out_lens.device)
    order = sorted_order(out_lens).contiguous()
    counter = torch.zeros(1, dtype=torch.int32, device=out_lens.device)
    out = _launch("chained_ragged_wavefront", ops, in_toks, out_toks,
                  in_lens, out_lens, rescale_every, grid, (order, counter))
    chained_ragged_wavefront.launches += 1
    return out


chained_ragged_wavefront.launches = 0


def make_wavefront_forward(a_diag, a_left, a_up, closure, B, Li, Lo,
                           device=None, merged=False, rescale_every=4,
                           variant=None, n_abs_hint=None, chain=None):
    """Build the wavefront Forward for fixed machine tensors and shapes.

    Log-space numpy tensors as lowering.matrices_2d returns them. Returns
    fn(in_toks (B,Li), out_toks (B,Lo), in_lens (B,), out_lens (B,)) ->
    (B,) float32 log-likelihoods on `device` (None: the card).

    merged=True, variant=None builds the merged kernel;
    variant="chained_ragged" the ragged schedule (B must be a multiple of
    `chain`, default 4, and the padded shapes non-empty, as the JAX factory
    asks; `chain` and `n_abs_hint` size the TPU kernel's lane windows and
    grid and are accepted and unused here, where a work queue takes their
    place); variant="lowrank" delegates to make_lowrank_forward. The other
    variants of the JAX factory ("chained", "seqscale", "factored", and the
    generic kernel of merged=False) are not ported yet.

    The JAX factory's `precision`, `split`, `n_chunks` and `interpret` are
    knobs of the TPU's matrix unit and compiler and are not carried: every
    product here is a float32 multiply-add."""
    if variant == "lowrank":
        return make_lowrank_forward(a_diag, a_left, a_up, closure, B, Li, Lo,
                                    device=device,
                                    rescale_every=rescale_every, chain=chain)
    if variant in ("chained", "seqscale", "factored"):
        raise NotImplementedError(
            "wavefront variant %r is not ported yet: ROADMAP.md queue A, "
            "item 10" % (variant,))
    if variant not in (None, "chained_ragged"):
        raise ValueError("unknown wavefront variant %r" % (variant,))
    if variant is None and not merged:
        raise NotImplementedError(
            "the generic unmerged wavefront kernel (merged=False) is not "
            "ported yet: ROADMAP.md queue A, item 10")
    if variant == "chained_ragged":
        n_chain = chain or 4
        if B % n_chain:
            raise ValueError("chained_ragged: B must be a multiple of chain")
        if Li < 1 or Lo < 1:
            raise ValueError("chained_ragged: needs non-empty sequences")
    dev = resolve_device(device)
    ops = merged_operands(prepare_merged(a_diag, a_left, a_up, closure), dev)
    wrapper = chained_ragged_wavefront if variant == "chained_ragged" \
        else merged_wavefront

    def forward(in_toks, out_toks, in_lens, out_lens):
        args = [torch.as_tensor(x, device=dev).to(torch.int32).contiguous()
                for x in (in_toks, out_toks, in_lens, out_lens)]
        if tuple(args[0].shape) != (B, Li) or tuple(args[1].shape) != (B, Lo):
            raise ValueError("expected tokens of shape (%d, %d) and (%d, %d)"
                             % (B, Li, B, Lo))
        return wrapper(ops, *args, rescale_every=rescale_every)

    return forward
