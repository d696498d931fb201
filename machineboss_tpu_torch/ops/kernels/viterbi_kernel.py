"""Max-plus (Viterbi) wavefront fill that writes the whole value lattice.

Counterpart of machineboss_tpu's ops/pallas/viterbi_kernel.py: the full
batched fill (`_viterbi_kernel`) and the envelope-banded fill of one pair
(`_viterbi_banded_kernel`). Every diagonal slab goes to device memory,
because the point of the device Viterbi is the lattice that the traceback
walks (algo/viterbi_device.py).

The host prep (`maxplus_class_mats`, `band_windows`, `envelope_diag_bands`,
the window geometry) is a numpy copy of the JAX package's and gives the
same numbers: the max-plus silent closure is folded into every class matrix
in float64 and the result clamped to float32, so no per-cell closure
product remains.

What is computed, per cell (i, o) on diagonal d = i + o and destination
state s', in float32 log space with NEG_INF = -1e30 for "no path":

    v[s'] = max( NEG_INF,
                 max_s up[y_o][s, s']        + cell(i,   o-1)[s],
                 max_s left[x_i][s, s']      + cell(i-1, o)[s],
                 max_s diag[x_i, y_o][s, s'] + cell(i-1, o-1)[s] )

with cell(0, 0) = c0 (closure row 0), absent classes skipped, a neighbour
outside the lattice (or the band) skipped, and a token outside its
alphabet treated as matching nothing. Only float32 adds and maxes occur, no
sums of many terms, so the CUDA kernels, the plain versions here and the
JAX kernels agree bit for bit on the same `premats`.

Each kernel has two versions with that one recurrence:

- `viterbi_forward_plain` / `viterbi_banded_forward_plain`: torch loops over
  diagonals, used on the CPU and as the card's comparison;
- `viterbi_wavefront` / `viterbi_banded_wavefront`: the counted wrappers of
  the hand-written CUDA kernels (csrc/viterbi_wavefront.cu,
  csrc/viterbi_banded_wavefront.cu, both on csrc/viterbi_common.cuh). A CUDA
  tensor launches the kernel or raises; only a CPU tensor takes the plain
  version. Their layouts come from `fill_launch_plan` (a cluster of one or
  two blocks a pair, shared slots or read-back) and `banded_launch_plan`
  (a cluster of up to 16 blocks for the one pair, the class columns of
  each block resident in shared memory as `pack_banded` lays them out or
  streamed, lanes an item), each checked against the built library's own
  shared-memory count on the card.

Slab layout: the full fill returns (n_diags, B, W, S) with W = Li + 1, slab
d holding cell (i, o = d - i) at index i; the banded fill returns
(n_diags, Wb, S), slab d holding cell i at window index i - bases[d]. Both
are what algo/traceback_device's walker reads, without a transpose.
"""

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ...utils.device import resolve_device
from ._build import load
from .lowrank_kernel import _check, _round_up

NEG_INF = -1e30
SMEM_MAX = 232448   # a block's shared memory on sm_90
_PIECE = 8          # the most cells a piece (csrc/viterbi_wavefront.cu CB)
_TD = 4          # destination states per thread (csrc/viterbi_common.cuh)
_BAND_PAD = 8    # the band window's width is rounded up to this many cells
# csrc/viterbi_banded_wavefront.cu: threads a block, diagonals a staged
# chunk, the cluster sizes it takes (16 is not portable, so the plan takes
# it only when asked) and the lanes an item may take
_BAND_THREADS = 512
_BAND_CH = 32
_CLUSTERS = (1, 2, 4, 8, 16)
_SPLITS = (1, 2, 4, 8)


def _mp_mat(a, b):
    """Max-plus matrix product: out[s, s'] = max_m a[s, m] + b[m, s']."""
    return (a[:, :, None] + b[None, :, :]).max(axis=1)


def maxplus_class_mats(a_diag, a_left, a_up, closure):
    """Closure-folded, transposed class matrices shared by the full and
    banded MAXPLUS kernels (the host-side _mp_mat folds here are ~2 s at
    S=64 — build once per machine and pass as `premats`):
      MU[(ty, s'), s]      = (A_up[ty] (x)mp C)[s, s']
      MD[(ty, s'), (ti,s)] = (A_diag[ti,ty] (x)mp C)[s, s']
      ML[(ti, s'), s]      = (A_left[ti] (x)mp C)[s, s']
    Returns (mu, md, ml, c0_row, classes)."""
    Ti, To, S, _ = a_diag.shape

    def lg(a):
        return np.maximum(np.asarray(a, np.float64), NEG_INF)

    dg, lf, up, cl = lg(a_diag), lg(a_left), lg(a_up), lg(closure)
    has_up = bool((up > NEG_INF / 2).any())
    has_left = bool((lf > NEG_INF / 2).any())
    has_diag = bool((dg > NEG_INF / 2).any())
    if not (has_up or has_left or has_diag):
        has_diag = True
    classes = (has_up, has_left, has_diag)

    def clamp32(m):
        return np.maximum(m, NEG_INF).astype(np.float32)

    mu = np.concatenate([_mp_mat(up[t], cl).T for t in range(To)], axis=0) \
        if has_up else np.full((8, 128), NEG_INF)
    md = np.full((To * S, Ti * S), NEG_INF)
    if has_diag:
        for ty in range(To):
            for ti in range(Ti):
                md[ty * S:(ty + 1) * S, ti * S:(ti + 1) * S] = \
                    _mp_mat(dg[ti, ty], cl).T
    else:
        md = np.full((8, 128), NEG_INF)
    ml = np.concatenate([_mp_mat(lf[t], cl).T for t in range(Ti)], axis=0) \
        if has_left else np.full((8, 128), NEG_INF)
    c0_row = clamp32(cl[0:1, :].T)                       # (S, 1)
    return clamp32(mu), clamp32(md), clamp32(ml), c0_row, classes


def band_windows(lo, hi, pad=128):
    """Window geometry for per-diagonal bands [lo_d, hi_d).

    Returns (bases, s1, Wb): non-decreasing bases advancing <= 1/step
    (clamped under lo_d where the band jumps faster — the window is then
    simply wider), and Wb = lane-aligned max(hi_d - base_d)."""
    n = len(lo)
    bases = np.zeros(n, np.int32)
    for d in range(1, n):
        bases[d] = min(max(bases[d - 1], 0) + 1, max(lo[d], 0))
        bases[d] = max(bases[d], bases[d - 1])
    w = max(int(hi[d] - bases[d]) for d in range(n))
    Wb = _round_up(max(w, 1), pad)
    s1 = np.zeros(n, np.int32)
    s1[1:] = bases[1:] - bases[:-1]
    assert (s1 >= 0).all() and (s1 <= 1).all()
    return bases, s1, Wb


def envelope_diag_bands(env):
    """Per-diagonal [lo_d, hi_d) cell-index bands from a row Envelope
    (core.seqpair.Envelope: in_start[o] <= i < in_end[o])."""
    Li = env.in_len
    Lo = env.out_len
    n_diags = Li + Lo + 1
    lo = np.full(n_diags, 10**9, np.int64)
    hi = np.full(n_diags, -10**9, np.int64)
    cnt = np.zeros(n_diags, np.int64)
    for o in range(Lo + 1):
        for i in range(env.in_start[o], env.in_end[o]):
            d = i + o
            lo[d] = min(lo[d], i)
            hi[d] = max(hi[d], i + 1)
            cnt[d] += 1
    # The banded kernel fills the bounding interval [lo, hi) of each
    # diagonal; a non-contiguous cross-section (possible only for
    # hand-built envelopes, never for the CLI's path +- width
    # bands) would silently admit out-of-envelope cells and can inflate
    # the device score vs the host env-restricted ViterbiMatrix.
    bad = (hi > lo) & (cnt != hi - lo)
    if bad.any():
        d = int(np.nonzero(bad)[0][0])
        raise ValueError(
            "envelope_diag_bands: diagonal %d cross-section is not "
            "contiguous (%d cells in [%d, %d)); the banded device kernel "
            "only supports per-diagonal interval envelopes — use the host "
            "engine for this envelope" % (d, cnt[d], lo[d], hi[d]))
    lo = np.where(hi > lo, lo, 0)
    hi = np.where(hi > lo, hi, 1)
    return lo, hi


# ------------------------------------------------------------------ operands

@dataclass
class ViterbiOperands:
    """One machine's maxplus_class_mats as tensors on one device.

    Each present class is a (n_tok, S, SP) float32 tensor of source-major
    blocks, blk[tok][s, s'] (token x * To + y for diag), the destination
    axis padded with NEG_INF to SP = round_up(S, 4) so that the kernel
    reads four destinations as one float4; the plain version reads
    [..., :S]. An absent class is None."""
    S: int
    SP: int
    Ti: int
    To: int
    c0: torch.Tensor
    up: torch.Tensor = None
    left: torch.Tensor = None
    diag: torch.Tensor = None
    # pack_banded's tensors by cluster size, made at first use
    packs: dict = field(default_factory=dict, repr=False)

    @property
    def classes(self):
        return (self.up is not None, self.left is not None,
                self.diag is not None)


def viterbi_operands(premats, device):
    """maxplus_class_mats output (numpy) -> ViterbiOperands on `device` (a
    torch.device). The alphabet sizes are read off the shapes of the
    present classes; a side that no present class reads counts 0."""
    mu, md, ml, c0, classes = premats
    has_up, has_left, has_diag = classes
    c0 = np.asarray(c0, np.float32).reshape(-1)
    S = c0.shape[0]
    SP = _round_up(S, _TD)
    Ti = To = 0
    if has_up:
        To = mu.shape[0] // S
    if has_left:
        Ti = ml.shape[0] // S
    if has_diag:
        To, Ti = md.shape[0] // S, md.shape[1] // S

    def blocks(dest_major):
        """(n_tok, S', S) destination-major -> (n_tok, S, SP) tensor."""
        n_tok = dest_major.shape[0]
        out = np.full((n_tok, S, SP), NEG_INF, np.float32)
        out[:, :, :S] = np.transpose(dest_major, (0, 2, 1))
        return torch.from_numpy(out).to(device)

    ops = ViterbiOperands(S=S, SP=SP, Ti=Ti, To=To,
                          c0=torch.from_numpy(c0.copy()).to(device))
    if has_up:
        ops.up = blocks(np.asarray(mu, np.float32).reshape(To, S, S))
    if has_left:
        ops.left = blocks(np.asarray(ml, np.float32).reshape(Ti, S, S))
    if has_diag:
        # md[(ty, s'), (ti, s)] -> [ti * To + ty][s', s]
        m4 = np.asarray(md, np.float32).reshape(To, S, Ti, S)
        ops.diag = blocks(np.transpose(m4, (2, 0, 1, 3))
                          .reshape(Ti * To, S, S))
    return ops


# ------------------------------------------------------------ plain versions

def _class_max(blk, S, tok, has, nbr, neg):
    """max_s blk[tok][s, s'] + nbr[s] per cell: tok and has (...,) long and
    bool, nbr (..., S). A cell whose neighbour is missing or whose token
    lies outside the alphabet gets NEG_INF."""
    n_tok = blk.shape[0]
    ok = has & (tok >= 0) & (tok < n_tok)
    m = blk[torch.clamp(tok, 0, n_tok - 1)][..., :S]          # (..., S, S)
    cand = (m + nbr[..., :, None]).max(dim=-2).values
    return torch.where(ok[..., None], cand, neg)


def viterbi_forward_plain(ops, in_toks, out_toks, in_lens=None,
                          out_lens=None):
    """Plain PyTorch version of the full fill, float32.

    in_toks (B, Li), out_toks (B, Lo) integer tensors on the device of
    `ops`; in_lens/out_lens (B,) or None for the padded lengths. Returns
    the (Li + Lo + 1, B, Li + 1, S) slabs; a cell outside its pair's
    (in_len, out_len) lattice holds NEG_INF."""
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    S, To = ops.S, ops.To
    W = Li + 1
    dev = ops.c0.device
    f32 = torch.float32
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    il = torch.full((B,), Li, device=dev) if in_lens is None \
        else in_lens.long()
    ol = torch.full((B,), Lo, device=dev) if out_lens is None \
        else out_lens.long()
    i_idx = torch.arange(W, device=dev)
    x_tok = in_toks.long()[:, torch.clamp(i_idx - 1, 0, max(Li - 1, 0))] \
        if Li else torch.zeros((B, W), dtype=torch.long, device=dev)
    has_x = (i_idx >= 1)[None, :].expand(B, W)

    n_diags = Li + Lo + 1
    out = torch.full((n_diags, B, W, S), NEG_INF, dtype=f32, device=dev)
    out[0, :, 0] = ops.c0
    pad = torch.full((B, 1, S), NEG_INF, dtype=f32, device=dev)
    for d in range(1, n_diags):
        o_idx = d - i_idx
        y_tok = out_toks.long()[:, torch.clamp(o_idx - 1, 0, max(Lo - 1, 0))] \
            if Lo else torch.zeros((B, W), dtype=torch.long, device=dev)
        has_y = (o_idx >= 1)[None, :].expand(B, W)
        p1 = out[d - 1]
        cur = torch.full((B, W, S), NEG_INF, dtype=f32, device=dev)
        if ops.up is not None:
            cur = torch.maximum(cur, _class_max(ops.up, S, y_tok, has_y, p1,
                                                neg))
        if ops.left is not None:
            nbr = torch.cat([pad, p1[:, :-1]], dim=1)
            cur = torch.maximum(cur, _class_max(ops.left, S, x_tok, has_x,
                                                nbr, neg))
        if ops.diag is not None and d >= 2:
            nbr = torch.cat([pad, out[d - 2][:, :-1]], dim=1)
            ok = has_x & has_y & (x_tok >= 0) & (x_tok < ops.Ti) \
                & (y_tok >= 0) & (y_tok < To)
            cur = torch.maximum(cur, _class_max(
                ops.diag, S, x_tok * To + y_tok, ok, nbr, neg))
        valid = (o_idx >= 0)[None, :] & (o_idx[None, :] <= ol[:, None]) \
            & (i_idx[None, :] <= il[:, None])
        out[d] = torch.where(valid[:, :, None], cur, neg)
    return out


@dataclass
class BandGeometry:
    """Per-diagonal band and window of one pair, on the host (numpy int32)
    and, as `meta`, on a device: meta[d] = (lo_d, hi_d, base_d)."""
    Li: int
    Lo: int
    lo: np.ndarray
    hi: np.ndarray
    bases: np.ndarray
    Wb: int
    meta: torch.Tensor = None


def band_geometry(Li, Lo, lo, hi, device, pad=_BAND_PAD):
    n_diags = Li + Lo + 1
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    if len(lo) != n_diags or len(hi) != n_diags:
        raise ValueError("band arrays must have Li + Lo + 1 = %d entries"
                         % n_diags)
    bases, _, Wb = band_windows(lo, hi, pad=pad)
    meta = np.stack([lo, hi, bases], axis=1).astype(np.int32)
    return BandGeometry(Li=Li, Lo=Lo, lo=lo.astype(np.int32),
                        hi=hi.astype(np.int32), bases=bases, Wb=Wb,
                        meta=torch.from_numpy(np.ascontiguousarray(meta))
                        .to(device))


def viterbi_banded_forward_plain(ops, geom, in_toks, out_toks):
    """Plain PyTorch version of the banded fill of ONE pair, float32.

    in_toks (Li,), out_toks (Lo,) integer tensors on the device of `ops`.
    Returns the (Li + Lo + 1, Wb, S) windows: slab d holds cell i at
    window index i - bases[d], NEG_INF outside [lo_d, hi_d) and outside
    the lattice."""
    Li, Lo, Wb = geom.Li, geom.Lo, geom.Wb
    S, To = ops.S, ops.To
    dev = ops.c0.device
    f32 = torch.float32
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    n_diags = Li + Lo + 1
    xt = in_toks.long()
    yt = out_toks.long()
    w_idx = torch.arange(Wb, device=dev)
    out = torch.full((n_diags, Wb, S), NEG_INF, dtype=f32, device=dev)

    def in_band(d, i):
        o = d - i
        return (i >= int(geom.lo[d])) & (i < int(geom.hi[d])) & (i <= Li) \
            & (o >= 0) & (o <= Lo)

    if int(geom.lo[0]) <= 0 < int(geom.hi[0]):     # base_0 = 0: cell (0, 0)
        out[0, 0] = ops.c0

    def shifted(slab, shift):
        """slab values at window index w + shift, NEG_INF off the window."""
        src = w_idx + shift
        ok = (src >= 0) & (src < Wb)
        return torch.where(ok[:, None], slab[torch.clamp(src, 0, Wb - 1)],
                           neg)

    for d in range(1, n_diags):
        base = int(geom.bases[d])
        s1 = base - int(geom.bases[d - 1])
        i = base + w_idx
        o = d - i
        has_x = i >= 1
        has_y = o >= 1
        x_tok = xt[torch.clamp(i - 1, 0, max(Li - 1, 0))] if Li \
            else torch.zeros_like(i)
        y_tok = yt[torch.clamp(o - 1, 0, max(Lo - 1, 0))] if Lo \
            else torch.zeros_like(i)
        cur = torch.full((Wb, S), NEG_INF, dtype=f32, device=dev)
        if ops.up is not None:
            cur = torch.maximum(cur, _class_max(
                ops.up, S, y_tok, has_y, shifted(out[d - 1], s1), neg))
        if ops.left is not None:
            cur = torch.maximum(cur, _class_max(
                ops.left, S, x_tok, has_x, shifted(out[d - 1], s1 - 1), neg))
        if ops.diag is not None and d >= 2:
            s2 = base - int(geom.bases[d - 2])
            ok = has_x & has_y & (x_tok >= 0) & (x_tok < ops.Ti) \
                & (y_tok >= 0) & (y_tok < To)
            cur = torch.maximum(cur, _class_max(
                ops.diag, S, x_tok * To + y_tok, ok,
                shifted(out[d - 2], s2 - 1), neg))
        out[d] = torch.where(in_band(d, i)[:, None], cur, neg)
    return out


# ------------------------------------------------------------------ wrappers

def _class_ptrs(ops):
    return [0 if t is None else t.data_ptr()
            for t in (ops.up, ops.left, ops.diag)]


def _n_toks(ops):
    """The tokens of each class's blocks, (up, left, diag); 0: absent."""
    return tuple(0 if t is None else int(t.shape[0])
                 for t in (ops.up, ops.left, ops.diag))


def fill_smem_bytes(Li, Lo, S, n_slots, n_toks, gbuck=False):
    """Shared bytes of a block of the batched fill (the layout of
    csrc/viterbi_wavefront.cu): n_slots (W, S) diagonals, the pair's
    tokens, and per class the diagonal's cells bucketed by token; with
    `gbuck` the tokens, the sorted cells and the pieces are in the block's
    global buffer (fill_gbuck_bytes) and shared memory keeps the per-token
    counts."""
    W = Li + 1
    n = _round_up(n_slots * W * S, 4) + 4
    if not gbuck:
        n += _round_up(Li, 4) + _round_up(Lo, 4)
    for nt in n_toks:
        n += _round_up(nt + 1, 4) + _round_up(nt, 4)
        if not gbuck:
            n += _round_up(W, 4) + 4 * (W + nt)
    return 4 * n


def fill_gbuck_bytes(Li, Lo, n_toks):
    """Global bytes a block of the batched fill takes with its buckets in
    global memory: the pair's tokens, and per class the sorted cells and
    the pieces."""
    W = Li + 1
    n = _round_up(Li, 4) + _round_up(Lo, 4)
    for nt in n_toks:
        n += _round_up(W, 4) + 4 * (W + nt)
    return 4 * n


BUCKETS = ("shared", "global")


def fill_launch_plan(ops, B, Li, Lo, sms, grid=None, cluster=None,
                     slots=None, piece=None, chunks=None, buckets=None,
                     mem_bytes=None):
    """How the batched fill walks a batch: a dict with `grid` (pair
    walkers, default one per pair), `cluster` (blocks a pair: 2 when the
    batch has fewer pairs than the card's `sms` multiprocessors and the
    states make two column groups, else 1), `n_slots` (previous diagonals
    in shared memory: 3 with a diag class, else 2; 0 when they do not fit,
    and the neighbours are read back from the lattice), `piece` (the most
    cells of one token that share a load of its block, 1 to 8, default 8),
    `chunks` (the source states an item takes, in 1 to 8 chunks; 0, the
    default: the kernel takes, per diagonal, as many as make two items a
    thread, at most 3), `buckets` ("shared": the pair's tokens and the
    diagonal's token buckets in shared memory; "global": in a global
    buffer of each block's own, where they do not fit shared memory) and
    `smem` (bytes), and `bytes` (device bytes: the lattice it writes and
    the global buckets). `cluster` (1 or 2), `slots` (True: keep
    them, False: read back), `piece`, `chunks` and `buckets` force a
    choice; a plan that does not fit raises ValueError, as does one whose
    bytes exceed `mem_bytes` (the card's memory; None: not checked)."""
    n_toks = _n_toks(ops)
    if cluster not in (None, 1, 2):
        raise ValueError("cluster must be 1 or 2")
    if buckets not in (None,) + BUCKETS:
        raise ValueError("buckets must be one of %s, not %r"
                         % (BUCKETS, buckets))
    if cluster is None:
        cluster = 2 if B < sms and ops.SP // _TD >= 2 else 1
    want = 3 if ops.diag is not None else 2
    if buckets is None:
        buckets = "shared" if fill_smem_bytes(
            Li, Lo, ops.S, 0, n_toks) <= SMEM_MAX else "global"
    gbuck = buckets == "global"
    fits = fill_smem_bytes(Li, Lo, ops.S, want, n_toks, gbuck) <= SMEM_MAX
    if slots is None:
        slots = fits
    elif slots and not fits:
        raise ValueError("viterbi fill: %d diagonals of %d cells x %d states "
                         "do not fit a block's %d bytes of shared memory"
                         % (want, Li + 1, ops.S, SMEM_MAX))
    n_slots = want if slots else 0
    smem = fill_smem_bytes(Li, Lo, ops.S, n_slots, n_toks, gbuck)
    if smem > SMEM_MAX:
        raise ValueError("viterbi fill: the token buckets of %d cells (%d "
                         "bytes) do not fit a block's %d bytes of shared "
                         "memory" % (Li + 1, smem, SMEM_MAX))
    grid = max(B, 1) if grid is None else int(grid)
    if grid < 1:
        raise ValueError("grid must be >= 1")
    piece = _PIECE if piece is None else int(piece)
    if not 1 <= piece <= _PIECE:
        raise ValueError("piece must be 1 to %d" % _PIECE)
    chunks = 0 if chunks is None else int(chunks)
    if not 0 <= chunks <= 8:
        raise ValueError("chunks must be 0 to 8")
    nbytes = 4 * (Li + Lo + 1) * B * (Li + 1) * ops.S \
        + (grid * cluster * fill_gbuck_bytes(Li, Lo, n_toks) if gbuck else 0)
    if mem_bytes is not None and nbytes > mem_bytes:
        raise ValueError("viterbi fill: %d pairs of %d x %d take %d bytes of "
                         "device memory (the lattice and the buckets), over "
                         "the card's %d" % (B, Li, Lo, nbytes, mem_bytes))
    return {"grid": grid, "cluster": cluster, "n_slots": n_slots,
            "piece": piece, "chunks": chunks, "buckets": buckets,
            "smem": smem, "bytes": nbytes}


def fill_smem_bytes_on_card(ops, cfg, Li, Lo):
    """The shared bytes the kernel's own layout takes for `cfg` (a
    fill_launch_plan), from the built library: must equal cfg["smem"]."""
    fn = load("viterbi_wavefront").viterbi_wavefront_smem_bytes
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_long
    return fn(Li, Lo, ops.S, cfg["n_slots"], *_n_toks(ops),
              int(cfg["buckets"] == "global"))


def fill_gbuck_bytes_on_card(ops, Li, Lo):
    """The global bytes a block takes with its buckets in global memory,
    from the built library: must equal fill_gbuck_bytes."""
    fn = load("viterbi_wavefront").viterbi_wavefront_gbuck_floats
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_long
    return 4 * fn(Li, Lo, *_n_toks(ops))


def viterbi_wavefront(ops, in_toks, out_toks, in_lens=None, out_lens=None,
                      grid=None, cluster=None, slots=None, piece=None,
                      chunks=None, buckets=None):
    """Max-plus wavefront fill: (Li + Lo + 1, B, Li + 1, S) float32 slabs.

    A CUDA tensor launches csrc/viterbi_wavefront.cu and counts one launch
    in `viterbi_wavefront.launches`; a CPU tensor takes
    viterbi_forward_plain. in_toks (B, Li) and out_toks (B, Lo) are int32
    and contiguous on the device of `ops`; in_lens/out_lens (B,) int32, or
    None for the padded lengths. `grid` pair walkers (default one per pair)
    take pairs b, b + grid, ...; each is a cluster of `cluster` blocks
    that share the destination states, and keeps the previous diagonals in
    shared memory or reads them back (`slots`), and loads a token's block
    once for up to `piece` cells of that token, over the source states in
    `chunks`, with its token buckets in shared or global memory
    (`buckets`); fill_launch_plan chooses all five by default. The cells
    beyond a pair's (in_len, out_len) hold NEG_INF, which no reader of a
    pair's lattice touches."""
    if in_toks.device.type == "cpu":
        return viterbi_forward_plain(ops, in_toks, out_toks, in_lens,
                                     out_lens)
    if in_toks.device.type != "cuda":
        raise ValueError("viterbi_wavefront runs on cuda or cpu tensors, "
                         "not %s" % in_toks.device)
    dev = ops.c0.device
    B, Li = in_toks.shape
    Lo = out_toks.shape[1]
    _check(in_toks, "in_toks", torch.int32, (B, Li), dev)
    _check(out_toks, "out_toks", torch.int32, (B, Lo), dev)
    if in_lens is None:
        in_lens = torch.full((B,), Li, dtype=torch.int32, device=dev)
    if out_lens is None:
        out_lens = torch.full((B,), Lo, dtype=torch.int32, device=dev)
    _check(in_lens, "in_lens", torch.int32, (B,), dev)
    _check(out_lens, "out_lens", torch.int32, (B,), dev)
    props = torch.cuda.get_device_properties(dev)
    cfg = fill_launch_plan(ops, B, Li, Lo, props.multi_processor_count,
                           grid, cluster, slots, piece, chunks, buckets,
                           props.total_memory)
    n_diags = Li + Lo + 1
    out = torch.empty((n_diags, B, Li + 1, ops.S), dtype=torch.float32,
                      device=dev)
    gbuck = cfg["buckets"] == "global"
    gbuf = torch.empty(
        cfg["grid"] * cfg["cluster"] * fill_gbuck_bytes(Li, Lo, _n_toks(ops))
        // 4 if gbuck else 1, dtype=torch.float32, device=dev)
    fn = load("viterbi_wavefront").viterbi_wavefront_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 10 + [I] * 15 + [P]
    fn.restype = I
    rc = fn(in_toks.data_ptr(), out_toks.data_ptr(), in_lens.data_ptr(),
            out_lens.data_ptr(), ops.c0.data_ptr(), *_class_ptrs(ops),
            out.data_ptr(), gbuf.data_ptr(), B, Li, Lo, ops.S, ops.SP,
            ops.To, *_n_toks(ops), cfg["n_slots"], cfg["cluster"],
            cfg["piece"], cfg["chunks"], cfg["grid"], int(gbuck),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("viterbi_wavefront launch failed: CUDA error %d"
                           % rc)
    viterbi_wavefront.launches += 1
    return out


viterbi_wavefront.launches = 0


def _groups_per_rank(SP, csize):
    """Column groups of 4 destination states a rank of the banded fill's
    cluster owns (the last ranks may own fewer, or none)."""
    return -(-(SP // _TD) // csize)


def _row_groups(SP, csize):
    """The groups of a rank's packed row: _groups_per_rank made odd, so
    that 8 lanes reading 8 consecutive rows hit distinct shared banks."""
    return _groups_per_rank(SP, csize) | 1


def pack_banded(ops, csize):
    """The present class blocks split by destination columns for a cluster
    of `csize` blocks: one float32 tensor on the device of `ops`, per
    present class (up, left, diag) in turn a (csize, n_tok, S, Wr) array.
    Rank h owns the 4 g columns from 4 g h of every token's (S, SP) block,
    g = ceil(SP / 4 / csize); its row holds them and NEG_INF up to Wr =
    4 * (g made odd), a stride at which 8 lanes reading 8 consecutive rows
    hit distinct shared banks, and NEG_INF past SP. Each rank's slice of a
    class is contiguous, so the kernel copies it to shared memory as it
    is. Cached on `ops`."""
    if csize not in ops.packs:
        own = _TD * _groups_per_rank(ops.SP, csize)
        Wr = _TD * _row_groups(ops.SP, csize)
        parts = []
        for t in (ops.up, ops.left, ops.diag):
            if t is None:
                continue
            n_tok, S, SP = t.shape
            out = torch.full((csize, n_tok, S, Wr), NEG_INF,
                             dtype=torch.float32, device=t.device)
            for h in range(csize):
                cols = t[:, :, h * own:min(SP, (h + 1) * own)]
                out[h, :, :, :cols.shape[2]] = cols
            parts.append(out.reshape(-1))
        ops.packs[csize] = torch.cat(parts).contiguous()
    return ops.packs[csize]


def unpack_banded(packed, ops, csize):
    """pack_banded's inverse: the (up, left, diag) blocks, each (n_tok, S,
    SP) or None, from the packed tensor (the shapes are read off `ops`)."""
    own = _TD * _groups_per_rank(ops.SP, csize)
    Wr = _TD * _row_groups(ops.SP, csize)
    out, at = [], 0
    for t in (ops.up, ops.left, ops.diag):
        if t is None:
            out.append(None)
            continue
        n_tok, S, SP = t.shape
        n = csize * n_tok * S * Wr
        part = packed[at:at + n].reshape(csize, n_tok, S, Wr)[..., :own]
        out.append(part.permute(1, 2, 0, 3).reshape(n_tok, S, csize * own)
                   [:, :, :SP].contiguous())
        at += n
    return tuple(out)


def banded_smem_bytes(ops, Wb, csize, resident, slots, staged=True):
    """Shared bytes of a block of the banded fill (the layout of
    csrc/viterbi_banded_wavefront.cu): the rank's resident columns of
    every class block, five (Wb, SP) diagonal slots and their mbarriers,
    two staged chunks of CH diagonals (bounds and, when `staged`, the
    tokens they reach) and their bases."""
    n = 12                             # the slots' five mbarriers
    if resident:
        n += sum(_n_toks(ops)) * ops.S * _TD * _row_groups(ops.SP, csize)
    if slots:
        n += 5 * Wb * ops.SP
    toks = (2 * _BAND_CH + Wb + 1) + (3 * _BAND_CH + Wb) if staged else 0
    stage = _round_up(3 * _BAND_CH + toks, 4)
    return 4 * (n + 2 * stage + 4)


def banded_launch_plan(ops, geom, sms, cluster=None, resident=None,
                       split=None, max_clusters=None, staged=None):
    """How the banded fill walks its pair: a dict with `cluster` (the
    cluster's blocks, which split the destination states), `resident`
    (each block's columns of the class blocks in its shared memory, or
    read through L2), `slots` (the previous diagonals in shared memory, or
    read back from the lattice when five windows do not fit), `split`
    (the lanes an item takes over the source states), `staged` (the band's
    tokens staged in shared memory with its bounds; False past the band
    whose tokens fit, about 14,000 cells, where they are read from global
    memory, with read-back), `smem` (bytes) and `groups_per_rank`.

    Defaults: split 8 from 32 states (4 from 8, else 1); the previous
    diagonals in slots where they fit; the smallest portable cluster (1,
    2, 4 or 8, at most one a column group of 4 states) whose band items
    (the widest diagonal's band cells x the rank's column groups x split)
    fit one pass of the block's 512 threads and whose columns fit beside
    the slots, resident; if none fits resident, the smallest whose items
    fit, streamed. `cluster` (1 to 16,
    at most SP / 4), `resident`, `split` (1, 2, 4, 8) and `staged` force a
    choice; a forced choice that does not fit raises ValueError.
    `max_clusters(cfg)`, if given, is the card's occupancy calculator
    (banded_max_clusters_on_card): a layout it gives no cluster is passed
    over, or raises when forced. `sms` bounds the cluster size."""
    n_dg = ops.SP // _TD
    if split is None:
        split = 8 if ops.S >= 32 else 4 if ops.S >= 8 else 1
    if split not in _SPLITS:
        raise ValueError("split must be one of %s" % (_SPLITS,))
    if cluster is not None and (cluster not in _CLUSTERS or cluster > n_dg
                                or cluster > sms):
        raise ValueError("cluster must be one of %s, at most SP / 4 = %d "
                         "and at most %d" % (_CLUSTERS, n_dg, sms))
    Wb = geom.Wb
    fits = banded_smem_bytes(ops, Wb, 1, False, False) <= SMEM_MAX
    if staged and not fits:
        raise ValueError("banded fill: the tokens of a band of %d cells do "
                         "not fit a block's %d bytes of shared memory"
                         % (Wb, SMEM_MAX))
    staged = fits if staged is None else bool(staged)
    slots = staged and banded_smem_bytes(ops, Wb, 1, False, True) <= SMEM_MAX

    def layout(c, res):
        cfg = {"cluster": c, "resident": res, "slots": slots,
               "split": split, "staged": staged,
               "groups_per_rank": _groups_per_rank(ops.SP, c),
               "smem": banded_smem_bytes(ops, Wb, c, res, slots, staged)}
        ok = cfg["smem"] <= SMEM_MAX and (max_clusters is None
                                          or max_clusters(cfg) >= 1)
        return cfg, ok

    cells = max(1, min(Wb, int((geom.hi - geom.lo).max())))

    def one_pass(c):
        return cells * _groups_per_rank(ops.SP, c) * split <= _BAND_THREADS

    if cluster is not None:
        if resident is None:
            cfg, ok = layout(cluster, True)
            if not ok:
                cfg, ok = layout(cluster, False)
        else:
            cfg, ok = layout(cluster, bool(resident))
        if not ok:
            raise ValueError("banded fill: cluster %d, %s, does not fit (%d "
                             "shared bytes a block)" % (
                                 cluster, "resident" if cfg["resident"]
                                 else "streamed", cfg["smem"]))
        return cfg
    sizes = [c for c in _CLUSTERS[:4] if c <= n_dg and c <= sms]
    for want in ((True, False) if resident is None else (bool(resident),)):
        fits = [c for c in sizes if layout(c, want)[1]]
        if fits:
            return layout(next((c for c in fits if one_pass(c)), fits[-1]),
                          want)[0]
    raise ValueError("banded fill: no cluster of %s fits a block's %d "
                     "bytes of shared memory" % (sizes, SMEM_MAX))


def banded_smem_bytes_on_card(ops, geom, cfg):
    """The shared bytes the kernel's own layout takes for `cfg` (a
    banded_launch_plan), from the built library: must equal cfg["smem"]."""
    fn = load("viterbi_banded_wavefront").viterbi_banded_smem_bytes
    fn.argtypes = [ctypes.c_int] * 10
    fn.restype = ctypes.c_long
    return fn(ops.S, ops.SP, geom.Wb, *_n_toks(ops), cfg["cluster"],
              int(cfg["resident"]), int(cfg["slots"]), int(cfg["staged"]))


def banded_max_clusters_on_card(ops, geom, cfg):
    """The card's occupancy calculator (cudaOccupancyMaxActiveClusters) for
    the banded fill in layout `cfg`: how many such clusters fit the card at
    once; 0 means the layout cannot launch. Raises on a CUDA error."""
    fn = load("viterbi_banded_wavefront").viterbi_banded_max_clusters
    fn.argtypes = [ctypes.c_int] * 11
    fn.restype = ctypes.c_int
    n = fn(ops.S, ops.SP, geom.Wb, *_n_toks(ops), cfg["cluster"],
           int(cfg["resident"]), int(cfg["slots"]), cfg["split"],
           int(cfg["staged"]))
    if n < 0:
        raise RuntimeError("viterbi_banded_max_clusters failed for %r" % cfg)
    return n


def viterbi_banded_wavefront(ops, geom, in_toks, out_toks, cluster=None,
                             resident=None, split=None, staged=None):
    """Banded max-plus fill of ONE pair: (Li + Lo + 1, Wb, S) float32
    windows, left on the device for the lattice walk.

    A CUDA tensor launches csrc/viterbi_banded_wavefront.cu (one cluster of
    blocks walks every diagonal, in the layout of banded_launch_plan, which
    `cluster`, `resident`, `split` and `staged` force; the card's occupancy
    calculator vets the layout before the launch) and counts one launch in
    `viterbi_banded_wavefront.launches`; a refused launch raises
    RuntimeError. A CPU tensor takes viterbi_banded_forward_plain (the
    layout keywords change nothing there). in_toks (Li,) and out_toks (Lo,)
    are int32 and contiguous on the device of `ops`, as is geom.meta."""
    if in_toks.device.type == "cpu":
        return viterbi_banded_forward_plain(ops, geom, in_toks, out_toks)
    if in_toks.device.type != "cuda":
        raise ValueError("viterbi_banded_wavefront runs on cuda or cpu "
                         "tensors, not %s" % in_toks.device)
    dev = ops.c0.device
    Li, Lo, Wb = geom.Li, geom.Lo, geom.Wb
    n_diags = Li + Lo + 1
    _check(in_toks, "in_toks", torch.int32, (Li,), dev)
    _check(out_toks, "out_toks", torch.int32, (Lo,), dev)
    _check(geom.meta, "geom.meta", torch.int32, (n_diags, 3), dev)
    cfg = banded_launch_plan(
        ops, geom, torch.cuda.get_device_properties(dev).multi_processor_count,
        cluster, resident, split,
        max_clusters=lambda c: banded_max_clusters_on_card(ops, geom, c),
        staged=staged)
    packed = pack_banded(ops, cfg["cluster"]) if cfg["resident"] else None
    out = torch.empty((n_diags, Wb, ops.S), dtype=torch.float32, device=dev)
    fn = load("viterbi_banded_wavefront").viterbi_banded_wavefront_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 9 + [I] * 15 + [P]
    fn.restype = I
    rc = fn(in_toks.data_ptr(), out_toks.data_ptr(), geom.meta.data_ptr(),
            ops.c0.data_ptr(), *_class_ptrs(ops),
            0 if packed is None else packed.data_ptr(), out.data_ptr(), Li,
            Lo, Wb, ops.S, ops.SP, ops.Ti, ops.To, *_n_toks(ops),
            cfg["cluster"], int(cfg["resident"]), int(cfg["slots"]),
            cfg["split"], int(cfg["staged"]),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("viterbi_banded_wavefront launch failed: CUDA "
                           "error %d" % rc)
    viterbi_banded_wavefront.launches += 1
    return out


viterbi_banded_wavefront.launches = 0


# ----------------------------------------------------------------- factories

def _premats(a_diag, a_left, a_up, closure, premats):
    return premats if premats is not None else \
        maxplus_class_mats(a_diag, a_left, a_up, closure)


def make_wavefront_viterbi(a_diag, a_left, a_up, closure, B, Li, Lo,
                           n_chunks=None, interpret=False, premats=None,
                           device=None):
    """Build the max-plus wavefront fill for fixed machine tensors/shapes.

    Tensors are LOG-space max-plus numpy matrices: a_diag (Ti, To, S, S),
    a_left (Ti, S, S), a_up (To, S, S), closure (S, S) = the max-plus
    silent closure (lowering.matrices_2d("maxplus")).

    Returns fn(in_toks (B, Li), out_toks (B, Lo), in_lens=None,
    out_lens=None) -> (n_diags, B, W, S) diagonal slabs on `device` (None:
    the card), W = Li + 1, slab d holding cells (i, o=d-i), ready for
    ops/wavefront.lattice_from_diagonals and the lattice walk. With
    lengths, cells beyond a pair's own lattice hold NEG_INF.

    `n_chunks` (the TPU kernel's VMEM accumulators) and `interpret`
    (Pallas interpret mode off the TPU) are the JAX factory's knobs of the
    TPU layout: accepted with its defaults and unused."""
    dev = resolve_device(device)
    ops = viterbi_operands(_premats(a_diag, a_left, a_up, closure, premats),
                           dev)

    def as_i32(x):
        return torch.as_tensor(x, device=dev).to(torch.int32).contiguous()

    def viterbi(in_toks, out_toks, in_lens=None, out_lens=None):
        it, ot = as_i32(in_toks), as_i32(out_toks)
        if tuple(it.shape) != (B, Li) or tuple(ot.shape) != (B, Lo):
            raise ValueError("expected tokens of shape (%d, %d) and (%d, %d)"
                             % (B, Li, B, Lo))
        il = None if in_lens is None else as_i32(in_lens)
        ol = None if out_lens is None else as_i32(out_lens)
        return viterbi_wavefront(ops, it, ot, il, ol)

    return viterbi


def make_wavefront_viterbi_banded(a_diag, a_left, a_up, closure, Li, Lo,
                                  lo, hi, interpret=False, premats=None,
                                  device=None):
    """Envelope-banded max-plus wavefront for ONE sequence pair.

    lo/hi: per-diagonal [lo_d, hi_d) bands of cell index i (from
    core.seqpair.Envelope via envelope_diag_bands). Only band cells are
    computed.

    Returns fn(in_toks (Li,), out_toks (Lo,)) -> the (Li+1, Lo+1, S)
    float64 numpy lattice with NEG_INF outside the band, for the host
    traceback. fn.fill_raw gives the (n_diags, Wb, S) windows on `device`
    (None: the card) for the lattice walk, fn.scatter turns host windows
    into the full lattice, fn.bases and fn.Wb are the window geometry.
    `interpret` (Pallas interpret mode off the TPU) is the JAX factory's
    knob of the TPU layout: accepted with its default and unused."""
    dev = resolve_device(device)
    ops = viterbi_operands(_premats(a_diag, a_left, a_up, closure, premats),
                           dev)
    geom = band_geometry(Li, Lo, lo, hi, dev)
    S, Wb, bases = ops.S, geom.Wb, geom.bases
    n_diags = Li + Lo + 1

    # vectorized window geometry
    ds_g = np.arange(n_diags)[:, None]                    # (n_diags, 1)
    i_g = bases[:, None].astype(np.int64) + np.arange(Wb)[None, :]
    o_g = ds_g - i_g
    in_band = (i_g >= geom.lo[:, None]) & (i_g < geom.hi[:, None]) \
        & (o_g >= 0) & (o_g <= Lo)

    def fill_raw(in_toks, out_toks):
        """Device band windows (n_diags, Wb, S): stay on the device, for
        the lattice walk (algo/traceback_device)."""
        it = torch.as_tensor(np.asarray(in_toks, np.int32), device=dev) \
            .contiguous()
        ot = torch.as_tensor(np.asarray(out_toks, np.int32), device=dev) \
            .contiguous()
        if tuple(it.shape) != (Li,) or tuple(ot.shape) != (Lo,):
            raise ValueError("expected tokens of shape (%d,) and (%d,)"
                             % (Li, Lo))
        return viterbi_banded_wavefront(ops, geom, it, ot)

    def scatter(lat):
        """Host (n_diags, Wb, S) windows -> full (Li+1, Lo+1, S)."""
        full = np.full((Li + 1, Lo + 1, S), NEG_INF, np.float64)
        dd, ww = np.nonzero(in_band & (i_g <= Li))
        full[i_g[dd, ww], o_g[dd, ww]] = lat[dd, ww, :]
        return full

    def viterbi(in_toks, out_toks):
        return scatter(fill_raw(in_toks, out_toks).cpu().numpy())

    viterbi.fill_raw = fill_raw
    viterbi.scatter = scatter
    viterbi.bases = bases
    viterbi.Wb = Wb
    return viterbi
