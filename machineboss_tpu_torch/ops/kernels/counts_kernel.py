"""The E-step's backward as one CUDA kernel: expected transition counts
over the row kernel's Forward and Backward lattices.

Counterpart of the backward pass that XLA derives for machineboss_tpu's
ops/fwdback.py:112 (`jax.value_and_grad` of a vmap of dp2d.forward_2d,
one jitted program with the E-step, no pallas_call). The E-step's
objective is sum_b g_b LL_b, LL_b = F_b(il, ol, S-1), with the row
recurrence of ops/dp2d.py (_row_scan, _rows):

    U(i,o) = F(i-1,o-1) (x) A_diag[x_i,y_o] (+) F(i,o-1) (x) A_up[y_o]
             (+) F(i-1,o) (x) A_left[x_i],   U(0,0) = e_0,
    F(i,o) = U(i,o) (x) C,

and its gradient with respect to the four log-space tensors is a sum over
each pair's cells (i <= il, o <= ol) of posterior terms:

    A_diag[x_i,y_o][s,t]  exp(F(i-1,o-1,s) + A_diag[s,t] + Bk(i,o,t) - LL)
    A_left[x_i][s,t]      the same with F(i-1,o,s)
    A_up[y_o][s,t]        the same with F(i,o-1,s)
    C[s,t]                exp(U(i,o,s) + C[s,t] + beta(i,o,t) - LL)

where Bk is the Backward lattice (the weight from the pre-closure state
to the end, as dp2d.backward_2d_lattice and the reference's
BackwardMatrix hold it) and beta the post-closure Backward: Bk's
neighbours through the emitting matrices, plus the end at (il, ol).
Neither lattice holds U or beta; both are recomputed from neighbours.

Pieces, for the E-step (ops/fwdback.CountModel):

* `estep_route(dtype, S)`: the E-step's route, stated here once: "rows"
  (this module: the row kernel and expected_counts on the card, their
  plain versions on the CPU) for 1..512 states, the row kernel's range,
  in float32 (float64 weights run on float32 copies of the matrices);
  "wavefront" (autograd through ops/wavefront_fast.py) for anything
  else.
* `RowLoglike`, a torch.autograd.Function: forward is the row kernel's
  score mode on the batch (one launch, no lattice kept); backward works in
  chunks of pairs (`counts_chunk_plan`, against the card's memory): a
  Forward lattice (one row_scan launch), the Backward lattices of the
  pairs' reversed prefixes (one launch, `backward_lattices`) and
  `expected_counts` (one launch).
* `expected_counts`, the counted wrapper of csrc/expected_counts.cu: a CUDA
  tensor launches the kernel once (or raises), a CPU tensor takes
  `expected_counts_plain`, the same function vectorised over a row.
* `counts_tables` (the kernel's compact lists of the finite entries, by
  destination and by source), `counts_launch_plan` (rows a unit, warps,
  blocks, where the tables and the warps' sums live) and
  `expected_counts_twin` (the kernel's arithmetic in plain PyTorch on
  those tables: tests only).

The Backward lattices are passed as the row kernel writes them on each
pair's reversed prefix (`Br`): Bk_b(i, o) = Br[b, ol_b - o, il_b - i] for
i <= il_b, o <= ol_b, which saves the card a flipped copy of a lattice.
"""

import ctypes
import time
from dataclasses import dataclass

import torch

from ...utils.device import free_bytes
from ..semiring import LOGSUMEXP, NEG_INF
from . import row_kernel
from ._build import load

SMEM_MAX = row_kernel.SMEM_MAX - 64   # dynamic bytes: the ticket's flag
                                      # is static shared memory
MAX_STATES = row_kernel.MAX_STATES
SMS = row_kernel.SMS
_F32 = 4
_F64 = 8
ACC_SHARE = 0.5      # of the card's memory the global accumulators may take


def estep_route(dtype, S):
    """The E-step's route for a model of S states in `dtype`: "rows"
    where the row kernel takes it (1 to MAX_STATES states in float32, or
    in float64 on float32 copies of the matrices, as the JAX package
    computes without x64; on the CPU the same functions' plain versions),
    else "wavefront" (autograd through the batched scaled wavefront, a
    float32 engine, any S)."""
    if dtype in (torch.float32, torch.float64) and 1 <= S <= MAX_STATES:
        return "rows"
    return "wavefront"


# ------------------------------------------------------------ the lattices

def reversed_prefixes(toks, lens):
    """(B, L) tokens with each row's first lens[b] reversed and the
    padding after them (0), by one gather."""
    L = toks.shape[-1]
    p = torch.arange(L, device=toks.device)
    lens = torch.as_tensor(lens, device=toks.device).long().reshape(-1, 1)
    src = (lens - 1 - p).clamp(min=0)
    rev = toks.long().gather(1, src) if L else toks.long()
    return torch.where(p < lens, rev, torch.zeros_like(rev))


def backward_lattices(a_diag, a_left, a_up, closure, in_toks, out_toks,
                      in_lens, out_lens):
    """The Backward lattices of a ragged batch, (B, Lo+1, Li+1, S), each
    on its pair's reversed prefix: the row engine (row_kernel.row_scan,
    one launch on the card) on the transposed matrices, the end state's
    start vector and reversed_prefixes' tokens, so that
    Bk_b(i, o) = Br[b, ol_b - o, il_b - i] (i <= il_b, o <= ol_b) is
    dp2d.backward_2d_lattice's cell of the pair alone."""
    S = closure.shape[-1]
    e_end = torch.full((S,), NEG_INF, dtype=closure.dtype,
                       device=closure.device)
    e_end[S - 1] = 0.0
    return row_kernel.row_scan(
        a_diag.transpose(-1, -2), a_left.transpose(-1, -2),
        a_up.transpose(-1, -2), closure.transpose(-1, -2),
        reversed_prefixes(in_toks, in_lens),
        reversed_prefixes(out_toks, out_lens), LOGSUMEXP, start_vec=e_end)


def unreversed(Br, in_lens, out_lens):
    """Br read back in dp2d.backward_2d_lattice's orientation: Bk[b, o, i]
    = Br[b, ol_b - o, il_b - i] inside each pair's prefix, NEG_INF
    outside it."""
    B, Lo1, Li1, _ = Br.shape
    dev = Br.device
    il = torch.as_tensor(in_lens, device=dev).long().reshape(B, 1)
    ol = torch.as_tensor(out_lens, device=dev).long().reshape(B, 1)
    ro = ol - torch.arange(Lo1, device=dev)                  # (B, Lo1)
    ri = il - torch.arange(Li1, device=dev)                  # (B, Li1)
    inside = (ro >= 0)[:, :, None] & (ri >= 0)[:, None, :]
    bi = torch.arange(B, device=dev)[:, None, None]
    Bk = Br[bi, ro.clamp(min=0)[:, :, None], ri.clamp(min=0)[:, None, :]]
    return torch.where(inside[..., None], Bk, torch.full_like(Bk, NEG_INF))


def _pairs(F, in_toks, out_toks, in_lens, out_lens, grad_ll, n_in, n_out):
    """Tokens clamped to the alphabets, lengths clamped to the padded
    shape, each pair's LL read from its Forward lattice and its weight,
    0 (and LL 0) for a pair with weight 0 or no path."""
    B, Lo1, Li1, S = F.shape
    dev = F.device
    it = in_toks.long().reshape(B, Li1 - 1).clamp(0, n_in - 1)
    ot = out_toks.long().reshape(B, Lo1 - 1).clamp(0, n_out - 1)
    il = torch.as_tensor(in_lens, device=dev).long().reshape(B) \
        .clamp(0, Li1 - 1)
    ol = torch.as_tensor(out_lens, device=dev).long().reshape(B) \
        .clamp(0, Lo1 - 1)
    LL = F[torch.arange(B, device=dev), ol, il, S - 1]
    g = torch.as_tensor(grad_ll, device=dev).to(F.dtype).reshape(B)
    live = (g != 0) & (LL > NEG_INF / 2)
    zero = torch.zeros_like(LL)
    return it, ot, il, ol, torch.where(live, LL, zero), \
        torch.where(live, g, zero), live


def _unpad(grads, n_in, n_out):
    gd, gl, gu, gc = grads
    return gd[:n_in, :n_out], gl[:n_in], gu[:n_out], gc


def _finite_entries(mats):
    """The four matrices' finite entries, matrix by matrix in row_scan's
    order (A_diag[x, y] as x * n_out + y, A_left[x], A_up[y], the
    closure): (src, dst, val, pos), each (n_mat, E) with E the most a
    matrix has (at least 1), padded with val NEG_INF and pos -1; pos is
    the entry's flat position in (n_mat, S, S)."""
    S = mats[3].shape[-1]
    M = torch.cat([m.reshape(-1, S, S) for m in mats])
    n_mat, dev = M.shape[0], M.device
    mm, kk, jj = torch.nonzero(M > NEG_INF / 2, as_tuple=True)
    cnt = torch.bincount(mm, minlength=n_mat)
    E = max(int(cnt.max()), 1)
    rank = torch.arange(len(mm), device=dev) - (torch.cumsum(cnt, 0)
                                                 - cnt)[mm]
    src = torch.zeros((n_mat, E), dtype=torch.long, device=dev)
    dst = torch.zeros((n_mat, E), dtype=torch.long, device=dev)
    val = torch.full((n_mat, E), NEG_INF, dtype=M.dtype, device=dev)
    pos = torch.full((n_mat, E), -1, dtype=torch.long, device=dev)
    src[mm, rank], dst[mm, rank] = kk, jj
    val[mm, rank] = M[mm, kk, jj]
    pos[mm, rank] = (mm * S + kk) * S + jj
    return src, dst, val, pos


def _scatter_lse(x, index, S):
    """logsumexp of x (..., E) grouped by index (..., E) into (..., S):
    NEG_INF (or NEG_INF plus a log count) where nothing finite lands."""
    mx = torch.full(x.shape[:-1] + (S,), NEG_INF, dtype=x.dtype,
                    device=x.device).scatter_reduce(-1, index, x, "amax")
    tot = torch.zeros_like(mx).scatter_add(
        -1, index, torch.exp(x - torch.gather(mx, -1, index)))
    return torch.where(tot > 0, torch.log(tot) + mx, NEG_INF)


def expected_counts_plain(F, Br, a_diag, a_left, a_up, closure, in_toks,
                          out_toks, in_lens, out_lens, grad_ll):
    """The gradient of sum_b grad_ll[b] LL_b with respect to (a_diag,
    a_left, a_up, closure), LL_b = F[b, ol, il, S-1], from the Forward
    lattices F (B, Lo+1, Li+1, S) post-closure, as row_scan writes them,
    and the reversed Backward lattices Br (backward_lattices). Pairs with
    grad_ll 0 or no path (LL <= NEG_INF / 2) add nothing. A row of every
    pair at a time, over each matrix's finite entries (an omitted entry's
    term is exp(-1e30 ...) = 0): the four terms of the module docstring,
    U and beta by logsumexp over the neighbours' terms, the terms summed
    by index_add_ into each entry's place."""
    n_in0, n_out0 = a_left.shape[0], a_up.shape[0]
    a_diag, a_left, a_up = row_kernel.nonempty(a_diag, a_left, a_up)
    B, Lo1, Li1, S = F.shape
    Li, Lo = Li1 - 1, Lo1 - 1
    dt, dev = F.dtype, F.device
    n_in, n_out = a_left.shape[0], a_up.shape[0]
    n_io = n_in * n_out
    it, ot, il, ol, LL, g, live = _pairs(F, in_toks, out_toks, in_lens,
                                         out_lens, grad_ll, n_in, n_out)
    Bk = unreversed(Br, il, ol)
    src, dst, val, pos = _finite_entries((a_diag, a_left, a_up, closure))
    flat = torch.zeros(src.shape[0] * S * S, dtype=dt, device=dev)
    i_idx = torch.arange(Li1, device=dev)
    ll, gw = LL[:, None, None], g[:, None, None]

    def side(m, nb, here, keep, acc):
        """Through matrix m (B, n) per cell, from the cells' neighbours nb
        (B, n, S): incoming (acc True: nb is F of the source cell, here
        Bk of this one; the terms are added into the gradient) the
        logsumexp of nb (x) A into each destination; outgoing (acc False:
        nb is Bk of the cell fed, summed into each source)."""
        k, j, v, p = src[m], dst[m], val[m].to(dt), pos[m]
        into, frm = (j, k) if acc else (k, j)
        x = torch.gather(nb, -1, frm) + v
        if acc:
            t = torch.exp(x + torch.gather(here, -1, into) - ll)
            ok = keep[..., None] & (p >= 0)
            flat.index_add_(0, p[ok], (t * gw)[ok])
        return _scatter_lse(x, into, S)

    neg = torch.full((B, Li1, S), NEG_INF, dtype=dt, device=dev)
    for o in range(Lo1):
        Bo = Bk[:, o]
        keep = live[:, None] & (i_idx <= il[:, None]) & (o <= ol)[:, None]
        U = neg.clone()
        if o == 0:
            U[:, 0, 0] = 0.0                       # the start vector e_0
        else:
            y = ot[:, o - 1, None]
            U = torch.logaddexp(U, side(
                (n_io + n_in + y).expand(B, Li1), F[:, o - 1], Bo, keep,
                True))
        if Li:
            up = side(n_io + it, F[:, o, :-1], Bo[:, 1:], keep[:, 1:], True)
            if o:
                up = torch.logaddexp(up, side(
                    it * n_out + y, F[:, o - 1, :-1], Bo[:, 1:],
                    keep[:, 1:], True))
            U[:, 1:] = torch.logaddexp(U[:, 1:], up)
        # beta: the cells this one feeds, and the end
        beta = neg.clone()
        end = (ol == o)[:, None] & (i_idx == il[:, None])
        beta[..., S - 1] = torch.where(end, 0.0, NEG_INF)
        if o < Lo:
            y1 = ot[:, o, None]
            beta = torch.logaddexp(beta, side(
                (n_io + n_in + y1).expand(B, Li1), Bk[:, o + 1], None, None,
                False))
            if Li:
                beta[:, :-1] = torch.logaddexp(beta[:, :-1], side(
                    it * n_out + y1, Bk[:, o + 1, 1:], None, None, False))
        if Li:
            beta[:, :-1] = torch.logaddexp(beta[:, :-1], side(
                n_io + it, Bo[:, 1:], None, None, False))
        # the closure's terms: exp(U(s) + C[s,t] + beta(t) - LL)
        k, j, v, p = src[-1], dst[-1], val[-1].to(dt), pos[-1]
        t = torch.exp(U[..., k] + v + beta[..., j] - ll)
        t = torch.where(keep[..., None], t, 0.0) * gw
        flat.index_add_(0, p[p >= 0], t.sum((0, 1))[p >= 0])
    n = n_io * S * S
    gd = flat[:n].view(n_in, n_out, S, S)
    gl = flat[n:n + n_in * S * S].view(n_in, S, S)
    gu = flat[n + n_in * S * S:-S * S].view(n_out, S, S)
    return _unpad((gd, gl, gu, flat[-S * S:].view(S, S)), n_in0, n_out0)


# ------------------------------------------------------------- the tables

@dataclass
class CountsTables:
    """The kernel's operands for one set of matrices, in row_scan's
    matrix order (A_diag[x, y] as x * n_out + y, A_left[x], A_up[y], the
    closure). The compact lists: off_f (n_mat + 1,) int32, matrix m's
    entries ent_f[off_f[m]:off_f[m + 1]]; ent_f (n_fin, 2) int32, each
    finite entry's (key, log value bits) sorted by (matrix, destination,
    source), its row its index among the finite entries; off_t, ent_t the
    same of the transposed matrices (sorted by source, then destination).
    A key holds in bits 0-9 the state the list is sorted by, in 10-14 the
    lane of the last entry of its run (that state) within its group of 32
    entries of the matrix's list, in 15 whether it starts its run in the
    group, in 16-25 the other state, in 26-28 the shuffle steps
    (ceil(log2)) the group's longest run needs. cdiag: every diagonal entry
    of the closure is finite (as (I - N)^-1's always are), and its S
    diagonal entries lead its forward list, by state; the rest follow by
    (destination, source). pos (n_fin,): each finite entry's flat
    position in (n_mat, S, S). prep_ms: the build's host clock, synchronised on a card."""
    S: int
    n_in: int
    n_out: int
    off_f: torch.Tensor
    ent_f: torch.Tensor
    off_t: torch.Tensor
    ent_t: torch.Tensor
    pos: torch.Tensor
    cdiag: bool
    prep_ms: float

    @property
    def n_mat(self):
        return self.n_in * self.n_out + self.n_in + self.n_out + 1

    @property
    def n_fin(self):
        return self.pos.shape[0]

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in
                   (self.off_f, self.ent_f, self.off_t, self.ent_t))


def compact_lists(M, fin, diag_first=False):
    """(off, ent, (mm, a, b)) of M (n_mat, S, S): each matrix's finite
    entries sorted by destination a, then source b (CountsTables' keys);
    with `diag_first` the last matrix's diagonal entries lead its list, by
    state, before the others. The transposed lists are compact_lists of M
    transposed."""
    n_mat, S, _ = M.shape
    dev = M.device
    mm, a, b = torch.nonzero(fin.transpose(1, 2), as_tuple=True)
    if diag_first:
        last = mm == n_mat - 1
        order = torch.argsort((mm * 2 + (last & (a != b))) * S * S
                              + torch.where(last & (a == b), a, a * S + b))
        mm, a, b = mm[order], a[order], b[order]
    n = len(mm)
    cnt = torch.bincount(mm, minlength=n_mat)
    off = torch.zeros(n_mat + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(cnt, 0)
    lane = (torch.arange(n, device=dev) - off[mm]) % 32
    head = lane == 0
    if n > 1:
        head[1:] |= (a[1:] != a[:-1]) | (mm[1:] != mm[:-1])
    # (each scatter's target sized n, so no count crosses to the host)
    seg = torch.cumsum(head.long(), 0) - 1
    tail = torch.zeros(n, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, seg, lane, "amax")[seg]
    # the shuffle steps a group's longest run needs: ceil(log2(length))
    length = tail - lane + 1                  # at each run's first entry
    group = torch.cumsum((lane == 0).long(), 0) - 1
    longest = torch.ones(n, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, group, length, "amax")[group]
    steps = torch.ceil(torch.log2(longest.double())).long()
    key = a | (tail << 10) | (head.long() << 15) | (b << 16) | (steps << 26)
    ent = torch.stack([key.to(torch.int32), M[mm, b, a].to(torch.float32)
                       .contiguous().view(torch.int32)], 1)
    return off.to(torch.int32), ent.contiguous(), (mm, a, b)


def counts_tables(a_diag, a_left, a_up, closure):
    """CountsTables of the four matrices (any strides, non-empty
    alphabets) on their device."""
    dev = closure.device
    row_kernel._sync(dev)
    t0 = time.perf_counter()
    S = closure.shape[-1]
    M = torch.cat([a_diag.reshape(-1, S, S), a_left.reshape(-1, S, S),
                   a_up.reshape(-1, S, S), closure.reshape(1, S, S)])
    fin = M > NEG_INF / 2
    cdiag = bool(torch.diagonal(fin[-1]).all())
    off_f, ent_f, (mm, dst, src) = compact_lists(M, fin, diag_first=cdiag)
    off_t, ent_t, _ = compact_lists(M.transpose(1, 2), fin.transpose(1, 2))
    row_kernel._sync(dev)
    return CountsTables(S=S, n_in=a_left.shape[0], n_out=a_up.shape[0],
                        off_f=off_f, ent_f=ent_f, off_t=off_t, ent_t=ent_t,
                        pos=(mm * S + src) * S + dst, cdiag=cdiag,
                        prep_ms=(time.perf_counter() - t0) * 1e3)


def counts_tables_cached(a_diag, a_left, a_up, closure):
    """(CountsTables, built): counts_tables kept per set of operand tensors
    (row_kernel.tables_cached), so the chunks of one backward pass build
    them once."""
    mats = (a_diag, a_left, a_up, closure)
    return row_kernel.tables_cached("counts", mats,
                                    lambda: counts_tables(*mats))


def dense_grads(tables, sums, dtype):
    """The four gradient tensors from the per-entry sums (n_fin,)."""
    S, n_in, n_out = tables.S, tables.n_in, tables.n_out
    flat = torch.zeros(tables.n_mat * S * S, dtype=dtype,
                       device=sums.device)
    flat[tables.pos] = sums.to(dtype)
    n_io = n_in * n_out * S * S
    gd = flat[:n_io].view(n_in, n_out, S, S)
    gl = flat[n_io:n_io + n_in * S * S].view(n_in, S, S)
    gu = flat[n_io + n_in * S * S:-S * S].view(n_out, S, S)
    return gd, gl, gu, flat[-S * S:].view(S, S)


# --------------------------------------------------------------- the plan

STRIP_T = 2          # cells a strip
MAX_WARPS = 16       # a block's warps (the kernel's launch bound)
MIN_WARPS = 4        # fewer with the sums shared, and the plan puts them
                     # in global memory
MAX_ROWS = 32        # rows a unit
UNITS_PER_WARP = 8   # the units a warp takes at least, where R allows
TAB_SHARE = 0.25     # of a block's shared memory the tables may take
SM_SMEM = 233472     # shared bytes an SM holds (228 KB)
BLOCK_RESERVE = 1024  # shared bytes the card reserves a block
SM_WARPS = 64


def _up16(n):
    return (n + 15) & ~15


def counts_smem_bytes(S, T, warps, n_mat, n_fin, tables_shared, acc_shared):
    """A block's shared bytes (the kernel's layout()): an mbarrier a warp;
    a warp's six staging slots (three rows of F, three of Bk) of (T+1) S
    + 8 floats (rounded up to 4 floats); the tables where shared; a warp's
    P_U and P_beta (S floats each, rounded up to 4); where shared, a
    warp's n_fin float32 sums."""
    seg = ((T + 1) * S + 8 + 3) & ~3
    sp = (S + 3) & ~3
    o = _up16(warps * 8) + warps * 6 * seg * _F32
    if tables_shared:
        o += 2 * (n_mat + 1) * 4
        o = (o + 7) & ~7
        o += 2 * n_fin * 8
    o = _up16(o) + warps * 2 * sp * _F32
    return o + (warps * n_fin * _F32 if acc_shared else 0)


def counts_launch_plan(S, n_mat, n_fin, B, Li, Lo, smem_max=SMEM_MAX,
                       sms=SMS, mem_bytes=None, acc=None):
    """The strips kernel's layout for B pairs padded to Li x Lo over S
    states, n_mat matrices and n_fin finite entries. Returns a dict: T
    (cells a strip, STRIP_T), warps (a block's: the most, up to
    MAX_WARPS, whose staging buffers, workspaces, tables and sums fit;
    with the sums in shared memory where that keeps MIN_WARPS warps, else
    in global memory), R (rows a unit: as many as leave each warp the
    card holds at once UNITS_PER_WARP units, 1 to MAX_ROWS), threads,
    units (B ceil((Lo + 1) / R) ceil((Li + 1) / T): a strip of T cells
    over R rows), blocks (enough that every warp has a unit, at most the
    blocks that fit the SMs at once: any batch, one pair too, spreads
    over the card; fewer where global sums would pass ACC_SHARE of
    `mem_bytes`), blocks_per_sm, blocks_per_pair, tables ("shared" where
    the lists take at most TAB_SHARE of a block's shared memory, else
    "global"), acc (each warp's n_fin float32 sums: "shared" or "global",
    as above; `acc="global"` forces it), smem_bytes and mem_bytes (the
    device bytes the call allocates: global sums, the blocks' float64
    partials, the float64 result). Raises ValueError past MAX_STATES,
    where no block fits or where one block's global sums pass
    `mem_bytes` (None: not checked)."""
    if not 1 <= S <= MAX_STATES:
        raise ValueError("expected_counts takes 1 to %d states, not %d"
                         % (MAX_STATES, S))
    if acc not in (None, "global"):
        raise ValueError("acc may be forced to 'global' only")
    t = STRIP_T
    tab_bytes = counts_smem_bytes(S, t, 0, n_mat, n_fin, True, False) \
        - counts_smem_bytes(S, t, 0, n_mat, n_fin, False, False)
    tab_shared = tab_bytes <= TAB_SHARE * smem_max

    def fit(sh):
        """The most warps whose block fits, with the sums shared or not;
        0 where none does."""
        for w in range(MAX_WARPS, 0, -1):
            if counts_smem_bytes(S, t, w, n_mat, n_fin, tab_shared,
                                 sh) <= smem_max:
                return w
        return 0

    w = fit(True) if acc is None else 0
    shared = w >= MIN_WARPS
    if not shared:
        w = fit(False)
    if not w:
        raise ValueError("no block of T=%d fits %d shared bytes at %d "
                         "states" % (t, smem_max, S))
    smem = counts_smem_bytes(S, t, w, n_mat, n_fin, tab_shared, shared)
    per_sm = max(1, min(SM_SMEM // (smem + BLOCK_RESERVE), SM_WARPS // w))
    nstrip = -(-(Li + 1) // t)
    R = max(1, min(MAX_ROWS, B * (Lo + 1) * nstrip
                   // (UNITS_PER_WARP * sms * per_sm * w)))
    units = B * (-(-(Lo + 1) // R)) * nstrip
    blocks = max(1, min(-(-units // w), sms * per_sm))
    per_block = 0 if shared else w * n_fin * _F32
    if per_block and mem_bytes is not None:
        cap = int(mem_bytes * ACC_SHARE) // (per_block + n_fin * _F64)
        if cap < 1:
            raise ValueError(
                "expected_counts needs %d device bytes for one block's "
                "accumulators of %d entries, past %d of the card's %d"
                % (per_block + n_fin * _F64, n_fin,
                   int(mem_bytes * ACC_SHARE), mem_bytes))
        blocks = min(blocks, cap)
    return {"T": t, "R": R, "warps": w, "threads": 32 * w, "units": units,
            "blocks": blocks, "blocks_per_sm": per_sm,
            "blocks_per_pair": blocks / B if B else 0.0,
            "tables": "shared" if tab_shared else "global",
            "acc": "shared" if shared else "global", "smem_bytes": smem,
            "mem_bytes": blocks * (per_block + n_fin * _F64) + n_fin * _F64}


def counts_chunk_plan(S, Li, Lo, B, mem_bytes=None):
    """Pairs a chunk of the E-step's backward takes at B pairs padded to
    Li x Lo over S states: a chunk holds a Forward and a Backward lattice
    a pair (float32), the row kernel's ring of three diagonals a pair
    (where it does not fit shared memory) and the reversed tokens. Returns
    a dict: pairs (all B where `mem_bytes` is None), chunks, pair_bytes,
    mem_bytes (a chunk's). Raises ValueError where one pair does not fit
    `mem_bytes`."""
    lattice = (Lo + 1) * (Li + 1) * S * _F32
    ring = 3 * (Li + 1) * (S + 1) * _F32
    pair = 2 * lattice + ring + 2 * _F64 * (Li + Lo)
    pairs = B
    if mem_bytes is not None:
        if pair > mem_bytes:
            raise ValueError(
                "one pair of %d x %d over %d states needs %d device bytes "
                "for its E-step lattices, past the %d allowed"
                % (Li, Lo, S, pair, mem_bytes))
        pairs = min(B, mem_bytes // pair)
    pairs = max(pairs, 1) if B else 0
    return {"pairs": pairs, "chunks": -(-B // pairs) if B else 0,
            "pair_bytes": pair, "mem_bytes": pairs * pair}


# ------------------------------------------------------------ the kernel

def _check(t, name, shape, dtype, dev):
    if t.device != dev:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, dev))
    if t.dtype != dtype:
        raise TypeError("%s has dtype %s, expected %s"
                        % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))


def _aligned(t):
    """t contiguous at a 16-byte aligned address (the copy engine's)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def expected_counts(F, Br, a_diag, a_left, a_up, closure, in_toks,
                    out_toks, in_lens, out_lens, grad_ll, blocks=None,
                    acc=None):
    """expected_counts_plain's function in one call.

    A CUDA tensor launches csrc/expected_counts.cu once (counts_launch_
    plan's layout on the tables of counts_tables_cached; `blocks` and
    `acc` force the plan's) and counts it in `expected_counts.launches`;
    `expected_counts.last` holds its plan and its tables' build ms (0.0
    when they were kept); a failed launch raises. A CPU tensor takes the
    plain version."""
    dev = F.device
    if dev.type == "cpu":
        return expected_counts_plain(F, Br, a_diag, a_left, a_up, closure,
                                     in_toks, out_toks, in_lens, out_lens,
                                     grad_ll)
    if dev.type != "cuda":
        raise ValueError("expected_counts runs on cuda or cpu tensors, "
                         "not %s" % dev)
    out, cfg, tables, built = _launch(
        F, Br, a_diag, a_left, a_up, closure, in_toks, out_toks, in_lens,
        out_lens, grad_ll, blocks, acc, None)
    expected_counts.launches += 1
    expected_counts.last = {"plan": cfg, "n_fin": tables.n_fin,
                            "prep_ms": tables.prep_ms if built else 0.0}
    return _unpad(dense_grads(tables, out, torch.float32),
                  a_left.shape[0], a_up.shape[0])


expected_counts.launches = 0
expected_counts.last = None


def expected_counts_profile(F, Br, a_diag, a_left, a_up, closure, in_toks,
                            out_toks, in_lens, out_lens, grad_ll):
    """expected_counts through the profile library (the source built with
    -DPHASE_PROFILE), on a card, uncounted: (plan, prof) with prof
    (warps of the grid, len(PROFILE_SLOTS)) int64, each warp's units and
    cells and its clock64 cycles a phase (csrc/expected_counts.cu)."""
    box = []
    _, cfg, _, _ = _launch(F, Br, a_diag, a_left, a_up, closure, in_toks,
                           out_toks, in_lens, out_lens, grad_ll, None, None,
                           box)
    torch.cuda.synchronize(F.device)
    return cfg, box[0]


PROFILE_SLOTS = ("units", "cells", "lists", "lattice", "emitting", "logs",
                 "closure", "reduce")


def _launch(F, Br, a_diag, a_left, a_up, closure, in_toks, out_toks,
            in_lens, out_lens, grad_ll, blocks, acc, prof):
    """expected_counts' CUDA call: (out (n_fin,) float64, plan, tables,
    built). prof a list: through the profile library, its counters
    appended."""
    dev = F.device
    mats = row_kernel.nonempty(a_diag, a_left, a_up) + (closure,)
    B, Lo1, Li1, S = F.shape
    n_in, n_out = mats[1].shape[0], mats[2].shape[0]
    f32 = torch.float32
    _check(F, "F", (B, Lo1, Li1, S), f32, dev)
    _check(Br, "Br", (B, Lo1, Li1, S), f32, dev)
    for m, name, shape in zip(mats, ("a_diag", "a_left", "a_up", "closure"),
                              ((n_in, n_out, S, S), (n_in, S, S),
                               (n_out, S, S), (S, S))):
        _check(m, name, shape, f32, dev)
    it = row_kernel._as_int32(in_toks, dev).reshape(B, Li1 - 1)
    ot = row_kernel._as_int32(out_toks, dev).reshape(B, Lo1 - 1)
    il = row_kernel._as_int32(in_lens, dev).reshape(B)
    ol = row_kernel._as_int32(out_lens, dev).reshape(B)
    g = torch.as_tensor(grad_ll, device=dev).to(f32).reshape(B) \
        .contiguous()
    F, Br = _aligned(F), _aligned(Br)
    tabs, built = counts_tables_cached(*mats)
    props = torch.cuda.get_device_properties(dev)
    cfg = counts_launch_plan(S, tabs.n_mat, tabs.n_fin, B, Li1 - 1, Lo1 - 1,
                             sms=props.multi_processor_count,
                             mem_bytes=props.total_memory, acc=acc)
    if blocks is not None:
        cfg = dict(cfg, blocks=blocks)
    nb, nw = cfg["blocks"], cfg["warps"]
    acc_g = None if cfg["acc"] == "shared" else torch.empty(
        (max(nb, 0), nw, tabs.n_fin), dtype=f32, device=dev)
    partial = torch.empty((max(nb, 0), tabs.n_fin), dtype=torch.float64,
                          device=dev)
    out = torch.zeros((tabs.n_fin,), dtype=torch.float64, device=dev)
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    pr = None
    if prof is not None:
        pr = torch.zeros((max(nb, 0) * nw, len(PROFILE_SLOTS)),
                         dtype=torch.int64, device=dev)
        prof.append(pr)
    lib = load("expected_counts" if prof is None
               else "expected_counts_profile")
    fn = lib.expected_counts_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 16 + [I] * 15 + [P]
    fn.restype = I
    rc = fn(tabs.off_f.data_ptr(), tabs.ent_f.data_ptr(),
            tabs.off_t.data_ptr(), tabs.ent_t.data_ptr(), F.data_ptr(),
            Br.data_ptr(), it.data_ptr(), ot.data_ptr(), il.data_ptr(),
            ol.data_ptr(), g.data_ptr(),
            None if acc_g is None else acc_g.data_ptr(), partial.data_ptr(),
            out.data_ptr(), ticket.data_ptr(),
            None if pr is None else pr.data_ptr(), B, Li1 - 1, Lo1 - 1, S,
            n_in, n_out, tabs.n_mat, tabs.n_fin, int(tabs.cdiag), cfg["T"],
            cfg["R"], nw, nb, int(cfg["tables"] == "shared"),
            int(cfg["acc"] == "shared"),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("expected_counts launch failed: CUDA error %d"
                           % rc)
    return out, cfg, tabs, built


def counts_smem_bytes_on_card(S, T, warps, n_mat, n_fin, tables_shared,
                              acc_shared):
    """The strips kernel's own count of a block's shared bytes."""
    fn = load("expected_counts").expected_counts_smem_bytes
    fn.restype = ctypes.c_longlong
    return int(fn(*(ctypes.c_int(int(v)) for v in (
        S, T, warps, n_mat, n_fin, tables_shared, acc_shared))))


# -------------------------------------------------------------- CPU twin

def _padded_lists(off, ent, n_mat):
    """(key, val, count) of each matrix's compact list, each (n_mat, E)
    but count (n_mat,), E the longest list rounded up to 32 (at least 32):
    key 0 and val 0 past a list's end."""
    off = off.long()
    cnt = off[1:] - off[:-1]
    E = max(32, -(-int(cnt.max()) // 32) * 32) if n_mat else 32
    r = torch.arange(E, device=ent.device)
    ok = r < cnt[:, None]
    idx = torch.where(ok, off[:-1, None] + r, 0)
    key = torch.where(ok, ent[idx, 0].long(), 0)
    val = torch.where(ok, ent[:, 1].contiguous().view(torch.float32)[idx],
                      0.0)
    return key, val, cnt


def run_sums(terms, keys):
    """The kernel's shuffle tree over lists of terms: terms (N, E) and
    their keys (N, E), E a multiple of 32 in groups of 32 lanes; lane l
    takes lane l + d's partial for d = 1, 2, 4, 8, 16 while l + d is
    within its run (the steps past a group's longest run add nothing), so
    a run's first lane holds its sum. Returns (sums, heads, states), each
    (N, E // 32, 32); keys 0 (past a list) head nothing."""
    N, E = terms.shape
    t = terms.reshape(N, E // 32, 32)
    k = keys.reshape(N, E // 32, 32)
    tail = (k >> 10) & 31
    lane = torch.arange(32, device=terms.device)
    for d in (1, 2, 4, 8, 16):
        v = torch.cat([t[..., d:], torch.zeros_like(t[..., :d])], -1)
        t = t + torch.where(lane + d <= tail, v, torch.zeros_like(v))
    return t, ((k >> 15) & 1) == 1, (k & 0x3ff).long()


def add_runs(P, runs):
    """Adds a list's run sums (run_sums' triple) into P (N, S) in the
    kernel's order, group by group: each group's runs hold distinct
    states."""
    t, head, state = runs
    for r in range(t.shape[1]):
        P.scatter_add_(1, state[:, r], torch.where(
            head[:, r], t[:, r], torch.zeros_like(t[:, r])))
    return P



def expected_counts_twin(tables, F, Br, in_toks, out_toks, in_lens,
                         out_lens, grad_ll, plan=None):
    """The strips kernel's arithmetic in plain PyTorch on `tables`, every
    live cell at once, in F's dtype (tests only): returns
    the per-entry sums (n_fin,) float64. Each cell's incoming terms
    exp((F_nb(k) + A[k, j]) + (Bk(j) - LL)) over its neighbours' compact
    lists (up, diag, left), their runs summed by run_sums into P_U(j) list
    by list, group by group, as the kernel adds them (add_runs; P_U(0) =
    exp(Bk(0) - LL) at the start cell); the outgoing terms
    exp((Bk_next(u) + A[t, u]) + (F(t) - LL)) over the transposed lists
    into P_beta(t), then exp(F(S-1) - LL) at the end cell; the closure
    terms exp((log P_U(s) - Bk(s) + C[s, t]) + (log P_beta(t) - F(t) +
    LL)). The reduction in the kernel's order of units: a cell's unit
    (b, o // R, i // T) is u, taken by warp u mod (blocks warps) of
    `plan` (counts_launch_plan's for these shapes by default); each warp's
    float32 sums, a block's over its warps in warp order in float64, the
    blocks' in block order."""
    S, n_in, n_out = tables.S, tables.n_in, tables.n_out
    n_mat, n_fin = tables.n_mat, tables.n_fin
    dev, dt = F.device, F.dtype
    B, Lo1, Li1, _ = F.shape
    if plan is None:
        plan = counts_launch_plan(S, n_mat, n_fin, B, Li1 - 1, Lo1 - 1)
    T, R, W, nb = plan["T"], plan["R"], plan["warps"], plan["blocks"]
    key_f, val_f, cnt_f = _padded_lists(tables.off_f, tables.ent_f, n_mat)
    key_t, val_t, cnt_t = _padded_lists(tables.off_t, tables.ent_t, n_mat)
    off_f = tables.off_f.long()
    it, ot, il, ol, LL, g, live = _pairs(F, in_toks, out_toks, in_lens,
                                         out_lens, grad_ll, n_in, n_out)
    ii = torch.arange(Li1, device=dev)
    oo = torch.arange(Lo1, device=dev)
    cell = live[:, None, None] & (oo[None, :, None] <= ol[:, None, None]) \
        & (ii[None, None, :] <= il[:, None, None])
    b, o, i = torch.nonzero(cell, as_tuple=True)
    N = len(b)
    out = torch.zeros(n_fin, dtype=torch.float64, device=dev)
    if N == 0:
        return out
    nstrip, nchunk = -(-Li1 // T), -(-Lo1 // R)
    warp = ((b * nchunk + o // R) * nstrip + i // T) % (W * nb)
    sums = torch.zeros((W * nb, n_fin), dtype=torch.float32, device=dev)
    n_io = n_in * n_out
    ll, gb = LL[b], g[b]
    x = torch.where(i > 0, it[b, (i - 1).clamp(min=0)], 0)
    y = torch.where(o > 0, ot[b, (o - 1).clamp(min=0)], 0)
    inner_i, inner_o = i < il[b], o < ol[b]
    x1 = torch.where(inner_i, it[b, i.clamp(max=Li1 - 2)] if Li1 > 1
                     else torch.zeros_like(i), 0)
    y1 = torch.where(inner_o, ot[b, o.clamp(max=Lo1 - 2)] if Lo1 > 1
                     else torch.zeros_like(o), 0)

    def vec(lat, oc, ic):          # (N, S): a cell's values
        return lat[b, oc.clamp(0, Lo1 - 1), ic.clamp(0, Li1 - 1)]

    def bk(oc, ic):                # Bk(ic, oc) = Br(ol - oc, il - ic)
        return vec(Br, ol[b] - oc, il[b] - ic)

    def terms(keys, vals, cnt, m, nb_vec, here, present):
        """(N, E) terms exp((nb[other] + v) + (here[state] - LL)) of
        matrix m (N,) per cell, 0 where absent or past the list."""
        k, v = keys[m], vals[m].to(dt)
        ok = present[:, None] & (torch.arange(k.shape[1], device=dev)
                                 < cnt[m][:, None])
        t = torch.exp((torch.gather(nb_vec, 1, (k >> 16) & 0x3ff) + v)
                      + (torch.gather(here, 1, k & 0x3ff) - ll[:, None]))
        t = torch.where(ok, t, torch.zeros_like(t))
        return t, torch.where(ok, k, torch.zeros_like(k)), ok

    Fc, Bc = vec(F, o, i), bk(o, i)
    start = (o == 0) & (i == 0)
    P_U = torch.zeros((N, S), dtype=dt, device=dev)
    P_U[:, 0] = torch.where(start, torch.exp(Bc[:, 0] - ll), 0.0)
    for m, on, inn, present in (
            (n_io + n_in + y, o - 1, i, o > 0),
            (x * n_out + y, o - 1, i - 1, (o > 0) & (i > 0)),
            (n_io + x, o, i - 1, i > 0)):
        t, k, ok = terms(key_f, val_f, cnt_f, m, vec(F, on, inn), Bc,
                         present)
        add_runs(P_U, run_sums(t, k))
        e = off_f[m][:, None] + torch.arange(t.shape[1], device=dev)
        rows = warp[:, None].expand_as(e)
        sums.index_put_((rows[ok], e[ok]), (gb[:, None] * t)[ok].float(),
                        accumulate=True)
    P_b = torch.zeros((N, S), dtype=dt, device=dev)
    for m, on, inn, present in (
            (n_io + n_in + y1, o + 1, i, inner_o),
            (x1 * n_out + y1, o + 1, i + 1, inner_o & inner_i),
            (n_io + x1, o, i + 1, inner_i)):
        t, k, _ = terms(key_t, val_t, cnt_t, m, bk(on, inn), Fc, present)
        add_runs(P_b, run_sums(t, k))
    end = (o == ol[b]) & (i == il[b])
    P_b[:, S - 1] += torch.where(end, torch.exp(Fc[:, S - 1] - ll), 0.0)
    ninf = torch.tensor(float("-inf"), dtype=dt, device=dev)
    lu = torch.where(P_U > 0, torch.log(P_U) - Bc, ninf)       # (N, S)
    lb = torch.where(P_b > 0, (torch.log(P_b) - Fc) + ll[:, None], ninf)
    m_cl = n_mat - 1
    k, v = key_f[m_cl], val_f[m_cl].to(dt)
    ok = torch.arange(k.shape[0], device=dev) < cnt_f[m_cl]
    t = torch.exp((lu[:, (k >> 16) & 0x3ff] + v) + lb[:, k & 0x3ff])
    t = torch.where(ok, t, torch.zeros_like(t)) * gb[:, None]
    e = off_f[m_cl] + torch.arange(k.shape[0], device=dev)
    sums.index_put_((warp[:, None].expand(N, int(ok.sum())),
                     e[ok].expand(N, -1)), t[:, ok].float(),
                    accumulate=True)
    blk = sums.view(nb, W, n_fin).double()
    for q in range(nb):
        part = torch.zeros(n_fin, dtype=torch.float64, device=dev)
        for w in range(W):
            part = part + blk[q, w]
        out = out + part
    return out


# ---------------------------------------------------- the autograd Function

def estep_backward(a_diag, a_left, a_up, closure, in_toks, out_toks,
                   in_lens, out_lens, lls, grad_lls, mem_bytes=None):
    """The four gradients of sum_b grad_lls[b] lls[b] (RowLoglike's
    backward) for detached matrices: the live pairs (grad != 0, ll >
    NEG_INF / 2) in chunks of counts_chunk_plan (mem_bytes None: the
    card's free memory, on the CPU one chunk), each trimmed to its longest
    pair, through one Forward lattice, one Backward lattice and one
    expected_counts call. `estep_backward.last` records the live pairs,
    the chunks and, on a card, the tables' build ms."""
    mats = (a_diag, a_left, a_up, closure)
    dev = closure.device
    grads = [torch.zeros_like(m) for m in mats]
    live = torch.nonzero((grad_lls != 0) & (lls > NEG_INF / 2))[:, 0]
    n = len(live)
    record = {"pairs": n, "chunks": 0, "pairs_per_chunk": 0,
              "tables_ms": 0.0}
    estep_backward.last = record
    if n == 0:
        return grads
    il = torch.as_tensor(in_lens, device=dev).long()[live]
    ol = torch.as_tensor(out_lens, device=dev).long()[live]
    if mem_bytes is None and dev.type == "cuda":
        mem_bytes = free_bytes(dev)
    plan = counts_chunk_plan(closure.shape[-1], int(il.max()),
                             int(ol.max()), n, mem_bytes)
    record.update(chunks=plan["chunks"], pairs_per_chunk=plan["pairs"])
    step = plan["pairs"]
    for k0 in range(0, n, step):
        idx = live[k0:k0 + step]
        ilc, olc = il[k0:k0 + step], ol[k0:k0 + step]
        Li, Lo = int(ilc.max()), int(olc.max())
        it = in_toks[idx, :Li]
        ot = out_toks[idx, :Lo]
        F = row_kernel.row_scan(*mats, it, ot, LOGSUMEXP)
        record["tables_ms"] += _prep_ms(row_kernel.row_scan, dev)
        Br = backward_lattices(*mats, it, ot, ilc, olc)
        record["tables_ms"] += _prep_ms(row_kernel.row_scan, dev)
        got = expected_counts(F, Br, *mats, it, ot, ilc, olc,
                              grad_lls[idx])
        record["tables_ms"] += _prep_ms(expected_counts, dev)
        del F, Br
        for acc, x in zip(grads, got):
            acc += x
    return grads


estep_backward.last = None


def _prep_ms(wrapper, dev):
    """The tables' build ms of the wrapper's last launch (a card call
    sets `last`; the CPU's plain versions build none)."""
    return wrapper.last["prep_ms"] if dev.type == "cuda" else 0.0


class RowLoglike(torch.autograd.Function):
    """lls (B,) of a padded batch through the row engine, differentiable
    in the four log-space matrices: forward is row_scan's score mode (one
    launch on the card), keeping the matrices, tokens, lengths and lls
    and no lattice (`RowLoglike.last`: its tables' build ms on a card);
    backward is estep_backward."""

    last = None

    @staticmethod
    def forward(ctx, a_diag, a_left, a_up, closure, in_toks, out_toks,
                in_lens, out_lens):
        mats = [m.detach() for m in (a_diag, a_left, a_up, closure)]
        lls = row_kernel.row_scan(*mats, in_toks, out_toks, LOGSUMEXP,
                                  lens=(in_lens, out_lens))
        RowLoglike.last = {"tables_ms": _prep_ms(row_kernel.row_scan,
                                                 lls.device)}
        ctx.save_for_backward(a_diag, a_left, a_up, closure, in_toks,
                              out_toks, in_lens, out_lens, lls)
        return lls

    @staticmethod
    def backward(ctx, grad_lls):
        a_diag, a_left, a_up, closure, it, ot, il, ol, lls = \
            ctx.saved_tensors
        mats = [m.detach() for m in (a_diag, a_left, a_up, closure)]
        grads = estep_backward(*mats, it, ot, il, ol, lls,
                               grad_lls.detach())
        return (*grads, None, None, None, None)
