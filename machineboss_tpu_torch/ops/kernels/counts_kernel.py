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
  plain versions on the CPU) for float32 and 1..512 states, the row
  kernel's range; "wavefront" (autograd through ops/wavefront_fast.py)
  for anything else.
* `RowLoglike`, a torch.autograd.Function: forward is the row kernel's
  score mode on the batch (one launch, no lattice kept); backward works in
  chunks of pairs (`counts_chunk_plan`, against the card's memory): a
  Forward lattice (one row_scan launch), the Backward lattices of the
  pairs' reversed prefixes (one launch, `backward_lattices`) and
  `expected_counts` (one launch).
* `expected_counts`, the counted wrapper of csrc/expected_counts.cu: a CUDA
  tensor launches the kernel once (or raises), a CPU tensor takes
  `expected_counts_plain`, the same function vectorised over a row.
* `counts_tables` (the kernel's finite-entry lists, each entry with its
  index among the finite entries), `counts_launch_plan` (blocks, where the
  per-warp accumulators live) and `expected_counts_twin` (the kernel's
  arithmetic in plain PyTorch on those tables: tests and chip_smoke only).

The Backward lattices are passed as the row kernel writes them on each
pair's reversed prefix (`Br`): Bk_b(i, o) = Br[b, ol_b - o, il_b - i] for
i <= il_b, o <= ol_b, which saves the card a flipped copy of a lattice.
"""

import ctypes
import time
from dataclasses import dataclass

import torch

from ..semiring import LOGSUMEXP, NEG_INF
from . import row_kernel
from ._build import load

THREADS = 512
WARPS = THREADS // 32
SMEM_MAX = row_kernel.SMEM_MAX - 64   # dynamic bytes: the ticket's flag
                                      # is static shared memory
MAX_STATES = row_kernel.MAX_STATES
SMS = row_kernel.SMS
_F32 = 4
_F64 = 8
ACC_SHARE = 0.5      # of the card's memory the global accumulators may take


def estep_route(dtype, S):
    """The E-step's route for a model of S states in `dtype`: "rows"
    where the row kernel takes it (float32, 1 to MAX_STATES states; on
    the CPU the same functions' plain versions), else "wavefront"
    (autograd through the batched scaled wavefront, any dtype and S)."""
    if dtype == torch.float32 and 1 <= S <= MAX_STATES:
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
    closure). hdr_f (n_mat * nsl, 2) int32: a (matrix, slice of 32
    destination columns) header, (offset into ent_f, rows); ent_f (n, 4)
    int32: a slice's (rows + 1) x 32 entries, its first row the lanes'
    finite counts, then row t the lanes' t-th (source, raw log value bits,
    index among the finite entries, 0) in ascending source order. hdr_t,
    ent_t: the same lists of the transposed matrices (a row's finite
    destinations; index -1). pos (n_fin,): each finite entry's flat
    position in (n_mat, S, S). prep_ms: the build's host clock,
    synchronised on a card."""
    S: int
    n_in: int
    n_out: int
    hdr_f: torch.Tensor
    ent_f: torch.Tensor
    hdr_t: torch.Tensor
    ent_t: torch.Tensor
    pos: torch.Tensor
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
                   (self.hdr_f, self.ent_f, self.hdr_t, self.ent_t))


def _column_lists(M, fin, index):
    """(hdr, ent) of M (n_mat, S, S): each column's finite sources in ELL
    slices of 32 columns, with `index` (n_mat, S, S) int32 or None."""
    n_mat, S, _ = M.shape
    dev = M.device
    nsl = -(-S // 32)
    cnt = torch.zeros((n_mat, nsl * 32), dtype=torch.int64, device=dev)
    cnt[:, :S] = fin.sum(1)
    rows = cnt.view(n_mat, nsl, 32).amax(-1)               # (n_mat, nsl)
    size = torch.where(rows > 0, (rows + 1) * 32, 0).reshape(-1)
    off = torch.cumsum(size, 0) - size
    ent = torch.zeros((int(size.sum()), 4), dtype=torch.int32, device=dev)
    off2 = off.view(n_mat, nsl)
    hm, hr = torch.nonzero(rows > 0, as_tuple=True)
    lanes = torch.arange(32, device=dev)
    j = hr[:, None] * 32 + lanes                            # (n, 32)
    ent[(off2[hm, hr][:, None] + lanes).reshape(-1), 0] = \
        cnt[hm[:, None].expand_as(j), j].reshape(-1).to(torch.int32)
    mm, kk, jj = torch.nonzero(fin, as_tuple=True)
    rank = (torch.cumsum(fin, 1) - 1)[mm, kk, jj]
    p = off2[mm, jj // 32] + (1 + rank) * 32 + jj % 32
    ent[p, 0] = kk.to(torch.int32)
    ent[p, 1] = M[mm, kk, jj].to(torch.float32).contiguous() \
        .view(torch.int32)
    ent[p, 2] = -1 if index is None else index[mm, kk, jj]
    hdr = torch.stack([off, rows.reshape(-1)], -1).to(torch.int32)
    return hdr.contiguous(), ent


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
    mm, kk, jj = torch.nonzero(fin, as_tuple=True)
    index = torch.full(M.shape, -1, dtype=torch.int32, device=dev)
    index[mm, kk, jj] = torch.arange(len(mm), dtype=torch.int32, device=dev)
    hdr_f, ent_f = _column_lists(M, fin, index)
    hdr_t, ent_t = _column_lists(M.transpose(1, 2), fin.transpose(1, 2),
                                 None)
    row_kernel._sync(dev)
    return CountsTables(S=S, n_in=a_left.shape[0], n_out=a_up.shape[0],
                        hdr_f=hdr_f, ent_f=ent_f, hdr_t=hdr_t, ent_t=ent_t,
                        pos=(mm * S + kk) * S + jj,
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

def counts_smem_bytes(S, n_fin, acc_shared):
    """A block's shared bytes (the kernel's smem_bytes): the warps'
    workspaces (two vectors of S floats) and, where shared, the warps'
    accumulators (n_fin floats each)."""
    return WARPS * (2 * S + (n_fin if acc_shared else 0)) * _F32


def counts_launch_plan(S, n_fin, B, smem_max=SMEM_MAX, sms=SMS,
                       mem_bytes=None, acc=None):
    """The kernel's layout for B pairs over S states and n_fin finite
    entries. Returns a dict: threads; blocks (a block takes pairs b, b +
    blocks, ...: min(B, sms), fewer where global accumulators would pass
    ACC_SHARE of `mem_bytes`); acc, where each warp's n_fin float32 sums
    live: "shared" where the 16 warps' fit a block's shared memory beside
    their workspaces, else "global" (`acc` "global" forces it, for tests);
    smem_bytes; mem_bytes (the device bytes the call allocates: global
    accumulators, the blocks' float64 partial sums, the float64 result).
    Raises ValueError past MAX_STATES or where one block's accumulators
    pass `mem_bytes` (None: not checked)."""
    if not 1 <= S <= MAX_STATES:
        raise ValueError("expected_counts takes 1 to %d states, not %d"
                         % (MAX_STATES, S))
    if acc not in (None, "global"):
        raise ValueError("acc may be forced to 'global' only")
    shared = acc is None and counts_smem_bytes(S, n_fin, True) <= smem_max
    blocks = max(1, min(B, sms))
    per_block = 0 if shared else WARPS * n_fin * _F32
    if per_block and mem_bytes is not None:
        fit = int(mem_bytes * ACC_SHARE) // per_block
        if fit < 1:
            raise ValueError(
                "expected_counts needs %d device bytes for one block's "
                "accumulators of %d entries, past %d of the card's %d"
                % (per_block, n_fin, int(mem_bytes * ACC_SHARE), mem_bytes))
        blocks = min(blocks, fit)
    mem = blocks * (per_block + n_fin * _F64) + n_fin * _F64
    return {"threads": THREADS, "blocks": blocks,
            "acc": "shared" if shared else "global",
            "smem_bytes": counts_smem_bytes(S, n_fin, shared),
            "mem_bytes": mem}


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
    n_in0, n_out0 = a_left.shape[0], a_up.shape[0]
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
    F, Br = F.contiguous(), Br.contiguous()
    tables, built = counts_tables_cached(*mats)
    props = torch.cuda.get_device_properties(dev)
    cfg = counts_launch_plan(S, tables.n_fin, B,
                             sms=props.multi_processor_count,
                             mem_bytes=props.total_memory, acc=acc)
    if blocks is not None:
        cfg = dict(cfg, blocks=blocks)
    nb = cfg["blocks"]
    acc_g = None if cfg["acc"] == "shared" else torch.empty(
        (max(nb, 0), WARPS, tables.n_fin), dtype=f32, device=dev)
    partial = torch.empty((max(nb, 0), tables.n_fin), dtype=torch.float64,
                          device=dev)
    out = torch.zeros((tables.n_fin,), dtype=torch.float64, device=dev)
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    fn = load("expected_counts").expected_counts_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 15 + [I] * 9 + [P]
    fn.restype = I
    rc = fn(tables.hdr_f.data_ptr(), tables.ent_f.data_ptr(),
            tables.hdr_t.data_ptr(), tables.ent_t.data_ptr(), F.data_ptr(),
            Br.data_ptr(), it.data_ptr(), ot.data_ptr(), il.data_ptr(),
            ol.data_ptr(), g.data_ptr(),
            None if acc_g is None else acc_g.data_ptr(), partial.data_ptr(),
            out.data_ptr(), ticket.data_ptr(), B, Li1 - 1, Lo1 - 1, S, n_in,
            n_out, tables.n_fin, nb, int(cfg["acc"] == "shared"),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("expected_counts launch failed: CUDA error %d"
                           % rc)
    expected_counts.launches += 1
    expected_counts.last = {"plan": cfg, "n_fin": tables.n_fin,
                            "prep_ms": tables.prep_ms if built else 0.0}
    return _unpad(dense_grads(tables, out, f32), n_in0, n_out0)


expected_counts.launches = 0
expected_counts.last = None


def counts_smem_bytes_on_card(S, n_fin, acc_shared):
    """The kernel's own count of a block's shared bytes."""
    return int(load("expected_counts").expected_counts_smem_bytes(
        ctypes.c_int(S), ctypes.c_int(n_fin), ctypes.c_int(int(acc_shared))))


# -------------------------------------------------------------- CPU twin

def _lists_back(hdr, ent, n_mat, S):
    """(src, val, index, count) of the lists, each (n_mat, SP, R) but
    count (n_mat, SP), SP = 32 nsl columns, R the longest list (>= 1)."""
    nsl = -(-S // 32)
    h = hdr.long().view(n_mat, nsl, 2)
    off, rows = h[..., 0], h[..., 1]
    R = max(int(rows.max()), 1) if rows.numel() else 1
    pad = torch.tensor([[0, 0, -1, 0]], dtype=torch.int32, device=ent.device)
    ent = torch.cat([ent, pad])
    none = ent.shape[0] - 1
    t = torch.arange(R + 1, device=ent.device)
    lanes = torch.arange(32, device=ent.device)
    p = off[..., None, None] + t[:, None] * 32 + lanes       # (m, r, R+1, 32)
    ok = (t[:, None] <= rows[..., None, None]) & (rows[..., None, None] > 0)
    got = ent[torch.where(ok, p, none)]
    got = got.permute(0, 1, 3, 2, 4).reshape(n_mat, nsl * 32, R + 1, 4)
    count = got[:, :, 0, 0].long()
    body = got[:, :, 1:]
    return (body[..., 0].long(), body[..., 1].contiguous()
            .view(torch.float32), body[..., 2].long(), count)


def expected_counts_twin(tables, F, Br, in_toks, out_toks, in_lens,
                         out_lens, grad_ll):
    """The kernel's arithmetic in plain PyTorch on `tables`, every live
    cell at once, in F's dtype: returns the per-entry sums (n_fin,). For
    each cell (i, o) of a live pair and each column j, the incoming terms
    exp((F_nb(k) + A[k, j]) + (Bk(j) - LL)) over its neighbours' lists
    (each a count of its entry; their sum P_U(j)); for each row t, the
    outgoing sum P_beta(t) of exp((Bk_next(u) + A[t, u]) + (F(t) - LL))
    over the transposed lists, plus 1 at the end cell's S-1; then the
    closure terms exp((log P_U(j) - Bk(j) + C[j, t]) + (log P_beta(t) -
    F(t) + LL)), which is exp(U(j) + C[j, t] + beta(t) - LL)."""
    S, n_in, n_out = tables.S, tables.n_in, tables.n_out
    n_mat = tables.n_mat
    dev, dt = F.device, F.dtype
    src_f, val_f, idx_f, cnt_f = _lists_back(tables.hdr_f, tables.ent_f,
                                             n_mat, S)
    src_t, val_t, _, cnt_t = _lists_back(tables.hdr_t, tables.ent_t,
                                         n_mat, S)
    R_f, R_t = src_f.shape[-1], src_t.shape[-1]
    it, ot, il, ol, LL, g, live = _pairs(F, in_toks, out_toks, in_lens,
                                         out_lens, grad_ll, n_in, n_out)
    _, Lo1, Li1, _ = F.shape
    # every live cell
    ii = torch.arange(Li1, device=dev)
    oo = torch.arange(Lo1, device=dev)
    cell = live[:, None, None] & (oo[None, :, None] <= ol[:, None, None]) \
        & (ii[None, None, :] <= il[:, None, None])
    b, o, i = torch.nonzero(cell, as_tuple=True)
    N = len(b)
    out = torch.zeros(tables.n_fin, dtype=torch.float64, device=dev)
    if N == 0:
        return out
    n_io = n_in * n_out
    ll, gb = LL[b], g[b]
    x = torch.where(i > 0, it[b, (i - 1).clamp(min=0)], 0)
    y = torch.where(o > 0, ot[b, (o - 1).clamp(min=0)], 0)
    inner_i, inner_o = i < il[b], o < ol[b]
    x1 = torch.where(inner_i, it[b, i.clamp(max=Li1 - 2)] if Li1 > 1
                     else torch.zeros_like(i), 0)
    y1 = torch.where(inner_o, ot[b, o.clamp(max=Lo1 - 2)] if Lo1 > 1
                     else torch.zeros_like(o), 0)
    SP = src_f.shape[1]

    def vec(lat, oc, ic):          # (N, SP): a cell's S values, padded
        v = lat[b, oc.clamp(0, Lo1 - 1), ic.clamp(0, Li1 - 1)]
        return torch.cat([v, torch.full((N, SP - S), NEG_INF, dtype=dt,
                                        device=dev)], 1)

    def bk(oc, ic):                # Bk(ic, oc) = Br(ol - oc, il - ic)
        return vec(Br, ol[b] - oc, il[b] - ic)

    Fc, Bc = vec(F, o, i), bk(o, i)
    r = torch.arange(R_f, device=dev)
    P_U = torch.zeros((N, SP), dtype=dt, device=dev)
    start = (o == 0) & (i == 0)
    P_U[:, 0] = torch.where(start, torch.exp(Bc[:, 0] - ll), 0.0)
    for m, on, inn, present in (
            (n_io + n_in + y, o - 1, i, o > 0),
            (x * n_out + y, o - 1, i - 1, (o > 0) & (i > 0)),
            (n_io + x, o, i - 1, i > 0)):
        k, v, e = src_f[m], val_f[m].to(dt), idx_f[m]         # (N, SP, R)
        ok = present[:, None, None] & (r < cnt_f[m][..., None])
        src = vec(F, on, inn)
        t = torch.exp(torch.gather(src, 1, k.reshape(N, -1)).view(k.shape)
                      + v + (Bc - ll[:, None])[..., None])
        t = torch.where(ok, t, torch.zeros_like(t))
        P_U = P_U + t.sum(-1)
        out.index_add_(0, e[ok], (gb[:, None, None] * t)[ok].double())
    r = torch.arange(R_t, device=dev)
    P_b = torch.zeros((N, SP), dtype=dt, device=dev)
    for m, on, inn, present in (
            (n_io + n_in + y1, o + 1, i, inner_o),
            (x1 * n_out + y1, o + 1, i + 1, inner_o & inner_i),
            (n_io + x1, o, i + 1, inner_i)):
        k, v = src_t[m], val_t[m].to(dt)
        ok = present[:, None, None] & (r < cnt_t[m][..., None])
        nxt = bk(on, inn)
        t = torch.exp(torch.gather(nxt, 1, k.reshape(N, -1)).view(k.shape)
                      + v + (Fc - ll[:, None])[..., None])
        P_b = P_b + torch.where(ok, t, torch.zeros_like(t)).sum(-1)
    end = (o == ol[b]) & (i == il[b])
    P_b[:, S - 1] += torch.where(end, torch.exp(Fc[:, S - 1] - ll), 0.0)
    ninf = torch.tensor(float("-inf"), dtype=dt, device=dev)
    lu = torch.where(P_U > 0, torch.log(P_U) - Bc, ninf)     # (N, SP)
    lb = torch.where(P_b > 0, torch.log(P_b) - Fc, ninf)
    m_cl = n_mat - 1
    k, v, e = src_f[m_cl], val_f[m_cl].to(dt), idx_f[m_cl]     # (SP, R)
    ok = torch.arange(R_f, device=dev) < cnt_f[m_cl][:, None]
    t = torch.exp((lu[:, k] + v) + (lb + ll[:, None])[..., None])
    t = torch.where(ok, t, torch.zeros_like(t))
    out.index_add_(0, e[ok].reshape(-1).repeat(N),
                   (gb[:, None, None] * t)[:, ok].reshape(-1).double())
    return out


# ---------------------------------------------------- the autograd Function

def _free_bytes(dev):
    """Device bytes the chunks may take: the CUDA runtime's free memory and
    what the caching allocator holds unused, less a tenth."""
    free, _ = torch.cuda.mem_get_info(dev)
    held = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(0.9 * (free + held))


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
        mem_bytes = _free_bytes(dev)
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
