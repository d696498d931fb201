"""The row engine of the pairwise DP as one CUDA kernel.

Counterpart of the jitted row scans of machineboss_tpu's ops/dp2d.py
(forward_2d, forward_2d_lattice, backward_2d_lattice and
forward_2d_banded: an outer lax.scan over output rows around an inner
lax.scan over input positions, compiled by XLA into one program, no
pallas_call). `row_scan` is the counted wrapper of csrc/row_scan.cu: a CUDA
tensor launches the kernel once for the whole call or raises; a CPU tensor
takes the plain version, ops/dp2d.py's eager loop (forward_2d_plain,
forward_2d_lattice_plain, forward_2d_banded_plain).

The kernel walks each pair by anti-diagonals on prepared operands
(`row_tables`: every matrix column's sources with a finite entry, with
their prepared values, sr.prepare's exp(M - colmax) for logsumexp and M
itself for max-plus, and the column shifts), built once per set of operand
tensors and kept (`row_tables_cached`). `row_scan_diagonal` is the same
walk in plain PyTorch on the same tables, in the kernel's stage order: the
tests and chip_smoke hold it to the plain versions and the kernel to it;
nothing on the main path calls it.

The kernel's layout comes from `row_launch_plan`, a pure function of the
shape: the cluster of blocks a pair, the cells a block holds of a
diagonal, where the ring of the last three diagonals lives ("shared" or
"global") and whether the lists are staged in shared memory, with the
shared and device bytes; it refuses only what the card's memory cannot
hold.

The row engine's gradient is counts_kernel.RowLoglike's (row_scan states
the rule): the kernels serve the logsumexp score's; the other calls
differentiate their plain versions on the CPU and raise on a card. A
machine
with an empty input or output alphabet (a generator or a recognizer)
runs with that side's matrices as one impossible token (`nonempty`).
"""

import ctypes
import time
import weakref
from dataclasses import dataclass

import torch

from ..semiring import NEG_INF
from ._build import load

THREADS = 512        # a block's threads
WARPS = THREADS // 32
SMEM_MAX = 232448    # shared bytes a block may take on the H100
MAX_STATES = 512     # dispatch.DENSE_MAX_STATES
SMS = 132            # the H100's multiprocessors, the plan's default
MAX_CLUSTER = 16     # a cluster's blocks (past 8: non-portable sizes)
MIN_CELLS = 4        # input positions a block of a cluster takes at least
_F32 = 4
_TAB_BYTES = 8       # an entry: (source, value bits) as two int32
INBOX = 4            # cells a block's inbox holds from its left neighbour
_BAR_BYTES = 2 * INBOX * 8   # the inbox's mbarriers


@dataclass
class RowTables:
    """The kernel's operands for one set of matrices and one semiring.

    tab (n_tab, 2) int32: first n_hdr headers, one a (matrix, slice of 32
    destination columns): (offset into the entries, rows); then the
    entries, a slice's block of (rows + 1) x 32: its first row the lanes'
    (finite count, column shift bits), then row t the lanes' t-th (source,
    prepared value bits), padded with (0, 0.0) in logsumexp and (0, -inf)
    in max-plus. Matrices in the order A_diag[x, y] (x * n_out + y),
    A_left[x], A_up[y], the closure. prep_ms: the build's host clock,
    synchronised on a card."""
    S: int
    n_in: int
    n_out: int
    maxplus: bool
    tab: torch.Tensor
    n_hdr: int
    prep_ms: float

    @property
    def n_mat(self):
        return self.n_in * self.n_out + self.n_in + self.n_out + 1

    @property
    def nsl(self):
        return -(-self.S // 32)

    @property
    def n_tab(self):
        return self.tab.shape[0]


def _pad_bits(maxplus):
    """The entries' padding value as int32 bits: 0.0, and -inf in
    max-plus (neither changes a sum or a max)."""
    return int(torch.tensor([float("-inf") if maxplus else 0.0])
               .view(torch.int32))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def row_tables(a_diag, a_left, a_up, closure, sr):
    """RowTables of the four matrices (any strides) on their device: the
    prepared values by sr.prepare on that device, as the plain version
    takes them, and the finite entries (> NEG_INF / 2) of every column in
    ascending source order."""
    dev = closure.device
    _sync(dev)
    t0 = time.perf_counter()
    S = closure.shape[-1]
    n_in, n_out = a_left.shape[0], a_up.shape[0]
    M = torch.cat([a_diag.reshape(-1, S, S), a_left.reshape(-1, S, S),
                   a_up.reshape(-1, S, S), closure.reshape(1, S, S)])
    n_mat = M.shape[0]
    maxplus = sr.name == "maxplus"
    if maxplus:
        vals, cm = M, torch.zeros((n_mat, S), dtype=M.dtype, device=dev)
    else:
        vals, cm = sr.prepare(M)
        cm = cm[:, 0, :]
    fin = M > NEG_INF / 2                                # (n_mat, k, j)
    nsl = -(-S // 32)
    cnt = torch.zeros((n_mat, nsl * 32), dtype=torch.int64, device=dev)
    cnt[:, :S] = fin.sum(1)
    rows = cnt.view(n_mat, nsl, 32).amax(-1)             # (n_mat, nsl)
    size = torch.where(rows > 0, (rows + 1) * 32, 0).reshape(-1)
    off = torch.cumsum(size, 0) - size
    total = int(size.sum())
    n_hdr = n_mat * nsl
    ent = torch.zeros((total, 2), dtype=torch.int32, device=dev)
    ent[:, 1] = _pad_bits(maxplus)
    off2 = off.view(n_mat, nsl)
    # the slices' first rows: each lane's count and column shift
    hm, hr = torch.nonzero(rows > 0, as_tuple=True)
    lanes = torch.arange(32, device=dev)
    j = hr[:, None] * 32 + lanes                          # (n, 32)
    pos = off2[hm, hr][:, None] + lanes
    live = j < S
    jc = j.clamp(max=S - 1)
    ent[pos[live], 0] = cnt[hm[:, None].expand_as(j), j][live].to(torch.int32)
    ent[pos[live], 1] = cm[hm[:, None].expand_as(j), jc][live].contiguous() \
        .view(torch.int32)
    # the entries: row 1 + (rank of the source in its column)
    mm, kk, jj = torch.nonzero(fin, as_tuple=True)
    rank = (torch.cumsum(fin, 1) - 1)[mm, kk, jj]
    pos = off2[mm, jj // 32] + (1 + rank) * 32 + jj % 32
    ent[pos, 0] = kk.to(torch.int32)
    ent[pos, 1] = vals[mm, kk, jj].contiguous().view(torch.int32)
    hdr = torch.stack([off, rows.reshape(-1)], -1).to(torch.int32)
    tab = torch.cat([hdr, ent]).contiguous()
    _sync(dev)
    return RowTables(S=S, n_in=n_in, n_out=n_out, maxplus=maxplus, tab=tab,
                     n_hdr=n_hdr, prep_ms=(time.perf_counter() - t0) * 1e3)


_TABLES = {}         # key -> (weakrefs to the matrices' bases, versions,
_TABLES_MAX = 16     #        tables)


def _owner(t):
    return t._base if t._base is not None else t


def tables_cached(tag, mats, build):
    """(tables, built): build() kept per set of operand tensors and `tag`
    (the kind of tables). The key is each matrix's address, shape,
    strides, dtype and device (a transposed view is its own entry); an
    entry is taken only while weak references to the matrices' storage
    owners still point at the same objects and their versions are
    unchanged, so a new tensor at a reused address, or one written in
    place, is built anew."""
    key = (tag,) + tuple((m.data_ptr(), tuple(m.shape), m.stride(),
                          m.dtype, str(m.device)) for m in mats)
    versions = tuple(m._version for m in mats)
    hit = _TABLES.get(key)
    if hit is not None and hit[1] == versions and all(
            r() is _owner(m) for r, m in zip(hit[0], mats)):
        return hit[2], False
    tables = build()
    for k in [k for k, v in _TABLES.items() if any(r() is None
                                                   for r in v[0])]:
        del _TABLES[k]
    while len(_TABLES) >= _TABLES_MAX:
        del _TABLES[next(iter(_TABLES))]
    _TABLES[key] = (tuple(weakref.ref(_owner(m)) for m in mats), versions,
                    tables)
    return tables, True


def row_tables_cached(a_diag, a_left, a_up, closure, sr):
    """(RowTables, built): row_tables kept per set of operand tensors and
    semiring (tables_cached)."""
    mats = (a_diag, a_left, a_up, closure)
    return tables_cached(sr.name, mats, lambda: row_tables(*mats, sr))


def row_columns(tables):
    """The tables read back as column lists: (src (n_mat, SP, R) int64,
    val (n_mat, SP, R) float32, shift (n_mat, SP), count (n_mat, SP)),
    SP = 32 nsl destination columns, R the longest slice (at least 1),
    padding as stored."""
    tab, n_hdr, nsl = tables.tab, tables.n_hdr, tables.nsl
    n_mat = tables.n_mat
    hdr = tab[:n_hdr].long().view(n_mat, nsl, 2)
    pad = torch.tensor([[0, _pad_bits(tables.maxplus)]], dtype=torch.int32,
                       device=tab.device)
    ent = torch.cat([tab[n_hdr:], pad])
    none = ent.shape[0] - 1
    R = max(int(hdr[..., 1].max()), 1)
    off, rows = hdr[..., 0], hdr[..., 1]                 # (n_mat, nsl)
    t = torch.arange(R + 1, device=tab.device)
    lanes = torch.arange(32, device=tab.device)
    pos = off[..., None, None] + t[:, None] * 32 + lanes  # (m, r, R+1, 32)
    ok = t[:, None] <= rows[..., None, None]
    ok = ok & (rows[..., None, None] > 0)
    pos = torch.where(ok, pos, none)
    got = ent[pos]                                        # (m, r, R+1, 32, 2)
    got = got.permute(0, 1, 3, 2, 4).reshape(n_mat, nsl * 32, R + 1, 2)
    head = got[:, :, 0]
    shift = head[..., 1].contiguous().view(torch.float32)
    count = head[..., 0].long()
    body = got[:, :, 1:]
    return (body[..., 0].long(), body[..., 1].contiguous()
            .view(torch.float32), shift, count)


def row_smem_bytes(S, ncb, ring_shared, n_tab=0):
    """A block's shared bytes (the kernel's smem_bytes): the staged lists
    (n_tab entries, 0 when not staged), the 16 warps' workspaces (three
    source cells of S + 1 floats and a vector of S) and, where shared, the
    ring of three diagonals of ncb cells of S + 1 floats and the inbox of
    INBOX cells (the left neighbour's last cells), after the inbox's
    mbarriers."""
    n = WARPS * (4 * S + 3)
    if ring_shared:
        n += (3 * ncb + INBOX) * (S + 1)
    return _BAR_BYTES + n * _F32 + n_tab * _TAB_BYTES


def row_launch_plan(S, Li, Lo, B, lattice=False, smem_max=SMEM_MAX,
                    mem_bytes=None, rows=None, sms=SMS, cluster=None,
                    n_tab=0):
    """The kernel's layout for B pairs padded to Li x Lo over S states.

    Returns a dict: threads; cluster (the blocks a pair: 1 where B alone
    fills the `sms` multiprocessors, else the largest power of two up to
    MAX_CLUSTER with B * cluster <= sms and at least MIN_CELLS input
    positions a block; `cluster` forces it, 1 to 16); cells_per_block
    (ceil((Li + 1) / cluster): a block's fixed range of input positions);
    rows, where the ring of the last three diagonals lives: "shared" where
    it fits a block's shared memory beside the warps' workspaces, else
    "global" (the pair's scratch; `rows` "global" forces it, for tests);
    tables ("shared" where the n_tab entries of the lists fit beside
    those, else "global"); smem_bytes; and mem_bytes (the device bytes the
    call allocates: the output, a lattice in lattice mode, the global
    ring and the lists). Raises ValueError past MAX_STATES or where
    mem_bytes exceeds `mem_bytes` (the card's memory; None: not
    checked)."""
    if not 1 <= S <= MAX_STATES:
        raise ValueError("the row kernel takes 1 to %d states, not %d"
                         % (MAX_STATES, S))
    if min(Li, Lo, B) < 0:
        raise ValueError("negative shape (Li=%d, Lo=%d, B=%d)" % (Li, Lo, B))
    if rows not in (None, "global"):
        raise ValueError("rows may be forced to 'global' only")
    if cluster is None:
        cluster = 1
        if B < sms:
            cluster = MAX_CLUSTER
            while cluster > 1 and (B * cluster > sms
                                   or Li + 1 < MIN_CELLS * cluster):
                cluster //= 2
    elif not 1 <= cluster <= 16:
        raise ValueError("a cluster holds 1 to 16 blocks, not %d" % cluster)
    ncb = -(-(Li + 1) // cluster)
    ring_shared = rows is None and row_smem_bytes(S, ncb, True) <= smem_max
    tab_shared = n_tab > 0 and row_smem_bytes(
        S, ncb, ring_shared, n_tab) <= smem_max
    smem = row_smem_bytes(S, ncb, ring_shared, n_tab if tab_shared else 0)
    out = B * (Lo + 1) * (Li + 1) * S * _F32 if lattice else B * _F32
    ring = 0 if ring_shared else B * 3 * (Li + 1) * (S + 1) * _F32
    mem = out + ring + n_tab * _TAB_BYTES
    if mem_bytes is not None and mem > mem_bytes:
        raise ValueError(
            "the row kernel needs %d device bytes for %d pairs of %d x %d "
            "over %d states (%s), past the card's %d"
            % (mem, B, Li, Lo, S, "lattices" if lattice else "scores",
               mem_bytes))
    return {"threads": THREADS, "cluster": cluster, "cells_per_block": ncb,
            "rows": "shared" if ring_shared else "global",
            "tables": "shared" if tab_shared else "global",
            "n_tab": n_tab, "smem_bytes": smem, "mem_bytes": mem}


def row_smem_bytes_on_card(cfg, S, Li):
    """The kernel's own count of a block's shared bytes for `cfg` (Li: the
    padded input length the plan was made for)."""
    n_tab = cfg["n_tab"] if cfg["tables"] == "shared" else 0
    return int(load("row_scan").row_scan_smem_bytes(
        ctypes.c_int(S), ctypes.c_int(-(-(Li + 1) // cfg["cluster"])),
        ctypes.c_int(int(cfg["rows"] == "shared")), ctypes.c_int(n_tab)))


def nonempty(a_diag, a_left, a_up):
    """The matrices with an empty alphabet side given one token whose
    matrices are all NEG_INF (a_left (0, S, S) of a generator becomes (1,
    S, S), a_diag gains the matching row or column), so every token, 0 on
    a padded side, indexes a matrix and no path consumes that side; the
    others are returned as they are."""
    n_in, n_out = a_left.shape[0], a_up.shape[0]
    if n_in and n_out:
        return a_diag, a_left, a_up
    S = a_left.shape[-1]

    def neg(*shape):
        return torch.full(shape, NEG_INF, dtype=a_left.dtype,
                          device=a_left.device)

    n_in1, n_out1 = max(n_in, 1), max(n_out, 1)
    diag = neg(n_in1, n_out1, S, S)
    diag[:n_in, :n_out] = a_diag
    return (diag, a_left if n_in else neg(1, S, S),
            a_up if n_out else neg(1, S, S))


def _as_int32(t, dev):
    return torch.as_tensor(t, device=dev).to(torch.int32).contiguous()


def _check_mat(t, name, shape, dev):
    if t.device != dev:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, dev))
    if t.dtype != torch.float32:
        raise TypeError("%s has dtype %s, expected torch.float32"
                        % (name, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))


def row_scan(a_diag, a_left, a_up, closure, in_toks, out_toks, sr,
             lens=None, start_vec=None, band=None, rows=None, cluster=None):
    """The row engine of ops/dp2d.py in one call.

    Matrices as lowering.matrices_2d gives them (any strides: Backward
    hands over transposed views; an empty alphabet side is given one
    impossible token by `nonempty`); tokens (Li,) and (Lo,) for one pair or
    (B, Li) and (B, Lo) for a batch. `lens` (in_len, out_len): the score
    cell(in_len, out_len, S-1) of each pair, a 0-dim tensor for one pair
    or (B,); None: the whole lattice, (Lo+1, Li+1, S) or (B, Lo+1, Li+1,
    S), seeded from `start_vec` (None: state 0). `band` (in_start, in_end),
    each (Lo+1,), for one pair: the banded score, every row of out_toks
    filled and read at in_len. `rows` ("global") and `cluster` force
    row_launch_plan's choices.

    A CUDA tensor launches csrc/row_scan.cu once (row_launch_plan's
    layout, on the tables of row_tables_cached) and counts it in
    `row_scan.launches`; `row_scan.last` holds the last launch's plan and
    its tables' build ms (0.0 when they were kept); a failed launch
    raises. A CPU tensor takes the plain version.

    The gradient, where a matrix or start_vec requires grad (and grad
    mode is on): the logsumexp score with the default start goes through
    counts_kernel.RowLoglike, whose forward is this call on the detached
    matrices and whose backward the E-step's kernels (a Forward and a
    Backward lattice, expected_counts; their plain versions on a CPU
    tensor); every other call (lattices, max-plus, banded, a start_vec)
    runs its plain version under autograd on a CPU tensor and raises on
    a CUDA tensor, where no kernel computes its gradient."""
    tensors = [a_diag, a_left, a_up, closure, start_vec]
    grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)
    if grad and sr.name == "logsumexp" and lens is not None \
            and band is None and start_vec is None:
        from .counts_kernel import RowLoglike
        dev = closure.device
        B = 1 if in_toks.dim() == 1 else in_toks.shape[0]
        it = torch.as_tensor(in_toks, device=dev).reshape(B, -1)
        ot = torch.as_tensor(out_toks, device=dev).reshape(B, -1)
        il, ol = (torch.as_tensor(n, device=dev).reshape(B) for n in lens)
        lls = RowLoglike.apply(a_diag, a_left, a_up, closure, it, ot, il, ol)
        return lls[0] if in_toks.dim() == 1 else lls
    a_diag, a_left, a_up = nonempty(a_diag, a_left, a_up)
    dev = closure.device
    if grad and dev.type != "cpu":
        raise ValueError("on a card the row engine's gradient is the "
                         "logsumexp score's (lens given, no band, no "
                         "start_vec); this call's inputs must not require "
                         "grad")
    if dev.type == "cpu":
        from .. import dp2d
        if band is not None:
            return dp2d.forward_2d_banded_plain(
                a_diag, a_left, a_up, closure, in_toks, out_toks, *band,
                *lens, sr=sr)
        if lens is not None:
            return dp2d.forward_2d_plain(a_diag, a_left, a_up, closure,
                                         in_toks, out_toks, *lens, sr=sr)
        return dp2d.forward_2d_lattice_plain(
            a_diag, a_left, a_up, closure, in_toks, out_toks, sr=sr,
            start_vec=start_vec)
    if dev.type != "cuda":
        raise ValueError("row_scan runs on cuda or cpu tensors, not %s" % dev)
    return _launch(a_diag, a_left, a_up, closure, in_toks, out_toks, sr,
                   lens, start_vec, band, rows, cluster, None)


def _launch(a_diag, a_left, a_up, closure, in_toks, out_toks, sr, lens,
            start_vec, band, rows, cluster, prof):
    """row_scan's CUDA call; prof (a (B, 7) int64 tensor): through the
    profile library, uncounted."""
    dev = closure.device
    if sr.name not in ("logsumexp", "maxplus"):
        raise ValueError("the row kernel takes the logsumexp and maxplus "
                         "semirings, not %s" % sr.name)
    single = in_toks.dim() == 1
    B = 1 if single else in_toks.shape[0]
    if out_toks.dim() != in_toks.dim() or (not single and
                                           out_toks.shape[0] != B):
        raise ValueError("in_toks %s and out_toks %s are not one pair or "
                         "one batch" % (tuple(in_toks.shape),
                                        tuple(out_toks.shape)))
    Li, Lo = in_toks.shape[-1], out_toks.shape[-1]
    it = _as_int32(in_toks, dev).reshape(B, Li)
    ot = _as_int32(out_toks, dev).reshape(B, Lo)
    S = closure.shape[-1]
    n_in, n_out = a_left.shape[0], a_up.shape[0]
    _check_mat(a_diag, "a_diag", (n_in, n_out, S, S), dev)
    _check_mat(a_left, "a_left", (n_in, S, S), dev)
    _check_mat(a_up, "a_up", (n_out, S, S), dev)
    _check_mat(closure, "closure", (S, S), dev)
    if start_vec is None:
        start_vec = torch.full((S,), sr.zero, dtype=torch.float32, device=dev)
        start_vec[0] = sr.one
    start_vec = start_vec.contiguous()
    _check_mat(start_vec, "start_vec", (S,), dev)
    lattice = lens is None
    if band is not None:
        if not single or lattice:
            raise ValueError("the banded call takes one pair's score")
        band = torch.stack([_as_int32(b, dev).reshape(-1) for b in band])
        if tuple(band.shape) != (2, Lo + 1):
            raise ValueError("band has shape %s, expected (2, %d)"
                             % (tuple(band.shape), Lo + 1))
        # every row of out_toks is filled and the last read at in_len
        lens = (lens[0], Lo)
    if not lattice:
        in_lens = _as_int32(lens[0], dev).reshape(-1)
        out_lens = _as_int32(lens[1], dev).reshape(-1)
        if in_lens.shape != (B,) or out_lens.shape != (B,):
            raise ValueError("lens %s, %s do not match %d pairs"
                             % (tuple(in_lens.shape), tuple(out_lens.shape),
                                B))
    tables, built = row_tables_cached(a_diag, a_left, a_up, closure, sr)
    props = torch.cuda.get_device_properties(dev)
    cfg = row_launch_plan(S, Li, Lo, B, lattice, rows=rows,
                          mem_bytes=props.total_memory,
                          sms=props.multi_processor_count, cluster=cluster,
                          n_tab=tables.n_tab)
    if lattice:
        out = torch.empty((B, Lo + 1, Li + 1, S), dtype=torch.float32,
                          device=dev)
    else:
        out = torch.empty((B,), dtype=torch.float32, device=dev)
    ring = torch.empty((B, 3, Li + 1, S + 1), dtype=torch.float32,
                       device=dev) if cfg["rows"] == "global" else None
    fn = load("row_scan" if prof is None else "row_scan_profile") \
        .row_scan_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 10 + [I] * 14 + [P]
    fn.restype = I
    rc = fn(tables.tab.data_ptr(), start_vec.data_ptr(), it.data_ptr(),
            ot.data_ptr(), None if lattice else in_lens.data_ptr(),
            None if lattice else out_lens.data_ptr(),
            None if band is None else band.data_ptr(), out.data_ptr(),
            None if ring is None else ring.data_ptr(),
            None if prof is None else prof.data_ptr(), tables.n_hdr,
            tables.n_tab, int(cfg["tables"] == "shared"), B, Li, Lo, S,
            n_in, n_out, cfg["cluster"], cfg["cells_per_block"],
            int(cfg["rows"] == "shared"), int(sr.name == "maxplus"),
            int(lattice), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("row_scan launch failed: CUDA error %d" % rc)
    if prof is None:
        row_scan.launches += 1
    row_scan.last = {"plan": cfg, "prep_ms": tables.prep_ms if built else 0.0}
    return out[0] if single else out


row_scan.launches = 0
row_scan.last = None

PROFILE_PHASES = ("load", "products", "scale", "barrier", "closure",
                  "write")


def row_scan_profile(a_diag, a_left, a_up, closure, in_toks, out_toks, sr,
                     lens=None, start_vec=None, band=None, rows=None,
                     cluster=None):
    """row_scan on the card through the profile library (the same source
    built with its clock64 counters; not counted as a launch). Returns (the
    result, {"cluster", "diagonals", "cells" of the first pair,
    "cycles_a_diagonal":
    phase: a warp's SM cycles a diagonal, averaged over the pair's warps,
    "cycles_a_cell": phase: cycles a cell, the barrier left out}). The
    phases: the neighbour loads, the three neighbour products, the
    closure's source vector (max and exps), the barrier, the closure
    product, the writes."""
    B = 1 if in_toks.dim() == 1 else in_toks.shape[0]
    prof = torch.zeros((B, 2 + len(PROFILE_PHASES)), dtype=torch.int64,
                       device=in_toks.device)
    out = _launch(a_diag, a_left, a_up, closure, in_toks, out_toks, sr, lens,
                  start_vec, band, rows, cluster, prof)
    tot = prof[0].cpu().tolist()
    diag_warps = max(tot[0], 1) * WARPS        # over the pair's blocks
    cells = max(tot[1], 1)
    cluster = row_scan.last["plan"]["cluster"]
    return out, {"cluster": cluster, "diagonals": tot[0] // cluster,
                 "cells": tot[1],
                 "cycles_a_diagonal": {p: tot[2 + k] / diag_warps for k, p
                                       in enumerate(PROFILE_PHASES)},
                 "cycles_a_cell": {p: tot[2 + k] / cells for k, p
                                   in enumerate(PROFILE_PHASES)
                                   if p != "barrier"}}


# ---------------------------------------------------------------- CPU twin

def _twin_product(src, mx, m, cols, maxplus):
    """The kernel's product for every cell at once: src (N, S) stored
    cells, mx (N,) their maxima, m (N,) matrix indices; (N, S) log
    values."""
    k, v, shift, _ = cols
    S = src.shape[-1]
    kk, vv = k[m][:, :S], v[m][:, :S]                     # (N, S, R)
    g = torch.gather(src, 1, kk.reshape(len(m), -1)).view(kk.shape)
    if maxplus:
        s = (g + vv).amax(-1)
        return torch.where(s > NEG_INF / 2, s, NEG_INF)
    s = torch.zeros_like(src)
    for t in range(kk.shape[-1]):
        s = s + g[..., t] * vv[..., t]
    c = (torch.log(torch.clamp(s, min=torch.finfo(s.dtype).tiny))
         + mx[:, None]) + shift[m][:, :S]
    return torch.where(s > 0, c, NEG_INF)


def _safe_max(x):
    m = x.amax(-1)
    return torch.where(m > NEG_INF / 2, m, 0.0)


def row_scan_diagonal(tables, in_toks, out_toks, lens=None, start_vec=None,
                      band=None):
    """The kernel's walk in plain PyTorch on `tables` (row_tables), on
    their device: row_scan's arguments after the matrices and the
    semiring, the same results. Diagonal by diagonal, every cell's three
    neighbour products on the stored cells (scaled by their maxima in
    logsumexp), combined by logaddexp (max), the closure product on the
    combined vector scaled by its max, the band, then the cell stored."""
    maxplus, S = tables.maxplus, tables.S
    dev = tables.tab.device
    cols = row_columns(tables)
    single = in_toks.dim() == 1
    B = 1 if single else in_toks.shape[0]
    Li, Lo = in_toks.shape[-1], out_toks.shape[-1]
    it = torch.as_tensor(in_toks, device=dev).long().reshape(B, Li)
    ot = torch.as_tensor(out_toks, device=dev).long().reshape(B, Lo)
    lattice = lens is None
    if band is not None:
        lens = (lens[0], Lo)
        bs = torch.as_tensor(band[0], device=dev).long().reshape(-1)
        be = torch.as_tensor(band[1], device=dev).long().reshape(-1)
    if lattice:
        Lp = torch.full((B,), Li, dtype=torch.long, device=dev)
        Lq = torch.full((B,), Lo, dtype=torch.long, device=dev)
    else:
        Lp = torch.as_tensor(lens[0], device=dev).long().reshape(-1) \
            .expand(B).clamp(0, Li)
        Lq = torch.as_tensor(lens[1], device=dev).long().reshape(-1) \
            .expand(B).clamp(0, Lo)
    if start_vec is None:
        start_vec = torch.full((S,), NEG_INF, dtype=torch.float32,
                               device=dev)
        start_vec[0] = 0.0
    # tokens of position i (1-based; 0 a dummy), clamped to the alphabet
    x_of = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                      it.clamp(0, tables.n_in - 1)], 1)
    y_of = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                      ot.clamp(0, tables.n_out - 1)], 1)
    n_io = tables.n_in * tables.n_out
    m_cl = tables.n_mat - 1
    ring = torch.zeros((3, B, Li + 1, S), dtype=torch.float32, device=dev)
    rmax = torch.zeros((3, B, Li + 1), dtype=torch.float32, device=dev)
    out = torch.full((B, Lo + 1, Li + 1, S) if lattice else (B,), NEG_INF,
                     dtype=torch.float32, device=dev)
    I = torch.arange(Li + 1, device=dev)
    bi = torch.arange(B, device=dev)[:, None].expand(B, Li + 1)
    ii = I.expand(B, Li + 1)
    for d in range(int((Lp + Lq).max()) + 1 if B else 0):
        o = d - ii
        valid = (o >= 0) & (o <= Lq[:, None]) & (ii <= Lp[:, None])
        bv, iv, ov = bi[valid], ii[valid], o[valid]
        if not len(bv):
            continue
        x, y = x_of[bv, iv], y_of[bv, ov]
        im1 = (iv - 1).clamp(min=0)
        p1, p2 = (d - 1) % 3, (d - 2) % 3
        up = _twin_product(ring[p1, bv, iv], rmax[p1, bv, iv],
                           n_io + tables.n_in + y, cols, maxplus)
        dg = _twin_product(ring[p2, bv, im1], rmax[p2, bv, im1],
                           x * tables.n_out + y, cols, maxplus)
        lf = _twin_product(ring[p1, bv, im1], rmax[p1, bv, im1], n_io + x,
                           cols, maxplus)
        up = torch.where((ov > 0)[:, None], up, NEG_INF)
        dg = torch.where(((ov > 0) & (iv > 0))[:, None], dg, NEG_INF)
        lf = torch.where((iv > 0)[:, None], lf, NEG_INF)
        if maxplus:
            t = torch.maximum(torch.maximum(up, dg), lf)
        else:
            t = torch.logaddexp(torch.logaddexp(up, dg), lf)
        if d == 0:
            t = start_vec.float().expand(len(bv), S).clone()
        tmax = torch.zeros(len(bv), device=dev) if maxplus else _safe_max(t)
        et = t if maxplus else torch.exp(t - tmax[:, None])
        c = _twin_product(et, tmax, torch.full_like(bv, m_cl), cols,
                          maxplus)
        if band is not None:
            inb = (iv >= bs[ov]) & (iv < be[ov])
            c = torch.where(inb[:, None], c, NEG_INF)
        cmax = torch.zeros(len(bv), device=dev) if maxplus else _safe_max(c)
        ring[d % 3, bv, iv] = c if maxplus else torch.exp(c - cmax[:, None])
        rmax[d % 3, bv, iv] = cmax
        if lattice:
            out[bv, ov, iv] = c
        else:
            end = (iv == Lp[bv]) & (ov == Lq[bv])
            out[bv[end]] = c[end, S - 1]
    return out[0] if single else out
