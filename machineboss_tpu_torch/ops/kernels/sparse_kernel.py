"""The sparse engine's token walks as one CUDA kernel.

Counterpart of the jitted sparse walks of machineboss_tpu's ops/sparse.py
(forward_2d_sparse, forward_1d_sparse, backward_1d_sparse and
backward_2d_sparse, :89-266, each one @jax.jit program unrolled over every
cell; viterbi_2d_sparse, :269, the max-plus Backward; no pallas_call).
`sparse_walk` is the counted wrapper of csrc/sparse_walk.cu: a machine on
the card launches the kernel once for a batch of pairs, or raises; a
machine on the CPU takes the plain version, ops/sparse.py's eager
anti-diagonal walk (`_token_walk`), pair by pair.

The kernel walks each pair by anti-diagonals on `sparse_tables` (built
once per SparseMachine, direction and semiring, and kept in its cache):
every emitting class's edges and the silent closure's as CSR lists keyed
by the scatter side (the destination for Forward, the source for
Backward), with the gather side's state and the weight of each edge, and
the (in token, out token) -> class table. Each cell takes two stages:
its three neighbours' terms reduced per scatter-side state (the eager
walk's `pre`), then the closure. `sparse_walk_diagonal` is the same walk
in plain PyTorch on the same tables, in the kernel's stage order: the
tests hold it to the eager walk and to the JAX engine; nothing on the
main path calls it.

The kernel's layout comes from `sparse_launch_plan`, a pure function of
the shape and the tables' sizes (`ListSizes`): the form ("2d": each block
of a cluster owns a fixed range of positions along the shorter side, a
group of warps a cell; "1d", where one side is empty: each block owns a
fixed range of states, balanced by `state_turns`), the blocks a pair (a
cluster of up to 16 while the batch leaves the card's multiprocessors
idle), the lanes that reduce one state's terms in each stage, where the 2D
ring
lives ("shared" or "global"), where the tables live ("shared": all of
them in every block; "slice": a block's states' lists; "global": read
through L1/L2), chosen by size alone, the clusters launched (each walks a
pair, then the next: a global ring is one a cluster, not one a pair),
with the shared and device bytes; it refuses only what the device memory
cannot hold for one pair.
"""

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.device import free_bytes
from ..semiring import NEG_INF
from ._build import load

THREADS = 512        # a block's threads
WARPS = THREADS // 32
SMEM_MAX = 232448    # shared bytes a block may take on the H100
SMS = 132            # the H100's multiprocessors, the plan's default
MAX_CLUSTER = 16     # a cluster's blocks (past 8: non-portable sizes)
MIN_TERMS = 512      # terms a diagonal a block of a cluster takes at least
BOX = 4              # the 2D inbox's slots (csrc/sparse_walk.cu)
BAR_BYTES = 64       # a block's mbarriers
IDX16_STATES = 65536  # staged gather indices are 16-bit below this many
LONG_LIST = 8        # closure entries a state's group takes at least
_DTYPES = {torch.float32: 4, torch.float64: 8}
_TABLES = {"global": 0, "shared": 1, "slice": 2}


@dataclass
class ListSizes:
    """What the launch plan reads of a machine's tables: S states, n_cls
    classes (the empty one last), n_io (in, out) token pairs, each state's
    emitting entries (over every class) and closure entries (state_emit,
    state_closure: (S,) int64, the entries of the lists that reduce into
    it), the mean entries of a non-empty emitting and closure list
    (emit_row, closure_row) and a cell's terms (cell_terms: its three
    neighbours' mean class edges and the closure's)."""
    S: int
    n_cls: int
    n_io: int
    state_emit: np.ndarray
    state_closure: np.ndarray
    emit_row: float
    closure_row: float
    cell_terms: float

    @property
    def n_emit(self):
        return int(self.state_emit.sum())

    @property
    def n_closure(self):
        return int(self.state_closure.sum())


@dataclass
class SparseTables:
    """The kernel's operands for one machine, direction and semiring.

    ints (int32): eoff ((n_cls * S + 1): the emitting lists' offsets, row
    c * S + t the class c's edges whose scatter-side state is t), coff
    (S + 1: the closure's), cls (n_in * n_out: the class of each (in, out)
    token pair; absent pairs the empty class n_cls - 1), eidx, cidx (the
    gather-side state of each entry), at o_coff, o_cls, o_eidx, o_cidx.
    weights (the machine's dtype): ew then cw (at o_cw), each entry's log
    weight, the plain version's values. sizes: the ListSizes the plan
    reads. prep_ms: the build's host clock, synchronised on a card."""
    S: int
    n_cls: int
    n_in: int
    n_out: int
    maxplus: bool
    reverse: bool
    ints: torch.Tensor
    weights: torch.Tensor
    o_coff: int
    o_cls: int
    o_eidx: int
    o_cidx: int
    o_cw: int
    sizes: ListSizes
    prep_ms: float

    @property
    def empty(self):
        return self.n_cls - 1

    @property
    def nbytes(self):
        return (self.ints.numel() * 4
                + self.weights.numel() * self.weights.element_size())


def _csr(scatter, gather, w, n_rows):
    """(offsets (n_rows + 1,), gather, w) sorted by scatter row, stably."""
    order = np.argsort(scatter, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(scatter,
                                                     minlength=n_rows))])
    return off, gather[order], w[order]


def _mean_row(off):
    n = np.diff(off)
    return float(n[n > 0].mean()) if (n > 0).any() else 0.0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sparse_tables(sm, reverse=False, viterbi=False):
    """SparseTables of SparseMachine `sm` for Forward (reverse=False) or
    Backward, in logsumexp or max-plus (viterbi), on sm's device; built
    once and kept in sm's cache. The weights are the plain version's: the
    class weights as sm holds them and the closure's float64 edge set
    cast to sm's dtype (SparseMachine.closure)."""
    key = ("sparse_tables", bool(reverse), bool(viterbi))
    if key in sm._cache:
        return sm._cache[key]
    dev = sm.device
    _sync(dev)
    t0 = time.perf_counter()
    S = sm.n_states
    dtype = np.dtype(sm.dtype)
    keys = sorted(k for k in sm.classes if k != (0, 0))
    n_cls = len(keys) + 1                      # the empty class last
    scat, gath, ws = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], \
        [np.zeros(0, dtype)]
    for k in keys:
        src, dst, lw = sm.classes[k]
        c = int(sm.class_index[k])
        s, g = (src, dst) if reverse else (dst, src)
        scat.append(c * S + np.asarray(s, np.int64))
        gath.append(np.asarray(g, np.int64))
        ws.append(np.maximum(np.asarray(lw, np.float64), NEG_INF)
                  .astype(dtype))
    eoff, eidx, ew = _csr(np.concatenate(scat), np.concatenate(gath),
                          np.concatenate(ws), n_cls * S)
    csrc, cdst, cwt = (t.cpu().numpy() for t in sm.closure(viterbi))
    s, g = (csrc, cdst) if reverse else (cdst, csrc)
    coff, cidx, cw = _csr(s.astype(np.int64), g.astype(np.int64),
                          cwt.astype(dtype), S)
    cls = sm.class_index.reshape(-1)
    parts = [eoff, coff, cls, eidx, cidx]
    starts = np.cumsum([0] + [len(p) for p in parts])
    ints = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(dev)
    weights = torch.from_numpy(np.concatenate([ew, cw])).to(dev)
    live = max(len(keys), 1)
    n_in, n_out = sm.class_index.shape
    sizes = ListSizes(
        S=S, n_cls=n_cls, n_io=n_in * n_out,
        state_emit=np.diff(eoff).reshape(n_cls, S).sum(0),
        state_closure=np.diff(coff), emit_row=_mean_row(eoff),
        closure_row=_mean_row(coff),
        cell_terms=3.0 * len(eidx) / live + len(cidx))
    tables = SparseTables(
        S=S, n_cls=n_cls, n_in=n_in, n_out=n_out, maxplus=bool(viterbi),
        reverse=bool(reverse), ints=ints, weights=weights,
        o_coff=int(starts[1]), o_cls=int(starts[2]), o_eidx=int(starts[3]),
        o_cidx=int(starts[4]), o_cw=len(ew), sizes=sizes, prep_ms=0.0)
    _sync(dev)
    tables.prep_ms = (time.perf_counter() - t0) * 1e3
    sm._cache[key] = tables
    return tables


def _lanes(terms):
    """Lanes a state's terms are spread over: the power of two at or
    below `terms`, 1 to 32."""
    g = 1
    while g < 32 and 2 * g <= terms:
        g *= 2
    return g


def _up16(n):
    return (n + 15) // 16 * 16


def sparse_smem_bytes(cfg):
    """A block's shared bytes for the plan `cfg` (the kernel's
    smem_layout): the mbarriers; the 2D form's shared ring of three
    diagonals of ncb cells, its inbox of BOX cells and the warps'
    workspaces, or the 1D form's cell and pre-closure vectors; the order
    of the block's n_rows states' closures and two counts; then the
    staged tables (weights, offsets, the class table, gather indices of 16
    or 32 bits)."""
    v = cfg["S"] * cfg["elt"]
    n = BAR_BYTES
    if cfg["form"] == "1d":
        n += 2 * _up16(v)
    elif cfg["rows"] == "shared":
        n += _up16(3 * cfg["ncb"] * v) + _up16(BOX * v) + _up16(WARPS * v)
    n += _up16((cfg["n_rows"] + 2) * 4)
    if cfg["tables"] != "global":
        ib = 2 if cfg["idx16"] else 4
        n_e, n_c, rows = cfg["n_e"], cfg["n_c"], cfg["n_rows"]
        n += (_up16(n_e * cfg["elt"]) + _up16(n_c * cfg["elt"])
              + _up16((cfg["n_cls"] * rows + 1) * 4) + _up16((rows + 1) * 4)
              + _up16(cfg["n_io"] * 4) + _up16(n_e * ib) + _up16(n_c * ib))
    return n


def state_turns(lists, lanes):
    """Each state's share of a 1D diagonal's time, in a warp's turns: a
    list of LONG_LIST closure entries or more (`lanes` > 1) its entries a
    lane plus two for its group's shuffle trees, a shorter one (a lane
    alone) its entries over a warp's 32 lanes; and a thirty-second for its
    emitting list."""
    n = lists.state_closure
    long = (lanes > 1) & (n >= LONG_LIST)
    return np.where(long, np.ceil(n / lanes) + 2, n / 32.0) + 1 / 32.0


def state_bounds(work, parts):
    """parts + 1 bounds of contiguous state ranges, each holding one state
    or more, balanced by `work` (a state's)."""
    S = len(work)
    cum = np.concatenate([[0], np.cumsum(np.asarray(work, np.float64))])
    out = [0]
    for k in range(1, parts):
        x = cum[-1] * k / parts
        j = int(np.searchsorted(cum, x))
        if j > 0 and x - cum[j - 1] < cum[min(j, S)] - x:
            j -= 1
        out.append(min(max(j, out[-1] + 1), S - (parts - k)))
    return out + [S]


def sparse_launch_plan(S, Li, Lo, B, lists, elt=4, smem_max=SMEM_MAX,
                       mem_bytes=None, sms=SMS, cluster=None, rows=None):
    """The kernel's layout for B pairs padded to Li x Lo on tables of
    sizes `lists` (ListSizes) over S states.

    Returns a dict: threads; W (the positions along the shorter side,
    min(Li, Lo) + 1); form: "1d" where a side is empty, a block holds
    the cell and pre-closure vectors (2 S values) and a forced cluster
    gives each block a state, else "2d"; cluster (the
    blocks a pair: 1 where B alone fills the `sms` multiprocessors, else
    the largest power of two up to MAX_CLUSTER with B * cluster <= sms, at
    least MIN_TERMS of a diagonal's W * cell_terms a block and, in 1D, a
    state a block; `cluster` forces it, 1 to 16); lanes_emit and
    lanes_closure (the lanes that reduce one state's terms in each stage:
    the power of two at or below half the mean emitting list's length and
    at or below the closure's); 2D: swap (the ranges along the output
    side, Lo < Li), ncb (a block's positions, ceil(W / cluster)), rows
    ("shared": the ring of three diagonals, the inbox and the warps'
    workspaces in shared memory where they fit, else "global": in global
    scratch, one a cluster launched; `rows` "global" forces it, and the 2D
    form); 1D: bounds (the cluster + 1 state bounds, balanced by
    state_turns); tables ("shared": all in every block, 2D, where they fit
    beside the rows; "slice": a block's states' lists, 1D, where the
    largest fits; else "global"), idx16 (16-bit staged gather indices,
    below IDX16_STATES states), n_rows, n_e, n_c (the staged states and
    entries, the largest slice's); grid (the clusters launched, each
    walking a pair and then the next: B with the 2D shared ring, else the
    clusters the card holds at once, sms // cluster, at most B, and no
    more than `mem_bytes` holds global scratch for); smem_bytes; and
    mem_bytes (the device bytes the call allocates: the scores, the
    tokens, the 1D bounds and the 2D global scratch).
    Raises ValueError where `mem_bytes` (the device memory free for the
    call; None: not checked) cannot hold one cluster's scratch beside the
    scores and tokens, and past the kernel's 32-bit indices (a diagonal's
    W * S values, a pair's Li + Lo + 2 tokens: 2^31, some 16 M aa at
    prot2dna's 132 states, where one ring takes 34 GB)."""
    if S < 1 or min(Li, Lo, B) < 0:
        raise ValueError("bad shape (S=%d, Li=%d, Lo=%d, B=%d)"
                         % (S, Li, Lo, B))
    if (min(Li, Lo) + 1) * S >= 2 ** 31 or Li + Lo + 2 >= 2 ** 31:
        raise ValueError("the sparse walk indexes a diagonal's values and a "
                         "pair's tokens in 32 bits: %d x %d over %d states "
                         "is past them" % (Li, Lo, S))
    if rows not in (None, "global"):
        raise ValueError("rows may be forced to 'global' only")
    W = min(Li, Lo) + 1
    cfg = {"threads": THREADS, "W": W, "S": S, "elt": elt,
           "n_cls": lists.n_cls, "n_io": lists.n_io,
           "lanes_emit": _lanes(lists.emit_row / 2),
           "lanes_closure": _lanes(lists.closure_row),
           "idx16": S < IDX16_STATES, "swap": Li > Lo, "ncb": 1,
           "bounds": None, "rows": "shared", "n_rows": S}
    cfg["form"] = "1d" if rows is None and W == 1 and (
        cluster is None or cluster <= S) and sparse_smem_bytes(
        dict(cfg, form="1d", tables="global")) <= smem_max else "2d"
    if cluster is None:
        cluster = 1
        if B < sms:
            cluster = MAX_CLUSTER
            while cluster > 1 and (
                    B * cluster > sms or
                    W * lists.cell_terms < MIN_TERMS * cluster or
                    (cfg["form"] == "1d" and cluster > S)):
                cluster //= 2
    elif not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError("a cluster holds 1 to %d blocks, not %d"
                         % (MAX_CLUSTER, cluster))
    cfg["cluster"] = cluster
    fixed = B * elt + B * (2 + Li + Lo) * 4
    scratch = 0
    if cfg["form"] == "1d":
        b = state_bounds(state_turns(lists, cfg["lanes_closure"]), cluster)
        cfg["bounds"] = b
        cfg["n_rows"] = max(b[k + 1] - b[k] for k in range(cluster))
        cfg["n_e"] = max(int(lists.state_emit[b[k]:b[k + 1]].sum())
                         for k in range(cluster))
        cfg["n_c"] = max(int(lists.state_closure[b[k]:b[k + 1]].sum())
                         for k in range(cluster))
        cfg["tables"] = "slice" if sparse_smem_bytes(
            dict(cfg, tables="slice")) <= smem_max else "global"
        fixed += (cluster + 1) * 4
        grid = min(B, max(sms // cluster, 1))
    else:
        cfg["ncb"] = -(-W // cluster)
        cfg.update(n_e=lists.n_emit, n_c=lists.n_closure)
        if rows is not None or sparse_smem_bytes(
                dict(cfg, tables="global")) > smem_max:
            cfg["rows"] = "global"
        cfg["tables"] = "shared" if sparse_smem_bytes(
            dict(cfg, tables="shared")) <= smem_max else "global"
        if cfg["rows"] == "global":
            scratch = (3 * W + cluster * WARPS) * S * elt
        grid = B if cfg["rows"] == "shared" else min(
            B, max(sms // cluster, 1))
    if mem_bytes is not None and scratch and B:
        if fixed + scratch > mem_bytes:
            raise ValueError(
                "the sparse walk needs %d device bytes for %d pairs of %d x "
                "%d over %d states (one ring of %d), past the %d free"
                % (fixed + scratch, B, Li, Lo, S, scratch, mem_bytes))
        grid = min(grid, (mem_bytes - fixed) // scratch)
    elif mem_bytes is not None and fixed > mem_bytes:
        raise ValueError(
            "the sparse walk needs %d device bytes for %d pairs of %d x %d, "
            "past the %d free" % (fixed, B, Li, Lo, mem_bytes))
    cfg.update(grid=grid, smem_bytes=sparse_smem_bytes(cfg),
               mem_bytes=fixed + grid * scratch)
    return cfg


def sparse_smem_bytes_on_card(cfg):
    """The kernel's own count of a block's shared bytes for `cfg`."""
    I = ctypes.c_int
    return int(load("sparse_walk").sparse_walk_smem_bytes(
        I(cfg["form"] == "1d"), I(cfg["S"]), I(cfg["elt"]), I(cfg["ncb"]),
        I(cfg["rows"] == "shared"), I(_TABLES[cfg["tables"]]),
        I(cfg["idx16"]), I(cfg["n_cls"]), I(cfg["n_io"]), I(cfg["n_rows"]),
        I(cfg["n_e"]), I(cfg["n_c"])))


def pad_tokens(seqs):
    """(tokens (B, L) int64, lengths (B,) int64) of B token lists, padded
    with 0 to the longest."""
    B = len(seqs)
    lens = np.array([len(s) for s in seqs], np.int64)
    out = np.zeros((B, int(lens.max()) if B else 0), np.int64)
    for b, s in enumerate(seqs):
        out[b, :len(s)] = s
    return out, lens


def _host(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                      np.int64)


class WalkCall:
    """One sparse_walk launch prepared: the tables, the plan (on the
    device memory free once the tables are built), the packed tokens, the
    1D form's state bounds and the 2D form's global scratch on the card,
    and the output. `launch()` launches the kernel and counts it in
    sparse_walk.launches; `last` holds the plan and the tables' build ms
    (0.0 when they were kept)."""

    def __init__(self, sm, in_toks, out_toks, in_lens, out_lens, viterbi,
                 reverse, cluster=None, rows=None):
        dev = sm.device
        if dev.type != "cuda":
            raise ValueError("the sparse kernel runs on cuda, not %s" % dev)
        built = ("sparse_tables", bool(reverse), bool(viterbi)) \
            not in sm._cache
        self.tables = t = sparse_tables(sm, reverse, viterbi)
        dtype = t.weights.dtype
        if dtype not in _DTYPES:
            raise TypeError("the sparse kernel takes float32 and float64 "
                            "machines, not %s" % dtype)
        it, ot = _host(in_toks), _host(out_toks)
        il, ol = _host(in_lens).reshape(-1), _host(out_lens).reshape(-1)
        B = it.shape[0]
        if it.ndim != 2 or ot.ndim != 2 or ot.shape[0] != B or \
                il.shape != (B,) or ol.shape != (B,):
            raise ValueError("tokens %s, %s and lengths %s, %s are not one "
                             "batch" % (it.shape, ot.shape, il.shape,
                                        ol.shape))
        Li, Lo = it.shape[1], ot.shape[1]
        elt = _DTYPES[dtype]
        self.cfg = cfg = sparse_launch_plan(
            t.S, Li, Lo, B, t.sizes, elt, mem_bytes=free_bytes(dev),
            sms=torch.cuda.get_device_properties(dev).multi_processor_count,
            cluster=cluster, rows=rows)
        # a token past int32 takes the empty class as any other outside
        # the alphabet does
        seq = np.concatenate([np.clip(il, 0, Li)[:, None],
                              np.clip(ol, 0, Lo)[:, None],
                              np.clip(it, -1, 2 ** 31 - 1),
                              np.clip(ot, -1, 2 ** 31 - 1)], 1)
        self.seq = torch.from_numpy(seq.astype(np.int32)).to(dev)
        self.out = torch.empty((B,), dtype=dtype, device=dev)
        self.bounds = None if cfg["bounds"] is None else torch.tensor(
            cfg["bounds"], dtype=torch.int32, device=dev)
        self.scratch = torch.empty(
            (cfg["grid"], (3 * cfg["W"] + cfg["cluster"] * WARPS) * t.S),
            dtype=dtype, device=dev) \
            if cfg["form"] == "2d" and cfg["rows"] == "global" and B \
            else None
        self.args = (B, Li, Lo, elt, dev)
        self.last = {"plan": cfg, "prep_ms": t.prep_ms if built else 0.0}

    def launch(self, prof=None):
        """Launches the kernel (with `prof`, a (grid, 7) int64 tensor, the
        profile library instead: not counted)."""
        t, cfg = self.tables, self.cfg
        B, Li, Lo, elt, dev = self.args
        fn = load("sparse_walk" if prof is None else "sparse_walk_profile") \
            .sparse_walk_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 32 + [P, P]
        fn.restype = I
        S = t.S
        ptr = (lambda x: None if x is None else x.data_ptr())
        rc = fn(self.seq.data_ptr(), t.ints.data_ptr(),
                t.weights.data_ptr(), ptr(self.bounds), self.out.data_ptr(),
                ptr(self.scratch), t.ints.numel(), t.o_coff, t.o_cls,
                t.o_eidx, t.o_cidx, t.o_cw, t.n_cls, t.n_in, t.n_out,
                B, Li, Lo, S, cfg["W"], cfg["cluster"], cfg["grid"],
                cfg["lanes_emit"], cfg["lanes_closure"],
                int(cfg["form"] == "1d"), int(cfg["rows"] == "shared"),
                _TABLES[cfg["tables"]], int(cfg["idx16"]), int(cfg["swap"]),
                cfg["ncb"], cfg["n_rows"], cfg["n_e"], cfg["n_c"],
                S - 1 if t.reverse else 0, 0 if t.reverse else S - 1,
                int(t.reverse), int(t.maxplus), int(elt == 8), ptr(prof),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("sparse_walk launch failed: CUDA error %d"
                               % rc)
        if prof is not None:
            return self.out
        sparse_walk.launches += 1
        sparse_walk.last = self.last
        return self.out


def sparse_walk(sm, in_toks, out_toks, in_lens, out_lens, viterbi=False,
                reverse=False, cluster=None, rows=None):
    """The sparse engine's token walk for a batch of B pairs.

    in_toks (B, Li) and out_toks (B, Lo): 1-based tokens (0 the empty
    side), padded; in_lens, out_lens (B,): each pair's lengths (arrays,
    lists or tensors). Forward (reverse=False) reads each pair's end
    state S-1; Backward walks the reversed pair with the edges traversed
    dst -> src from S-1 and reads state 0; viterbi: max-plus. Returns the
    (B,) scores, a tensor of sm's dtype on sm's device.

    On a machine on the card this launches csrc/sparse_walk.cu once
    (sparse_launch_plan's layout, on sparse_tables) and counts it in
    `sparse_walk.launches`; `sparse_walk.last` holds the plan and the
    tables' build ms; a failed launch raises. `cluster` and `rows`
    ("global") force the plan's choices. On the CPU each pair takes the
    plain version, ops/sparse.py's eager walk."""
    if sm.device.type == "cpu":
        from ..sparse import _token_walk
        it, ot = _host(in_toks), _host(out_toks)
        il = np.clip(_host(in_lens).reshape(-1), 0, it.shape[1])
        ol = np.clip(_host(out_lens).reshape(-1), 0, ot.shape[1])
        got = [_token_walk(sm, it[b, :il[b]], ot[b, :ol[b]], viterbi,
                           reverse) for b in range(it.shape[0])]
        return torch.tensor(got, dtype=sm._tables[False][2].dtype)
    return WalkCall(sm, in_toks, out_toks, in_lens, out_lens, viterbi,
                    reverse, cluster, rows).launch()


sparse_walk.launches = 0
sparse_walk.last = None

PROFILE_PHASES = ("prologue", "emit", "wait1", "closure", "wait2")


def sparse_walk_profile(call):
    """The launch `call` (a WalkCall) through the profile library (the
    same source built with its clock64 counters; not counted as a launch).
    Returns (the scores, {"cluster", "diagonals" and "rounds" (a warp's
    turns over its states) of the batch, "cycles_a_diagonal": phase: a
    warp's SM cycles a diagonal, averaged over every block's warps,
    "shares": phase: its share of the five}). The phases: the tokens and
    classes; stage 1-2's loads and reduction (1D: and its sends); the
    waits for data (2D: the left neighbour's cell in the inbox and the
    right one's free slot; 1D: the pre-closure vector's bytes); the
    closure (and its sends); the wait after it (2D: the block or cluster
    barrier; 1D: the cell's bytes)."""
    prof = torch.zeros((max(call.cfg["grid"], 1), 2 + len(PROFILE_PHASES)),
                       dtype=torch.int64, device=call.out.device)
    out = call.launch(prof)
    tot = prof.sum(0).cpu().tolist()
    cluster = call.cfg["cluster"]
    diag_warps = max(tot[0], 1) * (THREADS // 32)   # over every block
    cyc = {p: tot[2 + k] / diag_warps for k, p in enumerate(PROFILE_PHASES)}
    whole = sum(cyc.values()) or 1.0
    return out, {"cluster": cluster, "diagonals": tot[0] // cluster,
                 "rounds": tot[1], "cycles_a_diagonal": cyc,
                 "shares": {p: v / whole for p, v in cyc.items()}}


# ---------------------------------------------------------------- CPU twin

def _rows(off, n):
    """Each entry's row of a CSR offsets array (n entries)."""
    return torch.repeat_interleave(torch.arange(len(off) - 1,
                                                device=off.device),
                                   off[1:] - off[:-1], output_size=n)


def _reduce(vals, seg, n_seg, maxplus):
    """The kernel's reduction of terms per state: max-plus the max (-inf
    where a state has no term); logsumexp the max m, guarded to 0 at or
    below NEG_INF / 2, then log(sum exp(v - m)) + m, NEG_INF where the
    sum is 0."""
    top = torch.full((n_seg,), -float("inf"), dtype=vals.dtype,
                     device=vals.device).scatter_reduce_(
        0, seg, vals, "amax", include_self=True)
    if maxplus:
        return top
    safe = torch.where(top > NEG_INF / 2, top, 0.0)
    s = torch.zeros_like(top).index_add_(0, seg, torch.exp(vals - safe[seg]))
    return torch.where(s > 0, torch.log(torch.where(s > 0, s, 1.0)) + safe,
                       NEG_INF)


def sparse_walk_diagonal(tables, in_toks, out_toks, in_lens, out_lens):
    """The kernel's walk in plain PyTorch on `tables` (sparse_tables), on
    their device: sparse_walk's token arguments, the same (B,) scores (the
    kernel's logsumexp in one pass a list, this one's in two: the same sums
    in another order).
    Diagonal by diagonal, over every pair's cells at once: each cell's
    three neighbours' terms gathered from the ring through their classes'
    lists and reduced per scatter-side state (a missing neighbour's values
    NEG_INF, as the eager walk's ring row), the closure's terms reduced
    the same way, then the cell stored."""
    t = tables
    dev, S, mp = t.ints.device, t.S, t.maxplus
    ints = t.ints.long()
    eoff, coff = ints[:t.o_coff], ints[t.o_coff:t.o_cls]
    cls = ints[t.o_cls:t.o_eidx].view(t.n_in, t.n_out)
    eidx, cidx = ints[t.o_eidx:t.o_cidx], ints[t.o_cidx:]
    ew, cw = t.weights[:t.o_cw], t.weights[t.o_cw:]
    erow, crow = _rows(eoff, len(eidx)), _rows(coff, len(cidx))
    ecls, ets = erow // S, erow % S
    it = torch.as_tensor(_host(in_toks), device=dev)
    ot = torch.as_tensor(_host(out_toks), device=dev)
    B, Li, Lo = it.shape[0], it.shape[1], ot.shape[1]
    Lp = torch.as_tensor(_host(in_lens), device=dev).reshape(-1).clamp(0, Li)
    Lq = torch.as_tensor(_host(out_lens), device=dev).reshape(-1) \
        .clamp(0, Lo)
    bi = torch.arange(B, device=dev)

    def tok(seq, b, L, pos):             # the token consumed into pos
        k = (L - pos if t.reverse else pos - 1).clamp(0, max(
            seq.shape[1] - 1, 0))
        v = seq[b, k] if seq.shape[1] else torch.zeros_like(pos)
        return torch.where(pos > 0, v, 0)

    def cls_of(a, b):
        ok = (a >= 0) & (a < t.n_in) & (b >= 0) & (b < t.n_out)
        return torch.where(ok, cls[a.clamp(0, t.n_in - 1),
                                   b.clamp(0, t.n_out - 1)], t.empty)

    ring = torch.full((3, B, Li + 1, S), NEG_INF, dtype=t.weights.dtype,
                      device=dev)
    out = torch.full((B,), NEG_INF, dtype=t.weights.dtype, device=dev)
    start, read = (S - 1, 0) if t.reverse else (0, S - 1)
    for d in range(int((Lp + Lq).max()) + 1 if B else 0):
        ii = torch.arange(min(d, Li) + 1, device=dev)
        b2, i2 = bi[:, None].expand(B, len(ii)), ii.expand(B, len(ii))
        o2 = d - i2
        ok = (o2 >= 0) & (o2 <= Lq[:, None]) & (i2 <= Lp[:, None])
        bi_, iv = b2[ok], i2[ok]
        ov = d - iv
        N = len(bi_)
        if d == 0:
            pre = torch.full((N, S), NEG_INF, dtype=ring.dtype, device=dev)
            pre[:, start] = 0.0
        else:
            x, y = tok(it, bi_, Lp[bi_], iv), tok(ot, bi_, Lq[bi_], ov)
            zero = torch.zeros_like(x)
            nbs = ((cls_of(x, y), iv - 1, (iv >= 1) & (ov >= 1), 2),
                   (cls_of(x, zero), iv - 1, iv >= 1, 1),
                   (cls_of(zero, y), iv, ov >= 1, 1))
            vals, segs = [], []
            for c, src_i, has, back in nbs:
                # every entry of the cell's class: (cell, entry) pairs
                sel = (ecls[None, :] == c[:, None])
                cell, e = torch.nonzero(sel, as_tuple=True)
                src = ring[(d - back) % 3, bi_[cell],
                           src_i[cell].clamp(min=0), eidx[e]]
                src = torch.where(has[cell], src, NEG_INF)
                vals.append(src + ew[e])
                segs.append(cell * S + ets[e])
            pre = _reduce(torch.cat(vals), torch.cat(segs), N * S,
                          mp).view(N, S)
        cell = torch.arange(N, device=dev).repeat_interleave(len(cidx))
        e = torch.arange(len(cidx), device=dev).repeat(N)
        post = _reduce(pre[cell, cidx[e]] + cw[e], cell * S + crow[e],
                       N * S, mp).view(N, S)
        ring[d % 3, bi_, iv] = post
        end = (iv == Lp[bi_]) & (ov == Lq[bi_])
        out[bi_[end]] = post[end, read]
    return out
