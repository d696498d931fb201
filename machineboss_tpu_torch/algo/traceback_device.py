"""Device-side Viterbi traceback: walk the value lattice ON DEVICE.

Counterpart of machineboss_tpu's algo/traceback_device.py. Shipping a whole
value lattice to the host for the traceback costs far more than filling it,
so the lattice is walked at CELL granularity where it lies and only the
visited cells' 4-neighbourhood value vectors come back (O((Li+Lo) * 4S)
floats). The HOST then re-runs its exact traceback (algo/dp_host
.DPMatrix.traceback: per-edge option order, f64 arithmetic) over those
sparse values, so alignment output is identical to the full-readback path
whenever the device walk visits the same cells. If the host walk ever
queries a cell the device did not emit (an exact tie broken differently by
f32-vs-f64 candidate sums), the caller falls back to the full lattice
readback: correctness never depends on the device walk.

The walk mirrors the host option order exactly: candidates are laid out
[match, input-only, output-only, silent] with ascending source state inside
each block, and the first maximum wins, like np.argmax over the host option
list.

Two versions of the walk, with one contract:

- `lattice_walk_plain`: a torch loop over steps, all pairs of a batch at
  once, used on the CPU and as the card's comparison;
- `lattice_walk`: the counted wrapper of the hand-written CUDA kernel
  csrc/lattice_walk.cu (a warp a pair, several pairs a block, all pairs in
  one launch; `walk_launch_plan` lays it out once per walker and batch
  shape). A CUDA tensor launches the kernel or raises; only a CPU tensor
  takes the plain version. `lattice_walk_profile` runs the same source
  built with its clock64 phase profile (a separate library) and returns
  the cycles each phase of a step took. The JAX package has no Pallas kernel here: its walk is a
  jitted `lax.while_loop`, one device invocation; the same loop in eager
  PyTorch is dozens of tiny launches per step.
"""

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.kernels._build import load
from ..ops.kernels.lowrank_kernel import _check
from ..utils.device import resolve_device

NEG_INF = -1e30

# the kernel's layouts (csrc/lattice_walk.cu's Variant): "warp" is the
# design; each other one undoes one of its choices
WALK_VARIANTS = {"warp": 0, "block_barrier": 1, "tokens_global": 2,
                 "prefetch": 3, "edges_shared": 4}
# the profile library's cycle counters a pair, after the step count: in
# the warp layout, "edge" issues the loads that wait on the last move (the
# edge rows and the record's cells), "candidates" writes the record, forms
# the candidates and takes the warp's max (waiting for those loads),
# "argmax" the lowest index holding it, "barrier" the block barrier of that
# variant, "move" the step's state; the prefetch variant's "wait" stores the
# cells loaded a step ahead into the ring and "issue" loads the next ones
PROFILE_PHASES = ("wait", "issue", "edge", "candidates", "argmax",
                  "barrier", "move")
_MAX_PAIRS = 8               # the kernel's warps (pairs) a block
_SMEM_LIMIT = 227 * 1024     # dynamic shared memory a block may take


def maxplus_edge_matrices(ev):
    """Raw (non-closure-folded) per-token max-folded log matrices.

    Returns (a_diag (Ti, To, S, S), a_left (Ti, S, S), a_up (To, S, S),
    sil (S, S)) float32 numpy, NEG_INF for absent edges; parallel edges
    fold by MAX (Viterbi traceback semantics — lowering.log_trans folds
    by logaddexp, which is Forward semantics and would mis-rank
    traceback candidates on machines with parallel edges)."""
    S = ev.n_states()
    Ti = max(ev.input_tokenizer.n_tokens() - 1, 1)
    To = max(ev.output_tokenizer.n_tokens() - 1, 1)
    a_diag = np.full((Ti, To, S, S), NEG_INF)
    a_left = np.full((Ti, S, S), NEG_INF)
    a_up = np.full((To, S, S), NEG_INF)
    sil = np.full((S, S), NEG_INF)
    for (i, o), (src, dst, _, lw) in ev.edges_by_token().items():
        lw = np.where(np.isfinite(lw), lw, NEG_INF)
        if i and o:
            np.maximum.at(a_diag, (i - 1, o - 1, src, dst), lw)
        elif i:
            np.maximum.at(a_left, (i - 1, src, dst), lw)
        elif o:
            np.maximum.at(a_up, (o - 1, src, dst), lw)
        else:
            np.maximum.at(sil, (src, dst), lw)
    # a weight<=0 silent self-loop ties its own cell value and can never
    # be on an optimal simple path; excluding it keeps the walk finite
    np.fill_diagonal(sil, NEG_INF)
    f32 = np.float32
    return a_diag.astype(f32), a_left.astype(f32), a_up.astype(f32), \
        sil.astype(f32)


def silent_chain_depth(ev):
    """Longest silent chain (edges), for the walk-iteration bound."""
    S = ev.n_states()
    silent = ev.edges_by_token().get((0, 0))
    if silent is None:
        return 0
    src, dst, _, _ = silent  # sorted by (dst, src): topological
    depth = np.zeros(S, np.int64)
    for k in range(len(src)):
        if dst[k] != src[k]:
            depth[dst[k]] = max(depth[dst[k]], depth[src[k]] + 1)
    return int(depth.max())


@dataclass
class LatticeWalker:
    """The walk of one machine for pairs of at most (Li_max, Lo_max), on
    one device. The edge matrices are kept destination-major,
    [tok][dst][src]: the candidates into one state are contiguous."""
    S: int
    Ti: int
    To: int
    Li_max: int
    Lo_max: int
    Ncap: int
    max_steps: int
    ad: torch.Tensor     # (Ti, To, S, S)
    al: torch.Tensor     # (Ti, S, S)
    au: torch.Tensor     # (To, S, S)
    sil: torch.Tensor    # (S, S)
    rows: torch.Tensor   # (n_rows + 1, round4(S)): see edge_rows
    plans: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self):
        return self.ad.device


def make_lattice_walker(ev, Li_max, Lo_max, device=None):
    """Build the device cell-walk for one machine and max lengths.

    The lattice argument of the walk is the wavefront slab layout
    (n_diags, W, S), or (n_diags, B, W, S) for a batch: slab d holds cell
    (i, o=d-i) at window index w = i - bases[d] (bases = zeros for a full
    lattice; the banded fill's window bases otherwise).

    The walk returns (n_cells, ij (Ncap, 2) i32, vals (Ncap, 4, S) f32, ok)
    per pair, where vals[k] = [cell, diag-neighbor, left-neighbor,
    up-neighbor] value vectors of the k-th distinct visited cell ij[k], in
    visit (end-to-start) order; ok=False means the walk got stuck or
    overran its iteration bound Ncap * (1 + silent_chain_depth) and the
    caller must fall back to full readback. `device` None means the card."""
    dev = resolve_device(device)
    ad, al, au, sil = maxplus_edge_matrices(ev)
    Ncap = Li_max + Lo_max + 2

    def dst_major(m):
        return torch.from_numpy(np.ascontiguousarray(
            np.swapaxes(m, -1, -2))).to(dev)

    return LatticeWalker(
        S=ev.n_states(), Ti=ad.shape[0], To=ad.shape[1], Li_max=Li_max,
        Lo_max=Lo_max, Ncap=Ncap,
        max_steps=Ncap * (1 + silent_chain_depth(ev)),
        ad=dst_major(ad), al=dst_major(al), au=dst_major(au),
        sil=dst_major(sil),
        rows=torch.from_numpy(edge_rows(ad, al, au, sil)).to(dev))


def edge_rows(ad, al, au, sil):
    """The kernel's edge table: every destination state's row of incoming
    weights, in the order ad's rows (tx, ty, dst), al's (tx, dst), au's
    (ty, dst), sil's dst, as (n_rows + 1, round4(S)) float32 padded with
    NEG_INF (a row is 16-byte aligned; the last row, all NEG_INF, is what
    the kernel reads for a cell outside the lattice)."""
    S = sil.shape[0]
    rows = np.concatenate([np.swapaxes(m, -1, -2).reshape(-1, S)
                           for m in (ad, al, au, sil)])
    padded = np.full((len(rows) + 1, _round4(S)), NEG_INF, np.float32)
    padded[:-1, :S] = rows
    return padded


def lattice_walk_plain(walker, lat, bases, in_toks, out_toks, in_lens,
                       out_lens):
    """Plain PyTorch version of the walk: one loop over steps for all B
    pairs. Arguments and results as lattice_walk."""
    nd, B, W, S = lat.shape
    dev = lat.device
    Ncap, max_steps = walker.Ncap, walker.max_steps
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    bases = bases.long()
    xt, yt = in_toks.long(), out_toks.long()
    Lip, Lop = xt.shape[1], yt.shape[1]
    li, lo = in_lens.long(), out_lens.long()
    b_idx = torch.arange(B, device=dev)

    def get_cell(i, o):
        d = torch.clamp(i + o, 0, nd - 1)
        w = i - bases[d]
        v = lat[d, b_idx, torch.clamp(w, 0, W - 1)]
        ok = (i >= 0) & (o >= 0) & (i <= li) & (o <= lo) & (w >= 0) & (w < W)
        return torch.where(ok[:, None], v.float(), neg)

    i, o = li.clone(), lo.clone()
    s = torch.full((B,), S - 1, dtype=torch.long, device=dev)
    n = torch.zeros(B, dtype=torch.long, device=dev)
    step = torch.zeros(B, dtype=torch.long, device=dev)
    done = (li == 0) & (lo == 0) & (S == 1)
    stuck = torch.zeros(B, dtype=torch.bool, device=dev)
    pi = torch.full((B,), -1, dtype=torch.long, device=dev)
    po = pi.clone()
    ij = torch.full((B, Ncap, 2), -1, dtype=torch.int32, device=dev)
    vals = torch.full((B, Ncap, 4, S), NEG_INF, dtype=torch.float32,
                      device=dev)
    while True:
        act = ~done & (step < max_steps) & (n < Ncap)
        if not bool(act.any()):
            break
        cur, cdg = get_cell(i, o), get_cell(i - 1, o - 1)
        clf, cup = get_cell(i - 1, o), get_cell(i, o - 1)
        ab, an = b_idx[act], n[act]
        vals[ab, an] = torch.stack([cur, cdg, clf, cup], dim=1)[act]
        ij[ab, an] = torch.stack([i, o], dim=1)[act].to(torch.int32)
        n2 = n + ((i != pi) | (o != po)).long()

        tx = torch.clamp(xt[b_idx, torch.clamp(i - 1, 0, Lip - 1)], 0,
                         walker.Ti - 1)
        ty = torch.clamp(yt[b_idx, torch.clamp(o - 1, 0, Lop - 1)], 0,
                         walker.To - 1)
        cd = torch.where(((i > 0) & (o > 0))[:, None],
                         cdg + walker.ad[tx, ty, s], neg)
        cl = torch.where((i > 0)[:, None], clf + walker.al[tx, s], neg)
        cu = torch.where((o > 0)[:, None], cup + walker.au[ty, s], neg)
        cs = cur + walker.sil[s]
        opts = torch.cat([cd, cl, cu, cs], dim=1)      # host option order
        best = torch.argmax(opts, dim=1)               # first maximum
        bad = opts[b_idx, best] <= NEG_INF / 2
        case = best // S
        src = best % S
        i2 = torch.where(bad, i, i - ((case == 0) | (case == 1)).long())
        o2 = torch.where(bad, o, o - ((case == 0) | (case == 2)).long())
        s2 = torch.where(bad, s, src)
        done2 = ((i2 == 0) & (o2 == 0) & (s2 == 0)) | bad
        pi, po = torch.where(act, i, pi), torch.where(act, o, po)
        i, o, s = (torch.where(act, i2, i), torch.where(act, o2, o),
                   torch.where(act, s2, s))
        n = torch.where(act, n2, n)
        step = step + act.long()
        stuck = stuck | (act & bad)
        done = torch.where(act, done2, done)
    ok = done & ~stuck & (i == 0) & (o == 0) & (s == 0)
    return n.to(torch.int32), ij, vals, ok


def _round4(x):
    return (x + 3) & ~3


def walk_smem_bytes(S, Ti, To, nd, Lip, Lop, pairs, staged, variant="warp"):
    """Shared bytes of one block of the walk kernel, as
    csrc/lattice_walk.cu lays them out: when `staged`, the nd bases once a
    block and per pair the pair's tokens (not the "tokens_global"
    variant's); per pair a ring of 9 lattice cells for the "prefetch"
    variant; the left, up and silent edge rows once a block for the
    "edges_shared" variant."""
    Sp = _round4(S)
    edges = (Ti + To + 1) * S * Sp if variant == "edges_shared" else 0
    block = _round4(nd) if staged else 0
    tok = staged and variant != "tokens_global"
    per_pair = ((9 * Sp if variant == "prefetch" else 0)
                + (_round4(Lip) + _round4(Lop) if tok else 0))
    return 4 * (edges + block + pairs * per_pair)


def walk_launch_plan(S, Ti, To, nd, Lip, Lop, B, n_sm, variant="warp",
                     pairs=None):
    """The walk kernel's layout for B pairs on a card of n_sm
    multiprocessors: {"variant", "pairs" (a block), "blocks", "staged",
    "smem" (bytes)}. A warp walks a pair; a block takes enough pairs that
    the batch is one wave of blocks (at most 8). The diagonal bases and
    the pairs' tokens are staged in shared memory, with fewer pairs a
    block if that is what fits; where not even one pair's fit (a banded
    pair of two 30 kb sequences has 60,001 diagonals), the default layout
    reads them from global memory, so that every length has a layout, and
    a variant raises ValueError."""
    if variant not in WALK_VARIANTS:
        raise ValueError("walk variant must be one of %s, not %r"
                         % (sorted(WALK_VARIANTS), variant))
    if pairs is not None and not 1 <= pairs <= _MAX_PAIRS:
        raise ValueError("pairs a block must lie in [1, %d]" % _MAX_PAIRS)
    want = pairs or min(_MAX_PAIRS, max(-(-B // max(n_sm, 1)), 1))
    for P in range(want, 0 if pairs is None else want - 1, -1):
        nbytes = walk_smem_bytes(S, Ti, To, nd, Lip, Lop, P, True, variant)
        if nbytes <= _SMEM_LIMIT:
            return {"variant": variant, "pairs": P, "blocks": -(-B // P),
                    "staged": True, "smem": nbytes}
    if variant == "warp":
        return {"variant": variant, "pairs": want, "blocks": -(-B // want),
                "staged": False, "smem": 0}
    raise ValueError("lattice walk: S=%d, variant %s needs %d bytes of "
                     "shared memory a block, over the %d a block may take"
                     % (S, variant, nbytes, _SMEM_LIMIT))


_launchers = {}     # library name -> its lattice_walk_launch, argtypes set


def _launcher(lib):
    if lib not in _launchers:
        fn = load(lib).lattice_walk_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 12 + [I] * 14 + [P]
        fn.restype = I
        _launchers[lib] = fn
    return _launchers[lib]


def _walk_on_card(walker, lat, bases, in_toks, out_toks, in_lens, out_lens,
                  variant, pairs, profile):
    dev = walker.device
    nd, B, W, S = lat.shape
    if S != walker.S:
        raise ValueError("lattice has %d states, the walker %d"
                         % (S, walker.S))
    Lip, Lop = max(walker.Li_max, 1), max(walker.Lo_max, 1)
    _check(lat, "lat", torch.float32, (nd, B, W, S), dev)
    _check(bases, "bases", torch.int32, (nd,), dev)
    _check(in_toks, "in_toks", torch.int32, (B, Lip), dev)
    _check(out_toks, "out_toks", torch.int32, (B, Lop), dev)
    _check(in_lens, "in_lens", torch.int32, (B,), dev)
    _check(out_lens, "out_lens", torch.int32, (B,), dev)
    key = (B, nd, variant, pairs)
    plan = walker.plans.get(key)
    if plan is None:
        if "n_sm" not in walker.plans:
            walker.plans["n_sm"] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        plan = walker.plans[key] = walk_launch_plan(
            S, walker.Ti, walker.To, nd, Lip, Lop, B, walker.plans["n_sm"],
            variant, pairs)
    Ncap = walker.Ncap
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    ij = torch.full((B, Ncap, 2), -1, dtype=torch.int32, device=dev)
    vals = torch.full((B, Ncap, 4, S), NEG_INF, dtype=torch.float32,
                      device=dev)
    ok = torch.zeros(B, dtype=torch.int32, device=dev)
    prof = torch.zeros((B, 1 + len(PROFILE_PHASES)), dtype=torch.int64,
                       device=dev) if profile else None
    fn = _launcher("lattice_walk_profile" if profile else "lattice_walk")
    ptrs = [lat, bases, in_toks, out_toks, in_lens, out_lens, walker.rows,
            n, ij, vals, ok]
    rc = fn(*[t.data_ptr() for t in ptrs],
            prof.data_ptr() if profile else None, B, W, nd, S, walker.Ti,
            walker.To, Lip, Lop, Ncap, walker.max_steps, plan["pairs"],
            int(plan["staged"]), WALK_VARIANTS[variant], plan["smem"],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("lattice_walk launch failed: CUDA error %d" % rc)
    return (n, ij, vals, ok.bool()), prof


def lattice_walk(walker, lat, bases, in_toks, out_toks, in_lens, out_lens,
                 variant="warp", pairs=None):
    """Walk B pairs' lattices on their device.

    lat (n_diags, B, W, S) float32; bases (n_diags,) int32, shared by the
    pairs; in_toks (B, max(Li_max, 1)), out_toks (B, max(Lo_max, 1)) int32,
    0-based and padded; in_lens, out_lens (B,) int32. All contiguous on the
    walker's device. Returns tensors (n (B,) i32, ij (B, Ncap, 2) i32, vals
    (B, Ncap, 4, S) f32, ok (B,) bool).

    A CUDA tensor launches csrc/lattice_walk.cu once for all B pairs, laid
    out by walk_launch_plan (`variant`, `pairs` a block: see there), and
    counts it in `lattice_walk.launches`; a CPU tensor takes
    lattice_walk_plain."""
    if lat.device.type == "cpu":
        return lattice_walk_plain(walker, lat, bases, in_toks, out_toks,
                                  in_lens, out_lens)
    if lat.device.type != "cuda":
        raise ValueError("lattice_walk runs on cuda or cpu tensors, not %s"
                         % lat.device)
    out, _ = _walk_on_card(walker, lat, bases, in_toks, out_toks, in_lens,
                           out_lens, variant, pairs, False)
    lattice_walk.launches += 1
    return out


lattice_walk.launches = 0


def lattice_walk_profile(walker, lat, bases, in_toks, out_toks, in_lens,
                         out_lens, variant="warp", pairs=None):
    """lattice_walk on the card through the profile library (the same
    source built with its clock64 counters; not counted as a launch).
    Returns (the records, {"steps" over the pairs, "max_steps" of one
    pair, phase: SM cycles a step})."""
    out, prof = _walk_on_card(walker, lat, bases, in_toks, out_toks,
                              in_lens, out_lens, variant, pairs, True)
    tot = prof.sum(dim=0).cpu().tolist()
    steps = max(tot[0], 1)
    return out, dict({"steps": tot[0], "max_steps": int(prof[:, 0].max())},
                     **{p: tot[1 + k] / steps
                        for k, p in enumerate(PROFILE_PHASES)})


def walk_tensors(walker, bases, in_toks, out_toks):
    """lattice_walk's index arguments on the walker's device, from host
    data: bases (n_diags,) integers and lists of B 0-based token sequences
    (their lengths are the pairs' lengths). Token arrays are padded to the
    walker's max lengths (>= 1) so zero-length sequences and shorter batch
    members stay indexable. Returns [bases, in_toks, out_toks, in_lens,
    out_lens] int32 tensors."""
    def padded(toks_list, L):
        out = np.zeros((len(toks_list), max(L, 1)), np.int32)
        for b, t in enumerate(toks_list):
            out[b, :len(t)] = np.asarray(t, np.int32)
        return out

    arrs = (np.asarray(bases), padded(in_toks, walker.Li_max),
            padded(out_toks, walker.Lo_max), [len(t) for t in in_toks],
            [len(t) for t in out_toks])
    return [torch.from_numpy(np.ascontiguousarray(x, np.int32))
            .to(walker.device) for x in arrs]


def run_walker_batch(walker, lat, bases, in_toks, out_toks):
    """Walk a batch: lat (n_diags, B, W, S) on the walker's device; bases,
    in_toks, out_toks as walk_tensors takes them. Returns per pair the
    host-side (n_cells, ij ndarray, vals ndarray, ok)."""
    n, ij, vals, ok = lattice_walk(
        walker, lat.contiguous(),
        *walk_tensors(walker, bases, in_toks, out_toks))
    n, ij, vals, ok = (x.cpu().numpy() for x in (n, ij, vals, ok))
    return [(int(n[b]), ij[b], vals[b], bool(ok[b]))
            for b in range(len(in_toks))]


def run_walker(walk, lat, bases, in_toks, out_toks, li, lo):
    """Run the device walk of ONE pair, lat (n_diags, W, S), with the
    walker `walk` (make_lattice_walker's), and return host-side (n_cells,
    ij ndarray, vals ndarray, ok)."""
    return run_walker_batch(
        walk, lat[:, None], bases,
        [np.asarray(in_toks, np.int32)[:li]],
        [np.asarray(out_toks, np.int32)[:lo]])[0]


def sparse_cells_from_records(n_cells, ij, vals):
    """{(i, o): (S,) float64} from walker records: each record carries the
    cell itself plus its diag/left/up neighbors (exactly the cells the
    host traceback will query along the same path)."""
    cells = {}
    for k in range(n_cells):
        i, o = int(ij[k, 0]), int(ij[k, 1])
        for (di, do, r) in ((0, 0, 0), (-1, -1, 1), (-1, 0, 2), (0, -1, 3)):
            ci, co = i + di, o + do
            if ci >= 0 and co >= 0 and (ci, co) not in cells:
                cells[(ci, co)] = np.asarray(vals[k, r], np.float64)
    return cells
