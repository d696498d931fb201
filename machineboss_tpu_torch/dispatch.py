"""Auto-dispatching DP front end: the port's `CompiledMachine`.

Counterpart of machineboss_tpu's dispatch.py: the single-pair
log_forward/log_viterbi/log_backward_lattice with strategy='auto', and the
batched log_forward_batch with its padding and its router.

Single-pair strategy ('auto'):
  - machine too large to densify        -> sparse COO engine (ops/sparse)
  - 1D (one side empty), long sequence  -> associative scan (log depth)
  - 1D short / large S                  -> sequential scan
  - 2D                                  -> row scan (ops/dp2d)
The 1D rule reads the measured thresholds of the machine's device type:
`cuda` from dispatch_table_cuda.json, which autotune_dispatch.py measured
on the card, `cpu` from dispatch_table.json, the JAX package's table
(never assoc). A device type without a row takes the default rule, assoc
when L >= 256 and S <= 64.

log_forward_batch, dense machines:
  - structured 2D machines (lowrank_cost_ratio < 0.6, e.g. GeneWise
    prot2dna) -> the lowrank wavefront;
  - full-rank 2D machines -> the merged wavefront, or the ragged schedule
    (chained_ragged) when the batch is ragged, B % 8 == 0 and no sequence
    is empty;
  - 1D machines (exactly one empty side) -> the 1D scan;
  - engine="wavefront" -> the torch wavefront engine (ops/wavefront_fast).
Non-dense machines take the sparse engine, as in the JAX package, whose
class loops over them pair by pair; here the batch is one call of the
sparse walk (one kernel launch on the card).

Each kernel route launches its CUDA kernel on the card and runs the
kernel's plain PyTorch version on the CPU. With engine="auto" the CPU
takes, as the JAX package does off its accelerator, the wavefront engine
for every dense 2D machine, structured or full-rank, and the sequential
scan (ops/dp1d) for 1D ones; engine="kernel" forces the kernel routes on
any device.
"""

import json
import os

import numpy as np
import torch

from .core.eval import EvaluatedMachine
from .core.machine import Machine
from .core.params import Params
from .ops import dp1d, dp2d
from .ops import sparse as sparse_mod
from .ops.fwdback import pad_bucket
from .ops.kernels.lowrank_kernel import lowrank_cost_ratio
from .ops.kernels.scan1d_kernel import make_forward_1d_kernel
from .ops.kernels.wavefront_kernel import make_wavefront_forward, ragged_span
from .ops.lowering import LoweredMachine
from .ops.semiring import LOGSUMEXP, MAXPLUS
from .ops.wavefront_fast import forward_2d_wavefront_fast
from .utils.debug import check_finite
from .utils.device import resolve_device

DENSE_MAX_STATES = 512
LOWRANK_MAX_RATIO = 0.6


def _read_row(path, device_type):
    """The row of `device_type` in the table file at `path`, or None."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if "backends" in doc:
        return doc["backends"].get(device_type)
    return doc if doc.get("backend") == device_type else None


def _load_dispatch_table(device_type):
    """Measured engine thresholds, keyed by backend. The port's own
    dispatch_table_<device type>.json (autotune_dispatch.py, run on that
    device) comes first; else dispatch_table.json, the JAX package's
    table (rows `cpu` and `tpu`). Returns the row for `device_type`
    ("cpu" or "cuda") when one was recorded, else None (the default rule
    applies)."""
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("dispatch_table_%s.json" % device_type,
                 "dispatch_table.json"):
        row = _read_row(os.path.join(here, name), device_type)
        if row is not None:
            return row
    return None


def _check_engine(engine):
    if engine not in ("auto", "kernel", "pallas", "wavefront"):
        raise ValueError("engine must be 'auto', 'kernel' (or 'pallas') or "
                         "'wavefront', not %r" % (engine,))


class CompiledMachine:
    """A machine prepared for repeated device DP calls on `device` (None:
    the CUDA card, raising when CUDA is absent; "cpu" runs the plain
    PyTorch versions)."""

    # the dispatch tables' rows, read once per device type: a process may
    # hold CPU and CUDA machines at once
    _dispatch_tables = {}

    def __init__(self, machine, params=None, dtype=np.float32,
                 dense_max_states=DENSE_MAX_STATES, device=None):
        self.device = resolve_device(device)
        if not isinstance(machine, Machine):
            machine = Machine.from_file(machine) if isinstance(machine, str) \
                else Machine.from_json(machine)
        if params is None:
            params = machine.get_param_defs(True)
        elif not isinstance(params, Params):
            from .core.params import param_assign_from_json
            params = param_assign_from_json(params)
        self.machine = machine
        self.ev = EvaluatedMachine(machine, params)
        self.lowered = LoweredMachine(self.ev, dtype=dtype,
                                      dense_max_states=dense_max_states)
        self.is_dense = self.lowered.is_dense
        self.last_route = None
        self._cache = {}

    # -- tokenization helpers ----------------------------------------------

    def in_toks(self, seq):
        return [self.ev.input_tokenizer.sym2tok[c] - 1 for c in seq]

    def out_toks(self, seq):
        return [self.ev.output_tokenizer.sym2tok[c] - 1 for c in seq]

    # -- single pairs ------------------------------------------------------

    def _strategy(self, n_in, n_out, strategy, device_type=None):
        """The engine of a single-pair call: the sparse engine for a
        non-dense machine; for a 1D machine "assoc" or "scan" by the
        measured table of `device_type` (default: this machine's), else
        the default rule; "rows" for a 2D machine."""
        if strategy != "auto":
            return strategy
        if not self.is_dense:
            return "sparse"
        kind = self.device.type if device_type is None else device_type
        tables = CompiledMachine._dispatch_tables
        if kind not in tables:
            tables[kind] = _load_dispatch_table(kind)
        table = tables[kind]
        one_d = self.machine.input_empty() or self.machine.output_empty()
        if one_d:
            S = self.ev.n_states()
            L = max(n_in, n_out)
            if table:
                # measured: smallest L where the log-depth assoc scan beat
                # the sequential scan for the nearest measured S
                by_s = table["derived"]["assoc_min_L_by_S"]
                if by_s:
                    keys = sorted(int(k) for k in by_s)
                    nearest = min(keys, key=lambda k: abs(k - S))
                    return "assoc" if L >= by_s[str(nearest)] else "scan"
                return "scan"          # assoc never won on this backend
            # unmeasured device type: the JAX package's conservative guess,
            # with an S cap for the assoc scan's cost at large S
            return "assoc" if (L >= 256 and S <= 64) else "scan"
        return "rows"

    def _device_mats(self, key, make):
        """make()'s host matrices as float32 tensors on the device, cached
        under `key` (float32 whatever the lowering's dtype, as the JAX
        package's arrays are)."""
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(x, np.float32))
                .to(self.device) for x in make())
        return self._cache[key]

    def log_forward(self, input_seq, output_seq, strategy="auto",
                    viterbi=False):
        """Forward (or Viterbi) log-likelihood of one sequence pair, a
        float. As in the JAX package, the sparse engine scores Forward
        whatever `viterbi` is. `last_route` names the strategy taken."""
        sr = MAXPLUS if viterbi else LOGSUMEXP
        sr_name = sr.name
        it = self.in_toks(input_seq)
        ot = self.out_toks(output_seq)
        strat = self._strategy(len(it), len(ot), strategy)
        self.last_route = strat

        if strat == "sparse":
            return check_finite("forward_2d_sparse",
                                sparse_mod.forward_2d_sparse(
                                    self._sparse_machine(),
                                    [t + 1 for t in it],
                                    [t + 1 for t in ot]))

        if strat in ("scan", "assoc"):
            out_side = self.machine.input_empty()
            trans, closure = self._device_mats(
                ("1d", out_side, sr_name),
                lambda: self.lowered.emit_matrices_1d(output_side=out_side,
                                                      semiring=sr_name))
            toks = torch.tensor(ot if out_side else it, dtype=torch.long,
                                device=self.device)
            fn = dp1d.forward_1d_assoc if strat == "assoc" \
                else dp1d.forward_1d_scan
            return check_finite("forward_1d", float(
                fn(trans, closure, toks, len(toks), sr=sr)))

        mats = self._device_mats(("2d_dev", sr_name),
                                 lambda: self.lowered.matrices_2d(sr_name))
        return check_finite("forward_2d", float(dp2d.forward_2d(
            *mats, torch.tensor(it, dtype=torch.long, device=self.device),
            torch.tensor(ot, dtype=torch.long, device=self.device),
            len(it), len(ot), sr=sr)))

    def _sparse_machine(self):
        if "sparse" not in self._cache:
            self._cache["sparse"] = sparse_mod.SparseMachine(
                self.ev, device=self.device)
        return self._cache["sparse"]

    def _log_forward_batch_sparse(self, pairs):
        """The sparse engine's Forward of every pair in one sparse_walk
        call (one kernel launch on the card; the eager walk pair by pair
        on the CPU): what log_forward gives pair by pair."""
        from .ops.kernels.sparse_kernel import pad_tokens, sparse_walk
        it, il = pad_tokens([[t + 1 for t in self.in_toks(i)]
                             for i, _ in pairs])
        ot, ol = pad_tokens([[t + 1 for t in self.out_toks(o)]
                             for _, o in pairs])
        lls = sparse_walk(self._sparse_machine(), it, ot, il, ol)
        return check_finite("forward_2d_sparse",
                            lls.cpu().numpy().astype(np.float64))

    def log_viterbi(self, input_seq, output_seq, strategy="auto"):
        return self.log_forward(input_seq, output_seq, strategy,
                                viterbi=True)

    def log_backward_lattice(self, input_seq, output_seq):
        """The Backward lattice of one pair, (Lo+1, Li+1, S) on the
        machine's device (ops/dp2d.backward_2d_lattice)."""
        mats = self._device_mats(("2d_dev", "logsumexp"), self._host_mats)
        return dp2d.backward_2d_lattice(
            *mats, torch.tensor(self.in_toks(input_seq), dtype=torch.long,
                                device=self.device),
            torch.tensor(self.out_toks(output_seq), dtype=torch.long,
                         device=self.device))

    # -- routing -----------------------------------------------------------

    def _host_mats(self):
        if "2d" not in self._cache:
            self._cache["2d"] = tuple(np.asarray(x) for x in
                                      self.lowered.matrices_2d())
        return self._cache["2d"]

    def lowrank_ratio(self):
        """lowrank_cost_ratio of this machine (cached)."""
        if "lowrank_ratio" not in self._cache:
            self._cache["lowrank_ratio"] = lowrank_cost_ratio(
                *self._host_mats())[0]
        return self._cache["lowrank_ratio"]

    def route(self, engine="auto"):
        """The engine log_forward_batch takes for a dense 2D machine:
        'lowrank', 'fullrank' (the merged kernel or, by the batch, the
        ragged schedule) or 'wavefront'.

        engine: 'auto' takes the kernel routes on the card and, on the
        CPU, the wavefront engine for every dense 2D machine, as the JAX
        package does off its accelerator; 'kernel' (alias 'pallas', the
        JAX package's name for it) forces the kernel routes on any device;
        'wavefront' forces the torch wavefront engine."""
        _check_engine(engine)
        if engine == "wavefront" or (engine == "auto"
                                     and self.device.type == "cpu"):
            return "wavefront"
        if self.lowrank_ratio() < LOWRANK_MAX_RATIO:
            return "lowrank"
        return "fullrank"

    def log_forward_batch(self, pairs, engine="auto", pad_multiple=16,
                          bucket=False):
        """Batched Forward over [(input_seq, output_seq), ...] on the
        machine's device. Sequences are right-padded to a shared bucket
        (pad_bucket(max length, base=pad_multiple)); per-sequence lengths
        mask the padding. Returns a numpy (B,) array of log-likelihoods.

        engine: see `route`. bucket=True groups batches of >= 64 ragged
        pairs by length bucket and runs one call per group, as the JAX
        package does. Machines with exactly one empty side take the 1D
        scan, which pads every sequence to the batch's longest (no
        bucketing); engine='wavefront' keeps them on the 2D wavefront
        engine. A non-dense machine takes the sparse engine, the whole
        batch in one call of its walk (log_forward's scores, pair by
        pair). `last_route` names the route the call took."""
        if not self.is_dense:
            res = self._log_forward_batch_sparse(pairs)
            self.last_route = "sparse"
            return res
        one_d = self.machine.input_empty() != self.machine.output_empty()
        if one_d and engine != "wavefront":
            return self._log_forward_batch_1d(pairs, pad_multiple, engine)
        toks = [(self.in_toks(i), self.out_toks(o)) for i, o in pairs]
        if bucket and len(toks) >= 64:
            return self._log_forward_batch_bucketed(toks, engine,
                                                    pad_multiple)
        return self._log_forward_batch_padded(toks, engine, pad_multiple)

    def _log_forward_batch_1d(self, pairs, pad_multiple, engine):
        _check_engine(engine)
        out_side = self.machine.input_empty()
        seqs = [self.out_toks(o) if out_side else self.in_toks(i)
                for i, o in pairs]
        B = len(seqs)
        L = pad_bucket(max((len(s) for s in seqs), default=1),
                       base=pad_multiple)
        toks = np.zeros((B, L), np.int32)
        lens = np.zeros(B, np.int32)
        for n, sq in enumerate(seqs):
            toks[n, :len(sq)] = sq
            lens[n] = len(sq)
        key = ("1d_mats", out_side)
        if key not in self._cache:
            self._cache[key] = tuple(
                np.asarray(x) for x in self.lowered.emit_matrices_1d(
                    output_side=out_side))
        trans, closure = self._cache[key]
        dev = self.device
        if dev.type == "cuda" or engine != "auto":
            self.last_route = "scan1d"
            pkey = ("1d_kernel", out_side, B, L)
            if pkey not in self._cache:
                self._cache[pkey] = make_forward_1d_kernel(
                    trans, closure, B, L, device=dev)
            return check_finite("log_forward_batch_1d",
                                self._cache[pkey](toks, lens))
        self.last_route = "scan"
        fn = dp1d.make_batched(dp1d.forward_1d_scan)
        res = fn(torch.from_numpy(trans).to(dev),
                 torch.from_numpy(closure).to(dev),
                 torch.from_numpy(toks).to(dev),
                 torch.from_numpy(lens).to(dev))
        return check_finite("log_forward_batch_1d", res.cpu().numpy())

    def _log_forward_batch_bucketed(self, toks, engine, pad_multiple):
        B = len(toks)
        min_group = max(16, B // 16)
        shapes = [(pad_bucket(len(ti), base=pad_multiple),
                   pad_bucket(len(to), base=pad_multiple))
                  for ti, to in toks]
        groups = {}
        for n, s in enumerate(shapes):
            groups.setdefault(s, []).append(n)
        # merge under-filled groups forward. Sorting is by total padded
        # lattice area, and a carried group only merges into a bucket
        # that DOMINATES it in both dimensions — a lexicographic sort on
        # (Li, Lo) could otherwise fold a large-Lo group into a
        # smaller-Lo bucket and inflate the merged lattice beyond either
        # original (results would still be right — the padded call
        # recomputes pads from actual max lengths — but the padding win
        # would be lost)
        order = sorted(groups, key=lambda s: (s[0] * s[1], s))
        merged = []
        carry = []
        for i, s in enumerate(order):
            if carry and not all(s[d] >= max(shapes[n][d] for n in carry)
                                 for d in (0, 1)):
                # next bucket does not dominate the carried pairs: flush
                # them as their own (under-filled) group
                cs = (max(shapes[n][0] for n in carry),
                      max(shapes[n][1] for n in carry))
                merged.append((cs, carry))
                carry = []
            idxs = carry + groups[s]
            carry = []
            if len(idxs) < min_group and i + 1 < len(order):
                carry = idxs
            else:
                merged.append((s, idxs))
        if carry:
            cs = (max(shapes[n][0] for n in carry),
                  max(shapes[n][1] for n in carry))
            if merged and all(merged[-1][0][d] >= cs[d] for d in (0, 1)):
                s, idxs = merged[-1]
                merged[-1] = (s, idxs + carry)
            else:
                merged.append((cs, carry))
        out = np.empty(B)
        for _, idxs in merged:
            sub = [toks[n] for n in idxs]
            # pad group size to a power of two (repeat the first pair)
            gb = 1
            while gb < len(sub):
                gb *= 2
            padded = sub + [sub[0]] * (gb - len(sub))
            vals = self._log_forward_batch_padded(padded, engine,
                                                  pad_multiple)
            out[np.array(idxs)] = vals[:len(sub)]
        return out

    def _log_forward_batch_padded(self, toks, engine, pad_multiple):
        B = len(toks)
        Li = pad_bucket(max((len(t[0]) for t in toks), default=1),
                        base=pad_multiple)
        Lo = pad_bucket(max((len(t[1]) for t in toks), default=1),
                        base=pad_multiple)
        it = np.zeros((B, Li), np.int32)
        ot = np.zeros((B, Lo), np.int32)
        il = np.zeros(B, np.int32)
        ol = np.zeros(B, np.int32)
        for n, (ti, to) in enumerate(toks):
            it[n, :len(ti)] = ti
            ot[n, :len(to)] = to
            il[n] = len(ti)
            ol[n] = len(to)

        dev = self.device
        batch = [torch.from_numpy(x).to(dev) for x in (it, ot, il, ol)]
        route = self.route(engine)
        if route == "wavefront":
            self.last_route = "wavefront"
            res = forward_2d_wavefront_fast(
                *self._device_mats(("2d_dev", "logsumexp"), self._host_mats),
                *batch)
            return check_finite("log_forward_batch", res.cpu().numpy())
        # structured machines take the closure-folded min-rank kernel;
        # full-rank machines the merged kernel family: the ragged schedule
        # when the batch is ragged and chainable, plain merged otherwise
        variant = "lowrank" if route == "lowrank" else None
        chain = None
        hint = None
        is_ragged = bool((il != il[0]).any() or (ol != ol[0]).any())
        if (variant is None and is_ragged and B % 8 == 0
                and Li >= 1 and Lo >= 1 and il.min() >= 1
                and ol.min() >= 1):
            variant = "chained_ragged"
            chain = 8
            # bucket the span so the cache survives small changes of the
            # length profile
            hint = -(-ragged_span(il, ol, chain) // 64) * 64
        self.last_route = variant or "merged"
        key = ("kernel", B, Li, Lo, variant, chain, hint)
        if key not in self._cache:
            self._cache[key] = make_wavefront_forward(
                *self._host_mats(), B, Li, Lo, device=dev, merged=True,
                variant=variant, chain=chain, n_abs_hint=hint)
        res = self._cache[key](*batch)
        return check_finite("log_forward_batch", res.cpu().numpy())


def log_forward(machine, input_seq, output_seq, params=None,
                strategy="auto", device=None):
    return CompiledMachine(machine, params, device=device).log_forward(
        input_seq, output_seq, strategy)


def log_viterbi(machine, input_seq, output_seq, params=None,
                strategy="auto", device=None):
    return CompiledMachine(machine, params, device=device).log_viterbi(
        input_seq, output_seq, strategy)
