"""Device-filled Viterbi: MAXPLUS lattice on the device, traceback on host.

Counterpart of machineboss_tpu's algo/viterbi_device.py. The
O(Li*Lo*S^2) Viterbi fill runs on the device (max-plus semiring; the
max-plus silent closure is the host DAG-DP closure of
ops/lowering.closure_for); the O(path) traceback walks the values with the
SAME host machinery as the host ViterbiMatrix
(algo/dp_host.DPMatrix.traceback), so alignment output is identical to the
host engine by construction of the recurrence and differs only by
f32-vs-f64 fill noise at exact ties.

By default the lattice never leaves the device: it is walked there
(algo/traceback_device) and only the path's neighbourhood comes back.
"""

import numpy as np
import torch

from .dp_host import DPMatrix, NEG_INF
from ..ops.lowering import LoweredMachine
from ..utils.debug import check_finite
from ..utils.device import resolve_device


class DeviceViterbiMatrix(DPMatrix):
    """Drop-in for algo/dp_host.ViterbiMatrix with the fill on device.

    Accepts an optional pre-built LoweredMachine (reuse across pairs) and
    an optional `fill_fn(in_toks0, out_toks0) -> (Li+1, Lo+1, S) ndarray`
    override (e.g. the wavefront Viterbi kernel). `device` None means the
    card; it is used only by the default fill."""

    def __init__(self, ev, seq_pair, lowered=None, fill_fn=None,
                 dtype=np.float32, device=None):
        super().__init__(ev, seq_pair)
        it0 = np.array(self.input, np.int32) - 1      # device tokens 0-based
        ot0 = np.array(self.output, np.int32) - 1
        if fill_fn is None:
            from ..ops import dp2d
            from ..ops.semiring import MAXPLUS
            dev = resolve_device(device)
            lm = lowered if lowered is not None else \
                LoweredMachine(ev, dtype=dtype)
            mats = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                    for x in lm.matrices_2d("maxplus"))
            lattice = dp2d.forward_2d_lattice(
                *mats, torch.from_numpy(it0).to(dev),
                torch.from_numpy(ot0).to(dev), sr=MAXPLUS) \
                .permute(1, 0, 2).cpu().numpy()        # -> (Li+1, Lo+1, S)
        else:
            # fill_fn contract: (Li+1, Lo+1, S)
            lattice = np.asarray(fill_fn(it0, ot0))
        check_finite("device_viterbi_lattice", lattice)
        self.cell[...] = np.maximum(np.asarray(lattice, np.float64),
                                    NEG_INF)

    def log_like(self):
        return self.get(self.in_len, self.out_len, self.n_states - 1)

    def path(self, machine):
        return self.traceback(machine)


class _MissingCell(Exception):
    pass


def _cached(ev, attr, key, build):
    """Per-EvaluatedMachine cache for walkers/premats: a caller looping
    over read batches reuses one EvaluatedMachine, so host matrix prep and
    the walker's tensors are made once per machine."""
    store = ev.__dict__.setdefault(attr, {})
    if key not in store:
        store[key] = build()
    return store[key]


def _walker_for(ev, li, lo, dev):
    from .traceback_device import make_lattice_walker
    return _cached(ev, "_tb_walkers", (li, lo, str(dev)),
                   lambda: make_lattice_walker(ev, li, lo, device=dev))


class SparseDeviceViterbiMatrix(DPMatrix):
    """Lattice-free device Viterbi matrix.

    The device walks the lattice at cell granularity
    (algo/traceback_device.make_lattice_walker) and ships only the path
    cells' 4-neighborhood value vectors; get() serves those sparse values
    to the EXACT host traceback (same per-edge option order, f64
    arithmetic). Any query outside the emitted set — an exact tie broken
    differently by the f32 device argmax — triggers the full-lattice
    readback fallback, so output never depends on the device walk."""

    def __init__(self, ev, seq_pair, cells, walk_ok, fallback):
        super().__init__(ev, seq_pair)
        self._cells = cells or {}
        self._walk_ok = bool(walk_ok) and bool(self._cells)
        self._fallback = fallback
        self._full = None

    def _alloc_lattice(self):
        return None                      # get() never touches self.cell

    def _materialize(self):
        if self._full is None:
            self._full = self._fallback()
        return self._full

    def get(self, i, o, s):
        if self._full is not None:
            return self._full.get(i, o, s)
        if not (0 <= o <= self.out_len and self.env.contains(i, o)):
            return NEG_INF
        v = self._cells.get((i, o))
        if v is None:
            raise _MissingCell((i, o))
        return v[s]

    def log_like(self):
        # the final-cell record is valid even when the walk got stuck
        # (it is emitted before the first move), so a no-path pair's
        # -inf log-like never forces the full readback
        if self._full is None:
            v = self._cells.get((self.in_len, self.out_len))
            if v is not None:
                return float(v[self.n_states - 1])
        return self._materialize().log_like()

    def traceback(self, machine, *args, **kwargs):
        if self._full is not None or not self._walk_ok:
            return self._materialize().traceback(machine, *args, **kwargs)
        try:
            return super().traceback(machine, *args, **kwargs)
        except _MissingCell:
            return self._materialize().traceback(machine, *args, **kwargs)

    def path(self, machine):
        return self.traceback(machine)


def device_viterbi_matrices(ev, seq_pairs, lowered=None, dtype=np.float32,
                            engine="auto", interpret=False,
                            envelopes=None, sparse_traceback=True,
                            device=None):
    """Batched device Viterbi fill for a list of tokenizable SeqPairs.

    ONE batched MAXPLUS wavefront call (padded to the max lengths) fills
    every pair's value lattice on `device` (None: the card, raising
    without CUDA; "cpu" runs the plain PyTorch versions), and ONE walk
    traces every pair there. Returns [SparseDeviceViterbiMatrix, ...]
    (or, with sparse_traceback=False, [DeviceViterbiMatrix, ...] from a
    full readback) aligned with seq_pairs.

    engine: 'kernel' (alias 'pallas', the JAX package's name for it) = the
    closure-folded wavefront fill of ops/kernels/viterbi_kernel.py, which
    launches the CUDA kernel on the card and runs its plain version on the
    CPU; 'wavefront' = the torch diagonal engine; 'auto' = the kernel on
    the card, the torch engine on the CPU.

    envelopes: optional [core.seqpair.Envelope, ...] aligned with
    seq_pairs (e.g. --wiggle-room bands): non-full envelopes route to the
    BANDED kernel (one per-pair call over the band window: only band
    cells are filled) on any device and engine.

    `interpret` is the JAX package's Pallas switch, accepted and unused."""
    from ..ops.wavefront import (wavefront_2d_diagonals,
                                 lattice_from_diagonals)
    from ..ops.semiring import MAXPLUS
    from .traceback_device import (run_walker, run_walker_batch,
                                   sparse_cells_from_records)

    if engine not in ("auto", "kernel", "pallas", "wavefront"):
        raise ValueError("engine must be 'auto', 'kernel' (or 'pallas') or "
                         "'wavefront', not %r" % (engine,))
    dev = resolve_device(device)
    lm = lowered if lowered is not None else LoweredMachine(ev, dtype=dtype)

    def _is_full(env, li, lo):
        return all(env.in_start[o] == 0 and env.in_end[o] == li + 1
                   for o in range(lo + 1))

    host_mats = tuple(np.asarray(x) for x in lm.matrices_2d("maxplus"))
    if envelopes is not None and any(
            not _is_full(e, len(sp.input.seq), len(sp.output.seq))
            for e, sp in zip(envelopes, seq_pairs)):
        from ..ops.kernels.viterbi_kernel import (
            make_wavefront_viterbi_banded, envelope_diag_bands,
            maxplus_class_mats)
        premats = _cached(ev, "_vit_premats", None,
                          lambda: maxplus_class_mats(*host_mats))
        out = []
        for env, sp in zip(envelopes, seq_pairs):
            it0 = np.array(ev.input_tokenizer.tokenize(sp.input.seq),
                           np.int32) - 1
            ot0 = np.array(ev.output_tokenizer.tokenize(sp.output.seq),
                           np.int32) - 1
            li, lo = len(it0), len(ot0)
            lo_d, hi_d = envelope_diag_bands(env)
            fill = make_wavefront_viterbi_banded(
                *host_mats, li, lo, lo_d, hi_d, premats=premats, device=dev)
            if not sparse_traceback:
                out.append(DeviceViterbiMatrix(
                    ev, sp, fill_fn=lambda i0, o0, f=fill: f(i0, o0)))
                continue
            # band lattice stays ON DEVICE; only the path neighborhood
            # comes back (full readback only as a tie-divergence fallback)
            lat_dev = fill.fill_raw(it0, ot0)
            walker = _walker_for(ev, li, lo, dev)
            n, ij, vals, okf = run_walker(walker, lat_dev, fill.bases,
                                          it0, ot0, li, lo)
            cells = sparse_cells_from_records(n, ij, vals)

            if okf:
                # successful walk: drop the device lattice now — pinning
                # every pair's band in device memory for the matrices'
                # lifetime would exhaust the card on long batches; the
                # rare tie-divergence fallback re-runs the fill instead
                def _fb(fill=fill, it0=it0, ot0=ot0, sp=sp):
                    full = fill(it0, ot0)
                    return DeviceViterbiMatrix(
                        ev, sp, fill_fn=lambda i0, o0, f=full: f)
                lat_dev = None
            else:
                def _fb(lat_dev=lat_dev, fill=fill, sp=sp):
                    full = fill.scatter(lat_dev.cpu().numpy())
                    return DeviceViterbiMatrix(
                        ev, sp, fill_fn=lambda i0, o0, f=full: f)
            out.append(SparseDeviceViterbiMatrix(ev, sp, cells, okf, _fb))
        return out
    tok_in = [np.array(ev.input_tokenizer.tokenize(sp.input.seq),
                       np.int32) - 1 for sp in seq_pairs]
    tok_out = [np.array(ev.output_tokenizer.tokenize(sp.output.seq),
                        np.int32) - 1 for sp in seq_pairs]
    B = len(seq_pairs)
    Li = max([len(t) for t in tok_in] + [1])
    Lo = max([len(t) for t in tok_out] + [1])
    it = np.zeros((B, Li), np.int32)
    ot = np.zeros((B, Lo), np.int32)
    for b in range(B):
        it[b, :len(tok_in[b])] = tok_in[b]
        ot[b, :len(tok_out[b])] = tok_out[b]
    if engine == "auto":
        engine = "kernel" if dev.type == "cuda" else "wavefront"
    if engine in ("kernel", "pallas"):
        from ..ops.kernels.viterbi_kernel import (make_wavefront_viterbi,
                                                  maxplus_class_mats)
        premats = _cached(ev, "_vit_premats", None,
                          lambda: maxplus_class_mats(*host_mats))
        vit = make_wavefront_viterbi(*host_mats, B, Li, Lo, premats=premats,
                                     device=dev)
        # with the pairs' lengths the fill skips the padding cells, which
        # no reader below touches
        diags = vit(it, ot, [len(t) for t in tok_in],
                    [len(t) for t in tok_out])
    else:
        mats = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in host_mats)
        diags = wavefront_2d_diagonals(
            *mats, torch.from_numpy(it).to(dev), torch.from_numpy(ot).to(dev),
            sr=MAXPLUS)
    if not sparse_traceback:
        lat = lattice_from_diagonals(diags, Li, Lo)   # (B, Li+1, Lo+1, S)
        return [DeviceViterbiMatrix(
            ev, sp, fill_fn=lambda i0, o0, b=b, li=len(tok_in[b]),
            lo=len(tok_out[b]): lat[b, :li + 1, :lo + 1, :])
            for b, sp in enumerate(seq_pairs)]
    # keep the diagonal slabs ON DEVICE; one device walk over all pairs
    # ships just the path neighborhoods (the full batched lattice is only
    # read back if some pair's host traceback diverges from the device
    # walk)
    walker = _walker_for(ev, Li, Lo, dev)
    lat_cache = []

    def _full_lat():
        if not lat_cache:
            lat_cache.append(lattice_from_diagonals(diags, Li, Lo))
        return lat_cache[0]

    zeros = np.zeros(Li + Lo + 1, np.int32)
    records = run_walker_batch(walker, diags, zeros, tok_in, tok_out) \
        if B else []
    out = []
    for b, sp in enumerate(seq_pairs):
        li, lo = len(tok_in[b]), len(tok_out[b])
        n, ij, vals, okf = records[b]
        cells = sparse_cells_from_records(n, ij, vals)

        def _fb(b=b, li=li, lo=lo, sp=sp):
            return DeviceViterbiMatrix(
                ev, sp, fill_fn=lambda i0, o0:
                _full_lat()[b, :li + 1, :lo + 1, :])
        out.append(SparseDeviceViterbiMatrix(ev, sp, cells, okf, _fb))
    return out
