"""Viterbi alignment through an IMPLICIT composition gen (x) td.

The reference's fused Plan7 engines are score-only (semiring-parameterized
Forward/Viterbi, ref python/machineboss/jax/fused_plan7.py:636-645); its
alignments always require materializing the composed machine first
(Machine.compose -> ViterbiMatrix.traceback). This module goes further:
it fills the Viterbi lattice and walks the traceback directly on the
PRODUCT GRAPH of a generator and a transducer, without ever materializing
the composition — the piece that makes `--align` usable on profile x read
workloads where the composed state space is the bottleneck.

Design (host float64; alignment is per-read host work in the reference
too, ref src/dpmatrix.defs.h:62-130):

  states   p = (g, t), g a generator state, t a transducer state
  rows     r = number of output symbols consumed
  edges    gen-silent   (g,t)   -> (g',t)  : gen silent transition
           paired       (g,t)   -> (g',t') : gen emits a, td consumes a
                                             (absorbed if td outputs eps,
                                             row-advancing if td outputs y)
           td-only      (g,t)   -> (g,t')  : td input-eps transition
                                             (silent or row-advancing)

  fill     per row: scatter-max the advance edges for y_r from row r-1,
           then run the same-row silent fixpoint by vectorized edge
           relaxation (np.maximum.at) to convergence — exact because every
           silent cycle has negative log-weight, so optimal silent paths
           are simple.
  trace    from (end_g, end_t, Lo) walk any in-edge achieving the cell
           value (tolerance for fp noise); silent cycles cannot trap the
           walk for the same reason.

The canonical-interleaving concerns of the scoring engines
(ops/fused_plan7.py) do not arise: in MAX-PLUS, admitting every
interleaving only duplicates path weights, never changes the max.
"""

import math

import numpy as np

from ..core.machine import Machine, MachinePath, Transition, make_pair_name
from ..core import weight as W

NEG_INF = -np.inf


def _log_weights(machine, defs):
    """[[log w for each transition] for each state]."""
    out = []
    for ms in machine.states:
        row = []
        for tr in ms.trans:
            v = W.evaluate(tr.weight, defs)
            if v > 0:
                row.append(math.log(v))
            elif v == 0:
                row.append(NEG_INF)
            else:
                raise ValueError("negative weight on transition")
        out.append(row)
    return out


class FusedStep:
    """One product-graph move: the generator transition and/or transducer
    transition taken (either may be None), with endpoint product state."""

    __slots__ = ("g_src", "t_src", "g_dst", "t_dst", "gen_ti", "td_ti",
                 "out", "lw")

    def __init__(self, g_src, t_src, g_dst, t_dst, gen_ti, td_ti, out, lw):
        self.g_src, self.t_src = g_src, t_src
        self.g_dst, self.t_dst = g_dst, t_dst
        self.gen_ti, self.td_ti = gen_ti, td_ti
        self.out = out                       # emitted symbol or ""
        self.lw = lw


class FusedAlignment:
    def __init__(self, aligner, score, steps):
        self.aligner = aligner
        self.score = score
        self.steps = steps

    def alignment_columns(self):
        """[(in, out)] per non-silent column — matches
        MachinePath.alignment() on the composed machine (the composition
        of a generator never consumes input, so in is always None)."""
        return [("", s.out) for s in self.steps if s.out]

    def output_sequence(self):
        return [s.out for s in self.steps if s.out]

    def path_json_str(self):
        """Reference-format path JSON ({"start", "trans": [{"to", "id",
        "out"}...]}) over the implicit product machine: state ids are the
        same [gen, td] pair names Machine.compose assigns; "to" indices
        are product-space ids g*St+t (the composition is never
        materialized, so composed-machine indices do not exist here)."""
        al = self.aligner
        out = ['{"start":%d' % 0]
        nm = al._pair_name(0, 0)
        if nm is not None:
            from ..core.machine import name_dump
            out.append(',"id":%s' % name_dump(nm))
        out.append(',"trans":[')
        for n, s in enumerate(self.steps):
            if n:
                out.append(",")
            out.append('{"to":%d' % (s.g_dst * al.St + s.t_dst))
            nm = al._pair_name(s.g_dst, s.t_dst)
            if nm is not None:
                from ..core.machine import name_dump, write_escaped
                out.append(',"id":%s' % name_dump(nm))
            if s.out:
                from ..core.machine import write_escaped
                out.append(',"out":"%s"' % write_escaped(s.out))
            out.append("}")
        out.append("]}")
        return "".join(out)

    def to_machine_path(self, comp, max_hops=6):
        """Project the product-graph path onto a materialized composed
        machine (for parity tests / callers that composed anyway).

        Two representational gaps are bridged: the composition's second
        operand is the WAITING transform of the transducer (each td state
        may appear as `t` and `{"wait": t}`, with inserted unit hops,
        core/machine.py waiting_machine), and compose post-processing may
        splice silent chains away entirely. So each product step maps to
        a short silent search (bounded by max_hops) toward either split
        of the step's endpoint, emitting any pending symbols in order on
        the way; steps whose endpoints were spliced away merge into the
        next step's search. Emitted symbols are preserved exactly, and
        because compose's splices only SUM weight into surviving
        transitions, the projected path's composed weight is >= the
        product path weight (in practice it reaches the composed
        machine's own Viterbi optimum — see tests)."""
        from collections import deque
        al = self.aligner

        def strip(nm):
            # compose may graft a null start via concatenate, wrapping
            # every surviving name as ["concat-l"|"concat-r", inner]
            while (isinstance(nm, list) and len(nm) == 2
                   and nm[0] in ("concat-l", "concat-r")):
                nm = nm[1]
            return nm

        name2idx = {}
        for i, st in enumerate(comp.states):
            name2idx.setdefault(_name_key(strip(st.name)), []).append(i)

        def targets(g, t):
            tn = al.td.states[t].name
            keys = [_name_key(make_pair_name(al.gen.states[g].name, tn))]
            if tn is not None:
                keys.append(_name_key(make_pair_name(
                    al.gen.states[g].name, {"wait": tn})))
            out = []
            for k in keys:
                out.extend(name2idx.get(k, ()))
            return set(out)

        cur = comp.start_state()
        path = MachinePath()
        pending = []                        # emissions awaiting a match
        for s in self.steps:
            if s.out:
                pending.append(s.out)
            goal = targets(s.g_dst, s.t_dst)
            if not goal:
                continue                    # spliced away by compose
            if cur in goal and not pending:
                continue                    # silent step spliced to self
            # BFS: silent transitions freely, pending emissions in order
            start = (cur, 0)
            prev = {start: None}
            q = deque([(start, 0)])
            hit = None
            while q and hit is None:
                (idx, ne), depth = q.popleft()
                if depth >= max_hops:
                    continue
                for tr in comp.states[idx].trans:
                    if tr.in_:
                        continue
                    if tr.out == "":
                        nxt = (tr.dest, ne)
                    elif ne < len(pending) and tr.out == pending[ne]:
                        nxt = (tr.dest, ne + 1)
                    else:
                        continue
                    if nxt in prev:
                        continue
                    prev[nxt] = ((idx, ne), tr)
                    if tr.dest in goal and nxt[1] == len(pending):
                        hit = nxt
                        break
                    q.append((nxt, depth + 1))
            if hit is None:
                continue                    # endpoint unreachable: merge on
            hops = []
            node = hit
            while prev[node] is not None:
                node, tr = prev[node]
                hops.append(tr)
            path.trans.extend(reversed(hops))
            cur = hit[0]
            pending = []
        if pending:
            raise ValueError("trailing emissions not matched")
        if cur != comp.n_states() - 1:
            raise ValueError("path did not reach the composed end state")
        return path


def _name_key(name):
    import json
    return json.dumps(name, sort_keys=True)


class FusedViterbiAligner:
    """Viterbi fill + traceback on the implicit product of a generator
    and a transducer (see module docstring).

    gen: generator Machine (empty input alphabet); td: transducer Machine
    whose input alphabet covers gen's output alphabet. params: optional
    Params evaluated over BOTH machines' transitions (defaults to each
    machine's own param defs)."""

    def __init__(self, gen, td, params=None, gen_params=None,
                 td_params=None):
        self.gen, self.td = gen, td
        self.Sg, self.St = gen.n_states(), td.n_states()
        if gen_params is None:
            gen_params = params if params is not None \
                else gen.get_param_defs(True)
        if td_params is None:
            td_params = params if params is not None \
                else td.get_param_defs(True)
        gdefs, tdefs = gen_params.defs, td_params.defs
        glw = _log_weights(gen, gdefs)
        tlw = _log_weights(td, tdefs)

        # transducer transitions grouped by input symbol
        td_by_in = {}                       # in_sym -> [(t, ti, t', out, lw)]
        for t in range(self.St):
            for ti, tr in enumerate(td.states[t].trans):
                if np.isfinite(tlw[t][ti]):
                    td_by_in.setdefault(tr.in_, []).append(
                        (t, ti, tr.dest, tr.out, tlw[t][ti]))

        # edge lists: silent (same row) and advance (keyed by out symbol)
        sil = []                            # (psrc, pdst, w, gen_ti, td_ti)
        adv = {}                            # out_sym -> [..., out]
        St = self.St

        def add(lst, g, t, g2, t2, w, gti, tti):
            lst.append((g * St + t, g2 * St + t2, w, gti, tti))

        for g in range(self.Sg):
            for gti, gt in enumerate(gen.states[g].trans):
                w_g = glw[g][gti]
                if not np.isfinite(w_g):
                    continue
                if gt.in_:
                    raise ValueError("gen must be a generator (no inputs)")
                if not gt.out:
                    for t in range(St):
                        add(sil, g, t, gt.dest, t, w_g, gti, None)
                else:
                    for (t, tti, t2, out, w_t) in td_by_in.get(gt.out, ()):
                        if out:
                            adv.setdefault(out, [])
                            add(adv[out], g, t, gt.dest, t2, w_g + w_t,
                                gti, tti)
                        else:
                            add(sil, g, t, gt.dest, t2, w_g + w_t, gti, tti)
        for (t, tti, t2, out, w_t) in td_by_in.get("", ()):
            for g in range(self.Sg):
                if out:
                    adv.setdefault(out, [])
                    add(adv[out], g, t, g, t2, w_t, None, tti)
                else:
                    add(sil, g, t, g, t2, w_t, None, tti)

        # degenerate collapse: compose() SUMS transitions sharing
        # (src, dst, in, out) (TransAccumulator), and the host Viterbi
        # maxes over the collapsed graph — match that granularity here
        # so scores agree with ops/fused_plan7.py(semiring="maxplus")
        # exactly (silent cycles stay maxed in both; see the fused
        # module's loop_closure docstring for the composed-machine
        # difference)
        def collapse(lst):
            groups = {}
            for e in lst:
                key = (e[0], e[1])
                if key in groups:
                    old = groups[key]
                    w = np.logaddexp(old[2], e[2])
                    rep = e if e[2] > old[2] else old
                    groups[key] = (e[0], e[1], w, rep[3], rep[4])
                else:
                    groups[key] = e
            return list(groups.values())

        sil = collapse(sil)
        adv = {y: collapse(lst) for y, lst in adv.items()}
        self._sil = sil
        self._adv = adv
        self._sil_src = np.array([e[0] for e in sil], np.int64)
        self._sil_dst = np.array([e[1] for e in sil], np.int64)
        self._sil_w = np.array([e[2] for e in sil])
        self._adv_np = {
            y: (np.array([e[0] for e in lst], np.int64),
                np.array([e[1] for e in lst], np.int64),
                np.array([e[2] for e in lst]))
            for y, lst in adv.items()}
        # incoming adjacency for the traceback
        self._sil_in = {}
        for e in sil:
            self._sil_in.setdefault(e[1], []).append(e)
        self._adv_in = {}
        for y, lst in adv.items():
            by_dst = {}
            for e in lst:
                by_dst.setdefault(e[1], []).append(e)
            self._adv_in[y] = by_dst

    def _pair_name(self, g, t):
        return make_pair_name(self.gen.states[g].name,
                              self.td.states[t].name)

    def _relax_silent(self, v):
        """Same-row silent fixpoint by repeated vectorized relaxation."""
        if not len(self._sil_src):
            return v
        for _ in range(self.Sg * self.St + 1):
            before = v.copy()
            np.maximum.at(v, self._sil_dst, v[self._sil_src] + self._sil_w)
            if np.array_equal(before, v):
                return v
        raise RuntimeError("silent relaxation failed to converge "
                           "(cycle with log-weight >= 0?)")

    def fill(self, out_seq):
        """Viterbi lattice (Lo+1, Sg*St) for an output sequence."""
        Ns = self.Sg * self.St
        V = np.full((len(out_seq) + 1, Ns), NEG_INF)
        V[0, 0] = 0.0
        V[0] = self._relax_silent(V[0])
        for r, y in enumerate(out_seq, start=1):
            e = self._adv_np.get(y)
            if e is not None:
                src, dst, w = e
                np.maximum.at(V[r], dst, V[r - 1][src] + w)
            V[r] = self._relax_silent(V[r])
        return V

    def score(self, out_seq):
        return self.fill(list(out_seq))[-1, -1]

    def align(self, out_seq, tol=1e-9):
        out_seq = list(out_seq)
        V = self.fill(out_seq)
        p = self.Sg * self.St - 1
        r = len(out_seq)
        if not V[r, p] > NEG_INF:
            raise ValueError("Can't do traceback: no finite-weight paths")
        steps = []
        guard = 0
        while r > 0 or p != 0:
            guard += 1
            if guard > (self.Sg * self.St + 2) * (len(out_seq) + 2):
                raise RuntimeError("traceback failed to terminate")
            best = None
            for e in self._sil_in.get(p, ()):
                if e[0] == p:
                    # a weight-0 silent self-loop ties the cell value and
                    # would be re-selected forever; a self-loop with
                    # log-weight <= 0 can never be on an optimal simple path
                    continue
                cand = V[r][e[0]] + e[2]
                if best is None or cand > best[0]:
                    best = (cand, e, r)
            if r > 0:
                for e in self._adv_in.get(out_seq[r - 1], {}).get(p, ()):
                    cand = V[r - 1][e[0]] + e[2]
                    if best is None or cand > best[0]:
                        best = (cand, e, r - 1)
            if best is None or abs(best[0] - V[r, p]) > tol * max(
                    1.0, abs(V[r, p])):
                raise RuntimeError(
                    "traceback mismatch at row %d state %d: cell %.12g "
                    "best pred %.12g" % (r, p, V[r, p],
                                         best[0] if best else NEG_INF))
            _, (src, dst, w, gti, tti), r = best
            g2, t2 = divmod(dst, self.St)
            g1, t1 = divmod(src, self.St)
            out = ""
            if tti is not None:
                out = self.td.states[t1].trans[tti].out
            steps.append(FusedStep(g1, t1, g2, t2, gti, tti, out, w))
            p = src
        steps.reverse()
        return FusedAlignment(self, V[-1, -1], steps)
