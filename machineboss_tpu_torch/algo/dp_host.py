"""Host (numpy float64) DP engines: Forward, Backward, Viterbi, counts.

These are the exact-semantics reference engines used by the CLI for golden
parity and by tests as the oracle for the TPU engines (ops/dp*.py). Cell
recurrences mirror the reference interpreter (ref: src/forward.defs.h:22-49,
src/backward.cpp, src/viterbi.cpp, src/dpmatrix.h): four accumulation cases
per cell (match / input-only / output-only / silent) over incoming
transitions, in (outPos, inPos, state) order, with envelope banding.

Log weights are combined with the same 1e-4-spaced interpolated lookup-table
log-sum-exp as the reference (utils/logsumexp.py), so even unrounded 6-digit
log-likelihood outputs agree bit-for-bit with the golden files.
"""

import math

import numpy as np

from ..core.eval import EvaluatedMachine, Tokenizer
from ..utils.logsumexp import accumulate_at
from ..core.seqpair import Envelope
from ..core.machine import MachinePath

NEG_INF = -math.inf


from ..utils.logsumexp import lse as _logaddexp  # table-interpolated


class DPMatrix:
    """Envelope-banded (inPos, outPos, state) lattice of log weights."""

    def __init__(self, ev: EvaluatedMachine, seq_pair, env=None):
        self.ev = ev
        self.seq_pair = seq_pair
        self.input = ev.input_tokenizer.tokenize(seq_pair.input.seq)
        self.output = ev.output_tokenizer.tokenize(seq_pair.output.seq)
        self.in_len = len(self.input)
        self.out_len = len(self.output)
        self.n_states = ev.n_states()
        self.env = env if env is not None else Envelope(seq_pair)
        if not self.env.fits(seq_pair):
            raise ValueError("Envelope/sequence mismatch")
        if not self.env.connected():
            raise ValueError("Envelope is not connected")
        self.cell = self._alloc_lattice()
        self._mask = np.zeros((self.in_len + 1, self.out_len + 1), dtype=bool)
        for o in range(self.out_len + 1):
            self._mask[self.env.in_start[o]:self.env.in_end[o], o] = True

    def _alloc_lattice(self):
        """Dense (in_len+1, out_len+1, S) storage; subclasses that serve
        get() from sparse records override this to skip the allocation."""
        return np.full((self.in_len + 1, self.out_len + 1, self.n_states),
                       NEG_INF)

    def get(self, i, o, s):
        if 0 <= o <= self.out_len and self.env.contains(i, o):
            return self.cell[i, o, s]
        return NEG_INF

    def in_tok(self, pos):
        return self.input[pos - 1] if pos else 0

    def out_tok(self, pos):
        return self.output[pos - 1] if pos else 0

    # ------------------------------------------------------- trace machinery

    def _trace_options(self, state, i, o, incoming=True):
        """All transitions into cell (i,o,state) with their path log-likes.

        Returns parallel lists (other_state, trans_index, loglike) in the
        reference's option order: match, input-only, output-only, silent.
        """
        ev_state = self.ev.state[state]
        mapping = ev_state.incoming
        options = []
        in_tok = self.in_tok(i)
        out_tok = self.out_tok(o)

        def it(key, pi, po):
            for other, ti, lw in mapping.get(key, ()):
                options.append((other, ti, self.get(pi, po, other) + lw))

        if i and o:
            it((in_tok, out_tok), i - 1, o - 1)
        if i:
            it((in_tok, 0), i - 1, o)
        if o:
            it((0, out_tok), i, o - 1)
        it((0, 0), i, o)
        return options

    def traceback(self, machine, i=None, o=None, s=None, select=None,
                  visit=None):
        """Walk back from (i,o,s) to the start cell (ref dpmatrix.defs.h:62)."""
        if i is None:
            i, o, s = self.in_len, self.out_len, self.n_states - 1
        if not (self.get(i, o, s) > NEG_INF):
            raise ValueError("Can't do traceback: no finite-weight paths")
        path = MachinePath()
        while i > 0 or o > 0 or s != 0:
            options = self._trace_options(s, i, o)
            lls = [ll for _, _, ll in options]
            best = select(lls) if select else int(np.argmax(np.array(lls)))
            src, ti, _ = options[best]
            trans = machine.states[src].trans[ti]
            if not trans.input_empty():
                i -= 1
            if not trans.output_empty():
                o -= 1
            s = src
            path.trans.insert(0, trans)
            if visit and visit(i, o, s, ti):
                break
        return path

    def sample_path(self, machine, rng):
        def select(lls):
            w = np.exp(np.array(lls) - max(lls))
            w = w / w.sum()
            return int(rng.choice(len(lls), p=w))
        return self.traceback(machine, select=select)


class ForwardMatrix(DPMatrix):
    def __init__(self, ev, seq_pair, env=None, start_state=None):
        super().__init__(ev, seq_pair, env)
        self._fill(start_state if start_state is not None else 0)

    def _fill(self, start_state):
        edges = self.ev.edges_by_token()
        S = self.n_states
        for o in range(self.out_len + 1):
            out_tok = self.out_tok(o)
            for i in range(self.env.in_start[o], self.env.in_end[o]):
                in_tok = self.in_tok(i)
                ll = np.full(S, NEG_INF)
                if i == 0 and o == 0:
                    ll[start_state] = 0.0
                if i and o and self._mask[i - 1, o - 1]:
                    self._accum_vec(ll, self.cell[i - 1, o - 1],
                                    edges.get((in_tok, out_tok)))
                if i and self._mask[i - 1, o]:
                    self._accum_vec(ll, self.cell[i - 1, o],
                                    edges.get((in_tok, 0)))
                if o and self._mask[i, o - 1]:
                    self._accum_vec(ll, self.cell[i, o - 1],
                                    edges.get((0, out_tok)))
                # silent: in-cell, processed in dst order (advancing machine)
                silent = edges.get((0, 0))
                if silent is not None:
                    src, dst, _, lw = silent
                    for k in range(len(src)):
                        v = ll[src[k]] + lw[k]
                        if v > NEG_INF:
                            ll[dst[k]] = _logaddexp(ll[dst[k]], v)
                self.cell[i, o] = ll

    @staticmethod
    def _accum_vec(ll, prev, e):
        if e is None:
            return
        src, dst, _, lw = e
        contrib = prev[src] + lw
        # sequential per-edge accumulation in (dst, src) order, matching the
        # reference's per-cell transition iteration and its table-lse rounding
        accumulate_at(ll, dst, contrib)

    def log_like(self):
        return self.get(self.in_len, self.out_len, self.n_states - 1)


class ViterbiMatrix(DPMatrix):
    def __init__(self, ev, seq_pair, env=None):
        super().__init__(ev, seq_pair, env)
        self._fill()

    def _fill(self):
        edges = self.ev.edges_by_token()
        S = self.n_states
        for o in range(self.out_len + 1):
            out_tok = self.out_tok(o)
            for i in range(self.env.in_start[o], self.env.in_end[o]):
                in_tok = self.in_tok(i)
                ll = np.full(S, NEG_INF)
                if i == 0 and o == 0:
                    ll[0] = 0.0
                if i and o and self._mask[i - 1, o - 1]:
                    self._max_vec(ll, self.cell[i - 1, o - 1],
                                  edges.get((in_tok, out_tok)))
                if i and self._mask[i - 1, o]:
                    self._max_vec(ll, self.cell[i - 1, o],
                                  edges.get((in_tok, 0)))
                if o and self._mask[i, o - 1]:
                    self._max_vec(ll, self.cell[i, o - 1],
                                  edges.get((0, out_tok)))
                silent = edges.get((0, 0))
                if silent is not None:
                    src, dst, _, lw = silent
                    for k in range(len(src)):
                        v = ll[src[k]] + lw[k]
                        if v > ll[dst[k]]:
                            ll[dst[k]] = v
                self.cell[i, o] = ll

    @staticmethod
    def _max_vec(ll, prev, e):
        if e is None:
            return
        src, dst, _, lw = e
        contrib = prev[src] + lw
        np.maximum.at(ll, dst, contrib)

    def log_like(self):
        return self.get(self.in_len, self.out_len, self.n_states - 1)

    def path(self, machine):
        return self.traceback(machine)


class BackwardMatrix(DPMatrix):
    def __init__(self, ev, seq_pair, env=None):
        super().__init__(ev, seq_pair, env)
        self._fill()

    def _fill(self):
        S = self.n_states
        for o in range(self.out_len, -1, -1):
            end_out = o == self.out_len
            out_tok = 0 if end_out else self.output[o]
            for i in range(self.env.in_end[o] - 1, self.env.in_start[o] - 1, -1):
                end_in = i == self.in_len
                in_tok = 0 if end_in else self.input[i]
                ll = np.full(S, NEG_INF)
                for s in range(S - 1, -1, -1):
                    v = 0.0 if (end_in and end_out and s == S - 1) else NEG_INF
                    out_map = self.ev.state[s].outgoing
                    if not end_in and not end_out:
                        for d, ti, lw in out_map.get((in_tok, out_tok), ()):
                            v = _logaddexp(v, self.get(i + 1, o + 1, d) + lw)
                    if not end_in:
                        for d, ti, lw in out_map.get((in_tok, 0), ()):
                            v = _logaddexp(v, self.get(i + 1, o, d) + lw)
                    if not end_out:
                        for d, ti, lw in out_map.get((0, out_tok), ()):
                            v = _logaddexp(v, self.get(i, o + 1, d) + lw)
                    for d, ti, lw in out_map.get((0, 0), ()):
                        # silent edges go forward, so backward fill must read
                        # same-cell values of higher states first: iterate
                        # states descending (advancing machine guarantees d>s)
                        v = _logaddexp(v, ll[d] + lw)
                    ll[s] = v
                self.cell[i, o] = ll

    def log_like(self):
        return self.get(0, 0, 0)

    def get_counts(self, fwd, visit=None, counts=None):
        """Posterior transition counts (E-step); ref src/backward.h:13-18."""
        ll_total = self.log_like()
        for o in range(self.out_len, -1, -1):
            end_out = o == self.out_len
            out_tok = 0 if end_out else self.output[o]
            for i in range(self.env.in_end[o] - 1,
                           self.env.in_start[o] - 1, -1):
                end_in = i == self.in_len
                in_tok = 0 if end_in else self.input[i]
                if not self._mask[i, o]:
                    continue
                for s in range(self.n_states - 1, -1, -1):
                    log_odds = fwd.cell[i, o, s] - ll_total
                    if log_odds == NEG_INF:
                        continue
                    out_map = self.ev.state[s].outgoing

                    def acc(key, pi, po):
                        for d, ti, lw in out_map.get(key, ()):
                            post = math.exp(log_odds + self.get(pi, po, d) + lw)
                            if counts is not None:
                                counts.count[s][ti] += post
                            if visit is not None:
                                visit(s, ti, i, o, post)

                    if not end_in and not end_out:
                        acc((in_tok, out_tok), i + 1, o + 1)
                    if not end_in:
                        acc((in_tok, 0), i + 1, o)
                    if not end_out:
                        acc((0, out_tok), i, o + 1)
                    acc((0, 0), i, o)


class RollingForward:
    """O(in_len * states) memory Forward for log-likelihood only
    (ref RollingOutputForwardMatrix, src/dpmatrix.h:46-58)."""

    def __init__(self, ev, seq_pair):
        self.ev = ev
        self.input = ev.input_tokenizer.tokenize(seq_pair.input.seq)
        self.output = ev.output_tokenizer.tokenize(seq_pair.output.seq)
        in_len, out_len = len(self.input), len(self.output)
        S = ev.n_states()
        edges = ev.edges_by_token()
        prev = None
        for o in range(out_len + 1):
            out_tok = self.output[o - 1] if o else 0
            cur = np.full((in_len + 1, S), NEG_INF)
            for i in range(in_len + 1):
                in_tok = self.input[i - 1] if i else 0
                ll = np.full(S, NEG_INF)
                if i == 0 and o == 0:
                    ll[0] = 0.0
                if i and o:
                    ForwardMatrix._accum_vec(ll, prev[i - 1],
                                             edges.get((in_tok, out_tok)))
                if i:
                    ForwardMatrix._accum_vec(ll, cur[i - 1],
                                             edges.get((in_tok, 0)))
                if o:
                    ForwardMatrix._accum_vec(ll, prev[i],
                                             edges.get((0, out_tok)))
                silent = edges.get((0, 0))
                if silent is not None:
                    src, dst, _, lw = silent
                    for k in range(len(src)):
                        v = ll[src[k]] + lw[k]
                        if v > NEG_INF:
                            ll[dst[k]] = _logaddexp(ll[dst[k]], v)
                cur[i] = ll
            prev = cur
        self._ll = prev[in_len][S - 1]

    def log_like(self):
        return float(self._ll)
