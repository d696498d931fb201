"""Tokenization and numeric evaluation of machines.

Binds parameters, converts weights to log space, and indexes transitions by
(input token, output token, state) — the form all DP engines consume
(ref: src/eval.{h,cpp}). Token 0 is always the empty symbol; alphabet tokens
are assigned in sorted symbol order.

This module is also the host half of device lowering: ops/lowering.py takes
an EvaluatedMachine and produces dense/COO device tensors for the JAX/Pallas
DP kernels.
"""

import math

import numpy as np

from . import weight as W
from .machine import Machine, Transition, name_dump

NEG_INF = -math.inf


class Tokenizer:
    """Symbol <-> int token mapping; token 0 = empty symbol (ref src/eval.h:11)."""

    def __init__(self, symbols):
        self.tok2sym = [""] + list(symbols)
        self.sym2tok = {s: t for t, s in enumerate(self.tok2sym)}

    @staticmethod
    def empty_token():
        return 0

    def can_tokenize(self, seq):
        return all(s in self.sym2tok for s in seq)

    def tokenize(self, seq):
        try:
            return [self.sym2tok[s] for s in seq]
        except KeyError as e:
            raise ValueError("Can't tokenize symbol %s using this alphabet: %s"
                             % (e.args[0], " ".join(self.tok2sym)))

    def detokenize(self, toks):
        return [self.tok2sym[t] for t in toks]

    def n_tokens(self):
        return len(self.tok2sym)


class EvaluatedState:
    __slots__ = ("name", "n_transitions", "trans_offset",
                 "incoming", "outgoing", "log_trans_weight")

    def __init__(self):
        self.name = None
        self.n_transitions = 0
        self.trans_offset = 0
        # {(inTok,outTok): [(otherState, transIndex, logWeight), ...]}
        self.incoming = {}
        self.outgoing = {}
        self.log_trans_weight = []

    def best_outgoing_token(self, dest, out_tok):
        best_tok, best_lw = 0, NEG_INF
        for (i, o), lst in sorted(self.outgoing.items()):
            if o != out_tok:
                continue
            for d, ti, lw in lst:
                if d == dest and lw > best_lw:
                    best_lw = lw
                    best_tok = i
        return best_tok


class EvaluatedMachine:
    def __init__(self, machine, params=None):
        if not machine.is_advancing_machine():
            raise ValueError("Machine is not topologically sorted")
        self.machine = machine
        self.input_tokenizer = Tokenizer(machine.input_alphabet())
        self.output_tokenizer = Tokenizer(machine.output_alphabet())
        self.state = [EvaluatedState() for _ in range(machine.n_states())]
        defs = params.defs if params is not None else None
        ti_cum = 0
        for s, ms in enumerate(machine.states):
            es = self.state[s]
            es.name = ms.name
            for ti, trans in enumerate(ms.trans):
                d = trans.dest
                in_tok = self.input_tokenizer.sym2tok[trans.in_]
                out_tok = self.output_tokenizer.sym2tok[trans.out]
                if defs is None:
                    lw = 0.0
                else:
                    v = W.evaluate(trans.weight, defs)
                    if v > 0:
                        lw = math.log(v)
                    elif v == 0:
                        lw = NEG_INF
                    else:
                        lw = math.nan
                es.outgoing.setdefault((in_tok, out_tok), []).append((d, ti, lw))
                self.state[d].incoming.setdefault((in_tok, out_tok), []) \
                    .append((s, ti, lw))
                es.log_trans_weight.append(lw)
            es.n_transitions = len(ms.trans)
            es.trans_offset = ti_cum
            ti_cum += es.n_transitions
        self.n_transitions = ti_cum
        # multimap ordering: outgoing sorted by destination state (stable)
        for es in self.state:
            for lst in es.outgoing.values():
                lst.sort(key=lambda e: e[0])
        self._edges_cache = None

    def n_states(self):
        return len(self.state)

    def start_state(self):
        return 0

    def end_state(self):
        return self.n_states() - 1

    def state_name_json(self, s):
        if self.state[s].name is None:
            return str(s)
        return name_dump(self.state[s].name)

    def can_tokenize(self, sp):
        return (self.input_tokenizer.can_tokenize(sp.input.seq)
                and self.output_tokenizer.can_tokenize(sp.output.seq))

    # ------------------------------------------------------- edge-array views

    def edges_by_token(self):
        """COO edge arrays grouped by (inTok,outTok), for vectorized DP.

        Returns {(inTok,outTok): (src, dst, transIdx, logWeight)} with numpy
        arrays sorted by (dst, src, transIdx). Silent edges additionally
        sorted by dst for in-order accumulation (machine is advancing, so
        silent edges satisfy src < dst).
        """
        if self._edges_cache is None:
            groups = {}
            for s, es in enumerate(self.state):
                for (i, o), lst in es.outgoing.items():
                    g = groups.setdefault((i, o), [])
                    for d, ti, lw in lst:
                        g.append((d, s, ti, lw))
            out = {}
            for key, lst in groups.items():
                lst.sort()
                dst = np.array([e[0] for e in lst], dtype=np.int64)
                src = np.array([e[1] for e in lst], dtype=np.int64)
                tix = np.array([e[2] for e in lst], dtype=np.int64)
                lw = np.array([e[3] for e in lst], dtype=np.float64)
                out[key] = (src, dst, tix, lw)
            self._edges_cache = out
        return self._edges_cache

    # --------------------------------------------------------- path sums

    def sum_in_trans(self, all_paths=False):
        """Sum over non-outputting (or all) paths between states: (I - N)^-1.

        Replaces the reference's GSL LU inversion (ref: src/eval.cpp:146-181)
        with numpy; on device the same closure is computed once per machine
        and folded into transfer matrices.
        """
        n = self.n_states()
        one_minus = np.eye(n)
        for src in range(n):
            for (i, o), lst in self.state[src].outgoing.items():
                if all_paths or o == 0:
                    for d, ti, lw in lst:
                        one_minus[src, d] -= math.exp(lw) if lw > NEG_INF else 0.0
        return np.linalg.inv(one_minus)

    def log_sum_in_trans(self, all_paths=False):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.log(self.sum_in_trans(all_paths))

    def explicit_machine(self):
        m = Machine()
        for es in self.state:
            from .machine import State
            st = State(es.name)
            for (i, o), lst in sorted(es.outgoing.items()):
                for d, ti, lw in lst:
                    st.trans.append(Transition(
                        self.input_tokenizer.tok2sym[i],
                        self.output_tokenizer.tok2sym[o],
                        d, W.double_constant(math.exp(lw))))
            m.states.append(st)
        return m

    @staticmethod
    def decode(path, machine, params):
        """Most likely input symbols along a state path (ref eval.cpp:199)."""
        ev = EvaluatedMachine(machine, params)
        in_seq = []
        s = 0
        for t in path.trans:
            d = t.dest
            tok = ev.state[s].best_outgoing_token(
                d, ev.output_tokenizer.sym2tok[t.out])
            if tok:
                in_seq.append(ev.input_tokenizer.tok2sym[tok])
            s = d
        return in_seq

    def to_json_str(self):
        out = ['{"state":\n [']
        n = self.n_states()
        for s in range(n):
            es = self.state[s]
            out.append(("  " if s else "") + '{"n":%d' % s)
            if es.name is not None:
                out.append(',\n   "id":%s' % name_dump(es.name))
            for label, mapping, other_key in (
                    ("incoming", es.incoming, "from"),
                    ("outgoing", es.outgoing, "to")):
                if mapping:
                    out.append(',\n   "%s":[' % label)
                    nt = 0
                    for (i, o), lst in sorted(mapping.items()):
                        for other, ti, lw in lst:
                            if nt:
                                out.append(",\n               ")
                            nt += 1
                            out.append('{"%s":%d' % (other_key, other))
                            if i:
                                out.append(',"in":"%s"'
                                           % self.input_tokenizer.tok2sym[i])
                            if o:
                                out.append(',"out":"%s"'
                                           % self.output_tokenizer.tok2sym[o])
                            from ..utils.jsonfmt import cpp_double6
                            out.append(',"logWeight":%s}' % cpp_double6(lw))
                    out.append("]")
            out.append("}")
            if s < n - 1:
                out.append(",\n")
        out.append("\n ]\n}\n")
        return "".join(out)
