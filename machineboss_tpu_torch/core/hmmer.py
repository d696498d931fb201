"""HMMER3 profile importer (ref: src/hmmer.{h,cpp}).

Parses HMMER3 .hmm text files and builds either the core profile machine
(B/M/I/D chain, five states per node, local or glocal entry) or the full
Plan7 machine with N/C/J flanks (single or multi-hit) and SwissProt null
model background emissions.
"""

import math
import struct

from .machine import Machine, State, Transition
from . import weight as W

# SwissProt background amino acid frequencies
_BG_FREQ = {
    "A": 0.0825, "C": 0.0138, "D": 0.0546, "E": 0.0673,
    "F": 0.0386, "G": 0.0708, "H": 0.0227, "I": 0.0592,
    "K": 0.0581, "L": 0.0965, "M": 0.0241, "N": 0.0405,
    "P": 0.0473, "Q": 0.0393, "R": 0.0553, "S": 0.0663,
    "T": 0.0535, "V": 0.0686, "W": 0.0109, "Y": 0.0292,
}


def _f32(x):
    return struct.unpack("f", struct.pack("f", float(x)))[0]


def _str_to_prob(s):
    """'*' denotes probability zero; otherwise exp(-score), score parsed at
    float32 precision like the reference's stof."""
    return 0.0 if s == "*" else math.exp(-_f32(s))


class HmmerNode:
    __slots__ = ("match_emit", "ins_emit", "m_to_m", "m_to_i", "m_to_d",
                 "i_to_m", "i_to_i", "d_to_m", "d_to_d")


class HmmerModel:
    def __init__(self):
        self.node = []
        self.alph = []
        self.ins0_emit = []
        self.null_emit = []
        self.b_to_m1 = self.b_to_i0 = self.b_to_d1 = 0.0
        self.i0_to_m1 = self.i0_to_i0 = 0.0

    # ------------------------------------------------------------- parsing

    def read(self, text):
        lines = iter(text.splitlines())
        for line in lines:
            stripped = line.lstrip()
            if not stripped or not stripped[0].isupper():
                continue
            tag = ""
            for ch in stripped:
                if "A" <= ch <= "Z":
                    tag += ch
                else:
                    break
            if tag != "HMM" or not line.startswith("HMM"):
                continue
            fields = line.split()
            if len(fields) <= 1:
                raise ValueError("HMM parse error: empty alphabet")
            self.alph = fields[1:]
            # skip transition-header line + COMPO line + node-0 insert line? No:
            # reference skips 3 lines then reads node-0 insert emissions
            for _ in range(3):
                line = next(lines, None)
                if line is None:
                    break
            ins0 = line.split()
            if len(ins0) != len(self.alph):
                raise ValueError("HMM parse error: wrong number of fields in"
                                 " node 0 insert line")
            self.ins0_emit = [_str_to_prob(s) for s in ins0]
            line = next(lines, None)
            if line is None:
                break
            begin = line.split()
            self.b_to_m1 = _str_to_prob(begin[0])
            self.b_to_i0 = _str_to_prob(begin[1])
            self.b_to_d1 = _str_to_prob(begin[2])
            self.i0_to_m1 = _str_to_prob(begin[3])
            self.i0_to_i0 = _str_to_prob(begin[4])
            for line in lines:
                if line.startswith("//"):
                    break
                match_line = line.split()
                if len(match_line) != len(self.alph) + 6:
                    raise ValueError("HMM parse error: wrong number of fields"
                                     " in node match line")
                if int(match_line[0]) != len(self.node) + 1:
                    raise ValueError("HMM parse error: incorrect node index")
                ins_line = next(lines).split()
                if len(ins_line) != len(self.alph):
                    raise ValueError("HMM parse error: wrong number of fields"
                                     " in node insert line")
                trans_line = next(lines).split()
                if len(trans_line) != 7:
                    raise ValueError("HMM parse error: wrong number of fields"
                                     " in node transitions line")
                n = HmmerNode()
                n.match_emit = [_str_to_prob(s)
                                for s in match_line[1:len(self.alph) + 1]]
                n.ins_emit = [_str_to_prob(s) for s in ins_line]
                (n.m_to_m, n.m_to_i, n.m_to_d, n.i_to_m, n.i_to_i,
                 n.d_to_m, n.d_to_d) = [_str_to_prob(s) for s in trans_line]
                self.node.append(n)
            break
        self.load_null_model()

    @classmethod
    def from_file(cls, path):
        m = cls()
        with open(path) as f:
            m.read(f.read())
        return m

    def load_null_model(self):
        self.null_emit = [_BG_FREQ.get(sym, 1.0 / len(self.alph))
                          for sym in self.alph]

    # --------------------------------------------------- state index layout

    def b_idx(self):
        return 0

    def ix_idx(self, n):
        return 5 * n + 1

    def i_idx(self, n):
        return 5 * n + 2

    def mx_idx(self, n):
        return 5 * n - 2

    def m_idx(self, n):
        return 5 * n - 1

    def d_idx(self, n):
        return 5 * n

    def core_end_idx(self):
        return 5 * len(self.node) + 3

    def n_core_states(self):
        return 5 * len(self.node) + 4

    def n_idx(self):
        return self.n_core_states()

    def nx_idx(self):
        return self.n_core_states() + 1

    def plan7_b_idx(self):
        return self.n_core_states() + 2

    def cx_idx(self):
        return self.n_core_states() + 3

    def c_idx(self):
        return self.n_core_states() + 4

    def jx_idx(self):
        return self.n_core_states() + 5

    def j_idx(self):
        return self.n_core_states() + 6

    def t_idx(self):
        return self.n_core_states() + 7

    def n_plan7_states(self):
        return self.n_core_states() + 8

    def calc_match_occupancy(self):
        """Probability each match state is used in a sampled path (faithful
        to p7_hmm_CalculateOccupancy as reproduced by the reference)."""
        mocc = [0.0] * len(self.node)
        mocc[0] = 0.0
        if len(self.node) > 1:
            mocc[1] = self.node[0].m_to_i + self.node[0].m_to_m
        for k in range(2, len(self.node)):
            mocc[k] = (mocc[k - 1] * (self.node[k].m_to_m + self.node[k].m_to_i)
                       + (1.0 - mocc[k - 1]) * self.node[k].d_to_m)
        return mocc

    # ------------------------------------------------------ machine builders

    def machine(self, local=True):
        if not self.node:
            raise ValueError("Attempt to create a transducer from an empty"
                             " HMMER model")
        n_nodes = len(self.node)
        m = Machine([State() for _ in range(self.n_core_states())])
        m.states[self.b_idx()].name = "B"
        if local:
            occ = self.calc_match_occupancy()
            z = sum(occ[k] * (n_nodes - k + 1) for k in range(1, n_nodes))
            for k in range(1, n_nodes):
                m.states[self.b_idx()].trans.append(Transition(
                    "", "", self.m_idx(k), W.double_constant(occ[k] / z)))
        else:
            b = m.states[self.b_idx()]
            b.trans.append(Transition("", "", self.m_idx(1),
                                      W.double_constant(self.b_to_m1)))
            b.trans.append(Transition("", "", self.i_idx(0),
                                      W.double_constant(self.b_to_i0)))
            b.trans.append(Transition("", "", self.d_idx(1),
                                      W.double_constant(self.b_to_d1)))

        ix0 = m.states[self.ix_idx(0)]
        ix0.trans.append(Transition("", "", self.m_idx(1),
                                    W.double_constant(self.i0_to_m1)))
        ix0.trans.append(Transition("", "", self.i_idx(0),
                                    W.double_constant(self.i0_to_i0)))
        for sym_i, sym in enumerate(self.alph):
            m.states[self.i_idx(0)].trans.append(Transition(
                "", sym, self.ix_idx(0),
                W.double_constant(self.ins0_emit[sym_i])))

        for n in range(n_nodes + 1):
            ns = str(n)
            m.states[self.i_idx(n)].name = "I" + ns
            m.states[self.ix_idx(n)].name = "Ix" + ns
            if n > 0:
                m.states[self.m_idx(n)].name = "M" + ns
                m.states[self.mx_idx(n)].name = "Mx" + ns
                m.states[self.d_idx(n)].name = "D" + ns
                node = self.node[n - 1]
                end = n == n_nodes
                mx = m.states[self.mx_idx(n)]
                if end:
                    if not local:
                        mx.trans.append(Transition(
                            "", "", self.core_end_idx(),
                            W.double_constant(node.m_to_m)))
                else:
                    mx.trans.append(Transition(
                        "", "", self.m_idx(n + 1),
                        W.double_constant(node.m_to_m)))
                mx.trans.append(Transition("", "", self.i_idx(n),
                                           W.double_constant(node.m_to_i)))
                if not end:
                    mx.trans.append(Transition(
                        "", "", self.d_idx(n + 1),
                        W.double_constant(node.m_to_d)))
                ix = m.states[self.ix_idx(n)]
                ix.trans.append(Transition(
                    "", "", self.core_end_idx() if end else self.m_idx(n + 1),
                    W.double_constant(node.i_to_m)))
                ix.trans.append(Transition("", "", self.i_idx(n),
                                           W.double_constant(node.i_to_i)))
                dd = m.states[self.d_idx(n)]
                if end:
                    if not local:
                        dd.trans.append(Transition(
                            "", "", self.core_end_idx(),
                            W.double_constant(node.d_to_m)))
                else:
                    dd.trans.append(Transition(
                        "", "", self.m_idx(n + 1),
                        W.double_constant(node.d_to_m)))
                    dd.trans.append(Transition(
                        "", "", self.d_idx(n + 1),
                        W.double_constant(node.d_to_d)))
                for sym_i, sym in enumerate(self.alph):
                    m.states[self.m_idx(n)].trans.append(Transition(
                        "", sym, self.mx_idx(n),
                        W.double_constant(node.match_emit[sym_i])))
                    m.states[self.i_idx(n)].trans.append(Transition(
                        "", sym, self.ix_idx(n),
                        W.double_constant(node.ins_emit[sym_i])))
                if local:
                    # unit-weight exits to E from M and D (p7_profile_GetT)
                    m.states[self.m_idx(n)].trans.append(Transition(
                        "", "", self.core_end_idx(), W.ONE))
                    m.states[self.d_idx(n)].trans.append(Transition(
                        "", "", self.core_end_idx(), W.ONE))
        m.states[self.core_end_idx()].name = "E"
        return m

    def plan7_machine(self, multihit=False, length=400.0):
        if not self.node:
            raise ValueError("Attempt to create a Plan7 transducer from an"
                             " empty HMMER model")
        if len(self.null_emit) != len(self.alph):
            raise ValueError("Null model not loaded")
        core = self.machine(True)
        m = Machine([State() for _ in range(self.n_plan7_states())])
        for i in range(self.n_core_states()):
            m.states[i] = core.states[i].clone()
        m.states[self.plan7_b_idx()] = m.states[self.b_idx()]
        m.states[self.plan7_b_idx()].name = "B"
        m.states[self.b_idx()] = State("S")
        m.states[self.b_idx()].trans.append(Transition(
            "", "", self.nx_idx(), W.double_constant(1.0)))

        m.states[self.n_idx()].name = "N"
        for sym_i, sym in enumerate(self.alph):
            m.states[self.n_idx()].trans.append(Transition(
                "", sym, self.nx_idx(),
                W.double_constant(self.null_emit[sym_i])))
        m.states[self.nx_idx()].name = "Nx"
        m.states[self.nx_idx()].trans.append(Transition(
            "", "", self.n_idx(), W.double_constant(length / (length + 1))))
        m.states[self.nx_idx()].trans.append(Transition(
            "", "", self.plan7_b_idx(),
            W.double_constant(1.0 / (length + 1))))

        e = m.states[self.core_end_idx()]
        if multihit:
            e.trans.append(Transition("", "", self.cx_idx(),
                                      W.double_constant(0.5)))
            e.trans.append(Transition("", "", self.jx_idx(),
                                      W.double_constant(0.5)))
        else:
            e.trans.append(Transition("", "", self.cx_idx(),
                                      W.double_constant(1.0)))

        m.states[self.c_idx()].name = "C"
        for sym_i, sym in enumerate(self.alph):
            m.states[self.c_idx()].trans.append(Transition(
                "", sym, self.cx_idx(),
                W.double_constant(self.null_emit[sym_i])))
        m.states[self.cx_idx()].name = "Cx"
        m.states[self.cx_idx()].trans.append(Transition(
            "", "", self.c_idx(), W.double_constant(length / (length + 1))))
        m.states[self.cx_idx()].trans.append(Transition(
            "", "", self.t_idx(), W.double_constant(1.0 / (length + 1))))

        m.states[self.j_idx()].name = "J"
        m.states[self.jx_idx()].name = "Jx"
        if multihit:
            for sym_i, sym in enumerate(self.alph):
                m.states[self.j_idx()].trans.append(Transition(
                    "", sym, self.jx_idx(),
                    W.double_constant(self.null_emit[sym_i])))
            m.states[self.jx_idx()].trans.append(Transition(
                "", "", self.j_idx(),
                W.double_constant(length / (length + 1))))
            m.states[self.jx_idx()].trans.append(Transition(
                "", "", self.plan7_b_idx(),
                W.double_constant(1.0 / (length + 1))))

        m.states[self.t_idx()].name = "T"
        return m
