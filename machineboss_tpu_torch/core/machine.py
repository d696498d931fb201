"""Weighted finite-state transducer data structure and manipulation algebra.

The host-side machine core of the TPU framework: transducers are JSON-backed
graphs manipulated symbolically on the host, then lowered to dense/sparse
device tensors (ops/lowering.py) for DP on TPU.

Feature surface and JSON formats match the reference machine core
(ref: src/machine.{h,cpp}): composition, intersection, concatenation, union,
Kleene closures, reversal, transposition, normalization, silent-transition
elimination, state merging, sorting, downsampling, and byte-compatible JSON
and GraphViz DOT output.

Conventions (ref: src/machine.h:82-83):
  - start state is index 0, end state is the last index
  - a transition's empty input/output symbol is '' (epsilon)
  - state names are arbitrary JSON values (None = unnamed)
"""

import json as _json
import heapq

from . import weight as W
from .params import Params, Constraints
from ..utils.jsonfmt import write_escaped

WAIT_TAG = "wait"
CAT_LEFT_TAG = "concat-l"
CAT_RIGHT_TAG = "concat-r"
DEFAULT_SEQ_TAG = "seq"

# silent-cycle strategies (ref: src/machine.h Machine::SilentCycleStrategy)
LEAVE_SILENT_CYCLES = 0
BREAK_SILENT_CYCLES = 1
SUM_SILENT_CYCLES = 2

# Native (C++) fast-path gating: the native core (native/libmbcore.so) is
# byte-identical to this module (tests/test_native_parity.py) and takes over
# the hot graph ops for large machines. MB_NATIVE=1 forces it everywhere,
# MB_NATIVE=0 disables it; default uses it above these size thresholds.
NATIVE_COMPOSE_MIN_PRODUCT = 20000

# advancing_machine switches from the reference's recursive silent fold to
# the SCC-aware Kleene closure above this silent-SCC size (the fold is
# super-polynomial in the SCC span; see eliminate_silent_cycles)
SILENT_SCC_FOLD_LIMIT = 8
NATIVE_TRANSFORM_MIN_STATES = 2000


def _native_mode():
    import os
    v = os.environ.get("MB_NATIVE", "")
    if v == "0":
        return "off"
    if v == "1":
        return "force"
    return "auto"


def _native_lib():
    if _native_mode() == "off":
        return None
    from .. import native
    return native if native.available() else None


def name_dump(name):
    """nlohmann::json::dump() compatible compact dump (sorted object keys)."""
    return _json.dumps(name, separators=(",", ":"), sort_keys=True,
                       ensure_ascii=False)


def _is_json_pair(v):
    return isinstance(v, list) and len(v) == 2 and isinstance(v[0], str)


def make_pair_name(a, b):
    """Composite state name, replicating nlohmann::json brace-initialization:
    {a, b} becomes an OBJECT {a[0]:a[1], b[0]:b[1]} when both elements are
    2-element arrays whose first element is a string, else the array [a, b].
    Duplicate keys keep the first value (std::map emplace semantics)."""
    if _is_json_pair(a) and _is_json_pair(b):
        obj = {a[0]: a[1]}
        if b[0] not in obj:
            obj[b[0]] = b[1]
        return obj
    return [a, b]


class Transition:
    __slots__ = ("in_", "out", "dest", "weight")

    def __init__(self, in_="", out="", dest=0, weight=W.ONE):
        self.in_ = in_
        self.out = out
        self.dest = dest
        self.weight = weight

    def input_empty(self):
        return self.in_ == ""

    def output_empty(self):
        return self.out == ""

    def is_silent(self):
        return self.in_ == "" and self.out == ""

    def is_loud(self):
        return self.in_ != "" or self.out != ""

    def clone(self):
        return Transition(self.in_, self.out, self.dest, self.weight)

    def __repr__(self):
        return "Transition(%r,%r,%d,%r)" % (self.in_, self.out, self.dest,
                                            self.weight)


class State:
    __slots__ = ("name", "trans")

    def __init__(self, name=None, trans=None):
        self.name = name
        self.trans = trans if trans is not None else []

    def clone(self):
        return State(self.name, [t.clone() for t in self.trans])

    def terminates(self):
        return not self.trans

    def exits_with_input(self):
        return any(not t.input_empty() for t in self.trans)

    def exits_without_input(self):
        return any(t.input_empty() for t in self.trans)

    def exits_with_io(self):
        return any(t.is_loud() for t in self.trans)

    def exits_without_io(self):
        return any(t.is_silent() for t in self.trans)

    def waits(self):
        return not self.exits_without_input()

    def continues(self):
        return not self.exits_with_input() and not self.terminates()

    def is_silent(self):
        return not self.exits_with_io()

    def is_loud(self):
        return self.exits_with_io() and not self.exits_without_io()

    def get_transition(self, n):
        return self.trans[n]

    def find_transition(self, t):
        for n, mt in enumerate(self.trans):
            if mt.in_ == t.in_ and mt.out == t.out and mt.dest == t.dest:
                return n
        raise ValueError("Transition not found")


class TransAccumulator:
    """Collapses degenerate transitions, summing weights per (dest,in,out).

    Output order follows the reference's nested std::map iteration:
    dest ascending, then input symbol, then output symbol (ref:
    src/machine.cpp TransAccumulator::transitions).
    """

    def __init__(self):
        self.t = {}

    def clear(self):
        self.t = {}

    def accumulate(self, in_, out, dest, w):
        key = (dest, in_, out)
        if key in self.t:
            self.t[key] = W.add(w, self.t[key])
        else:
            self.t[key] = w

    def accumulate_trans(self, t):
        self.accumulate(t.in_, t.out, t.dest, t.weight)

    def transitions(self):
        return [Transition(in_, out, dest, w)
                for (dest, in_, out), w in sorted(self.t.items())]


class Machine:
    def __init__(self, states=None, funcs=None, cons=None):
        self.states = states if states is not None else []
        self.funcs = funcs if funcs is not None else Params()
        self.cons = cons if cons is not None else Constraints()

    # ------------------------------------------------------------------ basics

    def clone(self):
        m = Machine([s.clone() for s in self.states],
                    Params(self.funcs.defs),
                    Constraints(self.cons.prob, self.cons.rate, self.cons.norm))
        return m

    def n_states(self):
        return len(self.states)

    def n_transitions(self):
        return sum(len(s.trans) for s in self.states)

    def n_conditioned_transitions(self):
        """Max transitions conditional on one (in,out) label, plus silent ones."""
        count = {}
        null_count = 0
        for ms in self.states:
            for t in ms.trans:
                if t.is_silent():
                    null_count += 1
                else:
                    k = (t.in_, t.out)
                    count[k] = count.get(k, 0) + 1
        return (max(count.values()) if count else 0) + null_count

    def start_state(self):
        if not self.states:
            raise ValueError("Machine has no states")
        return 0

    def end_state(self):
        if not self.states:
            raise ValueError("Machine has no states")
        return len(self.states) - 1

    def state_name_json(self, s):
        if self.states[s].name is None:
            return str(s)
        return name_dump(self.states[s].name)

    def input_alphabet(self):
        return sorted({t.in_ for ms in self.states for t in ms.trans
                       if t.in_ != ""})

    def output_alphabet(self):
        return sorted({t.out for ms in self.states for t in ms.trans
                       if t.out != ""})

    def params(self):
        p = set()
        for ms in self.states:
            for t in ms.trans:
                p |= W.params_of(t.weight, self.funcs.defs)
        return p

    def get_param_defs(self, use_defaults=False):
        p = Params(self.funcs.defs)
        if use_defaults:
            p = self.cons.default_params().combine(p, True)
        return p

    def state_names_all_null(self):
        return all(ms.name is None for ms in self.states)

    def input_empty(self):
        return not self.input_alphabet()

    def output_empty(self):
        return not self.output_alphabet()

    def import_from(self, *others, overwrite=False):
        for m in others:
            self.funcs = self.funcs.combine(m.funcs, overwrite)
            self.cons = self.cons.combine(m.cons)

    # ------------------------------------------------------------ constructors

    @staticmethod
    def null():
        """One state, no transitions: unit weight for the empty string."""
        return Machine([State()])

    @staticmethod
    def zero():
        """Two states, no transitions: zero weight for every string."""
        return Machine([State(), State()])

    @staticmethod
    def single_transition(weight):
        m = Machine([State("trans-start"), State("trans-end")])
        m.states[0].trans.append(Transition("", "", 1, weight))
        return m

    @staticmethod
    def generator(seq, name=DEFAULT_SEQ_TAG):
        m = Machine([State([name, pos]) for pos in range(len(seq) + 1)])
        for pos, sym in enumerate(seq):
            m.states[pos].trans.append(Transition("", sym, pos + 1, W.ONE))
        return m

    @staticmethod
    def recognizer(seq, name=DEFAULT_SEQ_TAG):
        m = Machine([State([name, pos]) for pos in range(len(seq) + 1)])
        for pos, sym in enumerate(seq):
            m.states[pos].trans.append(Transition(sym, "", pos + 1, W.ONE))
        return m

    @staticmethod
    def echo(seq, name=DEFAULT_SEQ_TAG):
        return Machine.generator(seq, name).project_output_to_input()

    @staticmethod
    def wild_generator(symbols):
        st = State(list(symbols))
        for sym in symbols:
            st.trans.append(Transition("", sym, 0, W.ONE))
        return Machine([st])

    @staticmethod
    def wild_recognizer(symbols):
        st = State(list(symbols))
        for sym in symbols:
            st.trans.append(Transition(sym, "", 0, W.ONE))
        return Machine([st])

    @staticmethod
    def wild_echo(symbols):
        st = State(list(symbols))
        for sym in symbols:
            st.trans.append(Transition(sym, sym, 0, W.ONE))
        return Machine([st])

    @staticmethod
    def wild_single_generator(symbols):
        st = State(list(symbols))
        for sym in symbols:
            st.trans.append(Transition("", sym, 1, W.ONE))
        return Machine([st, State("end")])

    @staticmethod
    def wild_single_recognizer(symbols):
        st = State(list(symbols))
        for sym in symbols:
            st.trans.append(Transition(sym, "", 1, W.ONE))
        return Machine([st, State("end")])

    @staticmethod
    def wild_single_echo(symbols):
        st = State(list(symbols))
        for sym in symbols:
            st.trans.append(Transition(sym, sym, 1, W.ONE))
        return Machine([st, State("end")])

    # ------------------------------------------------------------- projections

    def project_output_to_input(self):
        if not self.input_empty():
            raise ValueError("Attempt to project output->input for transducer"
                             " whose input is nonempty")
        m = self.clone()
        for ms in m.states:
            for t in ms.trans:
                t.in_ = t.out
        return m

    def project_input_to_output(self):
        if not self.output_empty():
            raise ValueError("Attempt to project input->output for transducer"
                             " whose output is nonempty")
        m = self.clone()
        for ms in m.states:
            for t in ms.trans:
                t.out = t.in_
        return m

    def silence_input(self):
        m = self.clone()
        for ms in m.states:
            for t in ms.trans:
                t.in_ = ""
        return m

    def silence_output(self):
        m = self.clone()
        for ms in m.states:
            for t in ms.trans:
                t.out = ""
        return m

    # --------------------------------------------------------------- weighting

    def weight_inputs(self, w_or_macro=W.DEFAULT_MACRO):
        w = (w_or_macro if isinstance(w_or_macro, dict)
             else W.make_symbol_exprs(self.input_alphabet(), w_or_macro))
        m = self.clone()
        for ms in m.states:
            for t in ms.trans:
                if not t.input_empty():
                    t.weight = W.multiply(t.weight, w[t.in_])
        return m

    def weight_outputs(self, w_or_macro=W.DEFAULT_MACRO):
        w = (w_or_macro if isinstance(w_or_macro, dict)
             else W.make_symbol_exprs(self.output_alphabet(), w_or_macro))
        m = self.clone()
        for ms in m.states:
            for t in ms.trans:
                if not t.output_empty():
                    t.weight = W.multiply(t.weight, w[t.out])
        return m

    def weight_inputs_geometrically(self, gp):
        gw = W.from_json(_json.loads(gp))
        return Machine.concatenate(
            self.weight_inputs(gp),
            Machine.single_transition(W.negate(gw)))

    def weight_outputs_geometrically(self, gp):
        gw = W.from_json(_json.loads(gp))
        return Machine.concatenate(
            self.weight_outputs(gp),
            Machine.single_transition(W.negate(gw)))

    def normalize_jointly(self):
        m = self.clone()
        for ms in m.states:
            norm = W.ZERO
            for t in ms.trans:
                norm = W.add(norm, t.weight)
            for t in ms.trans:
                t.weight = W.divide(t.weight, norm)
        return m

    def normalize_conditionally(self):
        m = self.clone()
        alph = m.input_alphabet() + [""]
        for ms in m.states:
            for in_sym in alph:
                norm = W.ZERO
                for t in ms.trans:
                    if t.in_ == in_sym:
                        norm = W.add(norm, t.weight)
                for t in ms.trans:
                    if t.in_ == in_sym:
                        t.weight = W.divide(t.weight, norm)
        return m

    def pointwise_reciprocal(self):
        m = self.clone()
        for ms in m.states:
            for t in ms.trans:
                t.weight = W.reciprocal(t.weight)
        return m

    # -------------------------------------------------------------- predicates

    def is_ergodic_machine(self):
        acc = self.accessible_states()
        return len(acc) == self.n_states() and (self.n_states() - 1) in acc

    def is_waiting_machine(self):
        return all(ms.waits() or ms.continues() for ms in self.states)

    def is_advancing_machine(self):
        for s in range(1, self.n_states()):
            for t in self.states[s].trans:
                if t.is_silent() and t.dest <= s:
                    return False
        return True

    def is_decoding_machine(self):
        for s in range(1, self.n_states()):
            for t in self.states[s].trans:
                if t.output_empty() and t.dest <= s:
                    return False
        return True

    def is_toposorted_machine(self, exclude_self_loops=False):
        for s in range(1, self.n_states()):
            for t in self.states[s].trans:
                if (t.dest <= s) if exclude_self_loops else (t.dest < s):
                    return False
        return True

    def is_aligning_machine(self):
        for ms in self.states:
            seen = set()
            for t in ms.trans:
                key = (t.dest, t.in_, t.out)
                if key in seen:
                    return False
                seen.add(key)
        return True

    def n_back_transitions(self):
        return sum(1 for s in range(1, self.n_states())
                   for t in self.states[s].trans if t.dest <= s)

    def n_silent_back_transitions(self):
        return sum(1 for s in range(1, self.n_states())
                   for t in self.states[s].trans
                   if t.is_silent() and t.dest <= s)

    def n_empty_output_back_transitions(self):
        return sum(1 for s in range(1, self.n_states())
                   for t in self.states[s].trans
                   if t.output_empty() and t.dest <= s)

    # ----------------------------------------------------------- accessibility

    def accessible_states(self):
        n = self.n_states()
        fwd = [False] * n
        stack = [0]
        fwd[0] = True
        while stack:
            c = stack.pop()
            for t in self.states[c].trans:
                if not fwd[t.dest]:
                    fwd[t.dest] = True
                    stack.append(t.dest)
        back = [False] * n
        sources = [[] for _ in range(n)]
        for s in range(n):
            for t in self.states[s].trans:
                sources[t.dest].append(s)
        stack = [n - 1]
        back[n - 1] = True
        while stack:
            c = stack.pop()
            for src in sources[c]:
                if not back[src]:
                    back[src] = True
                    stack.append(src)
        return {s for s in range(n) if fwd[s] and back[s]}

    def ergodic_machine(self):
        """Remove unreachable states; collapse unit-silent chains (ref :996)."""
        if self.is_ergodic_machine():
            return self
        em = Machine()
        em.import_from(self)
        n = self.n_states()
        keep = [False] * n
        for s in self.accessible_states():
            keep[s] = True
        if not keep[n - 1]:
            return Machine.zero()
        null_equiv = {}
        for s in range(n):
            if keep[s]:
                d = s
                seen = set()
                while (len(self.states[d].trans) == 1
                       and self.states[d].trans[0].is_silent()
                       and W.is_one(self.states[d].trans[0].weight)
                       and d not in seen):
                    seen.add(d)
                    d = self.states[d].trans[0].dest
                if d != s:
                    null_equiv[s] = d
        old2new = [0] * n
        ns = 0
        for s in range(n):
            if keep[s] and s not in null_equiv:
                old2new[s] = ns
                ns += 1
        for s in range(n):
            if keep[s] and s in null_equiv:
                old2new[s] = old2new[null_equiv[s]]
        if ns == 0:
            return Machine.zero()
        for s in range(n):
            if keep[s] and s not in null_equiv:
                st = State(self.states[s].name)
                for t in self.states[s].trans:
                    if keep[t.dest]:
                        st.trans.append(
                            Transition(t.in_, t.out, old2new[t.dest], t.weight))
                em.states.append(st)
        return em

    def waiting_machine(self, wait_tag=WAIT_TAG, continue_tag=None):
        """Split mixed states into continue+wait pairs (ref :1053)."""
        if self.is_waiting_machine():
            return self
        wm = Machine()
        wm.import_from(self)
        new_states = [s.clone() for s in self.states]
        old2new = [0] * self.n_states()
        new2old = []
        for s in range(self.n_states()):
            ms = self.states[s]
            old2new[s] = len(new2old)
            new2old.append(s)
            if not ms.waits() and not ms.continues():
                c = State()
                w = State()
                if continue_tag is not None:
                    c.name = {continue_tag: ms.name}
                else:
                    c.name = ms.name
                w.name = {wait_tag: ms.name}
                for t in ms.trans:
                    (c if t.input_empty() else w).trans.append(t.clone())
                c.trans.append(Transition("", "", len(new_states), W.ONE))
                old2new.append(len(new2old))
                new2old.append(len(new_states))
                new_states[s] = c
                new_states.append(w)
        for s in new2old:
            ms = new_states[s]
            for t in ms.trans:
                t.dest = old2new[t.dest]
            wm.states.append(ms)
        return wm

    # ------------------------------------------------------------- composition

    @staticmethod
    def compose(first, orig_second, assign_state_names=True,
                collapse_degenerate=True, cycle_strategy=SUM_SILENT_CYCLES):
        """first's output feeds second's input (ref: src/machine.cpp:794)."""
        native = _native_lib()
        # the composed machine's silent SCCs are bounded by the product
        # of first's largest INPUT-EMPTY-edge SCC and second's largest
        # OUTPUT-EMPTY-edge SCC: a composed silent transition is either
        # (first silent, second stays) or (first out-only, second
        # in-only absorbing), so a composite silent cycle projects to a
        # closed in-empty walk in first and a closed out-empty walk in
        # second. Above the fold limit Python switches to the SCC-Kleene
        # closure (eliminate_silent_cycles), which the native core does
        # not implement — keep such machines on the Python path so
        # native stays byte-identical
        scc_bound = (max(first.max_silent_scc_size(
                         lambda t: t.input_empty()), 1)
                     * max(orig_second.max_silent_scc_size(
                           lambda t: t.output_empty()), 1))
        if (native is not None and assign_state_names and collapse_degenerate
                and scc_bound <= SILENT_SCC_FOLD_LIMIT
                and (_native_mode() == "force"
                     or first.n_states() * orig_second.n_states()
                     >= NATIVE_COMPOSE_MIN_PRODUCT)):
            out = native.compose_json(first.to_json_str(),
                                      orig_second.to_json_str(),
                                      cycle_strategy)
            result = Machine.from_json(_json.loads(out))
            result.import_from(first, orig_second)
            return result
        second = (orig_second if orig_second.is_waiting_machine()
                  else orig_second.waiting_machine())
        i_states, j_states = first.n_states(), second.n_states()
        assign_state_names = (assign_state_names
                              and not first.state_names_all_null()
                              and not second.state_names_all_null())

        # second's transitions grouped by input symbol, in list order (the
        # emit order below is unchanged — this only replaces the O(|trans|)
        # scan per first-transition with a dict hit; a dense waiting
        # machine like a substitution transducer has |alphabet|^2 + 2
        # |alphabet| transitions per state and the scan dominated compose)
        sec_by_in = []
        for j in range(j_states):
            by_in = {}
            for jt in second.states[j].trans:
                by_in.setdefault(jt.in_, []).append(jt)
            sec_by_in.append(by_in)

        # DFS accessibility prefilter over the product space
        keep = [False] * (i_states * j_states)
        to_visit = [0]
        keep[0] = True
        kept = []
        sec_waits = [second.states[j].waits() or second.states[j].terminates()
                     for j in range(j_states)]
        while to_visit:
            c = to_visit.pop()
            kept.append(c)
            i, j = divmod(c, j_states)
            msi, msj = first.states[i], second.states[j]
            dest = []
            if sec_waits[j]:
                for it in msi.trans:
                    if it.output_empty():
                        dest.append(it.dest * j_states + j)
                    else:
                        for jt in sec_by_in[j].get(it.out, ()):
                            dest.append(it.dest * j_states + jt.dest)
            else:
                for jt in msj.trans:
                    dest.append(i * j_states + jt.dest)
            for d in dest:
                if not keep[d]:
                    keep[d] = True
                    to_visit.append(d)
        if not keep[i_states * j_states - 1]:
            return Machine.zero()
        kept.sort()
        comp2kept = {c: k for k, c in enumerate(kept)}

        comp = Machine()
        comp.import_from(first, second)
        comp.states = [State() for _ in kept]
        if assign_state_names:
            for k, c in enumerate(kept):
                i, j = divmod(c, j_states)
                comp.states[k].name = make_pair_name(
                    first.states[i].name, second.states[j].name)
        for k, c in enumerate(kept):
            i, j = divmod(c, j_states)
            msi, msj = first.states[i], second.states[j]
            ms = comp.states[k]
            ta = TransAccumulator() if collapse_degenerate else None
            out = ms.trans

            def emit(in_, o, d, w):
                if ta is not None:
                    ta.accumulate(in_, o, d, w)
                else:
                    out.append(Transition(in_, o, d, w))

            if sec_waits[j]:
                for it in msi.trans:
                    if it.output_empty():
                        d = it.dest * j_states + j
                        if keep[d]:
                            emit(it.in_, "", comp2kept[d], it.weight)
                    else:
                        for jt in sec_by_in[j].get(it.out, ()):
                            d = it.dest * j_states + jt.dest
                            if keep[d]:
                                emit(it.in_, jt.out, comp2kept[d],
                                     W.multiply(it.weight, jt.weight))
            else:
                for jt in msj.trans:
                    d = i * j_states + jt.dest
                    if keep[d]:
                        emit("", jt.out, comp2kept[d], jt.weight)
            if ta is not None:
                ms.trans = ta.transitions()
        return (comp.ergodic_machine().advance_sort()
                .process_cycles(cycle_strategy).ergodic_machine())

    @staticmethod
    def intersect(first, orig_second, cycle_strategy=SUM_SILENT_CYCLES):
        """Intersection of two recognizers (ref: src/machine.cpp:909)."""
        if first.output_alphabet() or orig_second.output_alphabet():
            raise ValueError("Attempt to intersect transducers A&B with"
                             " nonempty output alphabets")
        native = _native_lib()
        # intersect pairs transitions with EQUAL input; a composite
        # silent cycle projects to in-empty cycles in both operands
        scc_bound = (max(first.max_silent_scc_size(
                         lambda t: t.input_empty()), 1)
                     * max(orig_second.max_silent_scc_size(
                           lambda t: t.input_empty()), 1))
        if (native is not None
                and scc_bound <= SILENT_SCC_FOLD_LIMIT
                and (_native_mode() == "force"
                     or first.n_states() * orig_second.n_states()
                     >= NATIVE_COMPOSE_MIN_PRODUCT)):
            out = native.combine_json("intersect", first.to_json_str(),
                                      orig_second.to_json_str(),
                                      cycle_strategy=cycle_strategy)
            result = Machine.from_json(_json.loads(out))
            result.import_from(first, orig_second)
            return result
        second = (orig_second if orig_second.is_waiting_machine()
                  else orig_second.waiting_machine())
        inter = Machine()
        inter.import_from(first, second)
        nj = second.n_states()
        inter.states = [State() for _ in range(first.n_states() * nj)]
        assign = (not first.state_names_all_null()
                  and not second.state_names_all_null())
        for i in range(first.n_states()):
            for j in range(nj):
                ms = inter.states[i * nj + j]
                if assign:
                    ms.name = make_pair_name(first.states[i].name,
                                             second.states[j].name)
                msi, msj = first.states[i], second.states[j]
                if msj.waits() or msj.terminates():
                    for it in msi.trans:
                        if it.input_empty():
                            ms.trans.append(Transition(
                                it.in_, "", it.dest * nj + j, it.weight))
                        else:
                            for jt in msj.trans:
                                if it.in_ == jt.in_:
                                    ms.trans.append(Transition(
                                        it.in_, "", it.dest * nj + jt.dest,
                                        W.multiply(it.weight, jt.weight)))
                else:
                    for jt in msj.trans:
                        ms.trans.append(Transition(
                            "", "", i * nj + jt.dest, jt.weight))
        return (inter.ergodic_machine().advance_sort()
                .process_cycles(cycle_strategy).ergodic_machine())

    # ---------------------------------------------------- concat/union/closure

    @staticmethod
    def concatenate(left, right, left_tag=CAT_LEFT_TAG, right_tag=CAT_RIGHT_TAG):
        if not left.n_states() or not right.n_states():
            raise ValueError("Attempt to concatenate uninitialized transducer")
        m = left.clone()
        m.import_from(left, right)
        for ms in m.states:
            if ms.name is not None:
                ms.name = [left_tag, ms.name]
        offset = left.n_states()
        for rs in right.states:
            ms = rs.clone()
            if ms.name is not None:
                ms.name = [right_tag, ms.name]
            for t in ms.trans:
                t.dest += offset
            m.states.append(ms)
        m.states[left.end_state()].trans.append(
            Transition("", "", right.start_state() + offset, W.ONE))
        return m

    @staticmethod
    def take_union(first, second, p_first=None, p_second=None):
        if not first.n_states() or not second.n_states():
            raise ValueError("Attempt to find union of uninitialized transducer")
        if p_first is None:
            p_first, p_second = W.ONE, W.ONE
        elif p_second is None:
            p_second = W.negate(p_first)
        m = Machine()
        m.import_from(first, second)
        m.states.append(State())
        for s in range(first.n_states()):
            ms = first.states[s].clone()
            if ms.name is not None:
                ms.name = ["union-1", ms.name]
            for t in ms.trans:
                t.dest += 1
            m.states.append(ms)
        off2 = 1 + first.n_states()
        for s in range(second.n_states()):
            ms = second.states[s].clone()
            if ms.name is not None:
                ms.name = ["union-2", ms.name]
            for t in ms.trans:
                t.dest += off2
            m.states.append(ms)
        m.states.append(State())
        end = len(m.states) - 1
        m.states[0].trans.append(Transition("", "", 1, p_first))
        m.states[0].trans.append(Transition("", "", off2, p_second))
        m.states[1 + first.end_state()].trans.append(
            Transition("", "", end, W.ONE))
        m.states[off2 + second.end_state()].trans.append(
            Transition("", "", end, W.ONE))
        return m

    @staticmethod
    def zero_or_one(q):
        if not q.n_states():
            raise ValueError("Attempt to quantify uninitialized transducer")
        m = q.clone()
        if m.states[-1].trans:
            for ms in m.states:
                if ms.name is not None:
                    ms.name = ["quant-main", ms.name]
            m.states[-1].trans.append(
                Transition("", "", m.end_state() + 1, W.ONE))
            st = State()
            if not q.state_names_all_null():
                st.name = ["quant-end"]
            m.states.append(st)
        m.states[0].trans.append(Transition("", "", m.end_state(), W.ONE))
        return m

    @staticmethod
    def kleene_plus(k):
        if not k.n_states():
            raise ValueError("Attempt to form Kleene closure of uninitialized"
                             " transducer")
        m = Machine()
        m.import_from(k)
        front = State()
        if not k.state_names_all_null():
            front.name = "kleene-plus"
        m.states.append(front)
        for s in k.states:
            ms = s.clone()
            for t in ms.trans:
                t.dest += 1
            m.states.append(ms)
        m.states[0].trans.append(Transition("", "", 1, W.ONE))
        m.states[m.end_state()].trans.append(Transition("", "", 1, W.ONE))
        return m

    @staticmethod
    def kleene_star(k):
        return Machine.zero_or_one(Machine.kleene_plus(k))

    @staticmethod
    def kleene_loop(main, loop):
        if not main.n_states() or not loop.n_states():
            raise ValueError("Attempt to form Kleene closure of uninitialized"
                             " transducer")
        assign = (not main.state_names_all_null()
                  and not loop.state_names_all_null())
        m = main.clone()
        if assign:
            for ms in m.states:
                if ms.name is not None:
                    ms.name = ["loop-main", ms.name]
        off = main.n_states()
        for s in loop.states:
            ms = s.clone()
            if assign and ms.name is not None:
                ms.name = ["loop-continue", ms.name]
            for t in ms.trans:
                t.dest += off
            m.states.append(ms)
        tail = State()
        if assign:
            tail.name = ["loop-end"]
        m.states.append(tail)
        m.states[main.end_state()].trans.append(
            Transition("", "", off + loop.start_state(), W.ONE))
        m.states[main.end_state()].trans.append(
            Transition("", "", m.end_state(), W.ONE))
        m.states[off + loop.end_state()].trans.append(
            Transition("", "", m.start_state(), W.ONE))
        return m

    @staticmethod
    def kleene_count(m, count_param):
        result = Machine.kleene_star(
            Machine.concatenate(Machine.single_transition(count_param), m))
        result.funcs.defs[count_param] = W.ONE
        return result

    @staticmethod
    def repeat(m, copies):
        result = m
        for _ in range(1, copies):
            result = Machine.concatenate(result, m)
        return result

    def reverse(self):
        m = Machine()
        m.import_from(self)
        n = self.n_states()
        m.states = [State() for _ in range(n)]
        for s in range(n):
            r = n - 1 - s
            ms = self.states[s]
            m.states[r].name = ms.name
            for t in ms.trans:
                m.states[n - 1 - t.dest].trans.append(
                    Transition(t.in_, t.out, r, t.weight))
        return m

    def transpose(self):
        m = self.clone()
        for ms in m.states:
            for t in ms.trans:
                t.in_, t.out = t.out, t.in_
        return m

    # ------------------------------------------------------------------ sorting

    def advance_sort(self, kind="silent"):
        """Reorder states to minimize backward 'silent' transitions.

        kind selects what counts as must-advance (ref: src/machine.cpp:1245):
          'silent'  : silent transitions (default advanceSort)
          'decode'  : non-outputting transitions (decodeSort)
          'all'     : all transitions (toposort)
        """
        if kind == "silent":
            count_back = Machine.n_silent_back_transitions
            must_advance = Transition.is_silent
        elif kind == "decode":
            count_back = Machine.n_empty_output_back_transitions
            must_advance = Transition.output_empty
        else:
            count_back = Machine.n_back_transitions
            must_advance = lambda t: True

        n_back_before = count_back(self)
        if not n_back_before:
            return self

        n = self.n_states()
        silent_in = [[] for _ in range(n)]
        silent_out = [[] for _ in range(n)]
        n_in = [0] * n
        n_out = [0] * n
        for s in range(1, n - 1):
            for t in self.states[s].trans:
                if (must_advance(t) and t.dest != s and t.dest != n - 1
                        and t.dest != 0):
                    silent_out[s].append(t.dest)
                    silent_in[t.dest].append(s)
                    n_out[s] += 1
                    n_in[t.dest] += 1

        # lazy-deletion heap keyed (nIncoming, nIncoming-nOutgoing, index);
        # matches the reference's mutable-comparator std::set because keys are
        # always current at (re)insertion time
        heap = []
        entry = {}

        def key(s):
            return (n_in[s], n_in[s] - n_out[s], s)

        def insert_state(s):
            k = key(s)
            entry[s] = k
            heapq.heappush(heap, (k, s))

        def remove_state(s):
            if s in entry:
                del entry[s]
                return True
            return False

        order = []

        def add_to_order(s):
            order.append(s)
            for nxt in silent_out[s]:
                found = remove_state(nxt)
                n_in[nxt] -= 1
                if found:
                    insert_state(nxt)
            for prv in silent_in[s]:
                found = remove_state(prv)
                n_out[prv] -= 1
                if found:
                    insert_state(prv)

        add_to_order(0)
        if n > 1:
            for s in range(1, n - 1):
                insert_state(s)
            while entry:
                k, s = heapq.heappop(heap)
                if entry.get(s) != k:
                    continue
                del entry[s]
                add_to_order(s)
            add_to_order(n - 1)

        old2new = [0] * n
        changed = False
        for pos, s in enumerate(order):
            changed = changed or s != pos
            old2new[s] = pos

        if not changed:
            result = self
        else:
            result = Machine()
            result.import_from(self)
            for s in order:
                st = self.states[s].clone()
                for t in st.trans:
                    t.dest = old2new[t.dest]
                result.states.append(st)

        n_back_after = count_back(result)
        if n_back_after >= n_back_before and changed:
            # restore original order; keep the (possibly worse) count for the
            # padding comparison below, faithfully to the reference
            result = self

        if n_back_after and not self.has_null_padding_states():
            with_dummy = self.pad_with_null_states()
            sorted_dummy = with_dummy.advance_sort(kind)
            if count_back(sorted_dummy) < n_back_after:
                result = sorted_dummy
        return result

    def decode_sort(self):
        return self.advance_sort("decode")

    def encode_sort(self):
        return self.transpose().decode_sort().transpose()

    def toposort(self):
        return self.advance_sort("all")

    def pad_with_null_states(self):
        has_null_start = (bool(self.states)
                          and len(self.states[0].trans) == 1
                          and self.states[0].exits_without_io())
        if has_null_start:
            for ms in self.states:
                for t in ms.trans:
                    if t.dest == 0:
                        has_null_start = False
                        break
                if not has_null_start:
                    break
        dummy = Machine.null()
        result = self if has_null_start else Machine.concatenate(dummy, self)
        if result.has_null_padding_states():
            return result
        return Machine.concatenate(result, dummy)

    def has_null_padding_states(self):
        if not self.states:
            return False
        if not (len(self.states[0].trans) == 1
                and self.states[0].exits_without_io()):
            return False
        ssi, esi = 0, self.n_states() - 1
        if self.states[esi].trans:
            return False
        null_to_end = 0
        for ms in self.states:
            for t in ms.trans:
                if t.dest == ssi:
                    return False
                if t.dest == esi:
                    if not t.is_silent():
                        return False
                    null_to_end += 1
        return null_to_end == 1

    # ------------------------------------------------- silent-cycle processing

    def process_cycles(self, cycle_strategy=SUM_SILENT_CYCLES):
        if cycle_strategy == LEAVE_SILENT_CYCLES:
            return self
        if cycle_strategy == SUM_SILENT_CYCLES:
            return self.advancing_machine()
        return self.drop_silent_back_transitions()

    def drop_silent_back_transitions(self):
        if self.is_advancing_machine():
            return self
        am = Machine()
        am.import_from(self)
        for s in range(self.n_states()):
            st = State(self.states[s].name)
            for t in self.states[s].trans:
                if not (t.is_silent() and t.dest <= s):
                    st.trans.append(t.clone())
            am.states.append(st)
        return am

    def silent_sccs(self, pred=None):
        """Strongly-connected components of the silent-transition graph
        (iterative Tarjan; deterministic component order). `pred`
        selects the edge set (default Transition.is_silent; the compose
        gate passes input-empty / output-empty predicates, since a
        COMPOSED silent cycle projects to a cycle of in-empty
        transitions in the first operand and out-empty transitions in
        the second — not necessarily silent ones)."""
        if pred is None:
            pred = Transition.is_silent
        n = self.n_states()
        adj = [[] for _ in range(n)]
        for s in range(n):
            for t in self.states[s].trans:
                if pred(t):
                    adj[s].append(t.dest)
        index = [-1] * n
        low = [0] * n
        on_stack = [False] * n
        stack = []
        sccs = []
        counter = [0]
        for root in range(n):
            if index[root] != -1:
                continue
            work = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = low[v] = counter[0]
                    counter[0] += 1
                    stack.append(v)
                    on_stack[v] = True
                recurse = False
                for k in range(pi, len(adj[v])):
                    w = adj[v][k]
                    if index[w] == -1:
                        work[-1] = (v, k + 1)
                        work.append((w, 0))
                        recurse = True
                        break
                    if on_stack[w]:
                        low[v] = min(low[v], index[w])
                if recurse:
                    continue
                work.pop()
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp.append(w)
                        if w == v:
                            break
                    sccs.append(sorted(comp))
                if work:
                    u = work[-1][0]
                    low[u] = min(low[u], low[v])
        return sccs

    def max_silent_scc_size(self, pred=None):
        return max((len(c) for c in self.silent_sccs(pred)), default=0)

    def eliminate_silent_cycles(self):
        """SCC-aware silent-cycle elimination.

        Tarjan SCCs over the silent-transition graph; within each
        nontrivial SCC the all-pairs silent-path sum K[i][j] is computed
        by Lehmann/Kleene elimination in the weight star-semiring
        (star = W.geometric_sum), and each SCC state's transition list is
        rewritten to K[i][j] (x) (exits of j) with the intra-SCC silent
        edges removed — an equivalent machine whose silent graph is
        acyclic. advancing_machine switches to this when the silent graph
        has a large SCC: the legacy advancing fold (the reference's
        recursion, ref src/machine.cpp:1177-1243) is pathological there —
        a composed multihit Plan7's E->J->B re-entry makes one silent SCC
        spanning the whole delete chain and the fold takes >10 minutes on
        fn3.hmm (PERF.md) where this closure takes milliseconds. Both sum
        silent cycles exactly (SUM_SILENT_CYCLES semantics), so Forward
        and Viterbi are unchanged."""
        sccs = [c for c in self.silent_sccs() if len(c) > 1]
        if not sccs:
            return self
        end = self.n_states() - 1
        if any(end in c for c in sccs):
            # the rewrite collapses silent wandering into wander-then-
            # EXIT transitions, so paths that TERMINATE inside an SCC
            # (end state in the component) would lose their mass
            raise ValueError(
                "eliminate_silent_cycles: the end state lies inside a "
                "silent SCC; termination mass cannot be represented by "
                "the exit rewrite — use the legacy advancing fold")
        am = Machine()
        am.import_from(self)
        am.states = [st.clone() for st in self.states]
        for comp in sccs:
            k = len(comp)
            pos = {s: i for i, s in enumerate(comp)}
            in_c = set(comp)
            # A[i][j] = sum of parallel silent edges comp[i] -> comp[j]
            A = [[W.ZERO] * k for _ in range(k)]
            for i, s in enumerate(comp):
                for t in am.states[s].trans:
                    if t.is_silent() and t.dest in in_c:
                        j = pos[t.dest]
                        A[i][j] = W.add(A[i][j], t.weight)
            # Lehmann elimination: afterwards A[i][j] = sum over all
            # NONEMPTY silent paths i -> j inside the SCC
            all_numeric = all(W.is_number(x) for Ai in A for x in Ai)
            if all_numeric:
                import numpy as np
                # the common case (imported HMMs, bound params): run the
                # k^3 closure vectorized in float64 probability space —
                # the pure-Python expression fold below is ~1 us/op and
                # dominated fn3 compose at |SCC| ~ 180
                An = np.array(A, np.float64)
                ok_numeric = True
                for m in range(k):
                    amm = An[m, m]
                    if not amm < 1.0:      # divergent silent cycle
                        ok_numeric = False
                        break
                    smm = 1.0 / (1.0 - amm) if amm else 1.0
                    col = An[:, m] * smm
                    row = An[m, :].copy()
                    An += np.outer(col, row)
                if ok_numeric and np.isfinite(An).all():
                    A = [[W.double_constant(v) for v in row]
                         for row in An]
                else:
                    all_numeric = False
            if not all_numeric:

                def star(w):
                    # numeric geometric sums fold to constants here
                    # (unlike W.geometric_sum, whose 1/(1-p) tree is kept
                    # symbolic for the legacy fold's golden-stable
                    # output): the k^3 closure would otherwise build
                    # O(k)-deep expression trees
                    if W.is_number(w) and float(w) < 1.0:
                        return W.double_constant(1.0 / (1.0 - float(w)))
                    return W.geometric_sum(w)

                for m in range(k):
                    smm = W.ONE if W.is_zero(A[m][m]) else star(A[m][m])
                    col = [W.multiply(A[i][m], smm) for i in range(k)]
                    row = A[m]
                    newA = []
                    for i in range(k):
                        Ai = A[i]
                        if W.is_zero(col[i]):
                            newA.append(Ai)
                            continue
                        newA.append([W.add(Ai[j],
                                           W.multiply(col[i], row[j]))
                                     for j in range(k)])
                    A = newA
            # rewrite: state i's transitions = sum_j K[i][j] (x) exits(j),
            # K[i][j] = A[i][j] (+ 1 if i == j); intra-SCC silent edges die
            exits = []
            for s in comp:
                exits.append([t for t in am.states[s].trans
                              if not (t.is_silent() and t.dest in in_c)])
            for i, s in enumerate(comp):
                ta = TransAccumulator()
                for j in range(k):
                    kij = W.add(A[i][j], W.ONE) if i == j else A[i][j]
                    if W.is_zero(kij):
                        continue
                    for t in exits[j]:
                        ta.accumulate(t.in_, t.out, t.dest,
                                      W.multiply(kij, t.weight))
                am.states[s].trans = ta.transitions()
        return am

    def advancing_machine(self):
        """Eliminate silent back-transitions by path-sum forwarding (ref :1177)."""
        if self.is_advancing_machine():
            return self
        big_sccs = [c for c in self.silent_sccs()
                    if len(c) > SILENT_SCC_FOLD_LIMIT]
        if big_sccs and not any(self.n_states() - 1 in c
                                for c in big_sccs):
            # the legacy fold below is pathological on large silent SCCs
            # (composed multihit Plan7); close the cycles per-SCC instead,
            # then sort the now-acyclic silent graph forward. The
            # SCC-Kleene rewrite collapses silent wandering into the
            # wander-then-EXIT transitions, so it cannot represent
            # TERMINATING inside an SCC — if the end state sits in an
            # oversized SCC (pathological hand-built machines only; a
            # Plan7 end state is outside the E->J->B loop), stay on the
            # exact legacy fold instead of silently dropping that mass.
            return (self.eliminate_silent_cycles().advance_sort()
                    .advancing_machine())
        am = Machine()
        am.import_from(self)
        n = self.n_states()
        fwd_trans = {}

        def update_fwd(i, new_min):
            # iterative emulation of the reference's recursion (deep chains)
            visits = {}
            stack = [(i, new_min)]
            while stack:
                vkey = stack[-1]
                visits[vkey] = visits.get(vkey, 0) + 1
                if visits[vkey] > n + 2:
                    raise RuntimeError(
                        "silent-transition cycle while building advancing"
                        " machine (state %d)" % vkey[0])
                ii, mm = stack[-1]
                if (ii, mm) in fwd_trans:
                    stack.pop()
                    continue
                # dependencies
                deps = []
                if mm > ii and (ii, mm - 1) not in fwd_trans:
                    deps.append((ii, mm - 1))
                if mm > ii:
                    old = fwd_trans.get((ii, mm - 1))
                elif mm == ii:
                    old = self.states[mm].trans
                else:
                    old = []
                if old is not None:
                    for t in old:
                        if t.is_silent() and t.dest < mm and ii != t.dest:
                            if (t.dest, mm) not in fwd_trans:
                                deps.append((t.dest, mm))
                if deps:
                    stack.extend(deps)
                    continue
                stack.pop()
                new_list = []
                for t_ij in old:
                    if t_ij.is_loud():
                        new_list.append(t_ij)
                    else:
                        j = t_ij.dest
                        if j >= mm:
                            new_list.append(t_ij)
                        else:
                            src = old if ii == j else fwd_trans[(j, mm)]
                            for t_jk in src:
                                new_list.append(Transition(
                                    t_jk.in_, t_jk.out, t_jk.dest,
                                    W.multiply(t_ij.weight, t_jk.weight)))
                fwd_trans[(ii, mm)] = new_list

        for s in range(n):
            st = State(self.states[s].name)
            am.states.append(st)
            update_fwd(s, s)
            ta = TransAccumulator()
            for t in fwd_trans[(s, s)]:
                ta.accumulate_trans(t)
            et = ta.transitions()
            exit_self = W.ONE
            for t in et:
                if t.is_silent() and t.dest == s:
                    exit_self = W.geometric_sum(t.weight)
                else:
                    st.trans.append(t)
            if not W.is_one(exit_self):
                for t in st.trans:
                    t.weight = W.multiply(exit_self, t.weight)
            fwd_trans[(s, s)] = st.trans
        if not am.is_advancing_machine():
            raise RuntimeError("failed to create advancing machine")
        return am

    def eliminate_silent_transitions(self, cycle_strategy=SUM_SILENT_CYCLES):
        """Remove all silent transitions (ref: src/machine.cpp:1611)."""
        native = _native_lib()
        if native is not None and \
                self.max_silent_scc_size() <= SILENT_SCC_FOLD_LIMIT \
                and (_native_mode() == "force"
                     or self.n_states() >= NATIVE_TRANSFORM_MIN_STATES):
            out = native.transform_json(self.to_json_str(),
                                        "eliminate_silent",
                                        cycle_strategy=cycle_strategy)
            result = Machine.from_json(_json.loads(out))
            result.import_from(self)
            return result
        if not self.is_advancing_machine():
            return self.process_cycles(cycle_strategy) \
                       .eliminate_silent_transitions()
        em = Machine()
        em.import_from(self)
        n = self.n_states()
        if not n:
            return em
        em.states = [State(self.states[s].name) for s in range(n)]
        silent_trans = [[] for _ in range(n)]
        for s in range(n - 1, -1, -1):
            ms = self.states[s]
            ems = em.states[s]
            silent = TransAccumulator()
            loud = TransAccumulator()
            self_loop = W.ZERO
            for t in ms.trans:
                if t.is_silent():
                    if t.dest == s:
                        self_loop = W.add(self_loop, t.weight)
                    elif self.states[t.dest].terminates() or t.dest == n - 1:
                        silent.accumulate_trans(t)
                    else:
                        for t2 in silent_trans[t.dest]:
                            silent.accumulate(t.in_, t.out, t2.dest,
                                              W.multiply(t.weight, t2.weight))
                        for t2 in em.states[t.dest].trans:
                            loud.accumulate(t2.in_, t2.out, t2.dest,
                                            W.multiply(t.weight, t2.weight))
                else:
                    loud.accumulate_trans(t)
            ems.trans = loud.transitions()
            silent_trans[s] = silent.transitions()
            if not W.is_zero(self_loop):
                self_exit = W.geometric_sum(self_loop)
                for t in silent_trans[s]:
                    t.weight = W.multiply(self_exit, t.weight)
        for ems in em.states:
            loud = TransAccumulator()
            for t in ems.trans:
                loud.accumulate_trans(t)
                for t2 in silent_trans[t.dest]:
                    loud.accumulate(t.in_, t.out, t2.dest,
                                    W.multiply(t.weight, t2.weight))
            ems.trans = loud.transitions()
        em.states[0].trans.extend(silent_trans[0])
        return em.ergodic_machine()

    # --------------------------------------------------------- state reduction

    def eliminate_single_silent_incoming_states(self):
        rm = self if self.is_advancing_machine() else self.advance_sort()
        n = rm.n_states()
        n_silent_in = [0] * n
        n_loud_in = [0] * n
        actual_source = [0] * n
        entry_weight = [W.ONE] * n
        for s in range(n):
            for t in rm.states[s].trans:
                if t.is_silent():
                    n_silent_in[t.dest] += 1
                    actual_source[t.dest] = s
                    entry_weight[t.dest] = t.weight
                else:
                    n_loud_in[t.dest] += 1
        elim = [False] * n
        for s in range(1, n - 1):
            elim[s] = n_silent_in[s] == 1 and n_loud_in[s] == 0
        new_index = [0] * n
        old_index = []
        for s in range(n):
            if not elim[s]:
                new_index[s] = len(old_index)
                old_index.append(s)
        if len(old_index) == n:
            return rm
        em = Machine()
        em.import_from(rm)
        em.states = [State() for _ in old_index]
        for s in range(n):
            if not elim[s]:
                em.states[new_index[s]].name = rm.states[s].name
            a = s
            mul = W.ONE
            while elim[a]:
                mul = W.multiply(entry_weight[a], mul)
                a = actual_source[a]
            source = em.states[new_index[a]]
            for t in rm.states[s].trans:
                if not elim[t.dest]:
                    source.trans.append(Transition(
                        t.in_, t.out, new_index[t.dest],
                        W.multiply(t.weight, mul)))
        return em

    def eliminate_single_silent_outgoing_states(self):
        rm = self if self.is_advancing_machine() else self.advance_sort()
        n = rm.n_states()
        eventual_dest = [0] * n
        exit_mul = [W.ONE] * n
        for s in range(n - 1, -1, -1):
            t_idx = s
            mul = W.ONE
            while (t_idx != 0 and t_idx != n - 1
                   and len(rm.states[t_idx].trans) == 1):
                tr = rm.states[t_idx].trans[0]
                if not tr.is_silent():
                    break
                mul = W.multiply(mul, tr.weight)
                t_idx = tr.dest
            exit_mul[s] = mul
            eventual_dest[s] = t_idx
        new_index = [0] * n
        old_index = []
        for s in range(n):
            if eventual_dest[s] == s:
                new_index[s] = len(old_index)
                old_index.append(s)
        for s in range(n):
            if eventual_dest[s] != s:
                new_index[s] = new_index[eventual_dest[s]]
        if len(old_index) == n:
            return rm
        em = Machine()
        em.import_from(self)
        em.states = []
        for s in old_index:
            st = rm.states[s].clone()
            for t in st.trans:
                t.weight = W.multiply(t.weight, exit_mul[t.dest])
                t.dest = new_index[t.dest]
            em.states.append(st)
        return em

    def eliminate_redundant_states(self):
        return (self.eliminate_single_silent_incoming_states()
                    .eliminate_single_silent_outgoing_states())

    def merge_equivalent_states(self):
        """Merge states with identical outgoing transitions (ref :1435)."""
        native = _native_lib()
        if native is not None and (_native_mode() == "force"
                                   or self.n_states()
                                   >= NATIVE_TRANSFORM_MIN_STATES):
            out = native.transform_json(self.to_json_str(),
                                        "merge_equivalent")
            result = Machine.from_json(_json.loads(out))
            result.import_from(self)
            return result
        current = self
        while True:
            n_old = current.n_states()
            nxt = Machine()
            nxt.import_from(current)
            nxt.states = []
            for s in range(current.n_states()):
                ta = TransAccumulator()
                for t in current.states[s].trans:
                    ta.accumulate_trans(t)
                nxt.states.append(State(current.states[s].name,
                                        ta.transitions()))
            current = nxt
            sig_groups = {}
            for s in range(current.n_states()):
                parts = sorted(
                    "%d\t%s\t%s\t%s" % (t.dest, t.in_, t.out,
                                        W.to_json_str(t.weight))
                    for t in current.states[s].trans)
                sig = "\n".join(parts) + "\n"
                sig_groups.setdefault(sig, []).append(s)
            redirect = {}
            for states in sig_groups.values():
                if len(states) > 1:
                    rep = states[0]
                    for s in states:
                        if s == 0 or s == current.n_states() - 1:
                            rep = s
                            break
                    for s in states:
                        if s != rep:
                            redirect[s] = rep
            if not redirect:
                break
            for ms in current.states:
                for t in ms.trans:
                    if t.dest in redirect:
                        t.dest = redirect[t.dest]
            current = current.ergodic_machine()
            if current.n_states() == n_old:
                break
        final = Machine()
        final.import_from(current)
        final.states = []
        for s in range(current.n_states()):
            ta = TransAccumulator()
            for t in current.states[s].trans:
                ta.accumulate_trans(t)
            final.states.append(State(current.states[s].name,
                                      ta.transitions()))
        return final

    def subgraph(self, trans_allowed):
        result = self.clone()
        for s in range(self.n_states()):
            result.states[s].trans = [
                t.clone() for ti, t in enumerate(self.states[s].trans)
                if trans_allowed[s][ti]]
        return result.ergodic_machine().eliminate_redundant_states()

    def strip_names(self):
        m = self.clone()
        for ms in m.states:
            ms.name = None
        return m

    # ------------------------------------------------------------------ JSON IO

    @classmethod
    def from_json(cls, j):
        from .schema import validate_or_die
        validate_or_die("machine", j)
        # embedded machine-op expressions (ref: src/machine.cpp:347-460)
        if "compose" in j:
            return cls.compose(cls.from_json(j["compose"][0]),
                               cls.from_json(j["compose"][1]),
                               True, True, BREAK_SILENT_CYCLES)
        if "compose-sum" in j:
            return cls.compose(cls.from_json(j["compose-sum"][0]),
                               cls.from_json(j["compose-sum"][1]),
                               True, True, SUM_SILENT_CYCLES)
        if "compose-unsort" in j:
            return cls.compose(cls.from_json(j["compose-unsort"][0]),
                               cls.from_json(j["compose-unsort"][1]),
                               True, True, LEAVE_SILENT_CYCLES)
        if "concat" in j:
            return cls.concatenate(cls.from_json(j["concat"][0]),
                                   cls.from_json(j["concat"][1]))
        if "intersect" in j:
            return cls.intersect(cls.from_json(j["intersect"][0]),
                                 cls.from_json(j["intersect"][1]),
                                 BREAK_SILENT_CYCLES)
        if "intersect-sum" in j:
            return cls.intersect(cls.from_json(j["intersect-sum"][0]),
                                 cls.from_json(j["intersect-sum"][1]),
                                 SUM_SILENT_CYCLES)
        if "intersect-unsort" in j:
            return cls.intersect(cls.from_json(j["intersect-unsort"][0]),
                                 cls.from_json(j["intersect-unsort"][1]),
                                 LEAVE_SILENT_CYCLES)
        if "union" in j:
            return cls.take_union(cls.from_json(j["union"][0]),
                                  cls.from_json(j["union"][1]))
        if "loop" in j:
            return cls.kleene_loop(cls.from_json(j["loop"][0]),
                                   cls.from_json(j["loop"][1]))
        if "opt" in j:
            return cls.zero_or_one(cls.from_json(j["opt"]))
        if "star" in j:
            return cls.kleene_star(cls.from_json(j["star"]))
        if "plus" in j:
            return cls.kleene_plus(cls.from_json(j["plus"]))
        if "eliminate" in j:
            return cls.from_json(j["eliminate"]).eliminate_silent_transitions()
        if "merge" in j:
            return cls.from_json(j["merge"]).merge_equivalent_states()
        if "reverse" in j:
            return cls.from_json(j["reverse"]).reverse()
        if "revcomp" in j:
            from .presets import make_preset
            m = cls.from_json(j["revcomp"])
            out_alph = set(m.output_alphabet())
            comp = make_preset("comprna" if ("U" in out_alph or "u" in out_alph)
                               else "compdna")
            return cls.compose(m.reverse(), comp)
        if "transpose" in j:
            return cls.from_json(j["transpose"]).transpose()

        m = cls()
        if "defs" in j:
            from .params import param_funcs_from_json
            m.funcs = param_funcs_from_json(j["defs"])
        if "cons" in j:
            m.cons = Constraints.from_json(j["cons"])
        id2n = {}
        dup_ids = set()
        for js in j["state"]:
            st = State()
            if "n" in js:
                if js["n"] != len(m.states):
                    raise ValueError("StateIndex n=%s out of sequence" % js["n"])
            if "id" in js:
                sid = js["id"]
                id_str = name_dump(sid)
                if id_str in id2n:
                    dup_ids.add(id_str)
                else:
                    id2n[id_str] = len(m.states)
                st.name = sid
            m.states.append(st)
        for idx, js in enumerate(j["state"]):
            ms = m.states[idx]
            for jt in js.get("trans", ()):
                t = Transition()
                dest = jt["to"]
                if isinstance(dest, bool):
                    raise ValueError("Invalid destination")
                if isinstance(dest, (int, float)):
                    t.dest = int(dest)
                else:
                    dstr = name_dump(dest)
                    if dstr not in id2n:
                        raise ValueError('No such state in "to": %s' % dstr)
                    if dstr in dup_ids:
                        raise ValueError(
                            'Ambiguous destination state ID in "to": %s' % dstr)
                    t.dest = id2n[dstr]
                t.in_ = jt.get("in", "")
                t.out = jt.get("out", "")
                if "weight" in jt:
                    t.weight = W.from_json(jt["weight"])
                elif "expr" in jt:
                    from .exprparse import parse_weight_expr
                    t.weight = parse_weight_expr(jt["expr"])
                else:
                    t.weight = W.ONE
                ms.trans.append(t)
        for ms in m.states:
            for t in ms.trans:
                if t.dest >= len(m.states):
                    raise ValueError("State %d does not exist" % t.dest)
        return m

    @classmethod
    def from_file(cls, path):
        with open(path) as f:
            return cls.from_json(_json.load(f))

    def to_json_str(self, memoize_repeated=False, show_params=False,
                    use_state_ids=False):
        """Byte-compatible with the reference writeJson (src/machine.cpp:203)."""
        memo = {}
        names = []
        name2def = {}
        if memoize_repeated:
            all_params = set()
            exprs = []
            for ms in self.states:
                for t in ms.trans:
                    exprs.append(t.weight)
            counts = W.count_subexpr_refs(exprs)
            for w in exprs:
                all_params |= W.params_of(w, {})
            common = []
            seen = set()

            def collect(w):
                if not W.is_expr_node(w):
                    return
                if w in seen:
                    return
                seen.add(w)
                if w[0] in ("log", "exp"):
                    collect(w[1])
                else:
                    collect(w[1])
                    collect(w[2])
                if counts.get(w, 0) > 1 and not W.is_one(w):
                    common.append(w)

            # gather in creation order approximation: walk exprs
            ordered = []
            seen2 = set()

            def walk_order(w):
                if not W.is_expr_node(w) or w in seen2:
                    return
                seen2.add(w)
                if w[0] in ("log", "exp"):
                    walk_order(w[1])
                else:
                    walk_order(w[1])
                    walk_order(w[2])
                if counts.get(w, 0) > 1 and not W.is_one(w):
                    ordered.append(w)

            for e in exprs:
                walk_order(e)
            def2name = {}
            n = 0
            for expr in ordered:
                d = W.to_json_str(expr, memo)
                if d in def2name:
                    memo[expr] = def2name[d]
                else:
                    prefix = ""
                    while True:
                        prefix += "_"
                        n += 1
                        nm = prefix + str(n)
                        if nm not in all_params:
                            break
                    memo[expr] = nm
                    name2def[nm] = d
                    def2name[d] = nm
                    names.append(nm)

        unique_name = None
        if use_state_ids:
            unique_name = []
            seen_ids = set()
            for ms in self.states:
                sid = ms.name
                n = 1
                while name_dump(sid) in seen_ids:
                    n += 1
                    sid = [[ms.name, n]]
                seen_ids.add(name_dump(sid))
                unique_name.append(sid)

        out = ['{"state":\n [']
        n_states = self.n_states()
        for s in range(n_states):
            ms = self.states[s]
            out.append(("  " if s else "") + "{")
            if not use_state_ids:
                out.append('"n":%d' % s)
            if use_state_ids or ms.name is not None:
                if not use_state_ids:
                    out.append(",\n   ")
                out.append('"id":%s' % name_dump(
                    unique_name[s] if use_state_ids else ms.name))
            if ms.trans:
                out.append(',\n   "trans":[')
                for nt, t in enumerate(ms.trans):
                    if nt:
                        out.append(",\n            ")
                    out.append('{"to":')
                    if use_state_ids:
                        out.append(name_dump(unique_name[t.dest]))
                    else:
                        out.append(str(t.dest))
                    if not t.input_empty():
                        out.append(',"in":"%s"' % write_escaped(t.in_))
                    if not t.output_empty():
                        out.append(',"out":"%s"' % write_escaped(t.out))
                    if not W.is_one(t.weight):
                        out.append(',"weight":%s' % W.to_json_str(t.weight, memo))
                    out.append("}")
                out.append("]")
            out.append("}")
            if s < n_states - 1:
                out.append(",\n")
        out.append("\n ]")
        if names or self.funcs.defs:
            out.append(',\n "defs":')
            count = 0
            for nm in names:
                out.append(("\n {" if not count else ",\n  ")
                           + '"%s":%s' % (nm, name2def[nm]))
                count += 1
            for k in sorted(self.funcs.defs):
                out.append(("\n {" if not count else ",\n  ")
                           + '"%s":' % k
                           + W.to_json_str(self.funcs.defs[k], memo))
                count += 1
            out.append("}")
        if show_params:
            by_cons = self.cons.by_param()
            uncons = [p for p in sorted(self.params()) if p not in by_cons]
            if uncons:
                out.append(',\n "params": [')
                out.append(",".join('"%s"' % write_escaped(p) for p in uncons))
                out.append("]")
        if not self.cons.empty():
            out.append(',\n "cons":\n')
            out.append(self.cons.to_json_str())
        else:
            out.append("\n")
        out.append("}\n")
        return "".join(out)

    def write_json(self, f, **kw):
        f.write(self.to_json_str(**kw))

    def to_dot_str(self, empty_label="&epsilon;", merge_edges=True,
                   abbreviate_labels=True):
        """GraphViz DOT output (ref: src/machine.cpp writeDot)."""
        end_idx = self.n_states() - 1
        out = ["digraph G {\n",
               " rankdir=LR;\n",
               ' node [fontname="Helvetica",fontsize=12];\n',
               ' edge [fontname="Helvetica",fontsize=10];\n', "\n",
               ' start [shape=point,width=0,height=0,label=""];\n',
               " start -> 0;\n", "\n"]
        for s in range(self.n_states()):
            nm = self.states[s].name
            shape = "doublecircle" if s == end_idx else "circle"
            label = nm if isinstance(nm, str) else name_dump(nm)
            out.append(' %d [shape=%s,label="%s"];\n'
                       % (s, shape, write_escaped(label)))
        out.append("\n")

        def io_label(t):
            in_str = empty_label if t.input_empty() else write_escaped(t.in_)
            out_str = empty_label if t.output_empty() else write_escaped(t.out)
            if abbreviate_labels:
                if not t.input_empty() and not t.output_empty() and t.in_ == t.out:
                    return in_str
                if t.input_empty() and not t.output_empty():
                    return out_str
                if not t.input_empty() and t.output_empty():
                    return in_str
                if t.input_empty() and t.output_empty():
                    return empty_label
            return in_str + "/" + out_str

        for s in range(self.n_states()):
            ms = self.states[s]
            if merge_edges:
                groups = {}
                group_silent = {}
                group_order = []
                for t in ms.trans:
                    wstr = W.to_string(t.weight, {})
                    key = (t.dest, wstr)
                    if key not in groups:
                        groups[key] = []
                        group_order.append(key)
                        group_silent[key] = True
                    groups[key].append(io_label(t))
                    if t.is_loud():
                        group_silent[key] = False
                for key in group_order:
                    combined = ",".join(groups[key])
                    if key[1] != "1":
                        combined += " [" + key[1] + "]"
                    line = ' %d -> %d [label="%s"' % (s, key[0], combined)
                    if group_silent[key]:
                        line += ",style=dashed,color=gray,fontcolor=gray"
                    out.append(line + "];\n")
            else:
                for t in ms.trans:
                    label = io_label(t)
                    if not W.is_one(t.weight):
                        label += " [" + W.to_string(t.weight, {}) + "]"
                    line = ' %d -> %d [label="%s"' % (s, t.dest, label)
                    if t.is_silent():
                        line += ",style=dashed,color=gray,fontcolor=gray"
                    out.append(line + "];\n")
            out.append("\n")
        out.append("}\n")
        return "".join(out)

    def __repr__(self):
        return "Machine(%d states, %d transitions)" % (
            self.n_states(), self.n_transitions())


class MachinePath:
    """A path through a machine: list of transitions (ref: src/machine.h:207)."""

    def __init__(self, trans=None):
        self.trans = list(trans) if trans else []

    def concatenate(self, other):
        return MachinePath(self.trans + other.trans)

    def input_sequence(self):
        return [t.in_ for t in self.trans if t.in_]

    def output_sequence(self):
        return [t.out for t in self.trans if t.out]

    def alignment(self):
        return [(t.in_, t.out) for t in self.trans if not t.is_silent()]

    @staticmethod
    def transpose_alignment(path):
        return [(b, a) for a, b in path]

    def to_json_str(self, m):
        out = ['{"start":%d' % m.start_state()]
        if m.states[m.start_state()].name is not None:
            out.append(',"id":%s' % name_dump(m.states[m.start_state()].name))
        out.append(',"trans":[')
        for n, t in enumerate(self.trans):
            if n:
                out.append(",")
            out.append('{"to":%d' % t.dest)
            if m.states[t.dest].name is not None:
                out.append(',"id":%s' % name_dump(m.states[t.dest].name))
            if not t.input_empty():
                out.append(',"in":"%s"' % write_escaped(t.in_))
            if not t.output_empty():
                out.append(',"out":"%s"' % write_escaped(t.out))
            out.append("}")
        out.append("]}")
        return "".join(out)
