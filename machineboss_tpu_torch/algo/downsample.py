"""Transition downsampling by posterior probability (ref: src/machine.cpp
Machine::downsample / stochasticDownsample, target/boss.cpp --downsample-*).

Works on the 'null' projection of an acyclic toposorted machine (all I/O
labels cleared), ranking transitions by posterior probability under the
empty-sequence Forward/Backward, then keeping the top fraction (or those
above a probability threshold), or sampling stochastic paths.
"""

import heapq
import math

import numpy as np

from ..core.seqpair import SeqPair
from ..core.eval import EvaluatedMachine
from .dp_host import ForwardMatrix, BackwardMatrix

NEG_INF = -math.inf


def _null_machine(machine):
    null = machine.clone()
    for ms in null.states:
        for t in ms.trans:
            t.in_ = ""
            t.out = ""
    return null


def _trace_allowed(null, fwd, back, i, o, s, ti, trans_allowed, counter):
    """Mark the transition and trace back to start / forward to end, marking
    every transition on the way until hitting an already-marked one."""

    def mark(state, trans_idx):
        if trans_allowed[state][trans_idx]:
            return True
        trans_allowed[state][trans_idx] = True
        counter[0] += 1
        return False

    if mark(s, ti):
        return
    # trace back from (i,o,s) to start
    fwd.traceback(null, i, o, s, visit=lambda i2, o2, s2, ti2: mark(s2, ti2))
    # trace forward from the transition's destination
    mt = null.states[s].trans[ti]
    _trace_forward(null, back, i, o, mt.dest,
                   lambda i2, o2, s2, ti2: mark(s2, ti2))


def _trace_forward(null, back, i, o, s, visit):
    n_states = back.n_states
    while i < back.in_len or o < back.out_len or s != n_states - 1:
        options = []
        out_map = back.ev.state[s].outgoing
        for d, ti, lw in out_map.get((0, 0), ()):
            options.append((d, ti, back.get(i, o, d) + lw))
        if not options:
            break
        lls = [ll for _, _, ll in options]
        best = int(np.argmax(np.array(lls)))
        d, ti, _ = options[best]
        if visit(i, o, s, ti):
            break
        s = d


def downsample(machine, max_proportion, min_post_prob=0.0):
    if not machine.is_toposorted_machine(True):
        raise ValueError("Machine must be acyclic & topologically sorted"
                         " before downsampling can take place")
    null = _null_machine(machine)
    trans_allowed = [[False] * len(ms.trans) for ms in null.states]
    ev = EvaluatedMachine(null, null.get_param_defs(True))
    empty = SeqPair()
    fwd = ForwardMatrix(ev, empty)
    back = BackwardMatrix(ev, empty)

    queue = []
    uid = [0]

    def sorter(s, ti, i, o, post):
        uid[0] += 1
        heapq.heappush(queue, (-post, uid[0], i, o, s, ti))

    back.get_counts(fwd, visit=sorter)
    n_trans_target = int(null.n_transitions() * max_proportion)
    counter = [0]
    while queue and (counter[0] == 0 or counter[0] < n_trans_target):
        neg_post, _, i, o, s, ti = heapq.heappop(queue)
        if -neg_post < min_post_prob and counter[0] > 0:
            break
        _trace_allowed(null, fwd, back, i, o, s, ti, trans_allowed, counter)
    return machine.subgraph(trans_allowed)


def stochastic_downsample(machine, rng, max_proportion, max_paths):
    if not machine.is_toposorted_machine(True):
        raise ValueError("Machine must be acyclic & topologically sorted"
                         " before stochastic downsampling can take place")
    null = _null_machine(machine)
    trans_allowed = [[False] * len(ms.trans) for ms in null.states]
    ev = EvaluatedMachine(null, null.get_param_defs(True))
    fwd = ForwardMatrix(ev, SeqPair())
    n_trans_target = int(null.n_transitions() * max_proportion)
    n_trans = [0]

    def visit(i, o, s, ti):
        if not trans_allowed[s][ti]:
            trans_allowed[s][ti] = True
            n_trans[0] += 1
        return False

    def select(lls):
        w = np.exp(np.array(lls) - max(lls))
        w = w / w.sum()
        return int(rng.choice(len(lls), p=w))

    for _ in range(max_paths):
        if n_trans[0] >= n_trans_target:
            break
        fwd.traceback(null, visit=visit, select=select)
    return machine.subgraph(trans_allowed)


def downsample_cli(machine, command, arg):
    import numpy as _np
    if command == "--downsample-size":
        return downsample(machine.toposort(), float(arg))
    if command == "--downsample-prob":
        return downsample(machine.toposort(), 1.0, float(arg))
    rng = _np.random.RandomState()
    if command == "--downsample-path":
        return stochastic_downsample(machine.toposort(), rng, 1.0, int(arg))
    dm = machine
    return stochastic_downsample(dm.toposort(), rng, float(arg),
                                 dm.n_states())
