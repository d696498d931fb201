"""Jumping-profile HMM from a FASTA multiple alignment (ref: src/jphmm.cpp).

One emit state per (row, column) of the alignment; a 'jump' probability
parameter moves between rows between columns.
"""

from .machine import Machine, State, Transition
from . import weight as W

JUMP_PARAM = "jump"


def jphmm(seqs):
    rows = len(seqs)
    if rows == 0:
        raise ValueError("No sequences supplied - can't construct a jpHMM"
                         " from an empty alignment")
    cols = seqs[0].length()
    if cols == 0:
        raise ValueError("Empty sequences supplied - can't construct a jpHMM"
                         " from an empty alignment")
    for s in seqs:
        if s.length() != cols:
            raise ValueError("Alignment is not flush - all sequences must be"
                             " same length to build a jpHMM from an alignment")

    def emit_state(row, col):
        return rows * col + row + 1

    m = Machine([State() for _ in range(rows * cols + 2)])
    m.states[0].name = "start"
    m.states[-1].name = "end"
    start_prob = W.reciprocal(W.int_constant(rows))
    p_jump = JUMP_PARAM
    stay_prob = W.ONE if rows == 1 else W.negate(p_jump)
    jump_prob = W.divide(p_jump, W.int_constant(rows - 1))
    for row in range(rows):
        m.states[0].trans.append(Transition(
            "", seqs[row].seq[0], emit_state(row, 0), start_prob))
    for src_col in range(cols):
        dest_col = src_col + 1
        for src_row in range(rows):
            src = m.states[emit_state(src_row, src_col)]
            src.name = {"row": src_row + 1, "col": src_col + 1}
            if dest_col < cols:
                for dest_row in range(rows):
                    src.trans.append(Transition(
                        "", seqs[dest_row].seq[dest_col],
                        emit_state(dest_row, dest_col),
                        stay_prob if src_row == dest_row else jump_prob))
            else:
                src.trans.append(Transition("", "", len(m.states) - 1, W.ONE))
    m.cons.prob.append(JUMP_PARAM)
    return m
