"""CSV position-specific weight matrix importer (ref: src/csv.{h,cpp}).

Each row gives per-position symbol weights; columns are headed by the output
symbols. An extra unheaded final column, if present, acts as an end weight.
mergingMachine() collapses consecutively repeated characters as in Graves
(2006) "Connectionist Temporal Classification".
"""

import struct

from .machine import Machine, State, Transition
from . import weight as W

START_TAG = "start"
END_TAG = "end"


def _f32(s):
    return struct.unpack("f", struct.pack("f", float(s)))[0]


class CSVProfile:
    def __init__(self):
        self.header = []
        self.row = []

    def read(self, text, split_chars=","):
        lines = text.splitlines()
        if lines:
            self.header = lines[0].split(split_chars)
            while self.header and self.header[-1] == "":
                self.header.pop()
        for line in lines[1:]:
            cols = [c for c in line.split(split_chars)]
            if cols == [""] or not cols:
                continue
            self.row.append([_f32(c) for c in cols])

    @classmethod
    def from_file(cls, path, split_chars=","):
        p = cls()
        with open(path) as f:
            p.read(f.read(), split_chars)
        return p

    def machine(self):
        n_rows = len(self.row)
        m = Machine([State(str(pos)) for pos in range(n_rows + 1)])
        for pos in range(n_rows):
            for col in range(min(len(self.row[pos]), len(self.header) + 1)):
                out = self.header[col] if col < len(self.header) else ""
                m.states[pos].trans.append(Transition(
                    "", out, pos + 1, W.double_constant(self.row[pos][col])))
        return m

    def merging_machine(self):
        if not self.header:
            raise ValueError("Need header to build mergingMachine from"
                             " CSVProfile")
        n_cols = len(self.header)
        n_rows = len(self.row)

        def state_index(pos, last_tok):
            if pos == 0:
                return 0
            return (pos - 1) * (n_cols + 1) + (0 if pos == n_rows else last_tok) + 1

        m = Machine([State() for _ in range(state_index(n_rows, 0) + 1)])
        for pos in range(1, n_rows):
            for tok in range(n_cols + 1):
                m.states[state_index(pos, tok)].name = [
                    [pos, "" if tok == n_cols else self.header[tok]]]
        m.states[0].name = START_TAG
        m.states[-1].name = END_TAG
        for pos in range(n_rows):
            for col in range(min(len(self.row[pos]), n_cols + 1)):
                dest = state_index(pos + 1, col)
                weight = W.double_constant(self.row[pos][col])
                for tok in range((n_cols if pos else 0) + 1):
                    src = state_index(pos, tok)
                    emit = ("" if ((col == tok and pos > 0) or col == n_cols)
                            else self.header[col])
                    m.states[src].trans.append(Transition(
                        "", emit, dest, weight))
        return m
