"""Beam-search decoding: most likely input sequence for a given output
(ref: src/beam.{h,cpp}).

A trie of input-sequence prefixes; each (outPos, state) cell maps prefix
node -> log weight, pruned to the top beamWidth prefixes. Requires a
decode-sorted machine (non-outputting transitions advance).
"""

import math

import numpy as np

DEFAULT_BEAM_WIDTH = 100
NEG_INF = -math.inf


class _SeqNode:
    __slots__ = ("in_tok", "parent", "child", "uid")

    def __init__(self, parent, in_tok, uid):
        self.in_tok = in_tok
        self.parent = parent
        self.child = {}
        self.uid = uid


class BeamSearchMatrix:
    def __init__(self, ev, out_syms, beam_width=DEFAULT_BEAM_WIDTH):
        self.ev = ev
        self.output = ev.output_tokenizer.tokenize(out_syms)
        self.out_len = len(self.output)
        self.n_states = ev.n_states()
        self.beam_width = beam_width
        self._uid = 0
        self.root = self._new_node(None, 0)
        # cells[(outPos, state)] = {node: logWeight}
        self.cells = {}
        self._fill()

    def _new_node(self, parent, in_tok):
        self._uid += 1
        return _SeqNode(parent, in_tok, self._uid)

    def _extend(self, node, in_tok):
        c = node.child.get(in_tok)
        if c is None:
            c = self._new_node(node, in_tok)
            node.child[in_tok] = c
        return c

    def _cell(self, out_pos, state):
        return self.cells.setdefault((out_pos, state), {})

    def _accumulate(self, dest_cell, entries, in_tok, out_pos):
        for src, ti, lw in entries:
            src_cell = self.cells.get((out_pos, src))
            if not src_cell:
                continue
            for prev_node, prev_lw in list(src_cell.items()):
                node = self._extend(prev_node, in_tok) if in_tok else prev_node
                val = prev_lw + lw
                if node in dest_cell:
                    dest_cell[node] = np.logaddexp(dest_cell[node], val)
                else:
                    dest_cell[node] = val

    def _fill(self):
        self._cell(0, 0)[self.root] = 0.0
        for out_pos in range(self.out_len + 1):
            out_tok = self.output[out_pos - 1] if out_pos else 0
            for dest in range(self.n_states):
                dest_cell = self._cell(out_pos, dest)
                incoming = self.ev.state[dest].incoming
                for (in_tok, o_tok), entries in sorted(incoming.items()):
                    if out_pos and o_tok == out_tok and out_tok != 0:
                        self._accumulate(dest_cell, entries, in_tok, out_pos - 1)
                    if o_tok == 0:
                        self._accumulate(dest_cell, entries, in_tok, out_pos)
                if len(dest_cell) > self.beam_width:
                    top = sorted(dest_cell.items(),
                                 key=lambda kv: (-kv[1], kv[0].uid))
                    self.cells[(out_pos, dest)] = dict(top[:self.beam_width])

    def best_seq(self):
        final = self.cells.get((self.out_len, self.n_states - 1), {})
        best_node, best_lw = None, NEG_INF
        for node, lw in sorted(final.items(), key=lambda kv: kv[0].uid):
            if lw > best_lw:
                best_node, best_lw = node, lw
        if best_node is None:
            raise ValueError("Beam search failed to find a sequence")
        toks = []
        node = best_node
        while node is not None and node.in_tok:
            toks.append(node.in_tok)
            node = node.parent
        toks.reverse()
        return self.ev.input_tokenizer.detokenize(toks)
