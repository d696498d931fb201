"""CTC-style prefix search over an implicit prefix machine
(ref: src/ctc.{h,cpp}).

For a generator G, the prefix machine is (echo + wild) composed with G; the
PrefixTree realizes it implicitly: each node holds seqCell (paths consuming
exactly the node's prefix) and prefixCell (paths consuming the prefix plus
any continuation, via the all-non-outputting-paths closure logSumInTrans).
Best-first A*-like search; also posterior sampling and simulated annealing /
MCMC refinement.
"""

import heapq
import math

import numpy as np

NEG_INF = -math.inf

BURN_STEPS_PER_TOK = 3
TARGET_INIT_ACCEPT_PROB = 0.8


def _lse(a, b):
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    return float(np.logaddexp(a, b))


class _Node:
    __slots__ = ("in_tok", "parent", "length", "seq_cell", "prefix_cell",
                 "log_prefix_prob", "extended", "child", "removed", "uid")

    def __init__(self, parent, in_tok, uid):
        self.in_tok = in_tok
        self.parent = parent
        self.length = parent.length + 1 if parent else 0
        self.child = []
        self.extended = False
        self.removed = False
        self.uid = uid

    def traceback(self):
        toks = []
        node = self
        while node.in_tok:
            toks.append(node.in_tok)
            node = node.parent
        toks.reverse()
        return toks

    def log_seq_prob(self):
        return self.seq_cell[-1, -1]


class PrefixTree:
    def __init__(self, ev, out_syms, max_backtrack=None):
        self.ev = ev
        self.log_sum_in = ev.log_sum_in_trans()
        self.output = ev.output_tokenizer.tokenize(out_syms)
        self.out_len = len(self.output)
        self.n_states = ev.n_states()
        self.max_backtrack = (max_backtrack if max_backtrack is not None
                              else float("inf"))
        self.best_seq_node = None
        self.best_log_seq_prob = NEG_INF
        self._uid = 0
        # precompute incoming edge arrays per (inTok) split by absorbing
        self.clear()

    # -------------------------------------------------------------- plumbing

    def clear(self):
        best = (self.best_seq_node.traceback()
                if self.best_seq_node else None)
        self.best_seq_node = None
        self.n_nodes = 0
        self.node_queue = []
        self.max_prefix_len = 0
        self.root = self._add_node(None, 0, humble=True)
        if best is not None:
            self.best_log_seq_prob = NEG_INF
            self.log_seq_prob_of(best, humble=True)

    def _fill(self, node):
        ev = self.ev
        S = self.n_states
        L = self.out_len
        seq = np.full((L + 1, S), NEG_INF)
        prefix = np.full((L + 1, S), NEG_INF)
        if node.parent is None:
            seq[0, 0] = 0.0
        in_tok = node.in_tok
        parent = node.parent
        for out_pos in range(L + 1):
            out_tok = self.output[out_pos - 1] if out_pos else 0
            for d in range(S):
                incoming = ev.state[d].incoming
                ll = seq[out_pos, d]
                if parent is not None:
                    if out_pos:
                        for s, ti, lw in incoming.get((in_tok, out_tok), ()):
                            ll = _lse(ll, parent.seq_cell[out_pos - 1, s] + lw)
                    for s, ti, lw in incoming.get((in_tok, 0), ()):
                        ll = _lse(ll, parent.seq_cell[out_pos, s] + lw)
                prefix[out_pos, d] = ll
                if out_pos:
                    for s, ti, lw in incoming.get((0, out_tok), ()):
                        ll = _lse(ll, seq[out_pos - 1, s] + lw)
                for s, ti, lw in incoming.get((0, 0), ()):
                    ll = _lse(ll, seq[out_pos, s] + lw)
                seq[out_pos, d] = ll
            if out_pos:
                out_tok = self.output[out_pos - 1]
                for d in range(S):
                    ll = prefix[out_pos, d]
                    incoming = ev.state[d].incoming
                    for (i, o), entries in sorted(incoming.items()):
                        if o != out_tok:
                            continue
                        for st, ti, lw in entries:
                            prev = prefix[out_pos - 1] \
                                + self.log_sum_in[:, st] + lw
                            with np.errstate(invalid="ignore"):
                                m = np.max(prev)
                                if m > NEG_INF:
                                    ll = _lse(ll, m + math.log(
                                        np.sum(np.exp(prev - m))))
                    prefix[out_pos, d] = ll
        node.seq_cell = seq
        node.prefix_cell = prefix
        lpp = NEG_INF
        final = prefix[L] + self.log_sum_in[:, S - 1]
        m = np.max(final)
        if m > NEG_INF:
            lpp = m + math.log(np.sum(np.exp(final - m)))
        node.log_prefix_prob = float(lpp)

    def _add_node(self, parent, in_tok, humble=False):
        if parent is not None:
            for c in parent.child:
                if c.in_tok == in_tok:
                    return c
        self._uid += 1
        node = _Node(parent, in_tok, self._uid)
        self.n_nodes += 1
        if parent is not None:
            parent.child.append(node)
        self.max_prefix_len = max(self.max_prefix_len, node.length)
        self._fill(node)
        if node.log_prefix_prob > self.best_log_seq_prob:
            heapq.heappush(self.node_queue,
                           (-node.log_prefix_prob, node.uid, node))
        lsp = node.log_seq_prob()
        if lsp > self.best_log_seq_prob:
            old_best = self.best_seq_node
            self.best_seq_node = node
            self.best_log_seq_prob = lsp
            if old_best is not None and old_best.extended:
                self._remove_node(old_best)
        return node

    def _remove_node(self, node):
        if node is not self.best_seq_node and not node.child:
            node.removed = True
            self.n_nodes -= 1
            if node.parent is not None:
                node.parent.child.remove(node)
                self._remove_node(node.parent)

    def _extend_node(self, parent):
        n_toks = self.ev.input_tokenizer.n_tokens() - 1
        for in_tok in range(1, n_toks + 1):
            self._add_node(parent, in_tok)
        parent.extended = True
        if self.max_prefix_len > parent.length and \
                self.max_backtrack != float("inf"):
            min_len = max(0, self.max_prefix_len - self.max_backtrack)
            if min_len:
                kept = []
                for neg, uid, np_ in self.node_queue:
                    if np_.removed:
                        continue
                    if np_.length >= min_len:
                        kept.append((neg, uid, np_))
                    else:
                        self._remove_node(np_)
                heapq.heapify(kept)
                self.node_queue = kept

    # ------------------------------------------------------------ public API

    def do_prefix_search(self):
        while self.node_queue:
            neg, uid, parent = heapq.heappop(self.node_queue)
            if parent.removed:
                continue
            if parent.log_prefix_prob > self.best_log_seq_prob:
                self._extend_node(parent)
            else:
                break
        if self.best_seq_node is None:
            raise ValueError("No valid sequence found")
        return self.best_seq()

    def best_seq(self):
        return self.ev.input_tokenizer.detokenize(
            self.best_seq_node.traceback())

    def log_seq_prob_of(self, toks, humble=False):
        current = self.root
        for t in toks:
            current = self._add_node(current, t, humble)
        return current.log_seq_prob()

    def _random_child(self, node, rng):
        r = rng.uniform(0, 1)
        for c in node.child:
            r -= math.exp(c.log_prefix_prob - node.log_prefix_prob)
            if r <= 0:
                return c
        return None

    def sample_tok_seq(self, rng):
        current = self.root
        while current.log_prefix_prob > current.log_seq_prob():
            self._extend_node(current)
            nxt = self._random_child(current, rng)
            if nxt is None:
                break
            current = nxt
        return current.traceback()

    def sample_seq(self, rng):
        return self.ev.input_tokenizer.detokenize(self.sample_tok_seq(rng))

    def do_annealed_search(self, rng, steps_per_tok, do_cooling=True):
        """Simulated annealing / MCMC search (ref src/ctc.cpp:142-176)."""
        n_toks = self.ev.input_tokenizer.n_tokens() - 1
        init_seq = self.sample_tok_seq(rng)
        steps = steps_per_tok * len(init_seq) * n_toks
        current = list(init_seq)
        current_lsp = self.log_seq_prob_of(current)
        burn_steps = len(current) + BURN_STEPS_PER_TOK * len(init_seq) * n_toks
        burn_log = []
        init_temp, final_temp = 1.0, 1.0
        last_burn_step = 0
        step = 0
        while step - last_burn_step < steps:
            ln = len(current)
            burning = do_cooling and len(burn_log) < burn_steps
            if burning:
                last_burn_step = step
                if step > steps and not burn_log:
                    break
            temperature = init_temp + (final_temp - init_temp) * (
                (step - last_burn_step) / steps if steps else 0.0)
            r = rng.randint(0, 3 * ln + 1)
            if r == 3 * ln:
                ev_type, pos = 2, ln
            else:
                ev_type, pos = r // ln, r % ln
            old_tok = None
            rev_fwd = 1.0
            if ev_type == 0:
                offset = rng.randint(1, n_toks)
                old_tok = current[pos]
                current[pos] = ((old_tok - 1 + offset) % n_toks) + 1
            elif ev_type == 1:
                old_tok = current[pos]
                del current[pos]
                rev_fwd = (3 * ln + 4) / (n_toks * (3 * ln + 1))
            else:
                new_tok = rng.randint(1, n_toks + 1)
                current.insert(pos, new_tok)
                rev_fwd = n_toks * (3 * ln + 1) / (3 * ln + 4)
            new_lsp = self.log_seq_prob_of(current)
            log_hastings = min(0.0, new_lsp - current_lsp + math.log(rev_fwd))
            accept_prob = (math.exp(log_hastings / temperature)
                           if temperature > 0 else (1.0 if log_hastings >= 0
                                                    else 0.0))
            accept = rng.uniform(0, 1) < accept_prob
            if burning and NEG_INF < log_hastings < math.inf:
                burn_log.append(log_hastings)
                if len(burn_log) == burn_steps:
                    arr = np.array(burn_log)
                    mean = float(arr.mean())
                    var = float((arr * arr).mean() - mean * mean)
                    log_a = math.log(TARGET_INIT_ACCEPT_PROB)
                    init_temp = (mean - math.sqrt(max(mean * mean
                                                      - log_a * var, 0.0))) \
                        / (2 * log_a)
                    final_temp = 0.0
            if accept:
                current_lsp = new_lsp
            else:
                if ev_type == 0:
                    current[pos] = old_tok
                elif ev_type == 1:
                    current.insert(pos, old_tok)
                else:
                    del current[pos]
            step += 1
        return self.best_seq()
