"""Device-accelerated CTC prefix-search scoring.

Counterpart of machineboss_tpu's algo/ctc_device.py. The prefix tree
itself stays on the host (an inherently sequential A* search), but each
node's DP fill -- the hot inner loop -- runs on the device, and extending
a node scores ALL candidate tokens in one batched pass (the candidate
tokens are a leading batch dimension). This is the SURVEY's 'host tree +
batched device scoring' design for beam/prefix decoding at nanopore scale.

Recurrences (matching algo/ctc.PrefixTree._fill):
  seq_cell:    one 2D DP column step for the appended input token
  prefix_cell: absorbing part, then chained through LS @ E_any[y_o] where
               LS is the all-non-outputting-paths closure
  logPrefixProb = lse(prefix[Lo] + LS[:, end])

The device tensors are float64, as the host tree's cells are: a 192-nt
read's cells span hundreds of nats, and in float32 the max-shifted
products (ops/semiring.py) lose every term more than ~87 nats below its
row's maximum -- the JAX class's prefix cells of such a read come out
dead (-1e30) or wrong where the host's are live -- and the chain of
float32 rounding at |ll| ~ 400 reaches 5e-4 nats. In float64 the shift
reaches ~708 nats.

The absorbing parts of every output position are computed at once; the
seq and prefix recurrences along the output positions are both of the
form x[o] = b[o] (+) x[o-1] (x) M[o-1] (the seq cell's own silent closure
distributed over its two terms), so one loop over the output positions
advances both, for every candidate token, with one batched product a
position.
"""

import numpy as np
import torch

from ..ops.semiring import LOGSUMEXP, NEG_INF
from ..utils.device import resolve_device


def _np_lse_reduce(stack):
    """logsumexp over the leading axis of (K, S, S), -inf aware."""
    m = np.max(stack, axis=0)
    safe = np.where(m > NEG_INF / 2, m, 0.0)
    s = np.sum(np.exp(stack - safe), axis=0)
    return np.where(s > 0, np.log(np.maximum(s, 1e-300)) + safe, NEG_INF)


def _np_log_matmul(a, b):
    amax = np.max(a, axis=-1, keepdims=True)
    bmax = np.max(b, axis=-2, keepdims=True)
    asafe = np.where(amax > NEG_INF / 2, amax, 0.0)
    bsafe = np.where(bmax > NEG_INF / 2, bmax, 0.0)
    prod = np.exp(a - asafe) @ np.exp(b - bsafe)
    with np.errstate(divide="ignore"):
        return np.where(prod > 0,
                        np.log(np.maximum(prod, 1e-300)) + asafe + bsafe,
                        NEG_INF)


class CTCDeviceModel:
    def __init__(self, ev, out_toks, device=None):
        """ev: EvaluatedMachine; out_toks: observed output token ids
        (1-based), fixed for the whole search; device: None for the CUDA
        card (raising when CUDA is absent), "cpu" for the CPU."""
        self.ev = ev
        self.device = dev = resolve_device(device)
        S = ev.n_states()
        self.S = S
        self.n_in = ev.input_tokenizer.n_tokens()
        n_out = ev.output_tokenizer.n_tokens()
        self.Lo = len(out_toks)

        # dense tensors (log space)
        dense = np.full((self.n_in, n_out, S, S), NEG_INF)
        for (i, o), (src, dst, _, lw) in ev.edges_by_token().items():
            for k in range(len(src)):
                w = lw[k] if np.isfinite(lw[k]) else NEG_INF
                dense[i, o, src[k], dst[k]] = np.logaddexp(
                    dense[i, o, src[k], dst[k]], w)
        ls = ev.log_sum_in_trans()  # all-non-outputting-paths closure
        ls = np.where(np.isfinite(ls), ls, NEG_INF)

        def f64(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                   device=dev)

        # per observed position matrices
        self.a_diag = f64(np.stack([dense[:, t] for t in out_toks])) \
            if self.Lo else torch.zeros((0, self.n_in, S, S),
                                        dtype=torch.float64, device=dev)
        # (Lo, n_in, S, S): transitions consuming input i emitting y_o
        self.a_in = f64(dense[:, 0])                       # (n_in, S, S)
        self.ls = f64(ls)
        # prefix chain matrices: LS @ E_any[y_o], with E_any = lse over i
        e_any = np.full((self.Lo, S, S), NEG_INF)
        for n, t in enumerate(out_toks):
            e_any[n] = _np_lse_reduce(dense[:, t])
        chain = np.stack([_np_log_matmul(ls, e_any[n])
                          for n in range(self.Lo)]) \
            if self.Lo else np.zeros((0, S, S))
        self.prefix_chain = f64(chain)
        # (eps,eps)-only silent closure, precomputed on the host
        n_mat = np.zeros((S, S))
        silent = ev.edges_by_token().get((0, 0))
        if silent is not None:
            ssrc, sdst, _, slw = silent
            np.add.at(n_mat, (ssrc, sdst),
                      np.where(np.isfinite(slw), np.exp(slw), 0.0))
        inv = np.linalg.inv(np.eye(S) - n_mat)
        with np.errstate(divide="ignore"):
            sc = np.where(inv > 0, np.log(np.maximum(inv, 1e-300)), NEG_INF)
        self._sc = f64(sc)
        # the two recurrences' step matrices, (2, Lo, S, S) prepared for
        # repeated products: the seq cell's emitting step a_diag[o-1, eps]
        # with its closure folded in, and the prefix chain
        seq_step = np.stack([_np_log_matmul(dense[0, t], sc)
                             for t in out_toks]) \
            if self.Lo else np.zeros((0, S, S))
        self._steps = LOGSUMEXP.prepare(
            torch.stack([f64(seq_step), self.prefix_chain]))
        # the absorbing products' matrices, every input token's, prepared
        self._absorb = LOGSUMEXP.prepare(self.a_in)          # (n_in, S, S)
        self._absorb_emit = LOGSUMEXP.prepare(self.a_diag)   # (Lo, n_in, ..)

    def _fill_tokens(self, parent_seq, toks):
        """parent_seq: (Lo+1, S) tensor; toks: (T,) long tensor of token
        ids (0 = root/none). Returns (seq_cell (T, Lo+1, S), prefix_cell
        (T, Lo+1, S), log_prefix_prob (T,))."""
        sr = LOGSUMEXP
        S, Lo, dev = self.S, self.Lo, self.device
        is_root = (toks == 0)[:, None, None]               # (T, 1, 1)

        # absorbing: parent rows o (non-emitting) and o-1 (emitting), for
        # every input token at once, then the candidates' rows
        absorb = sr.matmul_prepared(parent_seq[None], self._absorb)[toks]
        emit = sr.matmul_prepared(parent_seq[:-1, None, None, :],
                                  self._absorb_emit)[:, toks, 0]  # (Lo,T,S)
        absorb = torch.cat([absorb[:, :1],
                            sr.add(absorb[:, 1:], emit.transpose(0, 1))],
                           dim=1)                          # (T, Lo+1, S)
        absorb = torch.where(is_root, NEG_INF, absorb)
        start = torch.full((S,), NEG_INF, dtype=torch.float64, device=dev)
        start[0] = sr.one
        start = torch.where(is_root[:, 0], start, NEG_INF)  # (T, S)
        # pre = absorbs + start at o = 0; the seq cell's base is pre with
        # its own closure applied
        pre = torch.cat([sr.add(absorb[:, :1], start[:, None]),
                         absorb[:, 1:]], dim=1)
        base = torch.stack([sr.matmul(pre, self._sc), pre])  # (2,T,Lo+1,S)

        rows = [base[:, :, 0]]
        eb, bsafe = self._steps
        for o in range(1, Lo + 1):
            chained = sr.matmul_prepared(rows[-1], (eb[:, o - 1],
                                                    bsafe[:, o - 1]))
            rows.append(sr.add(base[:, :, o], chained))
        rows = torch.stack(rows, dim=2)                    # (2, T, Lo+1, S)
        seq_cell, prefix_cell = rows[0], rows[1]
        lpp = torch.logsumexp(prefix_cell[:, Lo] + self.ls[:, S - 1], dim=-1)
        return seq_cell, prefix_cell, lpp

    def _parent(self, parent_seq_cell):
        return torch.as_tensor(np.asarray(parent_seq_cell),
                               dtype=torch.float64, device=self.device)

    # public API ------------------------------------------------------------

    def fill(self, parent_seq_cell, in_tok):
        toks = torch.tensor([int(in_tok)], dtype=torch.long,
                            device=self.device)
        seq, pref, lpp = self._fill_tokens(self._parent(parent_seq_cell),
                                           toks)
        return seq[0].cpu().numpy(), pref[0].cpu().numpy(), float(lpp[0])

    def fill_all_tokens(self, parent_seq_cell):
        """Score every candidate extension token in one batched pass."""
        toks = torch.arange(1, self.n_in, dtype=torch.long,
                            device=self.device)
        seq, pref, lpp = self._fill_tokens(self._parent(parent_seq_cell),
                                           toks)
        return seq.cpu().numpy(), pref.cpu().numpy(), lpp.cpu().numpy()
