"""Device E-step: expected transition counts by automatic differentiation
(counterpart of machineboss_tpu's ops/fwdback.py), with batch tokenizing,
padding buckets and posterior lattices.

The identity E[n_t] = dLogLike/d(log w_t) turns count collection into a
gradient: `CountModel` builds the dense DP tensors differentiably from the
per-transition log-weight vector, runs the batched Forward recurrence, and
takes torch.autograd.grad of the summed log-likelihood, which yields the
count vector in the host's (state, transIndex) layout. Silent-transition
counts flow through the differentiable closure C = (I - N)^{-1}.

Deliberate difference: the JAX class differentiates a vmap of the row
scan (dp2d.forward_2d); this one differentiates the batched scaled
wavefront (ops/wavefront_fast.py), the same function, whose launches
serve the whole batch a diagonal at a time where the port's eager row
engine makes some thirty a cell. It also runs a generator (an empty input
side), on which the JAX class raises (its row scan indexes the empty
a_left).
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from .semiring import NEG_INF
from .wavefront_fast import forward_2d_wavefront_fast


class CountModel:
    """Static (host-side) description binding a machine's transitions to
    the differentiable device tensors, on `device` (None: the CUDA card,
    raising when CUDA is absent; "cpu" for the CPU)."""

    def __init__(self, ev, dtype=torch.float32, device=None):
        self.ev = ev
        self.device = resolve_device(device)
        S = ev.n_states()
        self.n_states = S
        self.n_in = ev.input_tokenizer.n_tokens()
        self.n_out = ev.output_tokenizer.n_tokens()
        # flat edge list in (state, transIndex) order = host count layout
        src, dst, itok, otok, logw = [], [], [], [], []
        for s, es in enumerate(ev.state):
            order = {}
            for (i, o), lst in es.outgoing.items():
                for d, ti, lw in lst:
                    order[ti] = (s, d, i, o, lw)
            for ti in range(es.n_transitions):
                s_, d, i, o, lw = order[ti]
                src.append(s_)
                dst.append(d)
                itok.append(i)
                otok.append(o)
                logw.append(lw if np.isfinite(lw) else NEG_INF)
        self._set_edges(src, dst, itok, otok,
                        np.maximum(np.array(logw, np.float64), NEG_INF),
                        dtype)

    @classmethod
    def from_edges(cls, src, dst, itok, otok, logw, n_states, n_in, n_out,
                   dtype=torch.float32, device=None):
        """A model from its flat edge arrays and sizes, with no
        EvaluatedMachine behind it (ev is None)."""
        model = cls.__new__(cls)
        model.ev = None
        model.device = resolve_device(device)
        model.n_states, model.n_in, model.n_out = n_states, n_in, n_out
        model._set_edges(src, dst, itok, otok, logw, dtype)
        return model

    def _set_edges(self, src, dst, itok, otok, logw, dtype):
        def index(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

        self.src = index(src)
        self.dst = index(dst)
        self.itok = index(itok)
        self.otok = index(otok)
        self.logw = torch.as_tensor(logw).to(self.device, dtype)
        self.n_edges = len(self.src)
        self.dtype = dtype

    # -- differentiable tensor construction --------------------------------

    def build_tensors(self, logw):
        """(a_diag, a_left, a_up, closure) in log space, differentiable in
        logw: the per-edge probabilities scattered by index_put with
        accumulate (parallel edges add), the closure as inv(I - N)."""
        S = self.n_states
        probs = torch.exp(logw)
        silent = (self.itok == 0) & (self.otok == 0)
        zero = torch.zeros((), dtype=logw.dtype, device=logw.device)
        n_mat = torch.zeros((S, S), dtype=logw.dtype, device=logw.device) \
            .index_put((self.src, self.dst), torch.where(silent, probs, zero),
                       accumulate=True)
        eye = torch.eye(S, dtype=logw.dtype, device=logw.device)
        closure = _safe_log(torch.linalg.inv(eye - n_mat))
        dense_p = torch.zeros((self.n_in, self.n_out, S, S), dtype=logw.dtype,
                              device=logw.device) \
            .index_put((self.itok, self.otok, self.src, self.dst),
                       torch.where(silent, zero, probs), accumulate=True)
        dense = _safe_log(dense_p)
        return dense[1:, 1:], dense[1:, 0], dense[0, 1:], closure

    # -- batched log-likelihood (the E-step objective) ---------------------

    def batch_loglike(self, logw, in_toks, out_toks, in_lens, out_lens,
                      weights=None):
        """Sum of log-likelihoods over a padded batch, and the (B,) lls.

        in_toks: (B, Li) 0-based padded tokens; lens give true lengths.
        weights: optional (B,) per-pair multipliers on the objective —
        weight 0 removes a (padding) pair from both the total and, through
        the gradient, the expected counts. Impossible pairs (ll <=
        NEG_INF/2) drop out of the sum."""
        lls = forward_2d_wavefront_fast(*self.build_tensors(logw), in_toks,
                                        out_toks, in_lens, out_lens)
        valid = lls > NEG_INF / 2
        w = torch.ones_like(lls) if weights is None else weights
        return torch.sum(torch.where(valid, lls, torch.zeros_like(lls)) * w), \
            lls

    def counts_and_loglike(self, in_toks, out_toks, in_lens, out_lens,
                           logw=None, weights=None):
        """Expected per-transition counts + total loglike for a batch:
        (counts (n_edges,), total, lls (B,)), from one autograd pass."""
        logw = (self.logw if logw is None else logw).detach() \
            .requires_grad_(True)
        with torch.enable_grad():
            total, lls = self.batch_loglike(logw, in_toks, out_toks,
                                            in_lens, out_lens,
                                            weights=weights)
            grads, = torch.autograd.grad(total, logw)
        return grads, total.detach(), lls.detach()


def _safe_log(p):
    """log p where p > 0, else NEG_INF; the inner where keeps log(0) out of
    the graph, so no NaN reaches the gradient."""
    pos = p > 0
    return torch.where(pos, torch.log(torch.where(pos, p, torch.ones_like(p))),
                       torch.full_like(p, NEG_INF))


def pad_bucket(n, ratio=1.5, base=8):
    """Geometric padding bucket (ref seq.py pad_length semantics: lengths
    rounded up to powers of `ratio` to bound recompilation on ragged
    batches)."""
    b = base
    while b < n:
        b = int(b * ratio) + 1
    return b


def tokenize_batch(ev, seq_pairs, pad_to=None, bucket=False, device=None):
    """Pad/tokenize a list of SeqPairs into (B, Li) and (B, Lo) 0-based
    token tensors and (B,) lengths on `device` (None: the CUDA card,
    raising when CUDA is absent; "cpu" for the CPU).

    bucket=True rounds padded lengths up to geometric buckets, as the JAX
    package does to reuse compiled kernels on ragged batches."""
    dev = resolve_device(device)
    in_seqs = [[ev.input_tokenizer.sym2tok[c] - 1 for c in sp.input.seq]
               for sp in seq_pairs]
    out_seqs = [[ev.output_tokenizer.sym2tok[c] - 1 for c in sp.output.seq]
                for sp in seq_pairs]
    li = max([len(s) for s in in_seqs] + [1])
    lo = max([len(s) for s in out_seqs] + [1])
    if bucket:
        li = pad_bucket(li)
        lo = pad_bucket(lo)
    if pad_to:
        li = max(li, pad_to)
        lo = max(lo, pad_to)
    B = len(seq_pairs)
    it = np.zeros((B, li), np.int32)
    ot = np.zeros((B, lo), np.int32)
    il = np.zeros(B, np.int32)
    ol = np.zeros(B, np.int32)
    for n, (i_s, o_s) in enumerate(zip(in_seqs, out_seqs)):
        it[n, :len(i_s)] = i_s
        ot[n, :len(o_s)] = o_s
        il[n] = len(i_s)
        ol[n] = len(o_s)
    return tuple(torch.from_numpy(x).to(dev) for x in (it, ot, il, ol))


def posterior_lattice(a_diag, a_left, a_up, closure, in_toks, out_toks,
                      sr=None):
    """Posterior state marginals P(state at (i,o) | sequences): the
    forward lattice plus backward lattice minus total log-likelihood,
    (Lo+1, Li+1, S)."""
    from . import dp2d
    from .semiring import LOGSUMEXP
    sr = sr or LOGSUMEXP
    f = dp2d.forward_2d_lattice(a_diag, a_left, a_up, closure, in_toks,
                                out_toks, sr=sr)
    b = dp2d.backward_2d_lattice(a_diag, a_left, a_up, closure, in_toks,
                                 out_toks, sr=sr)
    S = closure.shape[-1]
    ll = f[-1, -1, S - 1]
    # note: f is post-closure and b includes same-cell closure, so f+b
    # counts within-cell silent runs on both sides; state marginals are
    # exact at emission boundaries (i.e. for loud states), matching the
    # reference's posterior semantics
    return f + b - ll
