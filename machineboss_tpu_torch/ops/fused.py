"""Fused generator (x) transducer DP: score a transducer's output against a
generator without materializing the composite state space.

Counterpart of machineboss_tpu's ops/fused.py on torch tensors. The joint DP
cell is a (Sg, St) matrix per output position. Every composite transition
factors as a Kronecker product (generator move) (x) (transducer move), so
each update is two small matmuls instead of one (Sg*St)^2 product:

    C' = sum_a  Ga^T  C  T[a, out]        (G emits a; T consumes a)
       +        C  T[eps, out]            (T moves without input)
       + Gn^T C                           (G silent move)

Complexity O(Lo * A * (Sg^2 St + Sg St^2)) versus O(Lo * (Sg St)^2) for the
materialized composition. Joint silent moves (G emits, T absorbs silently)
are handled by fixed-iteration propagation. The JAX function's scan over
output positions is a Python loop here, with the same length mask.
"""

import numpy as np
import torch

from .semiring import LOGSUMEXP, NEG_INF


def fused_forward(g_emit, g_closure, t_tensor, t_closure, out_toks, out_len,
                  n_pair_iters=4, sr=LOGSUMEXP):
    """Forward log-likelihood of output sequence under generator (x)
    transducer, fused. Returns a 0-dim tensor on the operands' device.

    g_emit: (A, Sg, Sg) generator transitions emitting symbol a (log)
    g_closure: (Sg, Sg) closure over the generator's silent moves
    t_tensor: (A+1, n_out, St, St) transducer transitions indexed by
        (input token 0=eps, output token 0=eps) over the SHARED alphabet A
    t_closure: (St, St) closure over the transducer's (eps,eps) moves
    out_toks: (Lo,) 0-based observed output tokens; out_len: actual length.

    Silent composite paths decompose uniquely as alternations of G-silent
    runs (folded into g_closure), T-silent runs (t_closure, folded on the
    right of every T move), and PAIRED silent moves (G emits a, T absorbs
    it silently); only the paired count is iterated, bounded by
    n_pair_iters per output position.

    Interleaving canonicalization: values that arrive via a T-only output
    move ("cold") may feed paired moves but NOT g_closure, so commuting
    (G-silent, T-only) adjacent pairs are ordered G-first and each
    interleaving class is admitted once.
    """
    A, Sg, _ = g_emit.shape
    St = t_tensor.shape[-1]
    g_emit_t = g_emit.transpose(-1, -2)
    g_closure_t = g_closure.transpose(-1, -2)
    # fold the T (eps,eps) closure into every T move matrix
    tt = sr.matmul(t_tensor, t_closure)

    def close_g(c):
        return sr.matmul(g_closure_t, c)

    def paired(c):
        """One paired silent move (G emits a, T absorbs silently)."""
        ga_c = sr.matmul(g_emit_t, c[None])                       # (A,Sg,St)
        both = sr.matmul(ga_c, tt[1:, 0])                         # (A,Sg,St)
        return sr.reduce(both.movedim(0, -1), axis=-1)

    def propagate_hot(base):
        # h = close_g(base (+) paired(h)): geometric series over the
        # paired-move count
        acc = cur = close_g(base)
        for _ in range(n_pair_iters):
            cur = close_g(paired(cur))
            acc = sr.add(acc, cur)
        return acc

    c = torch.full((Sg, St), sr.zero, dtype=g_emit.dtype,
                   device=g_emit.device)
    c[0, 0] = sr.one
    c = propagate_hot(sr.matmul(c, t_closure))

    toks = out_toks.tolist() if torch.is_tensor(out_toks) else \
        [int(t) for t in out_toks]
    for pos in range(min(int(out_len), len(toks))):
        tok = toks[pos]
        # T-only output move: cold, no generator closure may follow
        cold = sr.matmul(c, tt[0, tok + 1])
        # paired with output: G emits a, T consumes a and emits tok
        ga_c = sr.matmul(g_emit_t, c[None])                        # (A,Sg,St)
        with_input = sr.matmul(ga_c, tt[1:, tok + 1])
        hot0 = sr.reduce(with_input.movedim(0, -1), axis=-1)
        h = propagate_hot(sr.add(hot0, paired(cold)))
        c = sr.add(h, cold)
    return c[Sg - 1, St - 1]


def fused_tensors(gen_ev, td_ev, dtype=None):
    """Lower an (evaluated generator, evaluated transducer) pair for
    fused_forward: numpy (g_emit, g_closure, t_tensor, t_closure). The
    generator's output alphabet must equal the transducer's input
    alphabet."""
    dtype = dtype or np.float32
    g_alph = gen_ev.output_tokenizer.tok2sym[1:]
    t_alph = td_ev.input_tokenizer.tok2sym[1:]
    if g_alph != t_alph:
        raise ValueError("generator output alphabet %r != transducer input"
                         " alphabet %r" % (g_alph, t_alph))
    A = len(g_alph)
    Sg = gen_ev.n_states()
    St = td_ev.n_states()
    g_emit = np.full((A, Sg, Sg), NEG_INF)
    g_null = np.full((Sg, Sg), NEG_INF)
    for (i, o), (src, dst, _, lw) in gen_ev.edges_by_token().items():
        for k in range(len(src)):
            w = lw[k] if np.isfinite(lw[k]) else NEG_INF
            if o == 0:
                g_null[src[k], dst[k]] = np.logaddexp(
                    g_null[src[k], dst[k]], w)
            else:
                g_emit[o - 1, src[k], dst[k]] = np.logaddexp(
                    g_emit[o - 1, src[k], dst[k]], w)
    n_out = td_ev.output_tokenizer.n_tokens()
    t_tensor = np.full((A + 1, n_out, St, St), NEG_INF)
    for (i, o), (src, dst, _, lw) in td_ev.edges_by_token().items():
        for k in range(len(src)):
            w = lw[k] if np.isfinite(lw[k]) else NEG_INF
            t_tensor[i, o, src[k], dst[k]] = np.logaddexp(
                t_tensor[i, o, src[k], dst[k]], w)

    def np_closure(log_n):
        n_mat = np.where(log_n > NEG_INF / 2, np.exp(log_n), 0.0)
        inv = np.linalg.inv(np.eye(n_mat.shape[0]) - n_mat)
        with np.errstate(divide="ignore"):
            return np.where(inv > 0, np.log(np.maximum(inv, 1e-300)),
                            NEG_INF)

    g_closure = np_closure(g_null)
    t_closure = np_closure(t_tensor[0, 0])
    return (g_emit.astype(dtype), g_closure.astype(dtype),
            t_tensor.astype(dtype), t_closure.astype(dtype))
