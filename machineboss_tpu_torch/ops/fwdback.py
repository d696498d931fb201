"""Batch tokenizing, padding buckets and posterior lattices (counterpart
of machineboss_tpu's ops/fwdback.py; its CountModel E-step is not ported
yet: ROADMAP.md queue A, item 5)."""

import numpy as np
import torch

from ..utils.device import resolve_device


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
