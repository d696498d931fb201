"""Alignment-constrained DP: scan along a prescribed alignment path.

Counterpart of machineboss_tpu's ops/dp_aligned.py. Given an alignment
(a sequence of columns, each consuming an input token, emitting an output
token, or both), the DP reduces to a 1D scan over the path's columns,
O(A * S^2) instead of O(Li * Lo * S^2): the device equivalent of the
path Envelope of core/seqpair.py, used for training on labeled
alignments.

Columns are encoded as (in_tok, out_tok) pairs with 0 = epsilon; the
transfer matrix of a column is A[in, out] (x) C.
"""

import numpy as np
import torch

from .semiring import LOGSUMEXP


def forward_aligned(log_trans, closure, col_in, col_out, n_cols,
                    sr=LOGSUMEXP):
    """log_trans: (n_in, n_out, S, S); closure: (S, S);
    col_in/col_out: (A,) token ids (0 = epsilon) per alignment column;
    n_cols: actual number of columns (padding allowed).
    Returns the path-constrained Forward log-likelihood."""
    S = closure.shape[-1]
    dev = closure.device
    col_in = torch.as_tensor(col_in, device=dev).long()
    col_out = torch.as_tensor(col_out, device=dev).long()
    e0 = torch.full((S,), sr.zero, dtype=closure.dtype, device=dev)
    e0[0] = sr.one
    f = sr.vecmat(e0, closure)
    mats = sr.matmul(log_trans[col_in[:int(n_cols)], col_out[:int(n_cols)]],
                     closure)                             # (n_cols, S, S)
    for m in mats:
        f = sr.vecmat(f, m)
    return f[S - 1]


def alignment_tokens(ev, alignment):
    """Convert a host alignment (list of (in_sym, out_sym)) to token arrays."""
    col_in = np.array([ev.input_tokenizer.sym2tok[a] if a else 0
                       for a, b in alignment], np.int32)
    col_out = np.array([ev.output_tokenizer.sym2tok[b] if b else 0
                        for a, b in alignment], np.int32)
    return col_in, col_out
