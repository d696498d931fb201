"""Destination-column factorization of token-conditioned WFST tensors.

The generic wavefront kernel pays Ti*To redundant MXU blocks per cell
because each cell's transition matrix depends on its (input, output) token
pair. Structured machines (profile HMMs, GeneWise prot2dna, anything with
emission-on-transition weights w(s -> s', tok) = trans(s, s') *
emit(s', tok)) admit an exact low-rank form PER DESTINATION COLUMN:

    A[t, s, s'] = sum_r  T_r[s, s'] * E_r[t, s']        (prob space)

found by an SVD of each destination's (n_tok, S) incoming slab. The DP
contribution for a cell with token t then becomes

    contrib = sum_r (T_r^T p) * (E_r^T onehot_t)         (elementwise *)

i.e. R shared (S, S) matmuls + one tiny (S, n_tok) token matmul instead of
n_tok masked (S, S) blocks. R is bounded by min(n_tok, S) and equals the
max destination-column rank: 1 for separable emissions (prot2dna's protein
side), n_tok in the fully random worst case (where this reduces to the
generic cost — never worse).

Reference anchor: the per-state incoming transition blocking the C++
interpreter exploits (ref src/eval.h:66-73); this is its MXU-shaped
equivalent.
"""

import numpy as np


def factorize_token_tensor(a, tol=1e-12):
    """Decompose prob-space a (T, S, Sdst) into (T_stack, E_stack) with
    a[t, s, d] == sum_r T_stack[r, s, d] * E_stack[r, t, d] (exact to
    float64 SVD accuracy).

    Returns (T_stack (R, S, Sd), E_stack (R, T, Sd), R). R == 0 when the
    tensor is identically zero."""
    a = np.asarray(a, np.float64)
    T, S, Sd = a.shape
    if not a.any():
        return (np.zeros((0, S, Sd)), np.zeros((0, T, Sd)), 0)
    # per-destination SVD; rank = count of significant singular values
    t_cols = []
    e_cols = []
    ranks = np.zeros(Sd, np.int64)
    for d in range(Sd):
        block = a[:, :, d]                      # (T, S)
        if not block.any():
            t_cols.append(np.zeros((0, S)))
            e_cols.append(np.zeros((0, T)))
            continue
        u, sv, vt = np.linalg.svd(block, full_matrices=False)
        r = int((sv > tol * sv[0]).sum())
        ranks[d] = r
        t_cols.append(sv[:r, None] * vt[:r])    # (r, S)
        e_cols.append(u[:, :r].T)               # (r, T)
    R = int(ranks.max()) if Sd else 0
    t_stack = np.zeros((R, S, Sd))
    e_stack = np.zeros((R, T, Sd))
    for d in range(Sd):
        r = len(t_cols[d])
        if r:
            t_stack[:r, :, d] = t_cols[d]
            e_stack[:r, :, d] = e_cols[d]
    return t_stack, e_stack, R


def factorization_error(a, t_stack, e_stack):
    """Max abs reconstruction error (diagnostic)."""
    recon = np.einsum("rsd,rtd->tsd", t_stack, e_stack)
    return float(np.abs(np.asarray(a, np.float64) - recon).max())
