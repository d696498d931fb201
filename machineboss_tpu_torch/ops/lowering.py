"""Lowering: EvaluatedMachine -> device tensors.

Produces the dense and sparse (COO) device forms consumed by the DP kernels
(replaces the per-cell transition maps of the reference interpreter,
ref src/eval.h:59-98, with tensor layouts shaped for the MXU):

  dense log_trans[n_in, n_out, S, S]   (token-conditioned transition matrices)
  silent closure C[S, S]               (sum over all-silent paths, (I-N)^-1)
  COO edge arrays grouped by (in,out)  (for large sparse machines)

The silent closure is computed once on host in probability space (matching
the reference's GSL LU inversion, src/eval.cpp:146-181) and folded into the
per-token matrices so device kernels never iterate silent chains.
"""

import math

import numpy as np

from ..core.eval import EvaluatedMachine

NEG_INF = -1e30


def _np_semimatmul(a, b, semiring="logsumexp"):
    """Host (numpy, float64) semiring matmul over the last two axes, with
    broadcasting: C[..., i, j] = (+)_k a[..., i, k] + b[..., k, j]."""
    if semiring in ("maxplus", "max", "viterbi"):
        return np.max(a[..., :, :, None] + b[..., None, :, :], axis=-2)
    amax = np.max(a, axis=-1, keepdims=True)
    bmax = np.max(b, axis=-2, keepdims=True)
    asafe = np.where(amax > NEG_INF / 2, amax, 0.0)
    bsafe = np.where(bmax > NEG_INF / 2, bmax, 0.0)
    prod = np.matmul(np.exp(a - asafe), np.exp(b - bsafe))
    with np.errstate(divide="ignore"):
        out = np.where(prod > 0,
                       np.log(np.maximum(prod, 1e-300)) + asafe + bsafe,
                       NEG_INF)
    return out


class LoweredMachine:
    """Host-side container of device-ready arrays for one machine."""

    def __init__(self, ev: EvaluatedMachine, dtype=np.float32,
                 dense_max_states=512):
        self.ev = ev
        self.n_states = ev.n_states()
        self.n_in = ev.input_tokenizer.n_tokens()
        self.n_out = ev.output_tokenizer.n_tokens()
        self.dtype = dtype
        S = self.n_states

        # ---- COO edges grouped by (inTok, outTok)
        self.edges = ev.edges_by_token()  # {(i,o): (src,dst,ti,logw)}

        # ---- silent closure in probability space: C = (I - N)^{-1}
        silent = self.edges.get((0, 0))
        closure = np.eye(S)
        if silent is not None:
            src, dst, _, lw = silent
            n_mat = np.zeros((S, S))
            np.add.at(n_mat, (src, dst), np.exp(lw))
            closure = np.linalg.inv(np.eye(S) - n_mat)
        with np.errstate(divide="ignore", invalid="ignore"):
            log_closure = np.where(closure > 0, np.log(np.maximum(closure,
                                                                  1e-300)),
                                   NEG_INF)
        self.log_closure = log_closure.astype(dtype)

        # ---- dense per-token-pair transition tensors
        self.is_dense = S <= dense_max_states
        if self.is_dense:
            lt = np.full((self.n_in, self.n_out, S, S), NEG_INF)
            for (i, o), (src, dst, _, lw) in self.edges.items():
                # collapse parallel edges by logaddexp
                np.logaddexp.at(lt, (i, o, src, dst),
                                np.where(np.isfinite(lw), lw, NEG_INF))
            lt = np.where(np.isfinite(lt), lt, NEG_INF)
            self.log_trans = np.maximum(lt, NEG_INF).astype(dtype)
        else:
            self.log_trans = None

        # flattened COO (for sparse kernels): arrays over all edges
        srcs, dsts, ins, outs, lws = [], [], [], [], []
        for (i, o), (src, dst, _, lw) in sorted(self.edges.items()):
            srcs.append(src)
            dsts.append(dst)
            ins.append(np.full(len(src), i))
            outs.append(np.full(len(src), o))
            lws.append(lw)
        if srcs:
            self.coo_src = np.concatenate(srcs).astype(np.int32)
            self.coo_dst = np.concatenate(dsts).astype(np.int32)
            self.coo_in = np.concatenate(ins).astype(np.int32)
            self.coo_out = np.concatenate(outs).astype(np.int32)
            self.coo_logw = np.where(
                np.isfinite(np.concatenate(lws)),
                np.concatenate(lws), NEG_INF).astype(dtype)
        else:
            self.coo_src = np.zeros(0, np.int32)
            self.coo_dst = np.zeros(0, np.int32)
            self.coo_in = np.zeros(0, np.int32)
            self.coo_out = np.zeros(0, np.int32)
            self.coo_logw = np.zeros(0, dtype)

    # ------------------------------------------------------------------

    def closure_for(self, semiring="logsumexp"):
        """Silent closure in the given semiring: sum over all silent paths
        (Forward) or max over silent paths (Viterbi, via DAG DP — advancing
        machines have strictly forward silent edges)."""
        if semiring in ("logsumexp", "sum", "forward"):
            return self.log_closure
        S = self.n_states
        c = np.full((S, S), NEG_INF)
        np.fill_diagonal(c, 0.0)
        silent = self.edges.get((0, 0))
        if silent is not None:
            src, dst, _, lw = silent  # sorted by (dst, src): topological
            for k in range(len(src)):
                s, d, w = src[k], dst[k], lw[k]
                cand = c[:, s] + w
                c[:, d] = np.maximum(c[:, d], cand)
        return c.astype(self.dtype)

    def emit_matrices_1d(self, output_side=True, semiring="logsumexp"):
        """Token-indexed transfer matrices with silent closure folded in.

        For a generator (1D over output): M[tok] = E_tok (x) C where
        E_tok[s,d] combines transitions emitting tok and C is the silent
        closure in the chosen semiring. Position p's forward update is
        f_p = f_{p-1} (x) M[tok_p]; the start vector is e_0 (x) C.

        Returns (M[n_tok, S, S], logC[S, S]) as numpy arrays (log space).
        """
        if self.log_trans is None:
            raise ValueError("emit_matrices_1d requires dense lowering")
        if output_side:
            emit = self.log_trans[0, 1:].astype(np.float64)  # (n_out-1,S,S)
        else:
            emit = self.log_trans[1:, 0].astype(np.float64)
        closure = self.closure_for(semiring).astype(np.float64)
        log_m = _np_semimatmul(emit, closure[None], semiring)
        return log_m.astype(self.dtype), closure.astype(self.dtype)

    def matrices_2d(self, semiring="logsumexp"):
        """Pieces for pairwise DP: (A_diag[n_in-1,n_out-1,S,S],
        A_left[n_in-1,S,S], A_up[n_out-1,S,S], C[S,S]); closure kept
        separate so kernels apply it once per cell after combining the three
        neighbor contributions."""
        if self.log_trans is None:
            raise ValueError("matrices_2d requires dense lowering")
        a_diag = self.log_trans[1:, 1:]
        a_left = self.log_trans[1:, 0]
        a_up = self.log_trans[0, 1:]
        return (a_diag, a_left, a_up, self.closure_for(semiring))


def lower(machine, params, dtype=np.float32, dense_max_states=512):
    ev = EvaluatedMachine(machine, params)
    return LoweredMachine(ev, dtype=dtype, dense_max_states=dense_max_states)
