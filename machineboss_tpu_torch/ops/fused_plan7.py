"""Chain-specialized fused Plan7 (x) transducer DP, on torch tensors.

Counterpart of machineboss_tpu's ops/fused_plan7.py. Scores a transducer's
output against a HMMER profile generator WITHOUT materializing the
composite state space, exploiting the Plan7 linear chain:
O(Lo * K * St^2) instead of O(Lo * S_p7^2 * St) for the composition.

Per output position (one row):
  1. "base" contributions from the previous row land batched over profile
     nodes k: the transducer consumes a profile emission AND emits y_o
     (EMy/EIy), or emits y_o on its own (Ty0 moves, valid in every
     generator state class).
  2. the within-row silent sweep along k (delete chains + silent
     absorption of profile emissions by the transducer) is a first-order
     affine recurrence over k whose transfer matrix A_k (3St x 3St, carry
     [Mx_k, Ix_k, D_k]) is ROW-INDEPENDENT. Three solvers: "scan" (a
     log-depth doubling over the (A, b) pairs, ceil(log2 K) batched
     semiring matmuls), "prefix" (one dense semiring matmul against the
     host-precomputed lower-block-triangular prefix-product matrix), and,
     inside the CUDA kernel of ops/kernels/fused_plan7_kernel.py, the
     doubling again, in scaled probability with host-prepared levels.
  3. within-node cycles (I_k self-loop, node-0 insert, N/C/J flank
     loops) are exact via host-precomputed (I - loop)^-1 closures.

Generator state classes mirror the importer's split emission states
(core/hmmer.py; emission on M_k -> Mx_k): M, Mx, I, Ix, D per node plus
S, N, Nx, B, E, C, Cx, J, Jx, T flanks and the node-0 insert I0/Ix0 (global
core mode). The transducer's (eps,eps) closure is folded on the right of
every transducer move.

Multihit re-entry (E -> J -> B within one output row) requires the second
profile pass to be absorbed silently by the transducer; the per-read
solver resolves it by `n_hit` fixed-point iterations
B <- B0 (+) exit*Jx(E(B)) of the row solve, the batch-major flat solver and
the kernel by an exact host closure.

Everything here is batched: the per-read solver carries a written-out
leading batch dimension where the JAX class vmaps it. The host
precomputation is numpy float64, unchanged from the JAX class; the tables
are float32 tensors on `device`.
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from .semiring import MAXPLUS, NEG_INF, PROB, get_semiring


def _np_log(p):
    p = np.asarray(p, np.float64)
    with np.errstate(divide="ignore"):
        return np.where(p > 0, np.log(np.maximum(p, 1e-300)), NEG_INF)


def _np_log_matmul(a, b):
    amax = np.max(a, axis=-1, keepdims=True)
    bmax = np.max(b, axis=-2, keepdims=True)
    asafe = np.where(amax > NEG_INF / 2, amax, 0.0)
    bsafe = np.where(bmax > NEG_INF / 2, bmax, 0.0)
    prod = np.exp(a - asafe) @ np.exp(b - bsafe)
    return np.where(prod > 0, _np_log(prod) + asafe + bsafe, NEG_INF)


def _np_lse(stack, axis=0):
    m = np.max(stack, axis=axis, keepdims=True)
    safe = np.where(m > NEG_INF / 2, m, 0.0)
    s = np.sum(np.exp(stack - safe), axis=axis)
    return np.where(s > 0, _np_log(s) + np.squeeze(safe, axis), NEG_INF)


# ---- max-plus (Viterbi) host counterparts: the same code path serves
# Forward via LOGSUMEXP and Viterbi via MAXPLUS; the infinite-sum closures
# (I - P)^-1 become max-plus Kleene stars (the best path through a
# substochastic loop never repeats it, so the star converges).

def _np_mp_matmul(a, b):
    return np.max(a[..., :, :, None] + b[..., None, :, :], axis=-2)


def _np_mp_star(m):
    """Kleene star of a square log-matrix in max-plus: max over any number
    of steps. Converges (to max over simple paths) iff every cycle has
    negative log-weight; repeated squaring of (I (+) A) doubles the
    admitted path length per iteration."""
    m = np.asarray(m, np.float64)
    if m.ndim == 3:
        return np.stack([_np_mp_star(m[k]) for k in range(m.shape[0])])
    n = m.shape[0]
    b = np.maximum(_np_log(np.eye(n)), m)
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 2):
        nb = _np_mp_matmul(b, b)
        if np.allclose(nb, b, atol=1e-12):
            return b
        b = nb
    nb = _np_mp_matmul(b, b)
    if not np.allclose(nb, b, atol=1e-9):
        raise ValueError("max-plus closure diverges (cycle with "
                         "log-weight >= 0)")
    return nb


_K_CLASSES = ("M", "Mx", "I", "Ix", "D")
_FLANKS = ("N", "Nx", "B", "E", "C", "Cx", "J", "Jx", "T", "I0", "Ix0")
_LOG_HALF = float(np.log(0.5))


class Plan7Fused:
    """Fused profile-HMM (x) transducer Forward.

    hmm: core.hmmer.HmmerModel (parsed HMMER3 text)
    td_ev: EvaluatedMachine of the transducer; its input alphabet must
        cover the HMM's alphabet.
    mode: 'core' (hmm.machine(local)) or 'plan7' (hmm.plan7_machine, with
        N/C/J flanks).
    device: where the tables live and the DP runs; None = the CUDA card.
    dtype: torch.float32, or torch.float64 for a reference run of the
        torch solvers (the kernel route is float32 only).
    """

    def __init__(self, hmm, td_ev, mode="plan7", local=True, multihit=False,
                 length=400.0, n_hit=3, solver="auto", semiring="logsumexp",
                 prob_space=None, device=None, dtype=torch.float32):
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError("dtype must be torch.float32 or torch.float64")
        self.dtype = dtype
        self.hmm = hmm
        self.td_ev = td_ev
        self.mode = mode
        self.local = local if mode == "core" else True
        self.multihit = multihit
        self.n_hit = n_hit if (mode == "plan7" and multihit) else 1
        # semiring parameterization: LOGSUMEXP = Forward, MAXPLUS = Viterbi;
        # the host-side precomputation swaps semiring-matched matmul /
        # reduce / closure
        self.sr = get_semiring(semiring)
        self.viterbi = self.sr is MAXPLUS
        # OPTIONAL execution semiring of the flat batch solver: for Forward
        # the row recurrence is linear, so it CAN run in scaled-probability
        # space (ops/semiring.ProbSemiring) with one renormalization per
        # token row. Kept as a semantics cross-check (tests run both). Host
        # setup (closures, multihit basis maps) always stays in log space;
        # Viterbi stays log (max has no prob-space form).
        if prob_space is None:
            prob_space = False
        self.prob_space = bool(prob_space) and not self.viterbi
        self._xsr = PROB if self.prob_space else self.sr
        hmatmul = _np_mp_matmul if self.viterbi else _np_log_matmul
        self._hmatmul = hmatmul
        K = len(hmm.node)
        if K < 1:
            raise ValueError("empty HMM")
        self.K = K
        St = td_ev.n_states()
        self.St = St
        A = len(hmm.alph)

        # ---- transducer tensors: dense (n_in, n_out, St, St) log weights
        n_in = td_ev.input_tokenizer.n_tokens()
        n_out = td_ev.output_tokenizer.n_tokens()
        self.n_out = n_out
        dense = np.full((n_in, n_out, St, St), NEG_INF)
        for (i, o), (src, dst, _, lw) in td_ev.edges_by_token().items():
            for t in range(len(src)):
                w = lw[t] if np.isfinite(lw[t]) else NEG_INF
                # parallel degenerate transitions collapse by SUM in both
                # semirings (compose's TransAccumulator does the same
                # before the host Viterbi ever runs)
                dense[i, o, src[t], dst[t]] = np.logaddexp(
                    dense[i, o, src[t], dst[t]], w)

        def sum_star(log_mat):
            """(I - P)^-1 in probability space (any leading batch dim):
            the geometric silent-cycle fold compose() applies
            (advancing_machine) regardless of the DP semiring."""
            p = np.where(log_mat > NEG_INF / 2, np.exp(log_mat), 0.0)
            n = p.shape[-1]
            if p.ndim == 2:
                return _np_log(np.linalg.inv(np.eye(n) - p))
            return np.stack([_np_log(np.linalg.inv(np.eye(n) - p[k]))
                             for k in range(p.shape[0])])

        self._sum_star = sum_star
        # td silent-chain closure: compose keeps acyclic silent chains
        # discrete, so the fold uses the MODE semiring (max-plus Kleene
        # star for Viterbi); td silent cycles would be sum-folded by
        # compose, but EvaluatedMachine requires an advancing transducer,
        # so the star is finite either way
        t_closure = (_np_mp_star(dense[0, 0]) if self.viterbi
                     else sum_star(dense[0, 0]))

        toks = []
        for sym in hmm.alph:
            t = td_ev.input_tokenizer.sym2tok.get(sym)
            if t is None:
                raise ValueError("transducer lacks input symbol %r" % sym)
            toks.append(t)

        # one-step move tensors (td silent closure folded AFTER the
        # symbol collapse below). The composed-machine semantics this
        # must match for Viterbi parity: compose() SUMS degenerate
        # transitions (same src/dst/in/out), and the host ViterbiMatrix
        # then maxes over the collapsed graph; so the per-symbol paired
        # moves collapse by logaddexp in BOTH semirings, while the td
        # silent chain (kept discrete by compose) folds with the mode
        # semiring.
        ta0_raw = dense[np.array(toks), 0]                     # (A, St, St)
        tay_raw = dense[np.array(toks)]                        # (A,n_out,..)
        ty0 = hmatmul(dense[0], t_closure)                     # (n_out,..)

        m_emit = np.array([[_np_log(n.match_emit[a]) for a in range(A)]
                           for n in hmm.node])                 # (K, A)
        i_emit = np.array([[_np_log(n.ins_emit[a]) for a in range(A)]
                           for n in hmm.node])
        null_emit = _np_log(np.array(hmm.null_emit))           # (A,)
        ins0_emit = _np_log(np.array(hmm.ins0_emit))

        def absorb(emit, closure=t_closure, mm=hmatmul):
            """(..., A) log dist -> (..., St, St) silent-absorb matrix:
            sum over the absorbed symbol (degenerate collapse), then the
            td silent closure folded with the given matmul."""
            raw = _np_lse(emit[..., :, None, None] + ta0_raw, axis=-3)
            return mm(raw, closure)

        em0 = absorb(m_emit)                                   # (K, St, St)
        ei0 = absorb(i_emit)
        enull0 = absorb(null_emit)
        eins00 = absorb(ins0_emit)

        sc = {n: _np_log(np.array([getattr(node, n) for node in hmm.node]))
              for n in ("m_to_m", "m_to_i", "m_to_d", "i_to_m", "i_to_i",
                        "d_to_m", "d_to_d")}

        def loop_closure(log_scalar, log_mat):
            """Closure of the scaled loop: geometric path-sum (I-sP)^-1
            for Forward, Kleene star (best number of traversals: zero,
            as loops cost) for Viterbi. NOTE an intentional semantic
            difference from Viterbi-on-the-composed-machine: compose()
            sum-folds silent cycles BEFORE the host Viterbi runs
            (advancing_machine), so the composed score can exceed the
            best-collapsed-path score by the folded cycle mass. The tests
            assert the exact sandwich vit_fused <= vit_composed <=
            fwd_fused plus exact f64 parity against algo/fused_align.py."""
            ls = np.maximum(np.asarray(log_scalar, np.float64), NEG_INF)
            if log_mat.ndim == 3:
                arg = ls[:, None, None] + log_mat
            else:
                arg = ls + log_mat
            return _np_mp_star(arg) if self.viterbi else sum_star(arg)

        ci = loop_closure(sc["i_to_i"], ei0)                   # (K, St, St)
        ci00 = loop_closure(_np_log(hmm.i0_to_i0), eins00)

        # local entry weights B -> M_k, k=1..K-1
        if self.local:
            occ = hmm.calc_match_occupancy()
            z = sum(occ[k] * (K - k + 1) for k in range(1, K))
            entry = np.full(K, NEG_INF)
            for k in range(1, K):
                if z > 0:
                    entry[k - 1] = float(_np_log(occ[k] / z))
            self._entry_np = entry
        else:
            self._entry_np = None

        # ---- row-independent along-k transfer, carry [Mx, Ix, D]:
        #   M_k  = Mx_{k-1} mm_{k-1} (+) Ix_{k-1} im_{k-1}
        #          (+) D_{k-1} dm_{k-1} (+) u_k
        #   Mx_k = M_k @ EM0_k (+) base_Mx_k
        #   I_k  = (mi_k Mx_k (+) base_I_k (+) ii_k base_Ix_k) @ CI_k
        #   Ix_k = I_k @ EI0_k (+) base_Ix_k
        #   D_k  = Mx_{k-1} md_{k-1} (+) D_{k-1} dd_{k-1} (+) base_D_k
        # Local mode's node-K differences (no mm/md continuation) need no
        # masking: sources at k-1 = K-1 are never read by A_k, k <= K-1.
        eye_log = _np_log(np.eye(St))
        a_mat = np.full((K, 3 * St, 3 * St), NEG_INF)
        for k in range(1, K):
            em = em0[k]
            to_ix = hmatmul(
                hmatmul(sc["m_to_i"][k] + em, ci[k]), ei0[k])
            a_mat[k, 0:St, 0:St] = sc["m_to_m"][k - 1] + em
            a_mat[k, St:2 * St, 0:St] = sc["i_to_m"][k - 1] + em
            a_mat[k, 2 * St:, 0:St] = sc["d_to_m"][k - 1] + em
            a_mat[k, 0:St, St:2 * St] = sc["m_to_m"][k - 1] + to_ix
            a_mat[k, St:2 * St, St:2 * St] = sc["i_to_m"][k - 1] + to_ix
            a_mat[k, 2 * St:, St:2 * St] = sc["d_to_m"][k - 1] + to_ix
            a_mat[k, 0:St, 2 * St:] = sc["m_to_d"][k - 1] + eye_log
            a_mat[k, 2 * St:, 2 * St:] = sc["d_to_d"][k - 1] + eye_log

        # ---- prefix-product row solver ("prefix"): the along-k affine
        # recurrence carry_k = b_k (+) carry_{k-1} A_k has CONSTANT
        # matrices, so its full solution carry_k = (+)_{j<=k} b_j P_{j->k}
        # (P_{j->k} = A_{j+1}...A_k, P_{k->k} = I) is ONE dense semiring
        # matmul against a host-precomputed lower-block-triangular
        # (K*3St, K*3St) matrix, which batches over reads. "scan" keeps
        # the log-depth doubling (used when the prefix matrix would be too
        # big).
        D3 = 3 * St
        if solver == "auto":
            solver = "prefix" if K * D3 <= 4096 else "scan"
        self._solver = solver
        if solver == "prefix":
            eye3 = _np_log(np.eye(D3))
            pref = np.full((K, K, D3, D3), NEG_INF)
            for k in range(K):
                pref[k, k] = eye3
            for k in range(1, K):
                for jj in range(k):
                    pref[jj, k] = hmatmul(pref[jj, k - 1], a_mat[k])
            t_tri = np.ascontiguousarray(
                pref.transpose(0, 2, 1, 3).reshape(K * D3, K * D3))
        else:
            t_tri = np.zeros((1, 1))

        # per-output-token paired-emission tensors, hoisted out of the row
        # loop: emy_all[y] = lse_a(m_emit[:,a] + T_{a,y}) depends only on
        # the row's output token, and n_out is small, so precomputing all
        # of them removes a (K, A, St, St) broadcast reduction from EVERY
        # row
        tay_t = np.transpose(tay_raw, (1, 0, 2, 3))            # (n_out,A,..)
        emy_all = hmatmul(_np_lse(m_emit[None, :, :, None, None]
                                  + tay_t[:, None], axis=2),
                          t_closure)                           # (n_out,K,S,S)
        eiy_all = hmatmul(_np_lse(i_emit[None, :, :, None, None]
                                  + tay_t[:, None], axis=2), t_closure)
        enully_all = hmatmul(_np_lse(null_emit[None, :, None, None]
                                     + tay_t, axis=1), t_closure)
        eins0y_all = hmatmul(_np_lse(ins0_emit[None, :, None, None]
                                     + tay_t, axis=1), t_closure)

        tables = {
            "emy_all": emy_all, "eiy_all": eiy_all,
            "enully_all": enully_all, "eins0y_all": eins0y_all,
            "ty0": ty0, "em0": em0, "ei0": ei0, "enull0": enull0,
            "eins00": eins00, "ci": ci, "ci00": ci00, "a_mat": a_mat,
            "t_tri": t_tri, "m_emit": m_emit, "i_emit": i_emit,
            "null_emit": null_emit, "ins0_emit": ins0_emit,
            "t_closure": t_closure,
        }
        tables.update(sc)
        self.b_to_m1 = float(_np_log(hmm.b_to_m1))
        self.b_to_i0 = float(_np_log(hmm.b_to_i0))
        self.b_to_d1 = float(_np_log(hmm.b_to_d1))
        self.i0_to_m1 = float(_np_log(hmm.i0_to_m1))
        self.i0_to_i0 = float(_np_log(hmm.i0_to_i0))
        self.log_loop = float(_np_log(length / (length + 1.0)))
        self.log_exit = float(_np_log(1.0 / (length + 1.0)))
        if mode == "plan7":
            tables["cloop"] = loop_closure(self.log_loop, enull0)
        self._j = {}
        self._install(tables)

    def _tensor(self, x):
        """A numpy array (or scalar) as a tensor of the working type on the
        device."""
        return torch.tensor(np.asarray(x, np.float64), dtype=self.dtype,
                            device=self.device)

    def _install(self, tables):
        """Put numpy tables on the device as `_j`, dropping every
        derived cache (the flat layout, the scan levels, the kernel's
        operands). convert.plan7_from_numpy installs another
        implementation's tables through this."""
        for n, v in tables.items():
            self._j[n] = self._tensor(v)
        self._j["entry"] = (self._tensor(self._entry_np)
                            if self._entry_np is not None else None)
        for name in ("_fb", "_nb", "_em_stack", "_em_src", "_hot_dst", "_mb",
                     "_mloop_star", "_scan_levels", "_kernel_ops",
                     "_kernel_cache"):
            self.__dict__.pop(name, None)

    # ------------------------------------------------------------------ DP

    def _bvecmat(self, v, m):
        """(..., K, St) x (K, St, St) -> (..., K, St) batched semiring
        vec-mat."""
        return self.sr.matmul(v[..., None, :], m)[..., 0, :]

    def _full(self, shape, value):
        return torch.full(shape, value, dtype=self.dtype,
                          device=self.device)

    def _scan_solve(self, b):
        """carry_k = b_k (+) carry_{k-1} A_k for all k by log-depth
        doubling over the (A, b) pairs: at offset `off` every element k >=
        off absorbs the element `off` to its left, (A1, b1) then (A2, b2)
        = (A1 A2, b1 A2 (+) b2). The A halves do not depend on the row, so
        their ceil(log2 K) levels are computed once. b: (Bn, K, 3St)."""
        sr = self.sr
        if not hasattr(self, "_scan_levels"):
            levels = []
            a = self._j["a_mat"]
            off = 1
            while off < self.K:
                levels.append((off, a[off:]))
                a = torch.cat([a[:off], sr.matmul(a[:-off], a[off:])], 0)
                off *= 2
            self._scan_levels = levels
        for off, a in self._scan_levels:
            upd = sr.add(sr.matmul(b[:, :-off, None, :], a)[:, :, 0, :],
                         b[:, off:])
            b = torch.cat([b[:, :off], upd], 1)
        return b

    def _row_core(self, B_hot, cold, hot, ix0_hot):
        """Within-row sweep over nodes, batched: B_hot (Bn, St), cold and
        hot values (Bn, K, St). `cold` values (arrived via a
        transducer-only output move) may feed paired emission-absorption
        moves but NOT generator-silent moves: the canonical interleaving
        orders commuting generator-silent moves BEFORE transducer-only
        moves, admitting each interleaving class once. `hot` holds
        prev-row paired-emission arrivals (EMy/EIy)."""
        j = self._j
        sr = self.sr
        K, St = self.K, self.St
        Bn = B_hot.shape[0]

        if self.local:
            u_hot = j["entry"][None, :, None] + B_hot[:, None, :]
        else:
            u0 = self.b_to_m1 + B_hot
            if ix0_hot is not None:
                u0 = sr.add(u0, self.i0_to_m1 + ix0_hot)
            u_hot = self._full((Bn, K, St), sr.zero)
            u_hot[:, 0] = u0

        b_mx = sr.add(self._bvecmat(sr.add(u_hot, cold["M"]), j["em0"]),
                      hot["Mx"])
        cold_i_ei0 = self._bvecmat(cold["I"], j["ei0"])
        ix_aff_in = sr.add(cold_i_ei0, hot["Ix"])
        i_aff = sr.add(j["m_to_i"][:, None] + b_mx,
                       j["i_to_i"][:, None] + ix_aff_in)
        b_ix = sr.add(self._bvecmat(self._bvecmat(i_aff, j["ci"]), j["ei0"]),
                      ix_aff_in)
        b_d = self._full((Bn, K, St), sr.zero)
        if not self.local:
            b_d[:, 0] = self.b_to_d1 + B_hot
        b = torch.cat([b_mx, b_ix, b_d], dim=-1)              # (Bn, K, 3St)

        if self._solver == "prefix":
            carry = sr.matmul(b.reshape(Bn, K * 3 * St),
                              j["t_tri"]).reshape(Bn, K, 3 * St)
        else:
            carry = self._scan_solve(b)
        mx_hot = carry[..., 0:St]
        ix_hot = carry[..., St:2 * St]
        d_hot = carry[..., 2 * St:]

        prev = torch.cat([self._full((Bn, 1, 3 * St), sr.zero),
                          carry[:, :-1]], 1)
        lin = sr.add(
            sr.add(torch.roll(j["m_to_m"], 1)[:, None] + prev[..., 0:St],
                   torch.roll(j["i_to_m"], 1)[:, None]
                   + prev[..., St:2 * St]),
            torch.roll(j["d_to_m"], 1)[:, None] + prev[..., 2 * St:])
        m_hot = sr.add(lin, u_hot)
        i_hot = self._bvecmat(
            sr.add(j["m_to_i"][:, None] + mx_hot,
                   j["i_to_i"][:, None] + ix_aff_in), j["ci"])
        return m_hot, mx_hot, i_hot, ix_hot, d_hot

    def _row_E(self, m_hot, mx_hot, i_hot, ix_hot, d_hot):
        """Exits to E are generator-silent: hot values only."""
        j = self._j
        sr = self.sr
        K = self.K
        if self.local:
            e = sr.reduce(torch.cat([m_hot, d_hot], 1), axis=1)
        else:
            e = sr.add(j["m_to_m"][K - 1] + mx_hot[:, K - 1],
                       j["d_to_m"][K - 1] + d_hot[:, K - 1])
        return sr.add(e, j["i_to_m"][K - 1] + ix_hot[:, K - 1])

    def _solve_row(self, cold, hot, first, Bn):
        """cold: per-class prev-row Ty0 arrivals; hot: per-class prev-row
        paired-emission arrivals; first: (St,) start vector at row 0 or
        None. Returns full (hot (+) cold) per-class values for the row;
        node classes (Bn, K, St), flanks (Bn, St)."""
        j = self._j
        sr = self.sr
        St = self.St
        zero_v = self._full((Bn, St), sr.zero)

        if self.mode == "plan7":
            nx_in = sr.add(hot["Nx"], sr.vecmat(cold["N"], j["enull0"]))
            if first is not None:
                nx_in = sr.add(nx_in, first[None].expand(Bn, St))
            nx_hot = sr.vecmat_small(nx_in, j["cloop"])
            n_hot = self.log_loop + nx_hot
            B0_hot = self.log_exit + nx_hot
            ix0_hot = None
        else:
            nx_hot = n_hot = zero_v
            B0_hot = (first[None].expand(Bn, St) if first is not None
                      else zero_v)
            if self.local:
                ix0_hot = None
            else:
                x = sr.add(
                    sr.vecmat(sr.add(self.b_to_i0 + B0_hot, cold["I0"]),
                              j["eins00"]), hot["Ix0"])
                ix0_hot = sr.vecmat_small(x, j["ci00"])

        B_hot = B0_hot
        e_hot = jx_hot = j_hot = zero_v
        m_hot = mx_hot = i_hot = ix_hot = d_hot = None
        for _ in range(self.n_hit):
            m_hot, mx_hot, i_hot, ix_hot, d_hot = self._row_core(
                B_hot, cold, hot, ix0_hot)
            e_hot = self._row_E(m_hot, mx_hot, i_hot, ix_hot, d_hot)
            if self.mode == "plan7" and self.multihit:
                jx_in = sr.add(
                    sr.add(hot["Jx"], sr.vecmat(cold["J"], j["enull0"])),
                    _LOG_HALF + e_hot)
                jx_hot = sr.vecmat_small(jx_in, j["cloop"])
                j_hot = self.log_loop + jx_hot
                B_hot = sr.add(B0_hot, self.log_exit + jx_hot)
            else:
                break

        val_E = sr.add(e_hot, cold["E"])
        if self.mode == "plan7":
            e_to_c = _LOG_HALF if self.multihit else 0.0
            cx_in = sr.add(
                sr.add(hot["Cx"], sr.vecmat(cold["C"], j["enull0"])),
                e_to_c + e_hot)
            cx_hot = sr.vecmat_small(cx_in, j["cloop"])
            c_hot = self.log_loop + cx_hot
            t_hot = self.log_exit + cx_hot
            val_T = sr.add(t_hot, cold["T"])
        else:
            cx_hot = c_hot = zero_v
            val_T = val_E
        if ix0_hot is not None:
            i0_hot = sr.add(self.b_to_i0 + B_hot, self.i0_to_i0 + ix0_hot)
            val_I0 = sr.add(i0_hot, cold["I0"])
            val_Ix0 = sr.add(ix0_hot, cold["Ix0"])
        else:
            val_I0 = val_Ix0 = zero_v
        return {"M": sr.add(m_hot, cold["M"]),
                "Mx": sr.add(mx_hot, cold["Mx"]),
                "I": sr.add(i_hot, cold["I"]),
                "Ix": sr.add(ix_hot, cold["Ix"]),
                "D": sr.add(d_hot, cold["D"]),
                "N": sr.add(n_hot, cold["N"]),
                "Nx": sr.add(nx_hot, cold["Nx"]),
                "B": sr.add(B_hot, cold["B"]),
                "E": val_E,
                "C": sr.add(c_hot, cold["C"]),
                "Cx": sr.add(cx_hot, cold["Cx"]),
                "J": sr.add(j_hot, cold["J"]),
                "Jx": sr.add(jx_hot, cold["Jx"]),
                "T": val_T, "I0": val_I0, "Ix0": val_Ix0}

    def _forward_impl(self, toks, lens):
        """The per-read solver over a batch: toks (Bn, Lo) output token ids
        (tokenizer space, >= 1), lens (Bn,). Returns (Bn,) log-likes."""
        j = self._j
        sr = self.sr
        K, St = self.K, self.St
        Bn, Lo = toks.shape
        zero_v = self._full((Bn, St), sr.zero)
        zero_kv = self._full((Bn, K, St), sr.zero)
        start = self._full((St,), sr.zero)
        start[0] = 0.0
        start = sr.vecmat(start, j["t_closure"])

        cold0 = {n: zero_kv for n in _K_CLASSES}
        cold0.update({n: zero_v for n in _FLANKS})
        hot0 = {"Mx": zero_kv, "Ix": zero_kv, "Nx": zero_v, "Cx": zero_v,
                "Jx": zero_v, "Ix0": zero_v}
        row = self._solve_row(cold0, hot0, start, Bn)

        for pos in range(min(Lo, int(lens.max())) if Bn else 0):
            y = toks[:, pos]
            ty = j["ty0"][y]                                  # (Bn, St, St)
            emy = j["emy_all"][y]                             # (Bn,K,St,St)
            eiy = j["eiy_all"][y]
            enully = j["enully_all"][y]
            eins0y = j["eins0y_all"][y]

            def pair(v, m):               # (Bn,K,St) x (Bn,K,St,St)
                return sr.matmul(v[..., None, :], m)[..., 0, :]

            cold = {n: pair(row[n], ty[:, None]) for n in _K_CLASSES}
            cold.update({n: sr.vecmat(row[n], ty) for n in _FLANKS})
            hot = {"Mx": pair(row["M"], emy),
                   "Ix": pair(row["I"], eiy),
                   "Nx": sr.vecmat(row["N"], enully),
                   "Cx": sr.vecmat(row["C"], enully),
                   "Jx": sr.vecmat(row["J"], enully),
                   "Ix0": sr.vecmat(row["I0"], eins0y)}
            new_row = self._solve_row(cold, hot, None, Bn)
            keep = pos < lens
            row = {n: torch.where(keep.reshape((Bn,) + (1,) * (v.dim() - 1)),
                                  new_row[n], v) for n, v in row.items()}
        return row["T"][:, St - 1]

    # --------------------------------------------- batch-major flat path

    def _init_flat(self):
        """One-time setup for the batch-major solver (see
        _forward_batch_impl). Builds the stacked per-token emission
        tensor, the flat block layout, and, for multihit, the exact
        B->outputs semiring maps that replace the n_hit fixed-point."""
        j = self._j
        sr = self.sr
        K, St = self.K, self.St
        plan7 = self.mode == "plan7"
        # flat block layout: [M(K) Mx(K) I(K) Ix(K) D(K)] + flanks
        self._fb = fb = {
            "M": 0, "Mx": K, "I": 2 * K, "Ix": 3 * K, "D": 4 * K,
            "N": 5 * K + 0, "Nx": 5 * K + 1, "B": 5 * K + 2,
            "E": 5 * K + 3, "C": 5 * K + 4, "Cx": 5 * K + 5,
            "J": 5 * K + 6, "Jx": 5 * K + 7, "T": 5 * K + 8,
            "I0": 5 * K + 9, "Ix0": 5 * K + 10,
        }
        self._nb = 5 * K + 11
        # paired-emission stack: src rows [M(K) I(K) N C J I0] ->
        # dst rows [Mx(K) Ix(K) Nx Cx Jx Ix0]
        if "_em_stack" not in self.__dict__:
            self._em_stack = torch.cat([
                j["emy_all"],                               # (n_out,K,S,S)
                j["eiy_all"],
                j["enully_all"][:, None],                   # N
                j["enully_all"][:, None],                   # C
                j["enully_all"][:, None],                   # J
                j["eins0y_all"][:, None],                   # I0
            ], dim=1)                                       # (n_out,2K+4,..)
        self._em_src = torch.tensor(np.concatenate([
            np.arange(K), 2 * K + np.arange(K),
            [fb["N"], fb["C"], fb["J"], fb["I0"]]]), dtype=torch.long,
            device=self.device)
        self._hot_dst = np.concatenate([
            K + np.arange(K), 3 * K + np.arange(K),
            [fb["Nx"], fb["Cx"], fb["Jx"], fb["Ix0"]]]).astype(np.int32)

        if plan7 and self.multihit and "_mb" not in self.__dict__:
            # exact multihit: the within-row map B -> (class outputs) is
            # semiring-linear and row-independent, so one basis pass
            # through the per-read row core yields M_{B->cls}; the
            # E->J->B re-entry fixed point B = C (+) B (x) M_loop then
            # solves EXACTLY with a host (I - M_loop)^{-1} closure (the
            # n_hit iteration in _solve_row is a truncation of this
            # series). The St basis vectors ride the batch dimension.
            zero_kv = self._full((St, K, St), sr.zero)
            cold0 = {n: zero_kv for n in ("M", "I")}
            hot0 = {"Mx": zero_kv, "Ix": zero_kv}
            basis = self._full((St, St), sr.zero)
            basis.fill_diagonal_(0.0)
            mb = self._row_core(basis, cold0, hot0, None)
            mb_e = self._row_E(*mb)
            # (St, K, St) -> (K, St, St) for batched right-multiplication
            self._mb = {n: v.permute(1, 0, 2).contiguous()
                        for n, v in zip(_K_CLASSES, mb)}
            self._mb["E"] = mb_e                             # (St, St)
            e_np = mb_e.double().cpu().numpy()
            cloop = j["cloop"].double().cpu().numpy()
            m_loop = self._hmatmul(e_np, cloop) \
                + np.log(0.5) + self.log_exit
            # exact multihit re-entry closure in the MODE semiring (sum
            # of re-entry counts for Forward, best count for Viterbi)
            star = _np_mp_star if self.viterbi else self._sum_star
            self._mloop_star = self._tensor(
                star(np.maximum(m_loop, NEG_INF)))

    def _row_core_batch(self, B_hot, cold_m, cold_i, hot_mx, hot_ix,
                        ix0_hot):
        """_row_core in the EXECUTION semiring (self._xsr): log ops for
        Viterbi and log-space Forward, pure multiply/add in
        scaled-probability space under prob_space (matrices and log
        constants exp'd by the semiring). B_hot (B,St);
        cold_m/cold_i/hot_mx/hot_ix (B,K,St). Always the prefix solver."""
        j = self._j
        sr = self._xsr
        K, St = self.K, self.St
        Bn = B_hot.shape[0]

        if self.local:
            u_hot = sr.cx(j["entry"][None, :, None], B_hot[:, None, :])
        else:
            u0 = sr.cx(self.b_to_m1, B_hot)
            if ix0_hot is not None:
                u0 = sr.add(u0, sr.cx(self.i0_to_m1, ix0_hot))
            u_hot = self._full((Bn, K, St), sr.zero)
            u_hot[:, 0] = u0

        def kmat(v, m):                       # (B,K,St) x (K,St,St)
            # tiny St contraction: elementwise-expanded semiring matmul
            return sr.vecmat_small(v, m)

        b_mx = sr.add(kmat(sr.add(u_hot, cold_m), j["em0"]), hot_mx)
        cold_i_ei0 = kmat(cold_i, j["ei0"])
        ix_aff_in = sr.add(cold_i_ei0, hot_ix)
        i_aff = sr.add(sr.cx(j["m_to_i"][None, :, None], b_mx),
                       sr.cx(j["i_to_i"][None, :, None], ix_aff_in))
        b_ix = sr.add(kmat(kmat(i_aff, j["ci"]), j["ei0"]), ix_aff_in)
        b_d = torch.full_like(b_mx, sr.zero)
        if not self.local:
            b_d[:, 0] = sr.cx(self.b_to_d1, B_hot)
        b = torch.cat([b_mx, b_ix, b_d], dim=-1)              # (B,K,3St)

        carry = sr.matmul(b.reshape(Bn, K * 3 * St),
                          j["t_tri"]).reshape(Bn, K, 3 * St)
        mx_hot = carry[:, :, 0:St]
        ix_hot = carry[:, :, St:2 * St]
        d_hot = carry[:, :, 2 * St:]

        prev = torch.cat([self._full((Bn, 1, 3 * St), sr.zero),
                          carry[:, :-1]], dim=1)
        lin = sr.add(
            sr.add(sr.cx(torch.roll(j["m_to_m"], 1)[None, :, None],
                         prev[:, :, 0:St]),
                   sr.cx(torch.roll(j["i_to_m"], 1)[None, :, None],
                         prev[:, :, St:2 * St])),
            sr.cx(torch.roll(j["d_to_m"], 1)[None, :, None],
                  prev[:, :, 2 * St:]))
        m_hot = sr.add(lin, u_hot)
        i_hot = kmat(sr.add(sr.cx(j["m_to_i"][None, :, None], mx_hot),
                            sr.cx(j["i_to_i"][None, :, None], ix_aff_in)),
                     j["ci"])
        return m_hot, mx_hot, i_hot, ix_hot, d_hot

    def _row_E_batch(self, m_hot, mx_hot, i_hot, ix_hot, d_hot):
        j = self._j
        sr = self._xsr
        K = self.K
        if self.local:
            e = sr.reduce(torch.cat([m_hot, d_hot], dim=1), axis=1)
        else:
            e = sr.add(sr.cx(j["m_to_m"][K - 1], mx_hot[:, K - 1]),
                       sr.cx(j["d_to_m"][K - 1], d_hot[:, K - 1]))
        return sr.add(e, sr.cx(j["i_to_m"][K - 1], ix_hot[:, K - 1]))

    def _solve_row_batch(self, cold, hot, first, Bn):
        """_solve_row over the flat (B, NB, St) layout. cold (B,NB,St);
        hot (B,2K+4,St) aligned with _hot_dst; first is the (St,) start
        vector at row 0 or None."""
        j = self._j
        sr = self._xsr
        K, St = self.K, self.St
        fb = self._fb
        zero_bv = self._full((Bn, St), sr.zero)
        plan7 = self.mode == "plan7"

        cold_m = cold[:, 0:K]
        cold_i = cold[:, 2 * K:3 * K]
        hot_mx = hot[:, 0:K]
        hot_ix = hot[:, K:2 * K]
        hot_nx = hot[:, 2 * K]
        hot_cx = hot[:, 2 * K + 1]
        hot_jx = hot[:, 2 * K + 2]
        hot_ix0 = hot[:, 2 * K + 3]

        if plan7:
            nx_in = sr.add(hot_nx,
                           sr.vecmat_small(cold[:, fb["N"]], j["enull0"]))
            if first is not None:
                nx_in = sr.add(nx_in, first[None].expand(Bn, St))
            nx_hot = sr.vecmat_small(nx_in, j["cloop"])
            n_hot = sr.cx(self.log_loop, nx_hot)
            B0_hot = sr.cx(self.log_exit, nx_hot)
            ix0_hot = None
        else:
            nx_hot = n_hot = zero_bv
            B0_hot = (first[None].expand(Bn, St)
                      if first is not None else zero_bv)
            if self.local:
                ix0_hot = None
            else:
                x = sr.add(
                    sr.vecmat_small(sr.add(sr.cx(self.b_to_i0, B0_hot),
                                           cold[:, fb["I0"]]), j["eins00"]),
                    hot_ix0)
                ix0_hot = sr.vecmat_small(x, j["ci00"])

        if plan7 and self.multihit:
            # base pass with no B mass, then exact re-entry closure
            m0, mx0, i0_, ix0_, d0 = self._row_core_batch(
                zero_bv, cold_m, cold_i, hot_mx, hot_ix, None)
            e_base = self._row_E_batch(m0, mx0, i0_, ix0_, d0)
            jx_base = sr.add(
                sr.add(hot_jx, sr.vecmat_small(cold[:, fb["J"]], j["enull0"])),
                sr.cx(_LOG_HALF, e_base))
            c_in = sr.add(B0_hot,
                          sr.cx(self.log_exit,
                                sr.vecmat_small(jx_base, j["cloop"])))
            B_hot = sr.vecmat_small(c_in, self._mloop_star)
            # outputs = base (+) B (x) M_{B->cls}
            mb = self._mb

            def badd(base_kv, key):
                return sr.add(base_kv,
                              sr.vecmat_small(B_hot[:, None, :], mb[key]))

            m_hot = badd(m0, "M")
            mx_hot = badd(mx0, "Mx")
            i_hot = badd(i0_, "I")
            ix_hot = badd(ix0_, "Ix")
            d_hot = badd(d0, "D")
            b_e = sr.vecmat_small(B_hot, mb["E"])
            e_hot = sr.add(e_base, b_e)
            jx_in = sr.add(jx_base, sr.cx(_LOG_HALF, b_e))
            jx_hot = sr.vecmat_small(jx_in, j["cloop"])
            j_hot = sr.cx(self.log_loop, jx_hot)
        else:
            B_hot = B0_hot
            m_hot, mx_hot, i_hot, ix_hot, d_hot = self._row_core_batch(
                B_hot, cold_m, cold_i, hot_mx, hot_ix, ix0_hot)
            e_hot = self._row_E_batch(m_hot, mx_hot, i_hot, ix_hot, d_hot)
            jx_hot = j_hot = zero_bv

        if plan7:
            e_to_c = _LOG_HALF if self.multihit else 0.0
            cx_in = sr.add(
                sr.add(hot_cx, sr.vecmat_small(cold[:, fb["C"]], j["enull0"])),
                sr.cx(e_to_c, e_hot))
            cx_hot = sr.vecmat_small(cx_in, j["cloop"])
            c_hot = sr.cx(self.log_loop, cx_hot)
            t_hot = sr.cx(self.log_exit, cx_hot)
        else:
            cx_hot = c_hot = zero_bv
            t_hot = e_hot
        if ix0_hot is not None:
            i0_hot = sr.add(sr.cx(self.b_to_i0, B_hot),
                            sr.cx(self.i0_to_i0, ix0_hot))
            ix0_v = ix0_hot
        else:
            i0_hot = ix0_v = zero_bv

        flanks = torch.stack([n_hot, nx_hot, B_hot, e_hot, c_hot, cx_hot,
                              j_hot, jx_hot, t_hot, i0_hot, ix0_v], dim=1)
        x_hot = torch.cat(
            [m_hot, mx_hot, i_hot, ix_hot, d_hot, flanks], dim=1)
        return sr.add(x_hot, cold)                           # (B,NB,St)

    def _forward_batch_impl(self, toks, lens):
        """Batch-major fused Forward: toks (B, Lo) output token ids,
        lens (B,). One flat (B, NB, St) row state; per row the shared
        output-only move is ONE batched semiring matmul over all blocks
        and the paired emissions ONE gathered batched matmul, against some
        twenty per-class ops in the per-read solver. Returns (B,)
        log-likes."""
        j = self._j
        sr = self._xsr
        K, St = self.K, self.St
        nb = self._nb
        fb = self._fb
        Bn, Lo = toks.shape
        prob = self.prob_space
        neg = self._full((Bn, nb, St), sr.zero)
        neg_hot = self._full((Bn, 2 * K + 4, St), sr.zero)

        start = self._full((St,), sr.zero)
        start[0] = sr.one
        start = sr.vecmat(start, j["t_closure"])
        x = self._solve_row_batch(neg, neg_hot, start, Bn)
        scale = self._full((Bn,), 0.0)
        if prob:
            x, scale = self._renorm(x, scale)

        for pos in range(min(Lo, int(lens.max())) if Bn else 0):
            y = toks[:, pos]
            cold = sr.vecmat_small(x, j["ty0"][y][:, None])  # (B,NB,St)
            src = x[:, self._em_src]                         # (B,2K+4,St)
            emg = self._em_stack[y]                          # (B,2K+4,S,S)
            hot = sr.vecmat_small(src, emg)
            # cold arrivals at the hot destinations stay in `cold`; the
            # solver reads them separately (canonical interleaving)
            x_new = self._solve_row_batch(cold, hot, None, Bn)
            scale_new = scale
            if prob:
                # ONE renormalization per token row keeps the f32
                # probability carry near unit scale (values > ~87 nats
                # below the per-read max flush to zero, far below the
                # 0.01-nat contract); the log here is (B,) scalars, not
                # a state-tensor pass
                x_new, scale_new = self._renorm(x_new, scale)
            keep = pos < lens
            x = torch.where(keep[:, None, None], x_new, x)
            scale = torch.where(keep, scale_new, scale)

        row = fb["T"] if self.mode == "plan7" else fb["E"]
        v = x[:, row, St - 1]
        if prob:
            return torch.where(
                v > 0.0, torch.log(torch.clamp(v, min=1e-38)) + scale,
                torch.full_like(v, NEG_INF))
        return v

    @staticmethod
    def _renorm(x, scale):
        """Per-read rescale of the probability carry (prob_space mode)."""
        m = x.amax(dim=(1, 2))                               # (B,)
        ok = m > 0.0
        inv = torch.where(ok, 1.0 / torch.clamp(m, min=1e-38),
                          torch.zeros_like(m))
        x = x * inv[:, None, None]
        scale = torch.where(ok, scale + torch.log(torch.clamp(m, min=1e-38)),
                            torch.full_like(scale, NEG_INF))
        return x, scale

    # ------------------------------------------------------------- public

    def _dev_tokens(self, toks, lens):
        """(B, Lo) int64 token ids and (B,) int64 lengths on the device,
        for the torch solvers' gathers."""
        t = torch.as_tensor(np.asarray(toks), device=self.device).long()
        n = torch.as_tensor(np.asarray(lens), device=self.device).long()
        return t, n

    def forward(self, out_syms):
        s2t = self.td_ev.output_tokenizer.sym2tok
        toks = np.array([s2t[c] for c in out_syms], np.int64).reshape(1, -1)
        t, n = self._dev_tokens(toks, [len(out_syms)])
        return float(self._forward_impl(t, n)[0])

    def forward_batch(self, seqs, pad_multiple=16, impl="auto"):
        """Score many output sequences in one device call. Sequences are
        right-padded to a shared geometric bucket; padding is masked by
        per-sequence lengths. Returns a numpy (B,) array.

        impl: as forward_batch_tokens, but 'auto' is the flat solver
        (with the prefix row solver) or else the per-read solver, as in
        the JAX class; ask for impl='kernel' to tokenize here and score
        through the kernel."""
        from .fwdback import pad_bucket
        if impl == "auto":
            impl = "flat" if self._solver == "prefix" else "vmap"
        B = len(seqs)
        Lo = pad_bucket(max((len(s) for s in seqs), default=1),
                        base=pad_multiple)
        toks = np.ones((B, Lo), np.int32)
        lens = np.zeros((B,), np.int32)
        s2t = self.td_ev.output_tokenizer.sym2tok
        for n, s in enumerate(seqs):
            toks[n, :len(s)] = [s2t[c] for c in s]
            lens[n] = len(s)
        return self.forward_batch_tokens(toks, lens, impl=impl)

    def _pick_impl(self, impl):
        """'auto' takes the kernel when it covers the configuration AND
        the tables are on a card, else the flat solver (with the prefix
        row solver) or the per-read solver; 'pallas' is the kernel's name
        in the JAX class."""
        if impl == "auto":
            if self._kernel_supported() and self.device.type == "cuda":
                return "kernel"
            return "flat" if self._solver == "prefix" else "vmap"
        if impl == "pallas":
            return "kernel"
        if impl not in ("kernel", "flat", "vmap"):
            raise ValueError("impl must be auto, kernel (pallas), flat or "
                             "vmap, not %r" % (impl,))
        return impl

    def _solver_fn(self, impl):
        if impl == "flat":
            if self._solver != "prefix":
                raise ValueError("the flat solver needs the prefix matrix "
                                 "(solver='prefix')")
            if not hasattr(self, "_fb"):
                self._init_flat()
            return self._forward_batch_impl
        return self._forward_impl

    def forward_stream(self, batches, impl="auto"):
        """Score a STREAM of (toks, lens) batches with pipelined dispatch:
        every batch's device work is enqueued on the device's stream before
        one synchronisation and one device-to-host copy of all results, so
        the per-call host round trips do not serialize with the device.
        Returns [np.ndarray per batch]."""
        impl = self._pick_impl(impl)
        if not batches:
            return []
        if impl == "kernel":
            # persists across calls: steady-state serving re-streams the
            # same token arrays every tick. Entries hold (host_array,
            # device_tensor): retaining the host array keeps its id alive,
            # so the id key can never be recycled onto a DIFFERENT array's
            # address (a freed-and-reallocated numpy array would otherwise
            # silently serve stale device tokens). Bounded to 64 entries
            # (FIFO) so the device copies cannot grow without limit.
            dev = self.__dict__.setdefault("_dev_cache", {})

            def as_dev(a):
                key = id(a)
                hit = dev.get(key)
                if hit is not None and hit[0] is a:
                    return hit[1]
                if len(dev) >= 64:
                    dev.pop(next(iter(dev)))
                d = torch.as_tensor(np.asarray(a), device=self.device) \
                    .to(torch.int32).contiguous()
                dev[key] = (a, d)
                return d

            pending = []
            for t, ln in batches:
                shape = np.shape(t)
                k = self._kernel_fwd(shape[0], shape[1])
                pending.append((k, k.device_call(as_dev(t), as_dev(ln)),
                                shape[0]))
            # ONE device-to-host copy of every batch's (3, B) result
            host = torch.cat([d for _k, d, _b in pending], dim=1) \
                .cpu().numpy()
            outs, at = [], 0
            for k, _d, B_ in pending:
                outs.append(k.decode(host[:, at:at + B_], B_))
                at += B_
            return outs
        fn = self._solver_fn(impl)
        pending = [fn(*self._dev_tokens(t, ln)) for t, ln in batches]
        host = torch.cat(pending).cpu().numpy()
        sizes = np.cumsum([p.shape[0] for p in pending])[:-1]
        return [np.array(o) for o in np.split(host, sizes)]

    def _pallas_supported(self):
        """The JAX class's name for _kernel_supported."""
        return self._kernel_supported()

    def _kernel_supported(self):
        """The row-solve kernel (ops/kernels/fused_plan7_kernel.py) covers
        the serving configuration: plan7 mode (always local), Forward in
        log space, a transducer of at most 4 states, multihit on or off."""
        return (self.mode == "plan7" and self.local and not self.viterbi
                and not self.prob_space and self.St <= 4
                and self.dtype == torch.float32)

    def _kernel_fwd(self, B, L):
        from .kernels.fused_plan7_kernel import make_fused_plan7_kernel
        cache = self.__dict__.setdefault("_kernel_cache", {})
        key = (B, L)
        if key not in cache:
            cache[key] = make_fused_plan7_kernel(self, B, L)
        return cache[key]

    def forward_batch_tokens(self, toks, lens, impl="auto"):
        """Device call on pre-tokenized reads: toks (B, Lo) 1-based
        output token ids (padded), lens (B,) real lengths. Use this when
        scoring the same reads repeatedly: forward_batch tokenizes on the
        host in Python. Returns a numpy (B,) array.

        impl: 'kernel' (alias 'pallas') = the hand-written row-solve
        kernel, one launch per batch ('auto' takes it on a card for the
        configurations it covers; on CPU tensors it runs the kernel's
        plain version); 'flat' = the batch-major solver (needs the prefix
        row solver; an EXACT multihit closure); 'vmap' = the per-read
        solver over the batch."""
        impl = self._pick_impl(impl)
        if impl == "kernel":
            toks = np.asarray(toks)
            return self._kernel_fwd(toks.shape[0], toks.shape[1])(
                toks, np.asarray(lens))
        out = self._solver_fn(impl)(*self._dev_tokens(toks, lens))
        return out.cpu().numpy()
