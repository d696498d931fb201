"""Fused Plan7 (x) transducer Forward over a read batch: the whole row solve
in one kernel.

Counterpart of machineboss_tpu's ops/pallas/fused_plan7_kernel.py. The flat
solver of ops/fused_plan7.py runs some forty tensor ops per token row; this
is the same solver in SCALED-PROBABILITY space with the row state kept on
the multiprocessor for the read's whole walk:

  - the row recurrence is linear, so every semiring op is a multiply/add;
    after every token row the read's state is scaled by the exact power of
    two of its maximum's binary exponent, and the exponents are summed in
    an integer: no log, exp or division anywhere in the loop;
  - the within-row affine solve carry_k = b_k + carry_{k-1} A_k, A_k =
    exp(a_mat)_k, is log-depth. The plain version doubles over nodes: at
    level l every node k >= 2^l absorbs the node 2^l to its left, b_k +=
    b_{k-2^l} P_l[k], with the row-independent products P_l[k] =
    A_{k-2^l+1} ... A_k prepared on the host (ceil(log2 K) levels, the
    scan solver's form in probability space). The kernel's warp layout
    gives each of a warp's 32 lanes a chunk of ceil(K/32) nodes, solves
    each chunk serially and scans the chunk ends across the lanes with the
    host's float64 span products (`prepare_fused_plan7`'s ntab, span,
    pan). The JAX kernel takes the closed form instead, one product with
    the (3St K)^2 lower-block-triangular prefix matrix, which suits a
    matrix unit; both log-depth forms also serve profiles built with
    solver="scan", which carry no prefix matrix;
  - a read's own token selects its coefficients directly (the JAX kernel
    accumulates one-hot masks over all output tokens);
  - multihit runs the row core once without B mass and adds the B
    contribution through the host's exact basis maps and re-entry closure.

Two versions with one arithmetic:

  - `fused_plan7_forward_plain`: torch, batched over reads, a Python loop
    over rows and over the doubling's levels; used on the CPU and as the
    card's comparison;
  - `fused_plan7_forward_kernel`: the wrapper of the hand-written CUDA
    kernel (csrc/fused_plan7.cu), ONE launch per batch, a warp a read, each
    read walking to its own length, laid out by `launch_plan` once per
    operands and batch shape. A CUDA tensor launches the kernel or raises;
    only a CPU tensor takes the plain version. `fused_plan7_profile` runs
    the same source built with its clock64 phase profile.

Both return (3, B) float32: the mantissa X[St-1][T], the sum of binary
exponents, and a dead flag (1.0 for a read that lost all its mass).
`decode` turns them into float64 log-likelihoods on the host.

Scope: mode='plan7' (always local), Forward, multihit on or off, a
transducer of at most 4 states. Other combinations stay on the torch
solvers of ops/fused_plan7.py.
"""

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ._build import load
from .lowrank_kernel import _check, _round_up

NEG_INF = -1e30

# columns of the per-node scalar table and panels of the per-node matrix
# table, in the order csrc/fused_plan7.cu reads them
KSC_NAMES = ("entry", "m_to_i", "i_to_i", "roll_m", "roll_i", "roll_d",
             "last")
KCO_NAMES = ("em0", "ei0", "ci", "mb_M", "mb_Mx", "mb_I", "mb_Ix", "mb_D")
N_FLANK = 11
F_N, F_NX, F_B, F_E, F_C, F_CX, F_J, F_JX, F_T = range(9)

_MAX_THREADS = 768           # node-doubling layout: __launch_bounds__
_MAX_READS = 15              # node-doubling layout: one named barrier a read
_MAX_WARP_READS = 8          # warp layout: reads (warps) a block
_MAX_CHUNK = 16              # warp layout: nodes a lane
_SMEM_LIMIT = 227 * 1024     # dynamic shared memory a block may take
LANES = 32
# the most profile nodes for which launch_plan takes the warp layout by
# default: all it takes. scripts/plan7_layouts.py times both layouts on the
# plan7 batch (B=1024 reads of 90, St=2, multihit) from K=86 to 512, and
# the warp layout is the faster at every K, also where a lane's state
# leaves its registers (PERF.md §6)
WARP_DEFAULT_MAX_K = LANES * _MAX_CHUNK
LAYOUTS = ("warp", "node_doubling")
# the profile library's cycle counters a read, after the row count, by
# layout (node_doubling: then one counter per doubling level)
PROFILE_PHASES = {
    "warp": ("flank1", "pass_a", "scan", "pass_b", "reduce_e", "flank3",
             "max_scale"),
    "node_doubling": ("phase1", "barriers", "phase3a", "reductions",
                      "phase3b", "phase4")}
_N_PROF = 20


def _p(x):
    """log -> probability (float64 host), -inf-safe."""
    x = np.asarray(x, np.float64)
    return np.where(x > NEG_INF / 2, np.exp(np.minimum(x, 80.0)), 0.0)


def prepare_fused_plan7(fused):
    """Host operands of the row-solve kernel for a Plan7Fused: a dict of
    float32 numpy arrays in probability space.

      consts  cloop, enull0, mloop_star, mb_E (St, St each), first (St,),
              loop_s, exit_s, e_to_c, then ty0 and en_y (n_sym, St, St
              each), flattened in this order
      ksc     (7, K) per-node scalars, rows as KSC_NAMES: the local entry
              weights, m_to_i, i_to_i, the three transitions into M_k
              rolled down one node, and the last node's I->E selector
      kco     (8, K, St, St) per-node matrices, panels as KCO_NAMES (the
              multihit basis maps are zero for a single-hit model)
      alev    (n_lev, K, 3St, 3St) the doubling's matrices: level l holds
              P_l[k] = A_{k-2^l+1} ... A_k for k >= 2^l (zeros below), A =
              exp(a_mat), n_lev = ceil(log2 K)
      emm/emi (n_sym, K, St, St) paired-emission panels of the M and I
              blocks per output symbol
    """
    if fused.mode != "plan7" or not fused.local or fused.viterbi:
        raise ValueError("fused plan7 kernel: plan7/local/Forward only")
    if fused.St > 4:
        raise ValueError("fused plan7 kernel: St <= 4")
    if not hasattr(fused, "_fb"):
        # the flat layout's tables (the emission stack, the multihit basis
        # maps and re-entry closure) do not depend on the row solver
        fused._init_flat()
    K, St = fused.K, fused.St
    n_sym = fused.n_out - 1

    def npy(x):
        return x.detach().double().cpu().numpy()

    j = {n: npy(v) for n, v in fused._j.items() if v is not None}
    multihit = bool(fused.multihit)
    zeros = np.zeros((K, St, St))
    mb = {n: npy(v) for n, v in fused._mb.items()} if multihit else {}

    kco = np.stack([_p(j["em0"]), _p(j["ei0"]), _p(j["ci"])]
                   + [_p(mb[n]) if multihit else zeros
                      for n in ("M", "Mx", "I", "Ix", "D")])
    ksc = np.zeros((len(KSC_NAMES), K))
    ksc[0] = _p(j["entry"])
    ksc[1] = _p(j["m_to_i"])
    ksc[2] = _p(j["i_to_i"])
    ksc[3] = _p(np.roll(j["m_to_m"], 1))
    ksc[4] = _p(np.roll(j["i_to_m"], 1))
    ksc[5] = _p(np.roll(j["d_to_m"], 1))
    ksc[6, K - 1] = _p(j["i_to_m"][K - 1])     # last-node I->E select

    em_stack = _p(npy(fused._em_stack))        # (n_out, 2K+4, St, St)
    emm = em_stack[1:, 0:K]
    emi = em_stack[1:, K:2 * K]
    en_y = em_stack[1:, 2 * K]

    first_log = np.full((St,), NEG_INF)
    first_log[0] = 0.0
    first = (_p(first_log)[None, :] @ _p(j["t_closure"]))[0]

    ident = np.eye(St)
    consts = np.concatenate([
        _p(j["cloop"]).ravel(), _p(j["enull0"]).ravel(),
        (_p(npy(fused._mloop_star)) if multihit else ident).ravel(),
        (_p(mb["E"]) if multihit else np.zeros((St, St))).ravel(),
        first,
        [float(_p(fused.log_loop)), float(_p(fused.log_exit)),
         0.5 if multihit else 1.0],
        _p(j["ty0"][1:]).ravel(), en_y.ravel()])

    def f32(x):
        return np.ascontiguousarray(x, np.float32)

    # the doubling's levels, products taken in float64
    cur = _p(j["a_mat"])
    levels, off = [], 1
    while off < K:
        lev = cur.copy()
        lev[:off] = 0.0
        levels.append(lev)
        cur = np.concatenate([cur[:off], cur[:-off] @ cur[off:]])
        off *= 2
    alev = np.stack(levels) if levels else np.zeros((0, K, 3 * St, 3 * St))

    ntab, span, pan = warp_tables(ksc, kco, _p(j["a_mat"]), emm, emi)
    return {"K": K, "St": St, "n_sym": n_sym, "multihit": multihit,
            "consts": f32(consts), "ksc": f32(ksc), "kco": f32(kco),
            "alev": f32(alev), "emm": f32(emm), "emi": f32(emi),
            "ntab": f32(ntab), "span": f32(span), "pan": f32(pan)}


def warp_chunk(K):
    """Nodes a lane in the warp layout: ceil(K / 32)."""
    return -(-K // LANES)


def lane_levels(K):
    """Levels of the warp layout's scan across the lanes that hold nodes:
    ceil(log2(ceil(K / chunk)))."""
    C = warp_chunk(K)
    return n_levels(-(-K // C))


def _rec_floats(St):
    return _round_up(8 + 17 * St * St, 4)


def _pan_floats(St):
    return _round_up(2 * St * St, 4)


def _span_floats(St):
    return _round_up(9 * St * St, 4)


def chunk_products(a, K):
    """(32, 3St, 3St) float64: lane c's chunk product A_{cC} ... A_{cC+C-1}
    of a (K, 3St, 3St), with A_k = 0 for the padding nodes k >= K."""
    C, D3 = warp_chunk(K), a.shape[-1]
    pad = np.zeros((LANES * C, D3, D3))
    pad[:K] = a
    t = np.zeros((LANES, D3, D3))
    for c in range(LANES):
        m = np.eye(D3)
        for k in range(c * C, (c + 1) * C):
            m = m @ pad[k]
        t[c] = m
    return t


def span_products(a, K):
    """(lane_levels(K), 32, 3St, 3St) float64: at level l, lane c's product
    of the chunk products of chunks c-2^l+1 .. c (zero for c < 2^l)."""
    cur = chunk_products(a, K)
    out = []
    for lev in range(lane_levels(K)):
        off = 1 << lev
        s = cur.copy()
        s[:off] = 0.0
        out.append(s)
        cur = np.concatenate([cur[:off], cur[:-off] @ cur[off:]])
    D3 = a.shape[-1]
    return np.stack(out) if out else np.zeros((0, LANES, D3, D3))


def _interleave(recs, F):
    """(..., 32 lanes, C, F0) records, zero-padded to F floats, as the
    kernel reads them: (..., C, F/4, 32, 4), float4 q of lane c's j-th
    record at [..., j, q, c]."""
    pad = np.zeros(recs.shape[:-1] + (F,))
    pad[..., :recs.shape[-1]] = recs
    pad = pad.reshape(recs.shape[:-1] + (F // 4, 4))
    n = pad.ndim
    return np.moveaxis(pad, n - 4, n - 2)


def warp_tables(ksc, kco, a, emm, emi):
    """The warp layout's tables from the float64 operands: ksc (7, K), kco
    (8, K, St, St), a = exp(a_mat) (K, 3St, 3St), emm and emi (n_sym, K,
    St, St). Lane c owns nodes k = c C + j, j < C = warp_chunk(K); a node
    past K is all zeros.

      ntab  (C, rec/4, 32, 4): node records, the 7 scalars of ksc and a 0,
            the 8 matrices of kco, A_k ([src][dst])
      span  (lane_levels(K), span/4, 32, 4): span_products
      pan   (n_sym, C, pan/4, 32, 4): panel records, emm then emi"""
    K, St = ksc.shape[1], kco.shape[-1]
    C, n_sym = warp_chunk(K), emm.shape[0]
    n = LANES * C
    rec = np.zeros((n, 8 + 17 * St * St))
    rec[:K, :7] = ksc.T
    rec[:K, 8:8 + 8 * St * St] = kco.transpose(1, 0, 2, 3).reshape(K, -1)
    rec[:K, 8 + 8 * St * St:] = a.reshape(K, -1)
    ntab = _interleave(rec.reshape(LANES, C, -1), _rec_floats(St))
    sp = span_products(a, K)
    span = _interleave(sp.reshape(len(sp), LANES, 1, 9 * St * St),
                       _span_floats(St))[:, 0]
    prec = np.zeros((n_sym, n, 2 * St * St))
    prec[:, :K, :St * St] = emm.reshape(n_sym, K, -1)
    prec[:, :K, St * St:] = emi.reshape(n_sym, K, -1)
    pan = _interleave(prec.reshape(n_sym, LANES, C, -1), _pan_floats(St))
    return ntab, span, pan


@dataclass
class Plan7Operands:
    """One prepare_fused_plan7 result as tensors on one device. `host`
    keeps the warp layout's host tables; `tables` holds each layout's
    device tables once a launch has asked for them (`layout_tables`), and
    `plans` the launch plans by batch shape."""
    K: int
    St: int
    n_sym: int
    multihit: bool
    consts: torch.Tensor
    ksc: torch.Tensor
    kco: torch.Tensor
    alev: torch.Tensor
    emm: torch.Tensor
    emi: torch.Tensor
    host: dict = field(default=None, repr=False, compare=False)
    tables: dict = field(default_factory=dict, repr=False, compare=False)
    plans: dict = field(default_factory=dict, repr=False, compare=False)

    def const_mats(self):
        """The consts vector cut up: (cloop, enull0, mloop_star, mb_E,
        first, loop_s, exit_s, e_to_c, ty0, en_y)."""
        St, n = self.St, self.St * self.St
        c = self.consts
        mats = [c[i * n:(i + 1) * n].reshape(St, St) for i in range(4)]
        at = 4 * n
        first = c[at:at + St]
        loop_s, exit_s, e_to_c = c[at + St:at + St + 3]
        at += St + 3
        ty0 = c[at:at + self.n_sym * n].reshape(self.n_sym, St, St)
        en_y = c[at + self.n_sym * n:].reshape(self.n_sym, St, St)
        return (*mats, first, loop_s, exit_s, e_to_c, ty0, en_y)


def plan7_operands(host, device):
    """Move a prepare_fused_plan7 result to `device` (a torch.device); on a
    CUDA device with the tables of the layout launch_plan picks for its K
    (the other layout's follow if a launch asks for it)."""
    ops = Plan7Operands(
        K=host["K"], St=host["St"], n_sym=host["n_sym"],
        multihit=host["multihit"],
        **{n: torch.tensor(host[n], device=device)
           for n in ("consts", "ksc", "kco", "alev", "emm", "emi")},
        host={n: host[n] for n in ("ntab", "span", "pan")})
    if device.type == "cuda":
        layout_tables(ops, default_layout(ops.K))
    return ops


def layout_tables(ops, layout):
    """The device tables a layout's kernel reads, made at the first ask:
    "warp" (ntab, span, pan) from the host tables; "node_doubling" (alev_k,)
    the doubling's matrices with level l's float4 q of node k at [l, q, k]
    when (3St)^2 is a multiple of 4, else its element e at [l, e, k], so
    that neighbouring nodes read neighbouring addresses."""
    if layout not in ops.tables:
        dev = ops.consts.device
        if layout == "warp":
            ops.tables[layout] = tuple(
                torch.tensor(np.ascontiguousarray(ops.host[n]), device=dev)
                for n in ("ntab", "span", "pan"))
        else:
            n_lev, na = ops.alev.shape[0], 9 * ops.St ** 2
            w = 4 if na % 4 == 0 else 1
            ops.tables[layout] = (ops.alev.reshape(
                n_lev, ops.K, na // w, w).permute(0, 2, 1, 3).contiguous(),)
    return ops.tables[layout]


def _vm(v, m):
    """(..., St) x (..., St, St) -> (..., St), multiply and add."""
    return (v[..., :, None] * m).sum(dim=-2)


def fused_plan7_forward_plain(ops, toks, lens):
    """Plain PyTorch version of the row-solve kernel, float32. toks (B, L)
    1-based output tokens (0 or a token past the alphabet contributes
    nothing), lens (B,), on the device of `ops`. Returns (3, B) float32:
    mantissa, exponent sum, dead flag."""
    K, St, n_sym = ops.K, ops.St, ops.n_sym
    dev = ops.consts.device
    B, L = toks.shape
    toks = toks.long()
    lens = torch.clamp(lens.long(), max=L)
    (cloop, enull0, mloop_star, mb_E, first, loop_s, exit_s, e_to_c, ty0,
     en_y) = ops.const_mats()
    entry, m_to_i, i_to_i, roll_m, roll_i, roll_d, last = \
        (ops.ksc[i][None, :, None] for i in range(len(KSC_NAMES)))
    em0, ei0, ci, mb_m, mb_mx, mb_i, mb_ix, mb_d = ops.kco
    # token 0 and tokens past the alphabet select all-zero coefficients
    zero_tok = torch.zeros((1, St, St), dtype=torch.float32, device=dev)
    ty0 = torch.cat([zero_tok, ty0, zero_tok])
    en_y = torch.cat([zero_tok, en_y, zero_tok])
    zero_pan = torch.zeros((1, K, St, St), dtype=torch.float32, device=dev)
    emm = torch.cat([zero_pan, ops.emm, zero_pan])
    emi = torch.cat([zero_pan, ops.emi, zero_pan])

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    xk = zeros(B, 5, K, St)              # M, Mx, I, Ix, D blocks
    fl = zeros(B, N_FLANK, St)           # the flank rows
    expo = torch.zeros(B, dtype=torch.int32, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    one = torch.ones(B, dtype=torch.float32, device=dev)

    n_rows = int(lens.max()) if B else 0
    for row in range(-1, n_rows):
        if row < 0:
            y = torch.zeros(B, dtype=torch.long, device=dev)
            keep = torch.ones(B, dtype=torch.bool, device=dev)
        else:
            y = toks[:, row]
            y = torch.where((y >= 1) & (y <= n_sym), y, torch.zeros_like(y))
            keep = row < lens
        ty = ty0[y]                                          # (B, St, St)
        eny = en_y[y]
        cold_k = _vm(xk, ty[:, None, None])                  # (B,5,K,St)
        cold_f = _vm(fl, ty[:, None])                        # (B,11,St)
        hot_mx = _vm(xk[:, 0], emm[y])
        hot_ix = _vm(xk[:, 2], emi[y])
        hot_nx = _vm(fl[:, F_N], eny)
        hot_cx = _vm(fl[:, F_C], eny)
        hot_jx = _vm(fl[:, F_J], eny)

        nx_in = _vm(cold_f[:, F_N], enull0) + hot_nx
        if row < 0:
            nx_in = nx_in + first
        nx_hot = _vm(nx_in, cloop)
        n_hot = loop_s * nx_hot
        b0 = exit_s * nx_hot

        # the row core, without B mass when multihit adds it afterwards
        u = zeros(B, K, St) if ops.multihit else entry * b0[:, None, :]
        b_mx = _vm(u + cold_k[:, 0], em0) + hot_mx
        ix_aff = _vm(cold_k[:, 2], ei0) + hot_ix
        i_aff = m_to_i * b_mx + i_to_i * ix_aff
        b_ix = _vm(_vm(i_aff, ci), ei0) + ix_aff
        carry = torch.cat([b_mx, b_ix, zeros(B, K, St)], dim=-1)  # (B,K,3St)
        for lev in range(len(ops.alev)):
            off = 1 << lev
            carry = torch.cat([carry[:, :off], carry[:, off:] + _vm(
                carry[:, :-off], ops.alev[lev, off:])], dim=1)
        mx_h = carry[..., 0:St]
        ix_h = carry[..., St:2 * St]
        d_h = carry[..., 2 * St:]
        prev = torch.cat([zeros(B, 1, 3 * St), carry[:, :-1]], dim=1)
        m_h = (roll_m * prev[..., 0:St] + roll_i * prev[..., St:2 * St]
               + roll_d * prev[..., 2 * St:]) + u
        i_h = _vm(m_to_i * mx_h + i_to_i * ix_aff, ci)
        e_base = (m_h + d_h + last * ix_h).sum(dim=1)        # (B, St)

        if ops.multihit:
            jx_base = _vm(cold_f[:, F_J], enull0) + hot_jx + 0.5 * e_base
            c_in = b0 + exit_s * _vm(jx_base, cloop)
            b_hot = _vm(c_in, mloop_star)
            bk = b_hot[:, None, :]
            m_h = m_h + _vm(bk, mb_m)
            mx_h = mx_h + _vm(bk, mb_mx)
            i_h = i_h + _vm(bk, mb_i)
            ix_h = ix_h + _vm(bk, mb_ix)
            d_h = d_h + _vm(bk, mb_d)
            b_e = _vm(b_hot, mb_E)
            e_hot = e_base + b_e
            jx_hot = _vm(jx_base + 0.5 * b_e, cloop)
            j_hot = loop_s * jx_hot
        else:
            b_hot = b0
            e_hot = e_base
            jx_hot = j_hot = zeros(B, St)
        cx_in = _vm(cold_f[:, F_C], enull0) + hot_cx + e_to_c * e_hot
        cx_hot = _vm(cx_in, cloop)
        zf = zeros(B, St)
        fl_new = torch.stack([n_hot, nx_hot, b_hot, e_hot, loop_s * cx_hot,
                              cx_hot, j_hot, jx_hot, exit_s * cx_hot, zf, zf],
                             dim=1) + cold_f
        xk_new = torch.stack([m_h, mx_h, i_h, ix_h, d_h], dim=1) + cold_k

        if row >= 0:
            # exact power-of-two renormalisation from the float's bits
            m = torch.maximum(xk_new.amax(dim=(1, 2, 3)),
                              fl_new.amax(dim=(1, 2)))
            alive = m > 0.0
            bits = torch.where(alive, m, one).view(torch.int32)
            kexp = (bits >> 23) & 0xFF
            inv = ((254 - kexp) << 23).view(torch.float32)
            xk_new = xk_new * inv[:, None, None, None]
            fl_new = fl_new * inv[:, None, None]
            expo = torch.where(keep, expo + (kexp - 127), expo)
            dead = dead | (keep & ~alive)
        xk = torch.where(keep[:, None, None, None], xk_new, xk)
        fl = torch.where(keep[:, None, None], fl_new, fl)
    return torch.stack([fl[:, F_T, St - 1], expo.to(torch.float32),
                        dead.to(torch.float32)])


def n_levels(K):
    """ceil(log2 K): the doubling's levels for K profile nodes."""
    return max(K - 1, 0).bit_length()


def _state_floats(K, St):
    """Floats of one read's state in the node-doubling layout: the node
    blocks, the solve's two b buffers and ix_aff."""
    return (_round_up(5 * K * St, 4) + 2 * _round_up(3 * K * St, 4)
            + _round_up(K * St, 4))


def _smem_floats(K, St, n_sym, R, TPR, tables, state="shared"):
    """Shared-memory floats of one block of the node-doubling layout, as
    csrc/fused_plan7.cu lays them out (every region rounded up to 4
    floats); `tables`: the doubling's matrices and the paired-emission
    panels too; `state` "global": only the constants and each read's
    reduction slots (the per-node tables and the state in global
    memory)."""
    n = St * St
    total = _round_up(4 * n + St + 3 + 2 * n_sym * n, 4)     # consts
    red = _round_up((TPR // 32) * (St + 1), 4)
    if state == "global":
        return total + R * red
    total += _round_up(len(KSC_NAMES) * K, 4)
    total += _round_up(len(KCO_NAMES) * K * n, 4)
    if tables:
        total += _round_up(n_levels(K) * K * 9 * n, 4)
        total += 2 * _round_up(n_sym * K * n, 4)
    return total + R * (_state_floats(K, St) + red)


def warp_smem_floats(K, St, n_sym, in_smem):
    """Shared-memory floats of one block of the warp layout: the constants,
    then each table that `in_smem` ({"nodes", "span", "panels"}: bool)
    puts there; none depends on the reads a block."""
    C = warp_chunk(K)
    total = _round_up(4 * St * St + St + 3 + 2 * n_sym * St * St, 4)
    if in_smem["nodes"]:
        total += C * _rec_floats(St) * LANES
    if in_smem["span"]:
        total += lane_levels(K) * _span_floats(St) * LANES
    if in_smem["panels"]:
        total += n_sym * C * _pan_floats(St) * LANES
    return total


STATES = ("shared", "global")


def _node_doubling_plan(K, St, n_sym, B, n_sm, reads_per_block, state,
                        mem_bytes=None):
    TPR = min(_round_up(K, 32), 256)
    r_max = min(max(_MAX_THREADS // TPR, 1), _MAX_READS)
    want = reads_per_block if reads_per_block is not None \
        else max(-(-B // max(n_sm, 1)), 1)
    if want < 1 or (reads_per_block is not None and want > r_max):
        raise ValueError("reads_per_block must lie in [1, %d] for K=%d"
                         % (r_max, K))
    if state not in (None,) + STATES:
        raise ValueError("state must be one of %s, not %r" % (STATES, state))
    R = min(want, r_max)
    if state != "global":
        while True:
            for tables in (True, False):
                nbytes = 4 * _smem_floats(K, St, n_sym, R, TPR, tables)
                if nbytes <= _SMEM_LIMIT:
                    return {"layout": "node_doubling", "reads": R,
                            "threads_per_read": TPR, "tables": tables,
                            "state": "shared", "smem": nbytes}
            if R == 1 or reads_per_block is not None:
                break
            R -= 1
        if state == "shared":
            raise ValueError(
                "fused plan7 kernel: K=%d, St=%d needs %d bytes of shared "
                "memory for %d reads a block, over the %d a block may take"
                % (K, St, nbytes, R, _SMEM_LIMIT))
        R = min(want, r_max)
    nbytes = 4 * _smem_floats(K, St, n_sym, R, TPR, False, "global")
    if nbytes > _SMEM_LIMIT:
        raise ValueError(
            "fused plan7 kernel: K=%d, St=%d needs %d bytes of shared memory "
            "for %d reads a block with the state in global memory, over the "
            "%d a block may take" % (K, St, nbytes, R, _SMEM_LIMIT))
    gbytes = 4 * -(-B // R) * R * _state_floats(K, St)
    if mem_bytes is not None and gbytes > mem_bytes:
        raise ValueError(
            "fused plan7 kernel: %d reads of a K=%d, St=%d profile take %d "
            "bytes of device memory for their state, over the card's %d"
            % (B, K, St, gbytes, mem_bytes))
    return {"layout": "node_doubling", "reads": R, "threads_per_read": TPR,
            "tables": False, "state": "global", "smem": nbytes,
            "bytes": gbytes}


def default_layout(K):
    """The layout launch_plan takes for K profile nodes when none is asked
    for: "warp" up to WARP_DEFAULT_MAX_K nodes, else "node_doubling"."""
    return "warp" if K <= WARP_DEFAULT_MAX_K else "node_doubling"


def launch_plan(K, St, n_sym, B, n_sm, reads_per_block=None, layout=None,
                state=None, mem_bytes=None):
    """The kernel's layout for a batch of B reads on a card of n_sm
    multiprocessors, a dict with "layout", "reads" (a block) and "smem"
    (bytes); `layout` None takes default_layout(K).

    "warp" (up to 512 profile nodes): a warp a read, enough reads a block
    (at most 8) that the batch is one wave of blocks; "chunk" nodes a
    lane, "lane_levels" scan levels; the node records, the span products
    and the panels go to shared memory in that order while they fit
    ("in_smem"), else they are read from global memory.
    "node_doubling": "threads_per_read" (one a node up to 256), reads a
    block within the thread, barrier (15) and shared-memory limits, the
    doubling's matrices and the panels in shared memory when both fit
    beside the state ("tables"), and "state": "shared" where each read's
    state (12 K St floats) and the per-node tables fit shared memory for
    one read a block at least, else "global" (the state in a global buffer
    of the read's own, the per-node tables read from global memory, whose
    device bytes the plan gives as "bytes" and checks against `mem_bytes`,
    the card's memory, when given); `state` forces it (node_doubling
    only)."""
    if layout is None:
        layout = default_layout(K)
    if layout == "node_doubling":
        return _node_doubling_plan(K, St, n_sym, B, n_sm, reads_per_block,
                                   state, mem_bytes)
    if state is not None:
        raise ValueError("state applies to the node_doubling layout")
    if layout != "warp":
        raise ValueError("layout must be one of %s, not %r"
                         % (LAYOUTS, layout))
    if warp_chunk(K) > _MAX_CHUNK:
        raise ValueError("the warp layout takes at most %d profile nodes, "
                         "not %d" % (LANES * _MAX_CHUNK, K))
    if reads_per_block is not None and \
            not 1 <= reads_per_block <= _MAX_WARP_READS:
        raise ValueError("reads_per_block must lie in [1, %d] for K=%d"
                         % (_MAX_WARP_READS, K))
    R = reads_per_block or min(_MAX_WARP_READS,
                               max(-(-B // max(n_sm, 1)), 1))
    in_smem = {"nodes": False, "span": False, "panels": False}
    for name in in_smem:
        in_smem[name] = True
        if 4 * warp_smem_floats(K, St, n_sym, in_smem) > _SMEM_LIMIT:
            in_smem[name] = False
    return {"layout": "warp", "reads": R, "chunk": warp_chunk(K),
            "lane_levels": lane_levels(K), "in_smem": in_smem,
            "smem": 4 * warp_smem_floats(K, St, n_sym, in_smem)}


_launchers = {}     # (library, layout) -> its launch function, argtypes set


def _launcher(lib, layout):
    if (lib, layout) not in _launchers:
        P, I = ctypes.c_void_p, ctypes.c_int
        if layout == "warp":
            fn = load(lib).fused_plan7_warp_launch
            fn.argtypes = [P] * 8 + [I] * 12 + [P]
        else:
            fn = load(lib).fused_plan7_nodes_launch
            fn.argtypes = [P] * 11 + [I] * 13 + [P]
        fn.restype = I
        _launchers[(lib, layout)] = fn
    return _launchers[(lib, layout)]


def _plan(ops, B, reads_per_block, layout, state=None):
    """launch_plan for these operands and B reads, made once per key."""
    key = (B, reads_per_block, layout, state)
    if key not in ops.plans:
        dev = ops.consts.device
        if "n_sm" not in ops.plans:
            props = torch.cuda.get_device_properties(dev)
            ops.plans["n_sm"] = props.multi_processor_count
            ops.plans["mem"] = props.total_memory
        ops.plans[key] = launch_plan(ops.K, ops.St, ops.n_sym, B,
                                     ops.plans["n_sm"], reads_per_block,
                                     layout, state, ops.plans["mem"])
    return ops.plans[key]


def state_floats_on_card(K, St):
    """One read's state floats in the node-doubling layout, from the built
    library: must equal _state_floats."""
    fn = load("fused_plan7").fused_plan7_nodes_state_floats
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_long
    return fn(K, St)


def _run_on_card(ops, toks, lens, reads_per_block, layout, profile,
                 state=None):
    dev = ops.consts.device
    B, L = toks.shape
    _check(toks, "toks", torch.int32, (B, L), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    out = torch.empty((3, B), dtype=torch.float32, device=dev)
    prof = torch.zeros((B, _N_PROF), dtype=torch.int64, device=dev) \
        if profile else None
    if B == 0:
        return out, prof
    plan = _plan(ops, B, reads_per_block, layout, state)
    tables = layout_tables(ops, plan["layout"])
    fn = _launcher("fused_plan7_profile" if profile else "fused_plan7",
                   plan["layout"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    pp = prof.data_ptr() if profile else None
    if plan["layout"] == "warp":
        ntab, span, pan = tables
        bits = sum(v << k for k, v in enumerate(plan["in_smem"].values()))
        rc = fn(ops.consts.data_ptr(), ntab.data_ptr(),
                span.data_ptr(), pan.data_ptr(), toks.data_ptr(),
                lens.data_ptr(), out.data_ptr(), pp, B, L, ops.K, ops.St,
                ops.n_sym, plan["chunk"], plan["lane_levels"],
                int(ops.multihit), plan["reads"], bits, plan["smem"],
                ops.consts.numel(), stream)
    else:
        gstate = plan["state"] == "global"
        R = plan["reads"]
        gst = torch.empty(-(-B // R) * R * _state_floats(ops.K, ops.St)
                          if gstate else 1, dtype=torch.float32, device=dev)
        rc = fn(ops.consts.data_ptr(), ops.ksc.data_ptr(),
                ops.kco.data_ptr(), tables[0].data_ptr(),
                ops.emm.data_ptr(), ops.emi.data_ptr(), toks.data_ptr(),
                lens.data_ptr(), out.data_ptr(), pp, gst.data_ptr(), B, L,
                ops.K, ops.St, ops.n_sym, n_levels(ops.K),
                int(ops.multihit), R, plan["threads_per_read"],
                int(plan["tables"]), int(gstate), plan["smem"],
                ops.consts.numel(), stream)
    if rc != 0:
        raise RuntimeError("fused_plan7 launch failed: CUDA error %d" % rc)
    return out, prof


def fused_plan7_forward_kernel(ops, toks, lens, reads_per_block=None,
                               layout=None, state=None):
    """The row solve over a read batch: (3, B) float32 (mantissa, exponent
    sum, dead flag).

    A CUDA tensor launches csrc/fused_plan7.cu once for the whole batch,
    laid out by launch_plan (`reads_per_block` reads share a block,
    `layout` "warp" or "node_doubling", `state` "shared" or "global" for
    the node-doubling layout; default: as launch_plan picks),
    and counts one launch in `fused_plan7_forward_kernel.launches`; a CPU
    tensor takes fused_plan7_forward_plain. toks (B, L) 1-based int32 and
    lens (B,) int32, contiguous, on the device of `ops`."""
    if toks.device.type == "cpu":
        return fused_plan7_forward_plain(ops, toks, lens)
    if toks.device.type != "cuda":
        raise ValueError("fused_plan7_forward_kernel runs on cuda or cpu "
                         "tensors, not %s" % toks.device)
    out, _ = _run_on_card(ops, toks, lens, reads_per_block, layout, False,
                          state)
    if toks.shape[0]:
        fused_plan7_forward_kernel.launches += 1
    return out


fused_plan7_forward_kernel.launches = 0


def fused_plan7_profile(ops, toks, lens, reads_per_block=None, layout=None):
    """fused_plan7_forward_kernel on the card through the profile library
    (the same source built with its clock64 counters; not counted as a
    launch). Returns (the (3, B) result, {"rows", phase: SM cycles a row}
    over the batch's reads; node_doubling adds "level_l" for each doubling
    level)."""
    out, prof = _run_on_card(ops, toks, lens, reads_per_block, layout, True)
    layout = _plan(ops, toks.shape[0], reads_per_block, layout)["layout"]
    tot = prof.sum(dim=0).cpu().tolist()
    rows = max(tot[0], 1)
    names = list(PROFILE_PHASES[layout])
    if layout == "node_doubling":
        names += ["level_%d" % lev for lev in range(n_levels(ops.K))]
    return out, dict({"rows": tot[0]}, **{
        p: tot[1 + k] / rows for k, p in enumerate(names)})


def decode(out, B_=None):
    """Host decode of the (3, B) result: power-of-two mantissa and
    exponent -> float64 log-likelihoods, NEG_INF for a dead read or a zero
    mantissa (the single place that knows the encoding; forward_stream
    reuses it)."""
    out = np.asarray(out, np.float64)
    B_ = out.shape[1] if B_ is None else B_
    mant, expo, dead = out[0, :B_], out[1, :B_], out[2, :B_] > 0.5
    with np.errstate(divide="ignore"):
        ll = np.log(np.maximum(mant, 1e-300)) + expo * np.log(2.0)
    return np.where(dead | (mant <= 0.0), NEG_INF, ll)


def make_fused_plan7_kernel(fused, B, L, interpret=False):
    """Build the kernel route for a Plan7Fused (mode='plan7', Forward, St
    <= 4) and fixed shapes. Returns fn(toks (B, L) 1-based integer tokens,
    lens (B,)) -> (B,) float64 numpy log-likelihoods, computed on the
    device of `fused`; fn.device_call(toks, lens) takes int32 tensors on
    that device and returns the (3, B) result there without
    synchronising; fn.decode is `decode`.

    `interpret` (the JAX factory's Pallas interpret mode off the TPU) is
    accepted, so the JAX call form runs, and unused: on CPU tensors the
    route runs the plain version."""
    if "_kernel_ops" not in fused.__dict__:
        fused._kernel_ops = plan7_operands(prepare_fused_plan7(fused),
                                           fused.device)
    ops = fused._kernel_ops
    dev = fused.device

    def device_call(toks, lens):
        if tuple(toks.shape) != (B, L):
            raise ValueError("expected tokens of shape (%d, %d)" % (B, L))
        return fused_plan7_forward_kernel(ops, toks, lens)

    def fwd(toks, lens):
        t = torch.as_tensor(np.asarray(toks), device=dev).to(torch.int32) \
            .contiguous()
        n = torch.as_tensor(np.asarray(lens), device=dev).to(torch.int32) \
            .contiguous()
        return decode(device_call(t, n).cpu().numpy(), B)

    fwd.device_call = device_call
    fwd.decode = decode
    return fwd


make_fused_plan7_pallas = make_fused_plan7_kernel
