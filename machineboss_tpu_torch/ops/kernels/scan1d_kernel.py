"""Batched 1D Forward scan in scaled probability.

Counterpart of machineboss_tpu's ops/pallas/scan1d_kernel.py. The host prep
(`prepare_scan1d`) is the JAX factory's: the log transfer matrices
(lowering.emit_matrices_1d, silent closure folded) are shifted by one
global g = max(trans) and exponentiated, EM[t] = exp(trans[t] - g), and the
start vector is the closure's row 0 as probabilities. g is added back as
len * g at the end, exactly, with no per-step bookkeeping.

The scan has two versions with one recurrence and one renormalisation
schedule:

- `scan1d_forward_plain`: a torch loop over positions in float32, used on
  the CPU and as the card's comparison;
- `scan1d_forward`: the wrapper of the hand-written CUDA kernel
  (csrc/scan1d.cu). A CUDA tensor launches the kernel or raises; only a CPU
  tensor takes the plain version.

The kernel's layout comes from `scan1d_launch_plan`, a pure function of the
shape (tokens, states, nonzeros per column, batch): warps a sequence,
sequences a block, exact zeros skipped through a per-token list of each
destination's nonzero sources (`scan1d_tables`, mode "csr") or whole dense
columns (mode "dense"), and whether the plan lives in shared memory.

Both return (3, B) float32: the mantissa p[S-1], the sum of binary
exponents taken out by the renormalisations, and a dead flag (1.0 for a
sequence that lost all its mass). `make_forward_1d_kernel` keeps the JAX
factory's contract: fn(toks (B, L), lens (B,)) -> (B,) float64 numpy
log-likelihoods, the final log(mantissa) + exponent*ln2 + len*g taken in
float64 on the host.

Every renorm_every-th position p is scaled by the exact power of two of
its max's binary exponent, so the loop carries no log: a log per step
biases a 10,000-step scan by hundredths of a nat. The plain version takes
the exponent with torch.frexp, whose mantissa lies in [0.5, 1): its
exponent is one more than the biased-exponent field the kernel reads, and
is brought to the kernel's convention (max scaled into [1, 2)) before use.
"""

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ...utils.device import resolve_device
from ._build import load
from .lowrank_kernel import _check, _round_up

NEG_INF = -1e30

# the kernel's constants (csrc/scan1d.cu)
_CH = 128            # tokens a staged chunk (a ring of four)
_RMAX = 8            # csr: rows a lane
# csr with the entries in registers: the kernel's (rows, terms) blocks and
# their mode numbers
_PF_SHAPES = {(2, 4): 3, (3, 6): 4, (4, 8): 5}
_DMAX = 4            # dense: destination columns a lane
_TERMS_MAX = 64      # csr: the longest segment a lane sums in a chain
_WMAX = 32           # warps a sequence
_NO_DEST = 0xFFFF
_MODES = {"csr": 0, "dense": 2}
VARIANTS = {None: 0, "block_barrier": 1, "tokens_global": 2,
            "renorm_barrier": 3}
SMEM_MAX = 232448    # shared bytes a block may take on the H100
_SMS = 132           # the H100's multiprocessors, the plan's default


def prepare_scan1d(trans, closure):
    """Host prep: (em (n_tok, S, S) float32 source x destination, c0 (S,)
    float32, g). em is the JAX factory's exp-shifted matrix before its
    transpose for the TPU's matrix unit."""
    trans = np.asarray(trans, np.float64)
    closure = np.asarray(closure, np.float64)
    g = float(np.max(trans)) if trans.size else 0.0  # single global shift
    if not np.isfinite(g):
        g = 0.0
    em = np.exp(np.maximum(trans - g, -700.0))
    em = np.where(np.isfinite(trans), em, 0.0)
    with np.errstate(divide="ignore"):
        c0 = np.where(np.isfinite(closure), np.exp(closure), 0.0)[0]
    return (np.ascontiguousarray(em).astype(np.float32),
            c0.astype(np.float32), g)


@dataclass
class Scan1dOperands:
    """One machine's prepare_scan1d result as tensors on one device. On a
    CUDA device the kernel's layout is added: destination states padded
    with zeros to SP = round_up(S, 32), the nonzeros of each token's
    destination columns, and the device tables of each layout used so far
    (`tables`, keyed by mode, lanes and terms) and the launch plans made
    so far (`plans`)."""
    n_tok: int
    S: int
    g: float
    em: torch.Tensor
    c0: torch.Tensor
    SP: int = 0
    em_pad: torch.Tensor = None
    c0_pad: torch.Tensor = None
    em_host: np.ndarray = None
    col_nnz: np.ndarray = None
    sinks: np.ndarray = None
    plans: dict = field(default_factory=dict)
    tables: dict = field(default_factory=dict)


def scan1d_operands(em, c0, g, device):
    """Move a prepare_scan1d result to `device` (a torch.device)."""
    n_tok, S, _ = em.shape
    ops = Scan1dOperands(n_tok=n_tok, S=S, g=g,
                         em=torch.tensor(em, device=device),
                         c0=torch.tensor(c0, device=device))
    if device.type != "cuda":
        return ops
    SP = _round_up(S, 32)
    em_pad = np.zeros((max(n_tok, 1), S, SP), np.float32)
    em_pad[:n_tok, :, :S] = em
    c0_pad = np.zeros(SP, np.float32)
    c0_pad[:S] = c0
    ops.SP = SP
    ops.em_pad = torch.tensor(em_pad, device=device)
    ops.c0_pad = torch.tensor(c0_pad, device=device)
    ops.em_host = np.asarray(em, np.float32)
    ops.col_nnz = column_counts(ops.em_host)
    ops.sinks = source_free(ops.em_host)
    return ops


# ------------------------------------------------------- the kernel's plan

def column_counts(em):
    """(n_tok, S) int: the nonzero sources of each token's destination
    column of em (n_tok, S, S), source x destination."""
    return (np.asarray(em) != 0).sum(axis=1).astype(np.int64)


def _pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def source_free(em):
    """(S,) bool: the states that are no entry's source in any token
    (End, in a generator): their values are read only for the max and
    the readout."""
    em = np.asarray(em)
    if em.shape[0] == 0:
        return np.zeros(em.shape[1], bool)
    return ~(em != 0).any(axis=(0, 2))


def _csr_layout(col_nnz, lanes, terms, sinks=None):
    """Where each destination's segments sit. A destination's group is
    the power of two of lanes that holds its longest list over the tokens
    cut into segments of `terms`; its position is row * lanes + lane of
    its first lane. Destinations that are some entry's source come first,
    the source-free ones (`sinks`) from the next whole row on; within each
    part groups are placed largest first, so each is aligned to its size
    and none crosses a warp. Returns (G, pos, rows, live_rows, lv_live,
    lv_sink), the lv the log2 of each part's largest group."""
    col_nnz = np.asarray(col_nnz, np.int64).reshape(-1, col_nnz.shape[-1])
    S = col_nnz.shape[1]
    sinks = np.zeros(S, bool) if sinks is None else np.asarray(sinks, bool)
    nseg = np.maximum(1, -(-col_nnz.max(axis=0, initial=0) // terms))
    G = np.array([_pow2(x) for x in nseg], np.int64)
    pos = np.empty(S, np.int64)
    p = 0
    lv = []
    for part in (~sinks, sinks):
        idx = np.nonzero(part)[0]
        for d in idx[np.argsort(-G[idx], kind="stable")]:
            pos[d] = p
            p += G[d]
        lv.append(int(np.log2(G[idx].max())) if len(idx) else 0)
        if len(lv) == 1:                 # the sinks start a row
            live_rows = -(-p // lanes)
            p = live_rows * lanes
    return G, pos, max(1, -(-p // lanes)), live_rows, lv[0], lv[1]


def _csr_cost(col_nnz, lanes, terms, sinks=None):
    """A step's cost in the kernel's own terms, for comparing layouts: an
    8-byte entry and a source load per term and row, the multiply-add
    chain of a segment, 30 cycles a shuffle level; the source-free rows
    only on one step of 4 (the renormalisations). None where the kernel
    cannot take the layout."""
    G, _, rows, live, lv_live, lv_sink = _csr_layout(col_nnz, lanes, terms,
                                                     sinks)
    if G.max() > 32 or rows > _RMAX:
        return None, rows
    step = 3 * live * terms + 4 * terms + 30 * lv_live
    sink = 3 * (rows - live) * terms + 4 * terms + 30 * lv_sink
    return step + (sink / 4.0 if rows > live else 0.0), rows


def _dense_cost(S, SP, lanes):
    """Dense columns' step cost in _csr_cost's terms: a column load and a
    multiply-add a source and column, a float4 load of p every 4
    sources."""
    cols = -(-SP // lanes)
    if cols > _DMAX:
        return None
    return 2 * cols * S + -(-S // 4)


def _best_csr(col_nnz, lanes, sinks=None):
    """(cost, terms, rows) of the cheapest segment length, 1 to
    _TERMS_MAX; None where no length fits."""
    longest = int(np.asarray(col_nnz).max(initial=0))
    best = None
    for terms in range(1, min(max(longest, 1), _TERMS_MAX) + 1):
        cost, rows = _csr_cost(col_nnz, lanes, terms, sinks)
        if cost is not None and (best is None or cost < best[0]):
            best = (cost, terms, int(rows))
    return best


def _group_bytes(SP):
    return 4 * (2 * SP + 4 * _CH + 2 * _WMAX)


def scan1d_launch_plan(n_tok, S, col_nnz, B, sms=_SMS, threads=None,
                       mode=None, sinks=None):
    """The scan kernel's layout for a machine of `n_tok` tokens and `S`
    states whose token columns hold `col_nnz` (n_tok, S) nonzeros, and a
    batch of B sequences, on a card of `sms` multiprocessors. A pure
    function of the shape:

    - lanes a sequence (a multiple of 32; `threads` if given): for csr
      the fewest warps whose rows fit the kernel's registers, for dense a
      column a lane;
    - mode: "csr" (the nonzero entries only, `terms` a segment, `rows`
      segments a lane, the rows of the source-free states `sinks` (S,)
      last, computed only on the steps that need them; "csr_pf" for one
      warp whose entries fit a register block of the kernel, `pf_shape`
      (2 x 4, 3 x 6 or 4 x 8 rows x terms), loaded a step ahead) or
      "dense" (whole columns), whichever costs less a step (`mode` forces
      one);
    - groups: sequences a block, about B / sms so that every
      multiprocessor has work, fewer where shared memory runs out;
    - smem_plan: the plan copied to each block's shared memory, where it
      fits beside the sequences' buffers, else read through the read-only
      cache.

    Raises ValueError for a machine too wide for the kernel."""
    if mode not in (None, "csr", "dense"):
        raise ValueError("mode must be None, 'csr' or 'dense'")
    col_nnz = np.asarray(col_nnz, np.int64).reshape(max(n_tok, 1), S) \
        if n_tok else np.zeros((1, S), np.int64)
    SP = _round_up(S, 32)
    if threads is not None and (threads < 32 or threads > 512
                                or threads % 32):
        raise ValueError("threads must be a multiple of 32 in [32, 512]")
    # csr: the fewest warps whose rows fit; dense: a column a lane (as
    # many lanes as padded states) unless the caller names the lanes
    cands = []
    if mode in (None, "csr"):
        for lanes in ([threads] if threads else
                      [32 * 2 ** k for k in range(5)]):
            csr = _best_csr(col_nnz, lanes, sinks)
            if csr is not None:
                cands.append((csr[0], lanes, "csr", csr[1], csr[2]))
                break
    if mode in (None, "dense"):
        lanes = threads or min(SP, 512)
        cost = _dense_cost(S, SP, lanes)
        if cost is not None:
            cands.append((cost, lanes, "dense", 0, 0))
    choice = min(cands, key=lambda c: c[0])[1:] if cands else None
    if choice is None:
        raise ValueError("scan1d: %d states are too many for the kernel's "
                         "layouts" % S)
    lanes, kind, terms, rows = choice
    live_rows, lv_live, lv_sink = rows, 0, 0
    if kind == "csr":
        _, _, _, live_rows, lv_live, lv_sink = _csr_layout(
            col_nnz, lanes, terms, sinks)
    shape = min((s for s in _PF_SHAPES if s[0] >= rows and s[1] >= terms),
                default=None) if kind == "csr" and lanes == 32 else None
    pf = shape is not None
    if kind == "dense":
        words = max(n_tok, 1) * S * SP
    elif pf:                 # a full block of entries a lane
        words = max(n_tok, 1) * shape[0] * shape[1] * lanes * 2
    else:
        words = max(n_tok, 1) * rows * terms * lanes * 2
    cap = min((256 if pf else 512) // lanes, 15 if lanes > 32 else 32)
    groups = max(1, min(cap, -(-B // sms))) if B else 1
    while groups > 1 and 4 * words + groups * _group_bytes(SP) > SMEM_MAX:
        groups -= 1
    smem_plan = 4 * words + groups * _group_bytes(SP) <= SMEM_MAX
    if not smem_plan:
        pf = False
        groups = max(1, min(512 // lanes, 15 if lanes > 32 else 32,
                            -(-B // sms), SMEM_MAX // _group_bytes(SP)))
    return {"mode": "csr_pf" if pf else kind, "lanes": lanes,
            "warps": lanes // 32, "terms": terms, "rows": rows,
            "live_rows": int(live_rows), "levels": [lv_live, lv_sink],
            "pf_shape": list(shape) if pf else None,
            "groups": groups, "grid": -(-B // groups) if B else 0,
            "SP": SP, "smem_plan": bool(smem_plan), "plan_words": int(words),
            "smem": int((4 * words if smem_plan else 0)
                        + groups * _group_bytes(SP))}


def scan1d_tables(em, cfg):
    """The plan's tables for the kernel, numpy int32, from em (n_tok, S, S)
    float32 source x destination and a scan1d_launch_plan result of mode
    csr or csr_pf: entries (n_tok, rows, terms, lanes, 2), each (source,
    the value's bits), a destination's list in source order cut into
    segments of `terms`, one segment a lane of the destination's group
    (unused slots (0, 0.0); csr_pf pads rows and terms to its pf_shape); meta
    (rows, lanes): the destination at its group's first lane (0xFFFF
    elsewhere) and log2 of the lane's group size in bits 16-19. The
    source-free states' rows come last."""
    em = np.asarray(em, np.float32)
    n_tok, S, _ = em.shape
    lanes, terms = cfg["lanes"], cfg["terms"]
    G, pos, rows, _, _, _ = _csr_layout(
        column_counts(em) if n_tok else np.zeros((1, S), np.int64),
        lanes, terms, source_free(em))
    if G.max() > 32:
        raise ValueError("a column of %d segments of %d exceeds a warp"
                         % (G.max(), terms))
    # csr_pf: rows and terms padded to the kernel's register block
    n_rows, n_terms = cfg["pf_shape"] if cfg["mode"] == "csr_pf" \
        else (rows, terms)
    ent = np.zeros((max(n_tok, 1), n_rows, n_terms, lanes, 2), np.int32)
    dest = np.full((n_rows, lanes), _NO_DEST, np.int64)
    lg = np.zeros((n_rows, lanes), np.int64)
    bits = em.view(np.int32)
    for d in range(S):
        r, l0 = divmod(int(pos[d]), lanes)
        dest[r, l0] = d
        lg[r, l0:l0 + G[d]] = int(np.log2(G[d]))
        for t in range(n_tok):
            src = np.nonzero(em[t, :, d])[0]
            j = np.arange(len(src))
            ent[t, r, j % terms, l0 + j // terms, 0] = src
            ent[t, r, j % terms, l0 + j // terms, 1] = bits[t, src, d]
    return ent, (dest | (lg << 16)).astype(np.int32)


def scan1d_launch_config(ops, B, threads=None, mode=None):
    """scan1d_launch_plan for these operands on their card, made once per
    batch size and layout and kept on `ops` (the plan's search over
    segment lengths takes milliseconds of host time)."""
    key = (B, threads, mode)
    if key not in ops.plans:
        sms = torch.cuda.get_device_properties(ops.c0.device) \
            .multi_processor_count
        ops.plans[key] = scan1d_launch_plan(
            ops.n_tok, ops.S, ops.col_nnz, B, sms=sms, threads=threads,
            mode=mode, sinks=ops.sinks)
    return ops.plans[key]


def _device_tables(ops, cfg):
    """(plan, meta) device tensors of a layout, made once per layout."""
    if cfg["mode"] == "dense":
        return ops.em_pad, ops.c0_pad      # dense columns read no meta
    key = (cfg["mode"], cfg["lanes"], cfg["terms"])
    if key not in ops.tables:
        ent, meta = scan1d_tables(ops.em_host, cfg)
        if cfg["mode"] == "csr_pf":
            # the kernel loads a lane's slots two at a time: (token, slot
            # pair, lane, 2 slots, 2)
            n, R, K, lanes, _ = ent.shape
            ent = np.ascontiguousarray(ent.reshape(
                n, R * K // 2, 2, lanes, 2).transpose(0, 1, 3, 2, 4))
        dev = ops.c0.device
        ops.tables[key] = (torch.tensor(ent.reshape(-1), device=dev),
                           torch.tensor(meta.reshape(-1), device=dev))
    return ops.tables[key]


def scan1d_smem_bytes_on_card(ops, cfg):
    """The kernel's own count of a block's shared bytes for `cfg`."""
    return int(load("scan1d").scan1d_smem_bytes(
        ctypes.c_int(ops.SP), ctypes.c_int(cfg["groups"]),
        ctypes.c_int(cfg["plan_words"]), ctypes.c_int(int(cfg["smem_plan"]))))


def scan1d_forward_plain(ops, toks, lens, renorm_every=4):
    """Plain PyTorch version of the 1D scan, float32. toks (B, L) integer
    tokens (negative: skipped position), lens (B,), on the device of `ops`.
    Returns (3, B) float32: mantissa, exponent sum, dead flag."""
    B, L = toks.shape
    n_tok, S = ops.n_tok, ops.S
    dev = ops.c0.device
    toks = toks.long()
    lens = lens.long()
    p = ops.c0[None].repeat(B, 1)
    expo = torch.zeros(B, dtype=torch.float32, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    one = torch.ones(B, dtype=torch.float32, device=dev)
    n_pos = min(int(lens.max()), L) if B else 0
    for d in range(n_pos):
        tok = toks[:, d]
        keep = (d < lens) & (tok >= 0)
        known = (tok >= 0) & (tok < n_tok)
        blocks = ops.em[torch.clamp(tok, 0, max(n_tok - 1, 0))]   # (B, S, S)
        cur = torch.bmm(p[:, None, :], blocks)[:, 0]
        cur = torch.where(known[:, None], cur, torch.zeros_like(cur))
        if (d + 1) % renorm_every == 0:
            m = cur.max(dim=-1).values
            alive = m > 0
            _, e = torch.frexp(torch.where(alive, m, one))
            # frexp's mantissa is in [0.5, 1): e - 1 is the exponent of the
            # biased-exponent field; a subnormal max has field 0
            inc = torch.clamp(e - 1, min=-127)
            cur = cur * torch.ldexp(one, -inc)[:, None]
            expo = torch.where(keep, expo + inc.to(torch.float32), expo)
            dead = dead | (keep & ~alive)
        p = torch.where(keep[:, None], cur, p)
    return torch.stack([p[:, S - 1], expo, dead.to(torch.float32)])


def scan1d_forward(ops, toks, lens, renorm_every=4, threads=None,
                   mode=None, variant=None):
    """1D Forward scan: (3, B) float32 (mantissa, exponent sum, dead flag).

    A CUDA tensor launches csrc/scan1d.cu in the layout of
    scan1d_launch_plan (`threads`: lanes a sequence, a multiple of 32;
    `mode`: "csr" or "dense"; None: the plan's choice) and counts one
    launch in `scan1d_forward.launches`; a CPU tensor takes
    scan1d_forward_plain. `variant` (a key of VARIANTS) undoes one design
    choice, for timing: "block_barrier", "tokens_global" or
    "renorm_barrier". toks (B, L) and lens (B,) are int32 and contiguous,
    on the device of `ops`."""
    if toks.device.type == "cpu":
        return scan1d_forward_plain(ops, toks, lens, renorm_every)
    if toks.device.type != "cuda":
        raise ValueError("scan1d_forward runs on cuda or cpu tensors, not %s"
                         % toks.device)
    if ops.em_pad is None:
        raise ValueError("operands were prepared for %s, not the card"
                         % ops.c0.device)
    if renorm_every < 1:
        raise ValueError("renorm_every must be >= 1")
    if variant not in VARIANTS:
        raise ValueError("variant must be one of %s" % list(VARIANTS))
    dev = ops.c0.device
    B, L = toks.shape
    _check(toks, "toks", torch.int32, (B, L), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    cfg = scan1d_launch_config(ops, B, threads, mode)
    if variant and not cfg["smem_plan"]:
        raise ValueError("the variants need the plan in shared memory")
    plan, meta = _device_tables(ops, cfg)
    lib = load("scan1d")
    out = torch.empty((3, B), dtype=torch.float32, device=dev)
    fn = lib.scan1d_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 6 + [I] * 17 + [P]
    fn.restype = I
    rc = fn(plan.data_ptr(), meta.data_ptr(), ops.c0_pad.data_ptr(),
            toks.data_ptr(), lens.data_ptr(), out.data_ptr(), B, L,
            ops.n_tok, ops.S, ops.SP, renorm_every, cfg["lanes"],
            cfg["rows"], cfg["terms"], cfg["groups"], cfg["live_rows"],
            *cfg["levels"], cfg["plan_words"],
            _PF_SHAPES[tuple(cfg["pf_shape"])] if cfg["mode"] == "csr_pf"
            else _MODES[cfg["mode"]], int(cfg["smem_plan"]), VARIANTS[variant],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("scan1d launch failed: CUDA error %d" % rc)
    scan1d_forward.launches += 1
    return out


scan1d_forward.launches = 0


def scan1d_loglike(out, lens, g):
    """The final reduction in float64 on the host: ONE log plus the exact
    exponent and shift terms. out (3, B) as the scan returns it."""
    out = np.asarray(out, np.float64)
    lens = np.asarray(lens)
    mant, expo, dead = out[0], out[1], out[2] > 0.5
    with np.errstate(divide="ignore"):
        ll = (np.log(np.maximum(mant, 1e-300)) + expo * np.log(2.0)
              + lens.astype(np.float64) * g)
    return np.where(dead | (mant <= 0.0), NEG_INF, ll)


def make_forward_1d_kernel(trans, closure, B, L, unroll=8, split=None,
                           renorm_every=4, interpret=False, device=None):
    """Build the batched 1D Forward for fixed shapes.

    trans (n_tok, S, S) log transfer matrices (silent closure folded,
    lowering.emit_matrices_1d); closure (S, S). Returns fn(toks (B, L)
    0-based integer tokens, lens (B,)) -> (B,) float64 numpy
    log-likelihoods, computed on `device` (None: the card).

    `unroll` and `split` (which amortise the TPU grid's step cost and
    shape its matrix-unit products) and `interpret` (Pallas interpret mode
    off the TPU) are the JAX factory's knobs of the TPU layout: accepted
    with its defaults and unused. The JAX factory also rounds renorm_every
    down
    to a divisor of its unroll; here any renorm_every >= 1 is taken as it
    is (the scaling is an exact power of two, so the schedule does not
    change the result)."""
    dev = resolve_device(device)
    ops = scan1d_operands(*prepare_scan1d(trans, closure), dev)

    def fwd(toks, lens):
        t = torch.as_tensor(np.asarray(toks), device=dev).to(torch.int32) \
            .contiguous()
        n = torch.as_tensor(np.asarray(lens), device=dev).to(torch.int32) \
            .contiguous()
        if tuple(t.shape) != (B, L):
            raise ValueError("expected tokens of shape (%d, %d)" % (B, L))
        out = scan1d_forward(ops, t, n, renorm_every=renorm_every)
        return scan1d_loglike(out.cpu().numpy(), np.asarray(lens), ops.g)

    return fwd


# the JAX package's name for the 1D factory
make_forward_1d_pallas = make_forward_1d_kernel
