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
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.device import resolve_device
from ._build import load
from .lowrank_kernel import _check, _round_up

NEG_INF = -1e30

# shared memory a block may take for the transfer matrices and its two
# state vectors (two such blocks fit one multiprocessor); larger machines
# are read through the read-only cache instead
_SMEM_LIMIT = 110 * 1024


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
    with zeros to SP = round_up(S, 32)."""
    n_tok: int
    S: int
    g: float
    em: torch.Tensor
    c0: torch.Tensor
    SP: int = 0
    em_pad: torch.Tensor = None
    c0_pad: torch.Tensor = None


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
    return ops


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


def scan1d_forward(ops, toks, lens, renorm_every=4, threads=None):
    """1D Forward scan: (3, B) float32 (mantissa, exponent sum, dead flag).

    A CUDA tensor launches csrc/scan1d.cu (one block per sequence,
    `threads` threads a block, a multiple of 32; default: one thread per
    padded state, at most 1024) and counts one launch in
    `scan1d_forward.launches`; a CPU tensor takes scan1d_forward_plain.
    toks (B, L) and lens (B,) are int32 and contiguous, on the device of
    `ops`."""
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
    dev = ops.c0.device
    B, L = toks.shape
    _check(toks, "toks", torch.int32, (B, L), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    if threads is None:
        threads = min(ops.SP, 1024)
    if threads < 32 or threads > 1024 or threads % 32:
        raise ValueError("threads must be a multiple of 32 in [32, 1024]")
    lib = load("scan1d")
    em_bytes = ops.n_tok * ops.S * ops.SP * 4
    em_in_smem = int(em_bytes + 2 * ops.SP * 4 <= _SMEM_LIMIT)
    out = torch.empty((3, B), dtype=torch.float32, device=dev)
    fn = lib.scan1d_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 5 + [I] * 8 + [P]
    fn.restype = I
    rc = fn(ops.em_pad.data_ptr(), ops.c0_pad.data_ptr(), toks.data_ptr(),
            lens.data_ptr(), out.data_ptr(), B, L, ops.n_tok, ops.S, ops.SP,
            renorm_every, threads, em_in_smem,
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
