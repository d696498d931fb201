"""The row engine of the pairwise DP as one CUDA kernel.

Counterpart of the jitted row scans of machineboss_tpu's ops/dp2d.py
(forward_2d, forward_2d_lattice, backward_2d_lattice and
forward_2d_banded: an outer lax.scan over output rows around an inner
lax.scan over input positions, compiled by XLA into one program, no
pallas_call). `row_scan` is the counted wrapper of csrc/row_scan.cu: a CUDA
tensor launches the kernel once for the whole call (one block a pair) or
raises; a CPU tensor takes the plain version, ops/dp2d.py's eager loop
(forward_2d_plain, forward_2d_lattice_plain, forward_2d_banded_plain).

The kernel's layout comes from `row_launch_plan`, a pure function of the
shape: lanes a destination state in the chain, the closure in shared
memory or read from global memory, the previous and current rows in
shared memory, in a global scratch buffer or (lattice mode) in the
lattice itself, and the shared and device bytes; it refuses only what the
card's memory cannot hold.

No caller differentiates the row engine (the E-step differentiates the
batched wavefront, ops/wavefront_fast.py), so an input that requires grad
raises rather than being detached.
"""

import ctypes

import torch

from ._build import load
from .lowrank_kernel import _check

THREADS = 512        # a block's threads, one block a pair
SMEM_MAX = 232448    # shared bytes a block may take on the H100
MAX_STATES = 512     # dispatch.DENSE_MAX_STATES
_F32 = 4


def _lanes(S):
    """Lanes a destination in the chain: the largest power of two <= 32
    whose groups for all S destinations fit the block's threads."""
    lanes = 1
    while lanes < 32 and 2 * lanes * S <= THREADS:
        lanes *= 2
    return lanes


def row_smem_bytes(S, Li, closure_shared, rows_shared):
    """A block's shared bytes (the kernel's smem_bytes): the two state
    vectors, the closure where shared, the two rows where shared."""
    n = 2 * S
    if closure_shared:
        n += S * S
    if rows_shared:
        n += 2 * (Li + 1) * S
    return n * _F32


def row_launch_plan(S, Li, Lo, B, lattice=False, smem_max=SMEM_MAX,
                    mem_bytes=None, rows=None):
    """The kernel's layout for B pairs padded to Li x Lo over S states.

    Returns a dict: threads, lanes, closure ("shared" where it fits beside
    the two state vectors, else "global"), rows ("shared" where the two
    rows of Li+1 cells fit beside those, else "global"; "lattice" in
    lattice mode; `rows` "global" forces the global rows, for tests),
    smem_bytes, and mem_bytes (the device bytes the call allocates: the
    output and the global row scratch). Raises ValueError past MAX_STATES
    or where mem_bytes exceeds `mem_bytes` (the card's memory; None: not
    checked)."""
    if not 1 <= S <= MAX_STATES:
        raise ValueError("the row kernel takes 1 to %d states, not %d"
                         % (MAX_STATES, S))
    if min(Li, Lo, B) < 0:
        raise ValueError("negative shape (Li=%d, Lo=%d, B=%d)" % (Li, Lo, B))
    if rows not in (None, "global") or (rows and lattice):
        raise ValueError("rows may be forced to 'global' in score mode only")
    closure_shared = row_smem_bytes(S, Li, True, False) <= smem_max
    if lattice:
        rows = "lattice"
    elif rows is None:
        rows = "shared" if row_smem_bytes(S, Li, closure_shared, True) \
            <= smem_max else "global"
    smem = row_smem_bytes(S, Li, closure_shared, rows == "shared")
    row_bytes = (Li + 1) * S * _F32
    out = B * (Lo + 1) * row_bytes if lattice else B * _F32
    mem = out + (2 * B * row_bytes if rows == "global" else 0)
    if mem_bytes is not None and mem > mem_bytes:
        raise ValueError(
            "the row kernel needs %d device bytes for %d pairs of %d x %d "
            "over %d states (%s), past the card's %d"
            % (mem, B, Li, Lo, S, "lattices" if lattice else "rows",
               mem_bytes))
    return {"threads": THREADS, "lanes": _lanes(S),
            "closure": "shared" if closure_shared else "global",
            "rows": rows, "smem_bytes": smem, "mem_bytes": mem}


def row_smem_bytes_on_card(cfg, S, Li):
    """The kernel's own count of a block's shared bytes for `cfg`."""
    return int(load("row_scan").row_scan_smem_bytes(
        ctypes.c_int(S), ctypes.c_int(Li),
        ctypes.c_int(int(cfg["closure"] == "shared")),
        ctypes.c_int(int(cfg["rows"] == "shared"))))


def _as_int32(t, dev):
    return torch.as_tensor(t, device=dev).to(torch.int32).contiguous()


def row_scan(a_diag, a_left, a_up, closure, in_toks, out_toks, sr,
             lens=None, start_vec=None, band=None, rows=None):
    """The row engine of ops/dp2d.py in one call.

    Matrices as lowering.matrices_2d gives them; tokens (Li,) and (Lo,)
    for one pair or (B, Li) and (B, Lo) for a batch. `lens` (in_len,
    out_len): the score cell(in_len, out_len, S-1) of each pair, a 0-dim
    tensor for one pair or (B,); None: the whole lattice, (Lo+1, Li+1, S)
    or (B, Lo+1, Li+1, S), seeded from `start_vec` (None: state 0). `band`
    (in_start, in_end), each (Lo+1,), for one pair: the banded score,
    every row of out_toks filled and read at in_len. `rows`: "global"
    forces row_launch_plan's global rows.

    A CUDA tensor launches csrc/row_scan.cu once (row_launch_plan's
    layout) and counts it in `row_scan.launches`; a failed launch raises.
    A CPU tensor takes the plain version."""
    tensors = [a_diag, a_left, a_up, closure, start_vec]
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError("the row engine has no gradient: its inputs must "
                         "not require grad")
    dev = closure.device
    if dev.type == "cpu":
        from .. import dp2d
        if band is not None:
            return dp2d.forward_2d_banded_plain(
                a_diag, a_left, a_up, closure, in_toks, out_toks, *band,
                *lens, sr=sr)
        if lens is not None:
            return dp2d.forward_2d_plain(a_diag, a_left, a_up, closure,
                                         in_toks, out_toks, *lens, sr=sr)
        return dp2d.forward_2d_lattice_plain(
            a_diag, a_left, a_up, closure, in_toks, out_toks, sr=sr,
            start_vec=start_vec)
    if dev.type != "cuda":
        raise ValueError("row_scan runs on cuda or cpu tensors, not %s" % dev)
    if sr.name not in ("logsumexp", "maxplus"):
        raise ValueError("the row kernel takes the logsumexp and maxplus "
                         "semirings, not %s" % sr.name)
    single = in_toks.dim() == 1
    B = 1 if single else in_toks.shape[0]
    if out_toks.dim() != in_toks.dim() or (not single and
                                           out_toks.shape[0] != B):
        raise ValueError("in_toks %s and out_toks %s are not one pair or "
                         "one batch" % (tuple(in_toks.shape),
                                        tuple(out_toks.shape)))
    Li, Lo = in_toks.shape[-1], out_toks.shape[-1]
    it = _as_int32(in_toks, dev).reshape(B, Li)
    ot = _as_int32(out_toks, dev).reshape(B, Lo)
    S = closure.shape[-1]
    n_in, n_out = a_left.shape[0], a_up.shape[0]
    # backward_2d_lattice hands over transposed views
    a_diag, a_left, a_up, closure = (m.contiguous() for m in
                                     (a_diag, a_left, a_up, closure))
    _check(a_diag, "a_diag", torch.float32, (n_in, n_out, S, S), dev)
    _check(a_left, "a_left", torch.float32, (n_in, S, S), dev)
    _check(a_up, "a_up", torch.float32, (n_out, S, S), dev)
    _check(closure, "closure", torch.float32, (S, S), dev)
    if start_vec is None:
        start_vec = torch.full((S,), sr.zero, dtype=torch.float32, device=dev)
        start_vec[0] = sr.one
    _check(start_vec, "start_vec", torch.float32, (S,), dev)
    lattice = lens is None
    if band is not None:
        if not single or lattice:
            raise ValueError("the banded call takes one pair's score")
        band = torch.stack([_as_int32(b, dev).reshape(-1) for b in band])
        _check(band, "band", torch.int32, (2, Lo + 1), dev)
        # every row of out_toks is filled and the last read at in_len
        lens = (lens[0], Lo)
    if not lattice:
        in_lens = _as_int32(lens[0], dev).reshape(-1)
        out_lens = _as_int32(lens[1], dev).reshape(-1)
        _check(in_lens, "in_len", torch.int32, (B,), dev)
        _check(out_lens, "out_len", torch.int32, (B,), dev)
    cfg = row_launch_plan(S, Li, Lo, B, lattice, rows=rows,
                          mem_bytes=torch.cuda.get_device_properties(dev)
                          .total_memory)
    if lattice:
        out = torch.empty((B, Lo + 1, Li + 1, S), dtype=torch.float32,
                          device=dev)
    else:
        out = torch.empty((B,), dtype=torch.float32, device=dev)
    rows = torch.empty((B, 2, Li + 1, S), dtype=torch.float32, device=dev) \
        if cfg["rows"] == "global" else None
    fn = load("row_scan").row_scan_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 12 + [I] * 11 + [P]
    fn.restype = I
    rc = fn(a_diag.data_ptr(), a_left.data_ptr(), a_up.data_ptr(),
            closure.data_ptr(), start_vec.data_ptr(), it.data_ptr(),
            ot.data_ptr(), None if lattice else in_lens.data_ptr(),
            None if lattice else out_lens.data_ptr(),
            None if band is None else band.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), B, Li, Lo, S, n_in,
            n_out, cfg["lanes"], int(cfg["closure"] == "shared"),
            int(cfg["rows"] == "shared"), int(sr.name == "maxplus"),
            int(lattice), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("row_scan launch failed: CUDA error %d" % rc)
    row_scan.launches += 1
    return out[0] if single else out


row_scan.launches = 0
