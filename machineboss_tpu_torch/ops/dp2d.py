"""Pairwise (2D) DP by rows, on torch.

Counterpart of machineboss_tpu's ops/dp2d.py. The lattice cell(i, o, s)
combines paths consuming input prefix i and emitting output prefix o,
ending in state s:

  cell(i,o) = [ cell(i-1,o-1) (x) A_diag[x_i, y_o]
              (+) cell(i-1,o) (x) A_left[x_i]
              (+) cell(i,o-1) (x) A_up[y_o] ] (x) C

where C is the silent closure. An outer loop runs over output rows and an
inner solver over input positions (O(Li*Lo*S^2) work): the sequential
scan (`assoc=False`, the default fill of
algo/viterbi_device.DeviceViterbiMatrix) or the associative scan over
augmented (S+1, S+1) affine matrices (`assoc=True`: log-depth per row,
semiring matmuls). `backward_2d_lattice` runs the same engine on the
reversed problem; `forward_2d_banded` masks cells outside an envelope.

Token arrays may carry leading batch dimensions ((B, Li) and (B, Lo), with
(B,) lengths): every pair of a batch goes through the same arithmetic.
Padded positions never feed the cells that are read out.

The sequential fill (`assoc=False`) and the banded fill go through
kernels/row_kernel.row_scan: on a CUDA tensor one launch of the
hand-written kernel (csrc/row_scan.cu) for the whole call, on a CPU
tensor the plain versions below (`forward_2d_plain`,
`forward_2d_lattice_plain`, `forward_2d_banded_plain`: the eager loop, one
torch call per step for the whole batch). The associative rows
(`assoc=True`) run the plain versions on either device.
"""

import torch

from .kernels import row_kernel
from .semiring import LOGSUMEXP, NEG_INF, associative_scan


def _e0(S, dtype, sr, device=None, state=0):
    v = torch.full((S,), sr.zero, dtype=dtype, device=device)
    v[state] = sr.one
    return v


def _prepare(left_mats, closure, sr):
    """The row scan's right-hand operands made ready once for all the
    rows of a pair (sr.prepare): each position's left matrix, one by one
    as the scan would, and the closure."""
    return ([None] + [sr.prepare(left_mats[..., i, :, :])
                      for i in range(1, left_mats.shape[-3])],
            sr.prepare(closure))


def _row_scan(u, left_mats, closure, sr, prep=None):
    """Solve f_i = (u_i (+) f_{i-1} (x) left_mats_i) (x) C for all i.

    u: (..., Li+1, S) pre-closure contributions; left_mats: (..., Li+1, S,
    S) where entry 0 is unused; prep: _prepare(left_mats, closure, sr),
    made here when not given. Returns (..., Li+1, S) post-closure cells."""
    left, c = _prepare(left_mats, closure, sr) if prep is None else prep
    f = sr.vecmat_prepared(u[..., 0, :], c)
    rows = [f]
    for i in range(1, u.shape[-2]):
        f = sr.vecmat_prepared(sr.add(u[..., i, :],
                                      sr.vecmat_prepared(f, left[i])), c)
        rows.append(f)
    return torch.stack(rows, dim=-2)


def _row_assoc(u, left_mats, closure, sr, prep=None):
    """Same as _row_scan but via associative affine composition.

    Affine step: f_i = f_{i-1} (x) M_i (+) v_i with M_i = left_i (x) C and
    v_i = u_i (x) C. Compose as (S+1, S+1) matrices [[M, 0], [v, 1]].

    A semiring product loses the terms more than ~80 nats below its row's
    largest in float32, and in the augmented row the constant one stands
    beside v, whose entries sit as far below it as the cells' scores: past
    about -88 nats the JAX package's float32 solver loses them (-1e30). So
    the scan runs in float64, and f0 and every v are shifted by their
    common maximum (exact: f_i moves by the same amount)."""
    S = u.shape[-1]
    dtype = u.dtype
    m = sr.matmul(left_mats[..., 1:, :, :], closure)      # (..., Li, S, S)
    v = sr.vecmat(u[..., 1:, :], closure)                 # (..., Li, S)
    f0 = sr.vecmat(u[..., 0, :], closure)
    if m.shape[-3] == 0:
        return f0[..., None, :]
    wide = torch.float64
    shift = torch.maximum(f0.amax(-1), v.amax((-2, -1)))
    shift = torch.where(shift > NEG_INF / 2, shift,
                        torch.zeros_like(shift)).to(wide)[..., None]
    aug = torch.full(m.shape[:-2] + (S + 1, S + 1), sr.zero, dtype=wide,
                     device=u.device)
    aug[..., :S, :S] = m
    aug[..., S, :S] = v.to(wide) - shift[..., None]
    aug[..., S, S] = sr.one
    prods = associative_scan(sr.matmul, aug, dim=-3)
    f0aug = torch.cat([f0.to(wide) - shift, torch.full(
        f0.shape[:-1] + (1,), sr.one, dtype=wide, device=u.device)], -1)
    rows = sr.vecmat(f0aug[..., None, :], prods)[..., :S] \
        + shift[..., None]                                # (..., Li, S)
    rows = torch.where(rows > NEG_INF / 2, rows, torch.full_like(
        rows, sr.zero)).to(dtype)
    return torch.cat([f0[..., None, :], rows], dim=-2)


def _rows(a_diag, a_left, a_up, closure, in_toks, out_toks, row_solver, sr,
          start_vec=None, n_rows=None):
    """Yield the lattice rows o = 0 .. n_rows-1 (default Lo+1), each
    (..., Li+1, S)."""
    S = closure.shape[-1]
    Li = in_toks.shape[-1]
    dtype, dev = closure.dtype, closure.device
    in_toks = in_toks.long()
    out_toks = out_toks.long()
    batch = in_toks.shape[:-1]

    # pre-gather per-position matrices
    left_mats = torch.cat(
        [torch.full(batch + (1, S, S), sr.zero, dtype=dtype, device=dev),
         a_left[in_toks]], dim=-3)

    prep = _prepare(left_mats, closure, sr) if row_solver is _row_scan \
        else None
    if start_vec is None:
        start_vec = _e0(S, dtype, sr, dev)
    u0 = torch.full(batch + (Li + 1, S), sr.zero, dtype=dtype, device=dev)
    u0[..., 0, :] = start_vec
    row = row_solver(u0, left_mats, closure, sr, prep)
    yield row
    n_rows = out_toks.shape[-1] + 1 if n_rows is None else n_rows
    for o in range(n_rows - 1):
        out_tok = out_toks[..., o]
        u = sr.vecmat(row, a_up[out_tok][..., None, :, :])   # (..., Li+1, S)
        if Li:
            diag = a_diag[in_toks, out_tok[..., None]]       # (..., Li, S, S)
            u = torch.cat([u[..., :1, :],
                           sr.add(u[..., 1:, :],
                                  sr.vecmat(row[..., :-1, :], diag))], -2)
        row = row_solver(u, left_mats, closure, sr, prep)
        yield row


def forward_2d(a_diag, a_left, a_up, closure, in_toks, out_toks,
               in_len, out_len, sr=LOGSUMEXP, assoc=False):
    """Log-likelihood (or Viterbi score) of the (in, out) pair: cell
    (in_len, out_len) at the end state. With (B, Li) and (B, Lo) tokens and
    (B,) lengths, the (B,) scores of a batch, each pair read at its own
    lengths."""
    if assoc:
        return forward_2d_plain(a_diag, a_left, a_up, closure, in_toks,
                                out_toks, in_len, out_len, sr, assoc=True)
    return row_kernel.row_scan(a_diag, a_left, a_up, closure, in_toks,
                               out_toks, sr, lens=(in_len, out_len))


def forward_2d_plain(a_diag, a_left, a_up, closure, in_toks, out_toks,
                     in_len, out_len, sr=LOGSUMEXP, assoc=False):
    """forward_2d by the eager loop, rows computed up to the longest
    out_len."""
    solver = _row_assoc if assoc else _row_scan
    S = closure.shape[-1]
    if in_toks.dim() == 1:
        o_end = int(out_len)
        for o, row in enumerate(_rows(a_diag, a_left, a_up, closure,
                                      in_toks, out_toks, solver, sr,
                                      n_rows=o_end + 1)):
            if o == o_end:
                return row[in_len, S - 1]
    dev = closure.device
    in_len = torch.as_tensor(in_len, device=dev).long()
    out_len = torch.as_tensor(out_len, device=dev).long()
    B = in_toks.shape[0]
    pick = torch.arange(B, device=dev)
    out = torch.full((B,), sr.zero, dtype=closure.dtype, device=dev)
    n_rows = int(out_len.max()) + 1 if B else 1
    for o, row in enumerate(_rows(a_diag, a_left, a_up, closure, in_toks,
                                  out_toks, solver, sr, n_rows=n_rows)):
        out = torch.where(out_len == o, row[pick, in_len, S - 1], out)
    return out


def forward_2d_lattice(a_diag, a_left, a_up, closure, in_toks, out_toks,
                       sr=LOGSUMEXP, assoc=False):
    """The whole lattice, (..., Lo+1, Li+1, S): output rows first."""
    if assoc:
        return forward_2d_lattice_plain(a_diag, a_left, a_up, closure,
                                        in_toks, out_toks, sr, assoc=True)
    return row_kernel.row_scan(a_diag, a_left, a_up, closure, in_toks,
                               out_toks, sr)


def forward_2d_lattice_plain(a_diag, a_left, a_up, closure, in_toks,
                             out_toks, sr=LOGSUMEXP, assoc=False,
                             start_vec=None):
    """forward_2d_lattice by the eager loop; row 0 seeded from `start_vec`
    (None: state 0)."""
    solver = _row_assoc if assoc else _row_scan
    return torch.stack(list(_rows(a_diag, a_left, a_up, closure, in_toks,
                                  out_toks, solver, sr, start_vec=start_vec)),
                       dim=-3)


def backward_2d_lattice(a_diag, a_left, a_up, closure, in_toks, out_toks,
                        sr=LOGSUMEXP, assoc=False):
    """Backward lattice b(o,i,s) = combined weight of all paths from state s
    at lattice position (i,o) to the machine end after the full sequences.

    b satisfies the forward recurrence on the index-reversed problem with
    transposed matrices and the end state as start vector, so it reuses the
    forward engine directly (b includes the same-cell silent closure, like
    the reference BackwardMatrix)."""
    S = closure.shape[-1]
    eN = _e0(S, closure.dtype, sr, closure.device, state=S - 1)
    rev = (a_diag.transpose(-1, -2), a_left.transpose(-1, -2),
           a_up.transpose(-1, -2), closure.transpose(-1, -2),
           in_toks.flip(-1), out_toks.flip(-1))
    if assoc:
        lattice_r = forward_2d_lattice_plain(*rev, sr, assoc=True,
                                             start_vec=eN)
    else:
        lattice_r = row_kernel.row_scan(*rev, sr, start_vec=eN)
    return lattice_r.flip(-3, -2)


def _row_scan_banded(u, prep, sr, in_band):
    """Banded row solver: cells outside the envelope band are forced to the
    semiring zero inside the recurrence, so in-row chains cannot pass
    through them (matching the host's banded DP exactly).

    prep: _prepare(left_mats, closure, sr); in_band: (Li+1,) bool for this
    row."""
    left, c = prep
    zero = torch.full_like(u[0], sr.zero)
    f = torch.where(in_band[0], sr.vecmat_prepared(u[0], c), zero)
    rows = [f]
    for i in range(1, u.shape[0]):
        f = sr.vecmat_prepared(sr.add(u[i], sr.vecmat_prepared(f, left[i])),
                               c)
        f = torch.where(in_band[i], f, zero)
        rows.append(f)
    return torch.stack(rows, dim=0)


def forward_2d_banded(a_diag, a_left, a_up, closure, in_toks, out_toks,
                      in_start, in_end, in_len, out_len, sr=LOGSUMEXP):
    """Envelope-banded 2D Forward (the Envelope of core/seqpair.py lowered
    to per-row masks): cells with i outside [in_start[o], in_end[o]) are
    excluded from every path.

    in_start/in_end: (Lo+1,) int arrays (the envelope rows; for padded rows
    beyond out_len pass [0, Li+1)). As in the JAX package, every row of
    out_toks is filled and the last row is read at in_len."""
    return row_kernel.row_scan(a_diag, a_left, a_up, closure, in_toks,
                               out_toks, sr, lens=(in_len, out_len),
                               band=(in_start, in_end))


def forward_2d_banded_plain(a_diag, a_left, a_up, closure, in_toks,
                            out_toks, in_start, in_end, in_len, out_len,
                            sr=LOGSUMEXP):
    """forward_2d_banded by the eager loop."""
    S = closure.shape[-1]
    Li = in_toks.shape[0]
    dtype, dev = closure.dtype, closure.device
    in_toks = in_toks.long()
    out_toks = out_toks.long()
    i_idx = torch.arange(Li + 1, device=dev)
    in_start = torch.as_tensor(in_start, device=dev)
    in_end = torch.as_tensor(in_end, device=dev)

    left_mats = torch.cat(
        [torch.full((1, S, S), sr.zero, dtype=dtype, device=dev),
         a_left[in_toks]], dim=0)

    def band(o):
        return ((i_idx >= in_start[o]) & (i_idx < in_end[o]))[:, None]

    prep = _prepare(left_mats, closure, sr)
    u0 = torch.full((Li + 1, S), sr.zero, dtype=dtype, device=dev)
    u0[0] = _e0(S, dtype, sr, dev)
    row = _row_scan_banded(u0, prep, sr, band(0))
    for o in range(out_toks.shape[0]):
        out_tok = out_toks[o]
        u = sr.vecmat(row, a_up[out_tok][None])
        if Li:
            diag = a_diag[in_toks, out_tok]
            u = torch.cat([u[:1], sr.add(u[1:],
                                         sr.vecmat(row[:-1], diag))], 0)
        row = _row_scan_banded(u, prep, sr, band(o + 1))
    return row[in_len, S - 1]
