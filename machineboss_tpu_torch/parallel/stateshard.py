"""State-sharded semiring operations: the tensor-parallel axis
(counterpart of machineboss_tpu's parallel/stateshard.py).

For very large compositions the (S, S) transfer matrices dominate memory
and matmul time; shard them column-wise over the 'state' mesh axis. A
forward step f' = f (x) M then computes each rank's output block locally
from the replicated input vector and finishes with one all_gather of the
(S/n)-sized pieces, in mesh order: ordinary sharded matmul in the
(logsumexp, +) semiring.

Deliberate difference: the JAX function carries the absolute log vector
through the scan; this one subtracts the vector's maximum every
RENORM_EVERY steps and sums those shifts in float64 at the end, since an
absolute float32 log value loses about |LL| * eps a step
(ops/dp1d.forward_1d_scan keeps a Kahan-compensated scale for the same
reason). Every rank holds the whole vector after the gather, so every
rank takes the same shifts.
"""

import torch

from ..ops.semiring import LOGSUMEXP, NEG_INF
from .mesh import MeshAxis, mesh_device

# steps between two shifts of the vector: it then stays within some tens
# of nats of 0, where float32 resolves 1e-6, and the shift's four launches
# are paid once every 16 tokens
RENORM_EVERY = 16


def state_sharded_scan_fn(mesh, sr=LOGSUMEXP, axis="state"):
    """Build fn(trans, closure, toks, length) -> the final state vector's
    last entry (the log-likelihood), replicated, with the per-token
    transfer matrices column-sharded over `axis`.

    `sr` is a log semiring (LOGSUMEXP or MAXPLUS: the vector is shifted
    by its maximum each step). trans (T, S, S) and closure (S, S) are
    passed whole (replicated) and
    each rank takes its column block (S divisible by the axis size); toks
    (L,); steps at positions >= length keep the vector."""
    ax = MeshAxis(mesh, axis)
    dev = mesh_device(mesh)

    def gather(f_local):
        return ax.all_gather(f_local).reshape(-1)             # tiled

    def fn(trans, closure, toks, length):
        trans = torch.as_tensor(trans, device=dev)
        closure = torch.as_tensor(closure, device=dev)
        # host token ids: a step's blocks are views, and a CUDA scalar index
        # would copy to the host (a sync) every step
        toks = torch.as_tensor(toks).long().tolist()
        S = closure.shape[0]
        if S % ax.size:
            raise ValueError("%d states do not split over %d '%s' shards"
                             % (S, ax.size, axis))
        cols = ax.block(S)
        # the column blocks made ready for products once, not each step
        # (LOGSUMEXP's shifted exponentials and shifts)
        prep = sr.prepare(trans[:, :, cols])
        e0 = torch.full((S,), sr.zero, dtype=trans.dtype, device=dev)
        e0[0] = sr.one
        f = gather(sr.vecmat(e0, closure[:, cols]))
        steps = toks[:int(length)]
        shifts = torch.zeros(-(-len(steps) // RENORM_EVERY),
                             dtype=torch.float64, device=dev)
        for pos, tok in enumerate(steps):
            f = gather(sr.vecmat_prepared(
                f, tuple(p[tok] for p in prep) if isinstance(prep, tuple)
                else prep[tok]))
            if (pos + 1) % RENORM_EVERY == 0:
                norm = f.max()
                norm = torch.where(norm > NEG_INF / 2, norm, 0.0)
                f = f - norm
                shifts[pos // RENORM_EVERY] = norm
        return (f[S - 1].double() + shifts.sum()).to(trans.dtype)

    return fn
