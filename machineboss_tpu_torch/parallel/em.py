"""Distributed EM: the data-parallel E-step with a SUM all_reduce of the
counts (counterpart of machineboss_tpu's parallel/em.py).

Replaces the reference's serial per-seqpair count accumulation
(ref src/counts.cpp:37-71, MachineCounts::operator+=) with a split of the
batch over the 'data' mesh axis: each rank runs the batched
differentiable E-step (ops/fwdback.py) on its block of sequence pairs and
the per-transition count vectors are summed by one all_reduce on the
axis's group. The count vector is O(# transitions) floats, so the
collective is negligible next to the DP. Without a mesh, one device runs
the whole training set in one batched call.
"""

import numpy as np
import torch

from ..algo.counts import MachineCounts
from ..core.eval import EvaluatedMachine
from ..ops.fwdback import CountModel, tokenize_batch
from .mesh import MeshAxis, axis_size, mesh_device


def sharded_counts_fn(model: CountModel, mesh):
    """Build the data-parallel E-step over a mesh with a 'data' axis.

    Returns fn(logw, in_toks, out_toks, in_lens, out_lens, weights=None)
    -> (counts_vector, total_loglike). Every rank passes the same global
    batch (B divisible by the axis size); each scores its block, and the
    returned values are summed over the axis (replicated)."""
    data = MeshAxis(mesh, "data")

    def fn(logw, it, ot, il, ol, weights=None):
        B = it.shape[0]
        if B % data.size:
            raise ValueError("a batch of %d does not split over %d data "
                             "shards" % (B, data.size))
        if weights is None:
            weights = torch.ones((B,), dtype=logw.dtype, device=logw.device)
        blk = data.block(B)
        grads, total, _ = model.counts_and_loglike(
            it[blk], ot[blk], il[blk], ol[blk], logw=logw,
            weights=weights[blk])
        data.all_reduce(grads)
        return grads, data.all_reduce(total.reshape(1))[0]

    return fn


def device_counts(machine, all_params, training_set, envelopes=None,
                  mesh=None, dtype=torch.float32, device=None):
    """Drop-in E-step for MachineFitter(engine='device').

    Computes expected counts for the whole training set on `device` (None:
    the CUDA card, raising when CUDA is absent; "cpu" for the CPU), or
    data-parallel over `mesh` (every rank with the same training set; the
    mesh's device, which `device` may name but not contradict), and
    returns a host MachineCounts. `envelopes` is ignored, as in the JAX
    package: the device E-step fills every cell."""
    if mesh is not None:
        mdev = mesh_device(mesh)
        if device is not None:
            want = torch.device(device)
            if want.type != mdev.type or (want.index is not None
                                          and want.index != mdev.index):
                raise ValueError("device %s disagrees with the mesh's %s"
                                 % (want, mdev))
        device = mdev
    ev = EvaluatedMachine(machine, all_params)
    model = CountModel(ev, dtype=dtype, device=device)
    seq_pairs = list(training_set.seq_pairs)
    it, ot, il, ol = tokenize_batch(ev, seq_pairs, device=model.device)
    if mesh is not None:
        B = len(seq_pairs)
        pad = (-B) % axis_size(mesh, "data")
        weights = torch.ones((B + pad,), dtype=dtype, device=model.device)
        if pad:
            # pad to a shardable batch by repeating leading rows with
            # objective weight 0: the padding pairs run through the DP but
            # contribute nothing to the loglike or (via the gradient) the
            # counts
            rows = torch.arange(pad, device=model.device) % B
            it, ot, il, ol = (torch.cat([x, x[rows]], 0)
                              for x in (it, ot, il, ol))
            weights[B:] = 0.0
        fn = sharded_counts_fn(model, mesh)
        grads, total = fn(model.logw, it, ot, il, ol, weights)
    else:
        grads, total, _ = model.counts_and_loglike(it, ot, il, ol)

    grads = grads.cpu().numpy().astype(np.float64)
    counts = MachineCounts()
    counts.init(ev)
    offset = 0
    for s in range(ev.n_states()):
        n = ev.state[s].n_transitions
        counts.count[s][:] = grads[offset:offset + n]
        offset += n
    counts.loglike = float(total)
    return counts
