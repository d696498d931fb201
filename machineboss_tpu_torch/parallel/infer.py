"""Data-parallel batched inference: Forward log-likelihoods over a mesh
(counterpart of machineboss_tpu's parallel/infer.py).

The serving-side counterpart of parallel/em.py: the machine's lowered
tensors are replicated on every rank and the (padded) seqpair batch is
split over the 'data' mesh axis; each rank runs the scaled-probability 2D
wavefront (ops/wavefront_fast.py) on its block and the per-pair
log-likelihoods are all-gathered in mesh order. One call scores B pairs
on N devices at N-way throughput.

No reference counterpart (the reference is single-process, SURVEY.md
§2.5).
"""

import numpy as np
import torch

from .mesh import MeshAxis, axis_size, mesh_device


def sharded_forward_fn(lowered, mesh):
    """Build the data-parallel batched Forward.

    lowered: ops.lowering.LoweredMachine (dense 2D). Returns
    fn(in_toks (B,Li), out_toks (B,Lo), in_lens, out_lens) -> (B,)
    log-likelihoods on the mesh's device, every rank passing the same
    batch, with B divisible by the 'data' axis size (pad with repeated
    pairs and slice, as forward_batch_sharded does, when it is not)."""
    from ..ops.wavefront_fast import forward_2d_wavefront_fast

    dev = mesh_device(mesh)
    data = MeshAxis(mesh, "data")
    mats = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in lowered.matrices_2d())

    def fn(it, ot, il, ol):
        B = it.shape[0]
        if B % data.size:
            raise ValueError("a batch of %d does not split over %d data "
                             "shards" % (B, data.size))
        blk = data.block(B)
        local = forward_2d_wavefront_fast(
            *mats, *(torch.as_tensor(x[blk], device=dev)
                     for x in (it, ot, il, ol)))
        return data.all_gather(local).reshape(B)

    return fn


def forward_batch_sharded(ev, seq_pairs, mesh, dtype=torch.float32):
    """Score tokenizable SeqPairs data-parallel over `mesh` ('data'
    axis). Returns a numpy (B,) array aligned with seq_pairs."""
    from ..ops.lowering import LoweredMachine
    from ..ops.fwdback import tokenize_batch

    lm = LoweredMachine(ev, dtype=torch.empty((), dtype=dtype).numpy()
                        .dtype.type)
    it, ot, il, ol = tokenize_batch(ev, list(seq_pairs),
                                    device=mesh_device(mesh))
    B = it.shape[0]
    pad = (-B) % axis_size(mesh, "data")
    if pad:
        it, ot, il, ol = (torch.cat([x] + [x[-1:]] * pad, 0)
                          for x in (it, ot, il, ol))
    fn = sharded_forward_fn(lm, mesh)
    return fn(it, ot, il, ol).cpu().numpy()[:B]
