"""The E-step for MachineFitter(engine='device') (counterpart of
machineboss_tpu's parallel/em.py).

One device runs the batched differentiable E-step (ops/fwdback.py) on the
whole training set and the count vector comes back to a host
MachineCounts in float64. The data-parallel form, shards of the pairs with
the count vectors summed across devices (`sharded_counts_fn`, `mesh=`),
waits for parallel/* on torch.distributed (ROADMAP.md queue A, item 8).
"""

import numpy as np
import torch

from ..algo.counts import MachineCounts
from ..core.eval import EvaluatedMachine
from ..ops.fwdback import CountModel, tokenize_batch


def device_counts(machine, all_params, training_set, envelopes=None,
                  mesh=None, dtype=torch.float32, device=None):
    """Drop-in E-step for MachineFitter(engine='device').

    Computes expected counts for the whole training set in one batched
    call on `device` (None: the CUDA card, raising when CUDA is absent;
    "cpu" for the CPU) and returns a host MachineCounts. `envelopes` is
    ignored, as in the JAX package: the device E-step fills every cell."""
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel E-step (mesh=) is not ported: it comes with "
            "parallel/* on torch.distributed, ROADMAP.md queue A item 8")
    ev = EvaluatedMachine(machine, all_params)
    model = CountModel(ev, dtype=dtype, device=device)
    seq_pairs = list(training_set.seq_pairs)
    it, ot, il, ol = tokenize_batch(ev, seq_pairs, device=model.device)
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
