"""High-level convenience API of the port (counterpart of machineboss_tpu's
api.py): the batched device entry points `device_forward_batch` and
`fused_plan7_forward`. The host entry points and `device_counts_batch` are
not ported yet (ROADMAP.md queue A, items 5 and 9)."""

import json

import torch

from .core.eval import EvaluatedMachine
from .core.machine import Machine
from .core.params import Params, param_assign_from_json
from .core.seqpair import NamedSeq, SeqPair


def _machine(m):
    if isinstance(m, Machine):
        return m
    if isinstance(m, dict):
        return Machine.from_json(m)
    return Machine.from_file(m)


def _params(p, machine=None, use_defaults=True):
    if isinstance(p, dict):
        p = param_assign_from_json(p)
    elif isinstance(p, str):
        with open(p) as f:
            p = param_assign_from_json(json.load(f))
    if p is None:
        return machine.get_param_defs(use_defaults) if machine is not None \
            else Params()
    if machine is not None:
        # fill in the machine's own defs and constraint defaults; explicit
        # user params win
        p = machine.get_param_defs(use_defaults).combine(p, True)
    return p


def _seq(s):
    if isinstance(s, NamedSeq):
        return s
    if isinstance(s, str):
        return NamedSeq(s, list(s))
    return NamedSeq("seq", list(s))


def device_forward_batch(machine, seq_pairs, params=None, dtype=None,
                         device=None):
    """Batched Forward log-likelihoods on `device` (None: the CUDA card,
    raising when CUDA is absent; "cpu" for the CPU).

    seq_pairs: list of (input_seq, output_seq). The batch goes through one
    call of the row engine (ops/dp2d.forward_2d) with the batch dimension
    written out. Returns a numpy array (B,)."""
    import numpy as np
    from .ops import dp2d
    from .ops.fwdback import tokenize_batch
    from .ops.lowering import LoweredMachine
    from .ops.semiring import LOGSUMEXP
    from .utils.device import resolve_device

    dev = resolve_device(device)
    m = _machine(machine)
    ev = EvaluatedMachine(m, _params(params, m))
    lm = LoweredMachine(ev, dtype=np.float32)
    mats = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in lm.matrices_2d()]
    pairs = [SeqPair(_seq(i), _seq(o)) for i, o in seq_pairs]
    it, ot, il, ol = tokenize_batch(ev, pairs, device=dev)
    return dp2d.forward_2d(*mats, it, ot, il, ol, sr=LOGSUMEXP).cpu().numpy()


def fused_plan7_forward(hmm_path_or_model, transducer, out_seqs,
                        params=None, mode="plan7", local=True,
                        multihit=False, length=400.0, device=None):
    """Forward log-likelihoods of output sequences under (profile HMM
    generator) (x) (transducer), fused: no composite state space.

    hmm_path_or_model: HMMER3 .hmm path or core.hmmer.HmmerModel;
    transducer: machine/file/JSON whose input alphabet covers the HMM's;
    device: None = the CUDA card, or "cpu".
    Returns a list of floats (one per sequence in out_seqs)."""
    from .core.hmmer import HmmerModel
    from .ops.fused_plan7 import Plan7Fused
    hmm = hmm_path_or_model if isinstance(hmm_path_or_model, HmmerModel) \
        else HmmerModel.from_file(hmm_path_or_model)
    td = _machine(transducer)
    ev = EvaluatedMachine(td, _params(params, td))
    fused = Plan7Fused(hmm, ev, mode=mode, local=local, multihit=multihit,
                       length=length, device=device)
    return [fused.forward(list(s)) for s in out_seqs]
