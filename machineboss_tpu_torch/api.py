"""High-level convenience API of the port (counterpart of machineboss_tpu's
api.py). Only the fused Plan7 entry point is ported so far; the other device
entry points are still to come."""

import json

from .core.eval import EvaluatedMachine
from .core.machine import Machine
from .core.params import Params, param_assign_from_json


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
