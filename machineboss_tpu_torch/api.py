"""High-level convenience API of the port (counterpart of machineboss_tpu's
api.py; ref: src/api.{h,cpp}, include/machineboss.h).

Free functions mirroring the reference C API surface (host float64
engines: Forward, Viterbi, counts, Baum-Welch, beam and prefix search),
plus the batched device entry points `device_forward_batch`,
`device_counts_batch` and `fused_plan7_forward`, which run on `device`
(None: the CUDA card, raising when CUDA is absent; "cpu" for the CPU).
All machine/params/seq arguments accept either loaded objects or file
paths."""

import json

import torch

from .algo.beam import BeamSearchMatrix, DEFAULT_BEAM_WIDTH
from .algo.counts import MachineCounts
from .algo.ctc import PrefixTree
from .algo.dp_host import RollingForward, ViterbiMatrix
from .algo.fitter import MachineFitter
from .core.eval import EvaluatedMachine
from .core.machine import Machine
from .core.params import Constraints, Params, param_assign_from_json
from .core.seqpair import NamedSeq, SeqPair, SeqPairList


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


def load_machine(path_or_json):
    """Load a machine from a file path or JSON value."""
    return _machine(path_or_json)


def save_machine(machine, path):
    with open(path, "w") as f:
        machine.write_json(f)


def forward_loglike(machine, input_seq, output_seq, params=None):
    """Forward log-likelihood of an (input, output) pair."""
    m = _machine(machine)
    ev = EvaluatedMachine(m, _params(params, m))
    sp = SeqPair(_seq(input_seq), _seq(output_seq))
    return RollingForward(ev, sp).log_like()


def viterbi_loglike(machine, input_seq, output_seq, params=None):
    m = _machine(machine)
    ev = EvaluatedMachine(m, _params(params, m))
    sp = SeqPair(_seq(input_seq), _seq(output_seq))
    return ViterbiMatrix(ev, sp).log_like()


def viterbi_align(machine, input_seq, output_seq, params=None):
    """Most likely alignment path; returns (loglike, MachinePath)."""
    m = _machine(machine)
    ev = EvaluatedMachine(m, _params(params, m))
    sp = SeqPair(_seq(input_seq), _seq(output_seq))
    vit = ViterbiMatrix(ev, sp)
    return vit.log_like(), vit.path(m)


def forward_backward_counts(machine, input_seq, output_seq, params=None):
    """Posterior expected transition counts (E-step) for one pair."""
    m = _machine(machine)
    ev = EvaluatedMachine(m, _params(params, m))
    sp = SeqPair(_seq(input_seq), _seq(output_seq))
    return MachineCounts(ev, sp)


def baum_welch_fit(machine, seq_pairs, constraints=None, seed=None,
                   engine="host", device=None):
    """EM parameter fit over a training set of (input, output) pairs.
    engine="device" runs the E-step batched on `device`."""
    m = _machine(machine)
    if isinstance(seq_pairs, SeqPairList):
        spl = seq_pairs
    else:
        spl = SeqPairList([SeqPair(_seq(i), _seq(o)) for i, o in seq_pairs])
    cons = constraints if isinstance(constraints, Constraints) \
        else (Constraints.from_json(constraints) if constraints
              else Constraints())
    fitter = MachineFitter(machine=m, constraints=cons, engine=engine,
                           device=device)
    fitter.seed = fitter.all_constraints().default_params().combine(
        _params(seed) if seed else fitter.seed, True)
    return fitter.fit(spl)


def beam_decode(machine, output_seq, params=None,
                beam_width=DEFAULT_BEAM_WIDTH):
    """Most likely input for an output, by beam search."""
    m = _machine(machine).decode_sort()
    ev = EvaluatedMachine(m, _params(params, m))
    return BeamSearchMatrix(ev, list(output_seq), beam_width).best_seq()


def beam_encode(machine, input_seq, params=None,
                beam_width=DEFAULT_BEAM_WIDTH):
    """Most likely output for an input, by beam search on the transpose."""
    m = _machine(machine).transpose().advance_sort().advancing_machine() \
                         .decode_sort()
    ev = EvaluatedMachine(m, _params(params, m))
    return BeamSearchMatrix(ev, list(input_seq), beam_width).best_seq()


def prefix_decode(machine, output_seq, params=None, max_backtrack=None):
    """Most likely input, by CTC prefix search."""
    m = _machine(machine)
    ev = EvaluatedMachine(m, _params(params, m))
    return PrefixTree(ev, list(output_seq), max_backtrack).do_prefix_search()


def prefix_encode(machine, input_seq, params=None, max_backtrack=None):
    m = _machine(machine).transpose().advance_sort().advancing_machine()
    ev = EvaluatedMachine(m, _params(params, m))
    return PrefixTree(ev, list(input_seq), max_backtrack).do_prefix_search()


# ---------------------------------------------------------------------------
# batched device API


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


def device_counts_batch(machine, seq_pairs, params=None, mesh=None,
                        device=None):
    """Batched E-step counts on `device`, or data-parallel over `mesh`
    (parallel/mesh.py), as a host MachineCounts."""
    from .parallel.em import device_counts
    m = _machine(machine)
    pairs = SeqPairList([SeqPair(_seq(i), _seq(o)) for i, o in seq_pairs])
    return device_counts(m, _params(params, m), pairs, mesh=mesh,
                         device=device)


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
