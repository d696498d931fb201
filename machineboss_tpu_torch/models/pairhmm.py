"""Pairwise-alignment model families.

Covers the reference's pairwise workloads (BASELINE.json workloads #3/#4):
  - dnapsw / protpsw: affine-gap pair HMMs over DNA / protein (BLOSUM62)
    (ref js/dnapsw.js, js/protpsw.js via preset generation)
  - prot2dna / psw2dna: GeneWise-style protein-to-DNA aligners — the
    protein PSW composed with a translate/frameshift machine
    (ref Makefile:228-232 preset composition)

Each family exposes the machine, plus host alignment and batched-device
scoring helpers. Device scoring auto-picks the wavefront kernel on the
CUDA card (dispatch.CompiledMachine); `device` names where it runs (None:
the card; "cpu" for the CPU).
"""

from ..core.presets import make_preset
from ..core.eval import EvaluatedMachine

FAMILIES = {
    "dnapsw": "DNA pairwise aligner (affine gaps)",
    "protpsw": "protein pairwise aligner (BLOSUM62, affine gaps)",
    "prot2dna": "GeneWise protein-to-DNA aligner (with introns)",
    "psw2dna": "GeneWise protein-PSW-to-DNA aligner",
    "dnapswnbr": "DNA pairwise aligner, neighbor-dependent",
}


class PairModel:
    """A ready-to-use pairwise aligner: host align + device batch score."""

    def __init__(self, family="protpsw", params=None, device=None):
        if family not in FAMILIES:
            raise ValueError("unknown pair family %r (have %s)"
                             % (family, sorted(FAMILIES)))
        self.family = family
        self.machine = make_preset(family)
        self.params = params if params is not None \
            else self.machine.get_param_defs(True)
        self.device = device
        self._compiled = None

    def ev(self):
        return EvaluatedMachine(self.machine, self.params)

    def align(self, input_seq, output_seq):
        """Viterbi alignment; returns (loglike, MachinePath)."""
        from .. import api
        return api.viterbi_align(self.machine, input_seq, output_seq,
                                 params=self.params)

    def loglike(self, input_seq, output_seq):
        from .. import api
        return api.forward_loglike(self.machine, input_seq, output_seq,
                                   params=self.params)

    def compiled(self):
        """Auto-dispatching device engine (cached)."""
        if self._compiled is None:
            from ..dispatch import CompiledMachine
            self._compiled = CompiledMachine(self.machine, self.params,
                                             device=self.device)
        return self._compiled

    def score_batch(self, pairs):
        """Batched device Forward over [(input, output), ...] pairs."""
        cm = self.compiled()
        return cm.log_forward_batch([(list(i), list(o)) for i, o in pairs])


def align(family, input_seq, output_seq, params=None):
    return PairModel(family, params).align(input_seq, output_seq)


def score_batch(family, pairs, params=None, device=None):
    return PairModel(family, params, device).score_batch(pairs)
