"""Profile model families: HMMER Plan7, CSV/PSWM profiles, jumping-profile
HMMs (ref src/hmmer.{h,cpp}, src/csv.{h,cpp}, src/jphmm.{h,cpp}).

The Plan7 family scores sequences on-device through the fused
generator(x)transducer engine (ops/fused_plan7.py) — the composite
profile-x-transducer state space is never materialized
(ref python/machineboss/jax/fused_plan7.py).
"""

from ..core.eval import EvaluatedMachine
from ..core.machine import Machine


class Plan7Profile:
    """A HMMER3 profile HMM, ready for machine algebra or fused scoring."""

    def __init__(self, hmm, mode="plan7", local=True, multihit=False,
                 length=400.0):
        from ..core.hmmer import HmmerModel
        self.hmm = hmm if isinstance(hmm, HmmerModel) \
            else HmmerModel.from_file(hmm)
        self.mode = mode
        self.local = local
        self.multihit = multihit
        self.length = length

    def machine(self):
        """The explicit WFST (generator over the profile's alphabet)."""
        if self.mode == "plan7":
            return self.hmm.plan7_machine(multihit=self.multihit,
                                          length=self.length)
        return self.hmm.machine(local=self.local)

    def fused(self, transducer, params=None, device=None):
        """Fused scorer against an observation transducer (e.g. a
        sequencing-error model): profile (x) transducer without composing,
        on `device` (None: the CUDA card; "cpu" for the CPU)."""
        td = transducer if isinstance(transducer, Machine) \
            else Machine.from_file(transducer)
        if params is None:
            params = td.get_param_defs(True)
        from ..ops.fused_plan7 import Plan7Fused
        ev = EvaluatedMachine(td, params)
        return Plan7Fused(self.hmm, ev, mode=self.mode, local=self.local,
                          multihit=self.multihit, length=self.length,
                          device=device)

    def score(self, seqs, transducer=None, params=None, device=None):
        """Forward log-likelihood of each sequence under the profile
        (optionally observed through a transducer). Default transducer is
        the identity (direct emission)."""
        if transducer is None:
            transducer = Machine.wild_echo(list(self.hmm.alph))
        fused = self.fused(transducer, params, device)
        return [fused.forward(list(s)) for s in seqs]


class PSWMProfile:
    """Position-specific weight-matrix generator from CSV
    (ref src/csv.{h,cpp}); merging variant collapses repeated symbols
    (CTC-style, Graves 2006)."""

    def __init__(self, csv_path_or_text):
        from ..core.csvprof import CSVProfile
        text = str(csv_path_or_text)
        if "\n" in text:
            self.prof = CSVProfile()
            self.prof.read(text)
        else:
            self.prof = CSVProfile.from_file(text)

    def machine(self, merging=False):
        return self.prof.merging_machine() if merging \
            else self.prof.machine()


def jphmm_from_fasta(fasta_path):
    """Jumping-profile HMM from a FASTA multiple alignment
    (ref src/jphmm.{h,cpp})."""
    from ..core.fastseq import read_fast_seqs
    from ..core.jphmm import jphmm
    return jphmm(read_fast_seqs(fasta_path))
