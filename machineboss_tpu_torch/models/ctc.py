"""CTC / basecaller model family (nanopore-style; BASELINE.json workload #5).

A CTC model is (per-position profile generator) composed with a merging
machine that collapses repeated symbols (Graves 2006; ref src/csv.h:23,
examples/nanopore_test.csv). Decoding the most likely label sequence uses
the prefix-search tree (ref src/ctc.{h,cpp}); training uses Baum-Welch EM.
"""

from ..core.machine import Machine
from ..core.eval import EvaluatedMachine


class CTCModel:
    """CTC basecaller: profile-over-observations + repeat-merging labels."""

    def __init__(self, csv_path_or_text):
        from .profile import PSWMProfile
        self.profile = PSWMProfile(csv_path_or_text)
        # input side = label sequence, output side = per-position profile
        self.machine = self.profile.machine(merging=True)
        self.params = self.machine.get_param_defs(True)

    def _transposed_tree(self, max_backtrack=None):
        # the merging machine is a generator whose OUTPUT is the merged
        # label sequence; searching its most likely output = prefix search
        # on the transpose with an empty target (api.prefix_encode shape)
        from ..algo.ctc import PrefixTree
        m = self.machine.transpose().advance_sort().advancing_machine()
        ev = EvaluatedMachine(m, self.params)
        return PrefixTree(ev, [], max_backtrack)

    def decode(self, max_backtrack=None):
        """Most likely merged label sequence, by CTC prefix search
        (host tree; ref src/ctc.cpp best-first search).

        Returns (label list, log probability)."""
        tree = self._transposed_tree(max_backtrack)
        seq = tree.do_prefix_search()
        return seq, tree.best_log_seq_prob

    def sample(self, n_samples, seed=0):
        """Posterior label-sequence sampling (ref src/ctc.cpp:142-176)."""
        import random
        tree = self._transposed_tree()
        rng = random.Random(seed)
        return [tree.sample_seq(rng) for _ in range(n_samples)]


def merging_machine(alphabet):
    """Standalone repeat-collapsing transducer over an alphabet: input is
    the label sequence, output repeats each label >= 1 times."""
    states = []
    syms = list(alphabet)
    first = {"id": "S", "trans":
             [{"in": s, "out": s, "to": "R%s" % s, "weight": 1}
              for s in syms] + [{"to": "End", "weight": 1}]}
    states.append(first)
    for s in syms:
        states.append({"id": "R%s" % s, "trans":
                       [{"out": s, "to": "R%s" % s, "weight": 1}]
                       + [{"in": t, "out": t, "to": "R%s" % t, "weight": 1}
                          for t in syms]
                       + [{"to": "End", "weight": 1}]})
    states.append({"id": "End", "trans": []})
    return Machine.from_json({"state": states})


def fit_error_model(error_machine, read_pairs, constraints, seed=None,
                    engine="device", device=None):
    """EM-fit a parameterized sequencing-error transducer to
    (true sequence, read) pairs — the nanopore training workload. The
    device E-step runs on `device` (None: the CUDA card; "cpu" for the
    CPU)."""
    from .. import api
    return api.baum_welch_fit(error_machine, read_pairs,
                              constraints=constraints, seed=seed,
                              engine=engine, device=device)
