"""The port's Plan7Fused (ops/fused_plan7.py): its row solvers against each
other, the float64 oracles and the JAX class, and the api entry point.

The second half of tests/test_torch_fused_plan7.py (which holds the
helpers, the bounds and the rest), split off so that pytest-xdist's
`--dist loadfile` gives the two halves to two workers. Bounds: 1e-4 nats
against the JAX class, 5e-3 against the float64 composed-machine oracle,
1e-4 against the float64 product-graph Viterbi oracle, 2e-3 between the
doubling and the prefix-product solvers.
"""

import numpy as np
import pytest

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import ViterbiMatrix
from machineboss_tpu_torch.algo.fused_align import FusedViterbiAligner
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.ops.fused_plan7 import Plan7Fused

from test_torch_fused_plan7 import (COMBOS, IDS, VS_F64, VS_JAX, generator,
                                    models, oracle, pair, toy_reads)


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_forward_matches_composed_oracle(combo):
    """The float64 composed-machine Forward on the toy, by the port's own
    host engine."""
    mode, local, multihit = combo
    _, (th, _, tev) = models("toy")
    tf = Plan7Fused(th, tev, mode=mode, local=local, multihit=multihit,
                    length=10.0, n_hit=4, device="cpu")
    gen = generator("toy", mode, local, multihit)
    for seq in ("ACG", "TTACGACGTT", "A"):
        want = oracle("toy", gen, seq)
        got = tf.forward(list(seq))
        if want == -np.inf:
            assert got < -1e20, (seq, got)
        else:
            assert abs(got - want) <= VS_F64, (seq, want, got)


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_scan_solver_matches_prefix(combo):
    """The log-depth doubling and the prefix-product matrix solve the same
    recurrence; on the 19-node profile the doubling has 5 levels."""
    mode, local, multihit = combo
    _, (th, _, tev) = models("amino19")
    cfg = dict(mode=mode, local=local, multihit=multihit, device="cpu")
    f_scan = Plan7Fused(th, tev, solver="scan", **cfg)
    f_pref = Plan7Fused(th, tev, solver="prefix", **cfg)
    assert len(f_scan._j["t_tri"]) == 1
    for seq in ("ACDEFGHIKLMNPQRSTVWYACDEFG", "WYV"):
        a, b = f_scan.forward(seq), f_pref.forward(seq)
        assert abs(a - b) <= 2e-3, (seq, a, b)
    assert len(f_scan._scan_levels) == 5
    reads = testmachines.plan7_reads(testmachines.AMINO, 4, 12, seed=1)
    a = f_scan.forward_batch(reads)                 # auto: the per-read one
    b = f_pref.forward_batch(reads, impl="vmap")
    assert np.abs(a - b).max() <= 2e-3
    with pytest.raises(ValueError, match="prefix"):
        f_scan.forward_batch(reads, impl="flat")


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_flat_and_vmap_match_jax(combo):
    """The batch-major flat solver and the per-read solver over a batch,
    each against the JAX class's, and flat against vmap (multihit differs
    by the per-read solver's n_hit truncation: flat can only be higher)."""
    mode, local, multihit = combo
    jf, tf = pair("toy", flat=True, mode=mode, local=local,
                  multihit=multihit, length=10.0, solver="prefix")
    reads = toy_reads(0, 10)
    flat = tf.forward_batch(reads, impl="flat")
    vmap = tf.forward_batch(reads, impl="vmap")
    assert np.abs(flat - jf.forward_batch(reads, impl="flat")).max() <= VS_JAX
    assert np.abs(vmap - jf.forward_batch(reads, impl="vmap")).max() <= VS_JAX
    assert np.array_equal(tf.forward_batch(reads), flat)   # auto
    tol = 1e-3 if multihit else 1e-5
    assert np.abs(flat - vmap).max() < tol
    if multihit:
        assert (flat >= vmap - 1e-5).all()
    gen = generator("toy", mode, local, multihit)
    for n in (0, 3, 7):
        want = oracle("toy", gen, "".join(reads[n]))
        assert abs(flat[n] - want) <= VS_F64, n
    single = tf.forward(reads[2])
    assert abs(vmap[2] - single) <= 1e-5


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_maxplus_matches_jax_and_the_product_graph_oracle(combo):
    """Fused Viterbi: the per-read and the flat solver against the JAX
    class, the float64 product-graph oracle (the port's copy of
    algo/fused_align.py), and the sandwich
    vit_fused <= vit_composed <= fwd_fused."""
    mode, local, multihit = combo
    _, (th, td, tev) = models("toy")
    jf, tf = pair("toy", flat=True, mode=mode, local=local,
                  multihit=multihit, length=10.0, n_hit=4,
                  semiring="maxplus")
    assert tf.viterbi and not tf.prob_space
    fwd = Plan7Fused(th, tev, mode=mode, local=local, multihit=multihit,
                     length=10.0, n_hit=4, device="cpu")
    gen = generator("toy", mode, local, multihit)
    aligner = FusedViterbiAligner(gen, td)
    seqs = ("A", "ACG", "TTACGACGTT", "GT")
    flat = tf.forward_batch([list(s) for s in seqs], impl="flat")
    for n, seq in enumerate(seqs):
        got = tf.forward(list(seq))
        assert abs(got - jf.forward(list(seq))) <= VS_JAX, seq
        want = aligner.score(seq)
        if want == -np.inf:
            assert got < -1e20 and flat[n] < -1e20, seq
            continue
        assert abs(got - want) <= 1e-4, (seq, want, got)
        assert abs(flat[n] - want) <= 1e-4, (seq, want, flat[n])
        comp_v = oracle("toy", gen, seq, ViterbiMatrix)
        assert got <= comp_v + 1e-4, seq
        assert comp_v <= fwd.forward(list(seq)) + VS_F64, seq


def test_api_fused_plan7_forward(tmp_path):
    from machineboss_tpu.api import fused_plan7_forward as j_api
    from machineboss_tpu_torch.api import fused_plan7_forward as t_api
    path = tmp_path / "toy.hmm"
    path.write_text(testmachines.TOY_HMM_TEXT)
    seqs = ["ACG", "GATTACA"]
    for multihit in (False, True):
        want = j_api(str(path), testmachines.TOY_TD_JSON, seqs,
                     multihit=multihit, length=10.0)
        got = t_api(str(path), testmachines.TOY_TD_JSON, seqs,
                    multihit=multihit, length=10.0, device="cpu")
        assert np.abs(np.array(got) - np.array(want)).max() <= VS_JAX
    th = models("toy")[1][0]
    by_path = t_api(str(path), testmachines.TOY_TD_JSON, ["ACG"],
                    length=10.0, device="cpu")
    by_model = t_api(th, Machine.from_json(testmachines.TOY_TD_JSON), ["ACG"],
                     length=10.0, device="cpu")
    assert by_model == by_path
