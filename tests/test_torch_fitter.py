"""EM training in the port: MachineFitter(engine="device") with the E-step
of parallel/em.device_counts against the host fit, checkpoint and resume,
and the api entry points against the JAX package's api.

A device fit (float32 counts by autograd) and a host fit (float64
Forward-Backward) from the same seed must give every parameter within
1e-3, the tolerance of tests/test_device_counts.py::test_device_em_fit:
on tkf91branch at a fixed branch length (its two rates), on the casino
(four probabilities) and on two prot2dna pairs with flanking DNA (21
norm groups: codon usage and the flanks' base composition, and three
probabilities). The host entries of api.py are the JAX package's
host engines, copied: their results must be equal, and the device entry
device_counts_batch within the count tolerance. This file imports the JAX
package only inside its JAX tests.
"""

import json
import os

import numpy as np
import pytest

from machineboss_tpu_torch import api, testmachines
from machineboss_tpu_torch.algo.fitter import MachineFitter
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.core.params import param_assign_from_json
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair, SeqPairList
from machineboss_tpu_torch.models import casino

from one_thread import one_torch_thread  # noqa: F401

FIT_TOL = 1e-3                   # per parameter, device fit vs host fit
ROLLS = ["154233314562365566666655661521246", "66666666666666",
         "123456123456"]


def _sp(i, o):
    return SeqPair(NamedSeq("i", list(i)), NamedSeq("o", list(o)))


def _evolved_pairs(n, L, seed):
    """n (ancestor, descendant) DNA pairs: random ancestors of L bases,
    each base deleted (8%), substituted (20%) or followed by an inserted
    base (5%)."""
    rng = np.random.RandomState(seed)
    acgt = list("ACGT")
    pairs = []
    for _ in range(n):
        anc = "".join(rng.choice(acgt, L))
        desc = []
        for c in anc:
            if rng.rand() < 0.08:
                continue
            desc.append(rng.choice(acgt) if rng.rand() < 0.2 else c)
            if rng.rand() < 0.05:
                desc.append(rng.choice(acgt))
        pairs.append((anc, "".join(desc)))
    return pairs


def _fit_case(name):
    """(machine, constraints, seed Params, SeqPairList, max_iterations)."""
    if name == "tkf91branch":
        return (make_preset("tkf91branch"), None,
                param_assign_from_json({"insRate": 0.1, "delRate": 0.2,
                                        "time": 0.5}),
                SeqPairList([_sp(a, d) for a, d in _evolved_pairs(6, 16, 5)]),
                1000)
    if name == "casino":
        return (casino.casino_machine(parameterized=True),
                casino.casino_constraints(),
                param_assign_from_json(casino.DEFAULTS),
                SeqPairList([_sp("", r) for r in ROLLS]), 1000)
    m = make_preset("prot2dna")
    pairs = testmachines.prot2dna_pairs(2, 8, seed=3, synonymous=True,
                                        flank=4)
    return (m, None, m.get_param_defs(True),
            SeqPairList([_sp(p, d) for p, d in pairs]), 2)


def _values(params):
    return {k: float(params.defs[k]) for k in params.defs}


@pytest.mark.parametrize("name", ["tkf91branch", "casino", "prot2dna"])
def test_device_fit_matches_host_fit(name):
    m, cons, seed, spl, iters = _fit_case(name)
    host = MachineFitter(machine=m, constraints=cons, seed=seed) \
        .fit(spl, max_iterations=iters)
    dev = MachineFitter(machine=m, constraints=cons, seed=seed,
                        engine="device", device="cpu") \
        .fit(spl, max_iterations=iters)
    want, got = _values(host), _values(dev)
    assert want.keys() == got.keys()
    moved = [k for k in want if k in seed.defs
             and abs(want[k] - float(seed.defs[k])) > 1e-3]
    assert moved, "the fit left every parameter at its seed"
    for k in want:
        assert abs(want[k] - got[k]) < FIT_TOL, (k, want[k], got[k])


def test_device_fit_checkpoint_resume_equals_uninterrupted(tmp_path):
    """A device fit stopped after one iteration and resumed from its
    checkpoint by a fresh fitter equals the uninterrupted device fit, to
    the JSON round trip's noise (the bound of
    tests/test_fitter_checkpoint.py)."""
    m, cons, seed, spl, _ = _fit_case("tkf91branch")

    def fitter(ck=None):
        return MachineFitter(machine=m, constraints=cons, seed=seed,
                             engine="device", device="cpu",
                             checkpoint_path=ck)

    full = fitter().fit(spl)
    ck = str(tmp_path / "em.ckpt.json")
    fitter(ck).fit(spl, max_iterations=1)
    with open(ck) as f:
        state = json.load(f)
    assert state["iteration"] == 1 and np.isfinite(state["loglike"])
    resumed = fitter(ck).fit(spl)
    with open(ck) as f:
        assert json.load(f)["iteration"] > 1
    assert not os.path.exists(ck + ".tmp")
    want, got = _values(full), _values(resumed)
    for k in want:
        assert abs(want[k] - got[k]) < 1e-12, (k, want[k], got[k])


def test_device_fit_without_a_device_runs_on_the_card():
    """engine="device" with device=None is the CUDA card: without CUDA the
    first E-step raises, with it the fit runs there."""
    import torch
    m, cons, seed, spl, _ = _fit_case("casino")
    fitter = MachineFitter(machine=m, constraints=cons, seed=seed,
                           engine="device")
    if torch.cuda.is_available():
        assert set(_values(fitter.fit(spl, max_iterations=1))) == \
            set(_values(seed))
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        fitter.fit(spl, max_iterations=1)


# ---- api.py against the JAX package's api


def _jax_api():
    from machineboss_tpu import api as japi
    return japi


def _jax_machine(m):
    from machineboss_tpu.core.machine import Machine as JMachine
    return JMachine.from_json(json.loads(m.to_json_str()))


def test_load_and_save_machine_equal_the_jax_api(tmp_path):
    japi = _jax_api()
    m = make_preset("tkf91branch")
    path = str(tmp_path / "m.json")
    with open(path, "w") as f:
        f.write(m.to_json_str())
    ours, theirs = api.load_machine(path), japi.load_machine(path)
    assert isinstance(ours, Machine)
    api.save_machine(ours, str(tmp_path / "ours.json"))
    japi.save_machine(theirs, str(tmp_path / "theirs.json"))
    with open(tmp_path / "ours.json") as a, open(tmp_path / "theirs.json") \
            as b:
        assert a.read() == b.read()
    assert api.load_machine(json.loads(m.to_json_str())).to_json_str() == \
        m.to_json_str()


SCORE_CASES = [("tkf91branch", "ACGTAC", "ACGGTC",
                {"insRate": 0.1, "delRate": 0.2, "time": 0.5}),
               ("jukescantor", "ACGT", "ACGA", {"t": 0.3})]


@pytest.mark.parametrize("name,x,y,params", SCORE_CASES)
def test_host_scoring_entries_equal_the_jax_api(name, x, y, params):
    japi = _jax_api()
    m = make_preset(name)
    jm = _jax_machine(m)
    assert api.forward_loglike(m, x, y, params) == \
        japi.forward_loglike(jm, x, y, params)
    assert api.viterbi_loglike(m, x, y, params) == \
        japi.viterbi_loglike(jm, x, y, params)
    ll, path = api.viterbi_align(m, x, y, params)
    jll, jpath = japi.viterbi_align(jm, x, y, params)
    assert ll == jll
    assert [(t.in_, t.out, t.dest) for t in path.trans] == \
        [(t.in_, t.out, t.dest) for t in jpath.trans]
    ours = api.forward_backward_counts(m, x, y, params)
    theirs = japi.forward_backward_counts(jm, x, y, params)
    assert ours.loglike == theirs.loglike
    for a, b in zip(ours.count, theirs.count):
        assert np.array_equal(a, b)


def test_baum_welch_fit_host_equals_the_jax_api():
    japi = _jax_api()
    m = casino.casino_machine(parameterized=True)
    data = [("", r) for r in ROLLS]
    cons = {"prob": ["pEnd", "changeToLoadedDie", "changeToFairDie",
                     "loadedP6"]}
    ours = api.baum_welch_fit(m, data, constraints=cons,
                              seed=dict(casino.DEFAULTS))
    theirs = japi.baum_welch_fit(_jax_machine(m), data, constraints=cons,
                                 seed=dict(casino.DEFAULTS))
    assert _values(ours) == {k: float(theirs.defs[k]) for k in theirs.defs}


def test_baum_welch_fit_device_matches_host():
    m = casino.casino_machine(parameterized=True)
    data = [("", r) for r in ROLLS]
    kw = dict(constraints=casino.casino_constraints(),
              seed=dict(casino.DEFAULTS))
    host = _values(api.baum_welch_fit(m, data, **kw))
    dev = _values(api.baum_welch_fit(m, data, engine="device",
                                     device="cpu", **kw))
    for k in host:
        assert abs(host[k] - dev[k]) < FIT_TOL, k


SEARCH_CASES = [("jukescantor", fn, seq, seq) for seq in ("ACGTTA", "GGCA")
                for fn in ("beam_decode", "beam_encode", "prefix_decode",
                           "prefix_encode")] + \
    [("merging", "beam_decode", "AABBA", "ABA"),
     ("merging", "prefix_decode", "AABBA", "ABA"),
     ("merging", "beam_encode", "AB", "AB")]


@pytest.mark.parametrize("machine,fn,seq,want", SEARCH_CASES)
def test_beam_and_prefix_search_equal_the_jax_api(machine, fn, seq, want):
    from machineboss_tpu_torch.models.ctc import merging_machine
    japi = _jax_api()
    if machine == "jukescantor":
        m, params = make_preset(machine), {"t": 0.3}
    else:
        m, params = merging_machine("AB"), None
    got = getattr(api, fn)(m, seq, params)
    assert got == getattr(japi, fn)(_jax_machine(m), seq, params)
    assert got == list(want)


def test_device_counts_batch_matches_the_jax_api():
    japi = _jax_api()
    m = make_preset("jukescantor")
    pairs = [("ACGT", "ACGA"), ("GGTA", "GCTA"), ("C", "C")]
    ours = api.device_counts_batch(m, pairs, params={"t": 0.3},
                                   device="cpu")
    theirs = japi.device_counts_batch(_jax_machine(m), pairs,
                                      params={"t": 0.3})
    assert abs(ours.loglike - theirs.loglike) < 1e-3
    for a, b in zip(ours.count, theirs.count):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    # mesh=: a world of one on the CPU, started in process and destroyed
    import torch.distributed as dist
    from machineboss_tpu_torch.parallel.mesh import make_mesh
    assert not dist.is_initialized()
    try:
        meshed = api.device_counts_batch(m, pairs, params={"t": 0.3},
                                         mesh=make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
    assert meshed.loglike == ours.loglike
    for a, b in zip(meshed.count, ours.count):
        assert np.array_equal(a, b)
