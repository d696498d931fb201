"""The port's model families (machineboss_tpu_torch/models/) against the
JAX package's (machineboss_tpu/models/): each case of tests/test_models.py
run through both packages, which must agree (host engines: exactly; device
engines on the CPU: at the engines' own tolerance). The device entries take
device="cpu" here; device=None is the card. This file imports the JAX
package only inside its tests.
"""

import json
import math

import numpy as np
import pytest

from machineboss_tpu_torch import api, testmachines
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.models import casino, ctc, pairhmm, profile, tkf91

ROLLS = "154233314562365566666655661521246"
VS_JAX = 1e-4                    # nats: device engines, same algorithm
FIT_TOL = 1e-3                   # per parameter, device fit vs host fit
CSV = "A,C,G,T\n0.7,0.1,0.1,0.1\n0.6,0.2,0.1,0.1\n0.1,0.1,0.1,0.7\n"


def _jax():
    from machineboss_tpu import api as japi
    from machineboss_tpu import models as jmodels
    return japi, jmodels


def _values(p):
    return {k: float(p.defs[k]) for k in p.defs}


def test_casino_fixed_vs_parameterized_default():
    japi, jm = _jax()
    ll_fix = api.forward_loglike(casino.casino_machine(False), "", ROLLS)
    ll_par = api.forward_loglike(casino.casino_machine(True), "", ROLLS,
                                 params=casino.DEFAULTS)
    assert math.isfinite(ll_fix) and abs(ll_fix - ll_par) < 1e-6
    assert ll_fix == japi.forward_loglike(jm.casino.casino_machine(False),
                                          "", ROLLS)
    assert ll_par == japi.forward_loglike(jm.casino.casino_machine(True),
                                          "", ROLLS, params=casino.DEFAULTS)
    assert casino.casino_machine(True).to_json_str() == \
        jm.casino.casino_machine(True).to_json_str()


def test_casino_decode_names():
    _, jm = _jax()
    ll, names = casino.decode("666666666")
    assert math.isfinite(ll) and "Loaded" in names
    assert set(names) <= {"Fair", "Loaded", "End"}
    assert (ll, names) == jm.casino.decode("666666666")


def test_casino_fit_improves_loglike():
    """The host fit equals the JAX package's; the device fit (engine
    "device" on the CPU) is within 1e-3 of it and improves the
    likelihood too."""
    _, jm = _jax()
    m = casino.casino_machine(parameterized=True)
    data = [ROLLS, "66666666666666", "123456123456"]
    ll0 = sum(api.forward_loglike(m, "", r, params=casino.DEFAULTS)
              for r in data)
    fitted = casino.fit(data)
    assert _values(fitted) == _values(jm.casino.fit(data))
    dev = casino.fit(data, engine="device", device="cpu")
    for k, v in _values(fitted).items():
        assert abs(_values(dev)[k] - v) < FIT_TOL, k
    for p in (fitted, dev):
        ll1 = sum(api.forward_loglike(m, "", r, params=p) for r in data)
        assert ll1 >= ll0 - 1e-9


def test_pairhmm_align_and_device_score():
    _, jm = _jax()
    pm = pairhmm.PairModel("dnapsw", device="cpu")
    jpm = jm.pairhmm.PairModel("dnapsw")
    ll, path = pm.align("ACGTACGT", "ACGAACGT")
    jll, jpath = jpm.align("ACGTACGT", "ACGAACGT")
    assert ll == jll and math.isfinite(ll)
    assert path.input_sequence() == list("ACGTACGT")
    assert [(t.in_, t.out, t.dest) for t in path.trans] == \
        [(t.in_, t.out, t.dest) for t in jpath.trans]
    pairs = [("ACGT", "ACGA"), ("ACGTA", "ACG")]
    host = [pm.loglike(*p) for p in pairs]
    assert host == [jpm.loglike(*p) for p in pairs]
    dev = pm.score_batch(pairs)
    assert pm.compiled().device.type == "cpu"
    np.testing.assert_allclose(np.array(dev), np.array(host), atol=1e-2)
    np.testing.assert_allclose(np.array(dev),
                               np.array(jpm.score_batch(pairs)), atol=VS_JAX)
    np.testing.assert_allclose(
        pairhmm.score_batch("dnapsw", pairs, device="cpu"), dev, atol=0)


def test_ctc_model_decode_and_sample():
    _, jm = _jax()
    model, jmodel = ctc.CTCModel(CSV), jm.ctc.CTCModel(CSV)
    seq, ll = model.decode()
    assert math.isfinite(ll) and "".join(seq) == "AT"
    assert (seq, ll) == jmodel.decode()
    samples = model.sample(5, seed=1)
    assert len(samples) == 5 and samples == jmodel.sample(5, seed=1)


def test_ctc_merging_machine_collapses_repeats():
    _, jm = _jax()
    m = ctc.merging_machine("AB")
    assert m.to_json_str() == jm.ctc.merging_machine("AB").to_json_str()
    ll = api.forward_loglike(m, "AB", "AAB")
    assert math.isfinite(ll)
    ll_bad = api.forward_loglike(m, "AB", "ABA")
    assert ll_bad == -math.inf or ll_bad < -1e29


def test_ctc_fit_error_model_device_matches_host():
    """fit_error_model's device E-step (on the CPU here) against the host
    fit of the same error transducer (jukescantor's branch length)."""
    from machineboss_tpu_torch.core.presets import make_preset
    m = make_preset("jukescantor")
    reads = [("ACGTACGTAA", "ACGTACCTAA"), ("GGCATT", "GGCATA"),
             ("TTAGC", "TTAGC")]
    seed = {"t": 0.5}
    host = ctc.fit_error_model(m, reads, None, seed=seed, engine="host")
    dev = ctc.fit_error_model(m, reads, None, seed=seed, device="cpu")
    assert abs(_values(host)["t"] - 0.5) > 1e-3
    for k, v in _values(host).items():
        assert abs(_values(dev)[k] - v) < FIT_TOL, k


def test_tkf91_root_and_descendant_loglike():
    japi, jm = _jax()
    params = tkf91.tkf91_params(0.5, 1.0, t=0.2)
    jparams = jm.tkf91.tkf91_params(0.5, 1.0, t=0.2)
    ll_root = api.forward_loglike(tkf91.root_machine(), "", "ACGT",
                                  params=params)
    assert math.isfinite(ll_root)
    assert ll_root == japi.forward_loglike(jm.tkf91.root_machine(), "",
                                           "ACGT", params=jparams)
    desc = tkf91.pair_machine()
    ll_desc = api.forward_loglike(desc, "", "ACG", params=params)
    assert math.isfinite(ll_desc)
    assert ll_desc == japi.forward_loglike(jm.tkf91.pair_machine(), "",
                                           "ACG", params=jparams)
    with pytest.raises(ValueError):
        tkf91.tkf91_params(1.0, 0.5)


def test_profile_pswm_machine():
    _, jm = _jax()
    csv = "A,C\n0.9,0.1\n0.2,0.8\n"
    m = profile.PSWMProfile(csv).machine()
    ll = api.forward_loglike(m, "", "AC")
    assert abs(ll - math.log(0.9 * 0.8)) < 1e-6
    assert m.to_json_str() == jm.profile.PSWMProfile(csv).machine() \
        .to_json_str()
    assert profile.PSWMProfile(csv).machine(merging=True).to_json_str() == \
        jm.profile.PSWMProfile(csv).machine(merging=True).to_json_str()


def test_profile_plan7_score_matches_jax(tmp_path):
    """Plan7Profile.score through the fused engine on the CPU, the toy
    profile seen directly and through the toy noise transducer."""
    _, jm = _jax()
    path = tmp_path / "toy.hmm"
    path.write_text(testmachines.TOY_HMM_TEXT)
    seqs = ["ACG", "GATTACA"]
    prof = profile.Plan7Profile(str(path), length=10.0)
    jprof = jm.profile.Plan7Profile(str(path), length=10.0)
    assert prof.machine().to_json_str() == jprof.machine().to_json_str()
    td = Machine.from_json(testmachines.TOY_TD_JSON)
    from machineboss_tpu.core.machine import Machine as JMachine
    jtd = JMachine.from_json(json.loads(td.to_json_str()))
    for ours, theirs in ((prof.score(seqs, device="cpu"), jprof.score(seqs)),
                         (prof.score(seqs, td, device="cpu"),
                          jprof.score(seqs, jtd))):
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours, theirs, atol=VS_JAX)
    assert prof.fused(td, device="cpu").device.type == "cpu"


def test_profile_jphmm_from_fasta(tmp_path):
    _, jm = _jax()
    path = tmp_path / "aln.fa"
    path.write_text(">a\nACGT\n>b\nACCT\n>c\nAGGT\n")
    m = profile.jphmm_from_fasta(str(path))
    assert m.to_json_str() == \
        jm.profile.jphmm_from_fasta(str(path)).to_json_str()
    ll = api.forward_loglike(m, "", "ACGT", params={"jump": 0.1})
    assert math.isfinite(ll)
