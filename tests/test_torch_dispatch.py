"""The port's CompiledMachine.log_forward_batch against the JAX package's.

On the CPU the port routes prot2dna to the plain lowrank version and the
JAX package to its jnp wavefront: two algorithms, so the bound is the
lowrank bound, 5e-3 nats. Full-rank machines take the wavefront engine in
both packages: 1e-4 nats (same algorithm, other summation order).
"""

import json

import numpy as np
import pytest
import torch

from machineboss_tpu.core.machine import Machine as JMachine
from machineboss_tpu.core.presets import make_preset as j_make_preset
from machineboss_tpu.dispatch import CompiledMachine as JCompiled

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.convert import compiled_from_json, \
    lowered_from_numpy
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.dispatch import CompiledMachine
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64

LOWRANK_BOUND = 5e-3
WAVEFRONT_BOUND = 1e-4
_cache = {}


def _prot2dna():
    if "p2d" not in _cache:
        _cache["p2d"] = (JCompiled(j_make_preset("prot2dna")),
                         CompiledMachine(make_preset("prot2dna"),
                                         device="cpu"))
    return _cache["p2d"]


def _pairs(B, lo, hi, seed):
    lens = np.random.RandomState(seed).randint(lo, hi + 1, B)
    return testmachines.prot2dna_pairs(B, lens, seed=seed)


def test_log_forward_batch_matches_jax_and_f64():
    jcm, tcm = _prot2dna()
    pairs = _pairs(8, 3, 8, seed=4)
    port = tcm.log_forward_batch(pairs)
    assert port.shape == (8,) and np.isfinite(port).all()
    np.testing.assert_allclose(port, jcm.log_forward_batch(pairs), rtol=0,
                               atol=LOWRANK_BOUND)
    mats = [np.asarray(x, np.float64) for x in tcm._host_mats()]
    ref = [forward_2d_f64(*mats, tcm.in_toks(i), tcm.out_toks(o))
           for i, o in pairs]
    np.testing.assert_allclose(port, ref, rtol=0, atol=LOWRANK_BOUND)


def test_router_picks_lowrank_for_prot2dna():
    _, tcm = _prot2dna()
    assert tcm.route() == "lowrank"
    assert tcm.lowrank_ratio() < 0.6
    assert tcm.route("wavefront") == "wavefront"


def test_full_rank_cpu_takes_wavefront_like_jax():
    m = testmachines.build_random_transducer(6, list("ACGT"), seed=3)
    tcm = CompiledMachine(m, device="cpu")
    assert tcm.lowrank_ratio() >= 0.6 and tcm.route() == "wavefront"
    jcm = JCompiled(JMachine.from_json(json.loads(m.to_json_str())))
    rng = np.random.RandomState(5)
    pairs = [("".join(rng.choice(list("ACGT"), n)),
              "".join(rng.choice(list("ACGT"), n))) for n in (5, 9, 12)]
    np.testing.assert_allclose(tcm.log_forward_batch(pairs),
                               jcm.log_forward_batch(pairs), rtol=0,
                               atol=WAVEFRONT_BOUND)


def test_bucketed_equals_padded():
    _, tcm = _prot2dna()
    pairs = _pairs(64, 1, 12, seed=6)
    # per-pair arithmetic is the same in every bucket; only the batched
    # matmul shapes differ, which may reorder f32 sums (1e-5 nats)
    np.testing.assert_allclose(tcm.log_forward_batch(pairs, bucket=True),
                               tcm.log_forward_batch(pairs), rtol=0,
                               atol=1e-5)


def _one_d_machine():
    return {"state": [
        {"id": "S", "trans": [{"out": "A", "to": "S", "weight": 0.5},
                              {"out": "C", "to": "S", "weight": 0.3},
                              {"to": "E", "weight": 0.2}]},
        {"id": "E", "trans": []}]}


@pytest.mark.parametrize("branch", ["one_d", "sparse", "full_rank_card"])
def test_unported_routes_raise(branch):
    if branch == "one_d":
        cm = CompiledMachine(_one_d_machine(), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP") as err:
            cm.log_forward_batch([("", "AC")])
        assert "1D" in str(err.value)
    elif branch == "sparse":
        cm = CompiledMachine(make_preset("prot2dna"), device="cpu",
                             dense_max_states=16)
        with pytest.raises(NotImplementedError, match="ROADMAP") as err:
            cm.log_forward_batch([("M", "ATG")])
        assert "non-dense" in str(err.value)
    else:
        cm = CompiledMachine(
            testmachines.build_random_transducer(6, list("ACGT"), seed=3),
            device="cpu")
        # the router decides before touching the card
        cm.device = torch.device("cuda")
        with pytest.raises(NotImplementedError, match="ROADMAP") as err:
            cm.route()
        assert "full-rank" in str(err.value)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        cm = CompiledMachine(make_preset("prot2dna"))
        assert cm.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CompiledMachine(make_preset("prot2dna"))


def test_compiled_from_json_round_trip():
    m = j_make_preset("dnapsw")
    params = {k: v for k, v in json.loads(
        m.get_param_defs(True).to_json_str()).items()}
    params.update({"gapOpen": 0.1, "gapExtend": 0.7, "subAA": 0.7,
                   "subCC": 0.6})
    jcm = JCompiled(m, params)
    tcm = compiled_from_json(m.to_json_str(), json.dumps(params),
                             device="cpu")
    rng = np.random.RandomState(7)
    pairs = [("".join(rng.choice(list("ACGT"), a)),
              "".join(rng.choice(list("ACGT"), b)))
             for a, b in ((4, 6), (9, 7), (12, 12))]
    res = tcm.log_forward_batch(pairs)
    assert np.isfinite(res).all()
    np.testing.assert_allclose(res, jcm.log_forward_batch(pairs), rtol=0,
                               atol=WAVEFRONT_BOUND)


def test_lowered_from_numpy_is_exact():
    jcm, _ = _prot2dna()
    mats = [np.asarray(x) for x in jcm.lowered.matrices_2d()]
    tm = lowered_from_numpy(*mats, device="cpu")
    for a, t in zip(mats, tm):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert np.array_equal(a, t.numpy())
