"""The port's CompiledMachine.log_forward_batch against the JAX package's.

On the CPU, with engine="auto", both packages take their wavefront
engine for every dense 2D machine, structured (prot2dna) or full-rank:
1e-4 nats (same algorithm, other summation order). With
engine="kernel" the port takes its kernel routes (their plain versions on
the CPU): merged, chained_ragged and the 1D scan, each within 2e-3 nats of
the JAX package's log_forward_batch on the same pairs.
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
from machineboss_tpu_torch.ops.kernels.wavefront_kernel import ragged_span

LOWRANK_BOUND = 5e-3
WAVEFRONT_BOUND = 1e-4
KERNEL_ROUTE_BOUND = 2e-3
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
    assert tcm.last_route == "wavefront"
    assert port.shape == (8,) and np.isfinite(port).all()
    np.testing.assert_allclose(port, jcm.log_forward_batch(pairs), rtol=0,
                               atol=WAVEFRONT_BOUND)
    mats = [np.asarray(x, np.float64) for x in tcm._host_mats()]
    ref = [forward_2d_f64(*mats, tcm.in_toks(i), tcm.out_toks(o))
           for i, o in pairs]
    np.testing.assert_allclose(port, ref, rtol=0, atol=LOWRANK_BOUND)


def test_router_picks_lowrank_for_prot2dna():
    """The lowrank route is the card's (and engine="kernel"'s) for
    prot2dna; engine="auto" on the CPU takes the wavefront engine, as the
    JAX class does off its accelerator."""
    _, tcm = _prot2dna()
    assert tcm.route() == "wavefront"
    assert tcm.route("kernel") == "lowrank"
    assert tcm.lowrank_ratio() < 0.6
    assert tcm.route("wavefront") == "wavefront"
    on_card = CompiledMachine(make_preset("prot2dna"), device="cpu")
    on_card.device = torch.device("cuda")   # decided before any launch
    assert on_card.route() == "lowrank"


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


def _one_d_machine(side="out"):
    return {"state": [
        {"id": "S", "trans": [{side: "A", "to": "S", "weight": 0.5},
                              {side: "C", "to": "T", "weight": 0.3},
                              {"to": "E", "weight": 0.2}]},
        {"id": "T", "trans": [{side: "A", "to": "S", "weight": 0.6},
                              {side: "C", "to": "T", "weight": 0.1},
                              {"to": "E", "weight": 0.3}]},
        {"id": "E", "trans": []}]}


@pytest.mark.parametrize("branch", ["one_d", "sparse", "full_rank_card"])
def test_unported_routes_raise(branch):
    """Only the non-dense route is still unported; the 1D route and the
    full-rank route on the card, which used to raise, now score."""
    if branch == "one_d":
        cm = CompiledMachine(_one_d_machine(), device="cpu")
        res = cm.log_forward_batch([("", "AC")])
        assert cm.last_route == "scan"
        assert res[0] == pytest.approx(np.log(0.5 * 0.3 * 0.3), abs=1e-5)
    elif branch == "sparse":
        cm = CompiledMachine(make_preset("prot2dna"), device="cpu",
                             dense_max_states=16)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue A, item 7") as err:
            cm.log_forward_batch([("M", "ATG")])
        assert "non-dense" in str(err.value)
    else:
        cm = CompiledMachine(
            testmachines.build_random_transducer(6, list("ACGT"), seed=3),
            device="cpu")
        # the router decides before touching the card
        cm.device = torch.device("cuda")
        assert cm.route() == "fullrank"


def _dense6():
    if "dense6" not in _cache:
        m = testmachines.build_random_transducer(6, list("ACGT"), seed=3)
        _cache["dense6"] = (
            JCompiled(JMachine.from_json(json.loads(m.to_json_str()))),
            CompiledMachine(m, device="cpu"))
    return _cache["dense6"]


def _acgt_pairs(lens, seed):
    rng = np.random.RandomState(seed)
    return [("".join(rng.choice(list("ACGT"), n)),
             "".join(rng.choice(list("ACGT"), n))) for n in lens]


@pytest.mark.parametrize("batch,route", [
    ("uniform", "merged"), ("ragged_b6", "merged"),
    ("ragged_b8", "chained_ragged"), ("ragged_b8_empty", "merged")])
def test_full_rank_kernel_route(batch, route):
    """engine="kernel" on the CPU drives the full-rank router: merged on a
    uniform batch, on a ragged batch with B % 8 != 0 and on one with an
    empty sequence; chained_ragged on a ragged batch of 8."""
    jcm, tcm = _dense6()
    lens = {"uniform": [9] * 8, "ragged_b6": [5, 9, 12, 7, 9, 11],
            "ragged_b8": [5, 9, 12, 7, 9, 11, 6, 10],
            "ragged_b8_empty": [5, 9, 12, 0, 9, 11, 6, 10]}[batch]
    pairs = _acgt_pairs(lens, seed=len(lens) + lens[3])
    # the ragged schedule's cache key carries the chain length and the
    # span of the sorted schedule, rounded up to 64, as the JAX router's
    ragged_key = ("chained_ragged", 8,
                  -(-ragged_span(lens, lens, 8) // 64) * 64) \
        if route == "chained_ragged" else (None, None, None)
    for engine in ("kernel", "pallas"):
        res = tcm.log_forward_batch(pairs, engine=engine)
        assert tcm.last_route == route
        assert ("kernel", len(lens), 16, 16) + ragged_key in tcm._cache
    np.testing.assert_allclose(res, jcm.log_forward_batch(pairs), rtol=0,
                               atol=KERNEL_ROUTE_BOUND)
    mats = [np.asarray(x, np.float64) for x in tcm._host_mats()]
    ref = [forward_2d_f64(*mats, tcm.in_toks(i), tcm.out_toks(o))
           for i, o in pairs]
    np.testing.assert_allclose(res, ref, rtol=0, atol=KERNEL_ROUTE_BOUND)
    # the default engine keeps full-rank machines on the wavefront engine
    # off the card, as the JAX package does
    tcm.log_forward_batch(pairs)
    assert tcm.last_route == "wavefront"


def test_kernel_engine_keeps_structured_machines_on_lowrank():
    _, tcm = _prot2dna()
    assert tcm.route("kernel") == "lowrank" and tcm.route("pallas") == "lowrank"
    tcm.log_forward_batch(_pairs(2, 3, 5, seed=1), engine="kernel")
    assert tcm.last_route == "lowrank"
    with pytest.raises(ValueError, match="engine must be"):
        tcm.route("mosaic")


@pytest.mark.parametrize("engine", ["auto", "kernel"])
@pytest.mark.parametrize("side", ["in", "out"])
def test_one_d_machines_take_the_1d_route(side, engine):
    """An input-empty and an output-empty machine through
    log_forward_batch, against the JAX package's: the sequential scan with
    engine="auto" off the card, the 1D kernel route with "kernel"."""
    js = _one_d_machine(side)
    tcm = CompiledMachine(js, device="cpu")
    jcm = JCompiled(JMachine.from_json(js))
    rng = np.random.RandomState(3)
    seqs = ["".join(rng.choice(list("AC"), n)) for n in (0, 1, 7, 30, 18)]
    pairs = [("", q) if side == "out" else (q, "") for q in seqs]
    res = tcm.log_forward_batch(pairs, engine=engine)
    assert tcm.last_route == ("scan" if engine == "auto" else "scan1d")
    assert res.shape == (5,) and np.isfinite(res).all()
    np.testing.assert_allclose(res, jcm.log_forward_batch(pairs), rtol=0,
                               atol=KERNEL_ROUTE_BOUND)
    # engine="wavefront" keeps a 1D machine on the 2D wavefront engine
    wf = tcm.log_forward_batch(pairs, engine="wavefront")
    assert tcm.last_route == "wavefront"
    np.testing.assert_allclose(wf, res, rtol=0, atol=KERNEL_ROUTE_BOUND)
    with pytest.raises(ValueError, match="engine must be"):
        tcm.log_forward_batch(pairs, engine="mosaic")


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
