"""The port's copied host layer equals the JAX package's exactly.

machineboss_tpu_torch keeps its own copies of the numpy-only modules
(core/*, ops/lowering.py, ops/host_oracle.py, the lowrank host prep). On
the same machine they must give bit-identical arrays (np.array_equal): the
copies change only import paths, so any difference is a copying fault.
"""

import dataclasses
import json

import numpy as np
import pytest

from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
from machineboss_tpu.core.presets import make_preset as j_make_preset
from machineboss_tpu.ops.host_oracle import forward_2d_f64 as j_f64
from machineboss_tpu.ops.lowering import LoweredMachine as JLowered
from machineboss_tpu.ops.pallas.lowrank_kernel import (
    lowrank_cost_ratio as j_ratio, prepare_lowrank as j_prepare)

from machineboss_tpu_torch.core.eval import EvaluatedMachine as TEvaluated
from machineboss_tpu_torch.core.presets import make_preset as t_make_preset
from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64 as t_f64
from machineboss_tpu_torch.ops.kernels.lowrank_kernel import (
    lowrank_cost_ratio as t_ratio, prepare_lowrank as t_prepare)
from machineboss_tpu_torch.ops.lowering import LoweredMachine as TLowered
from machineboss_tpu_torch import testmachines

MACHINES = ["prot2dna", "allclass", "dense8"]
_cache = {}


def _machines(name):
    """(JAX package machine, port machine) built by each package's own
    code from the same seeds."""
    if name not in _cache:
        if name == "prot2dna":
            pair = (j_make_preset("prot2dna"), t_make_preset("prot2dna"))
        elif name == "allclass":
            from test_pallas_kernel import build_allclass_transducer
            pair = (build_allclass_transducer(5, list("AC")),
                    testmachines.build_allclass_transducer(5, list("AC")))
        else:
            from bench import build_random_transducer
            pair = (build_random_transducer(8, list("ACGT"), seed=15),
                    testmachines.build_random_transducer(8, list("ACGT"),
                                                         seed=15))
        _cache[name] = pair
    return _cache[name]


def _mats(name):
    key = ("mats", name)
    if key not in _cache:
        jm, tm = _machines(name)
        jl = JLowered(JEvaluated(jm, jm.get_param_defs(True)),
                      dtype=np.float32)
        tl = TLowered(TEvaluated(tm, tm.get_param_defs(True)),
                      dtype=np.float32)
        _cache[key] = ([np.asarray(x) for x in jl.matrices_2d()],
                       [np.asarray(x) for x in tl.matrices_2d()])
    return _cache[key]


@pytest.mark.parametrize("name", MACHINES)
def test_machine_json_equal(name):
    jm, tm = _machines(name)
    assert json.loads(jm.to_json_str()) == json.loads(tm.to_json_str())


@pytest.mark.parametrize("name", MACHINES)
def test_matrices_2d_equal(name):
    jmats, tmats = _mats(name)
    for a, b in zip(jmats, tmats):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", MACHINES)
def test_prepare_lowrank_equal(name):
    jmats, tmats = _mats(name)
    jplan, jm = j_prepare(*jmats)
    tplan, tm = t_prepare(*tmats)
    assert jplan["Sa"] == tplan["Sa"]
    assert np.array_equal(jplan["idx"], tplan["idx"])
    assert np.array_equal(jplan["c0"], tplan["c0"])
    assert [dataclasses.astuple(c) for c in jplan["classes"]] == \
        [dataclasses.astuple(c) for c in tplan["classes"]]
    assert len(jm) == len(tm)
    for (jM, jE), (tM, tE) in zip(jm, tm):
        assert np.array_equal(jM, tM) and np.array_equal(jE, tE)
    if name == "prot2dna":
        # the plan the main path runs: 132 states pruned to 100, a rank-2
        # source-side up class and a rank-1 destination-side left class
        assert tplan["Sa"] == 100
        assert [dataclasses.astuple(c) for c in tplan["classes"]] == [
            ("up", "src", 2, 4, False), ("left", "dest", 1, 20, True)]
        assert tm[0][0].shape == (100, 200) and tm[1][0].shape == (100, 100)


@pytest.mark.parametrize("name", MACHINES)
def test_lowrank_cost_ratio_equal(name):
    jmats, tmats = _mats(name)
    jr = j_ratio(*jmats)[0]
    tr = t_ratio(*tmats)[0]
    assert jr == tr
    if name == "prot2dna":
        assert tr < 0.6


@pytest.mark.parametrize("name", MACHINES)
def test_forward_2d_f64_equal(name):
    jmats, tmats = _mats(name)
    n_in, n_out = tmats[1].shape[0], tmats[2].shape[0]
    rng = np.random.RandomState(3)
    for li, lo in ((4, 12), (7, 5), (0, 3)):
        it = rng.randint(0, n_in, li)
        ot = rng.randint(0, n_out, lo)
        assert j_f64(*jmats, it, ot) == t_f64(*tmats, it, ot)
