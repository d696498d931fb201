"""The port's log-space wavefront engine (ops/wavefront.py) against the JAX
package's, for both semirings.

The same numpy matrices and tokens go through both. Bounds: 2e-3 nats for
LOGSUMEXP (max-shifted float32 matmuls on both sides, summed in another
order) and 1e-5 nats for MAXPLUS (float32 adds and maxes; the closure is
applied per step on both sides).
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.ops import wavefront as wf
from machineboss_tpu_torch.ops.host_oracle import (forward_2d_f64,
                                                   viterbi_2d_f64)
from machineboss_tpu_torch.ops.lowering import LoweredMachine
from machineboss_tpu_torch.ops.semiring import LOGSUMEXP, MAXPLUS

BOUND = {"logsumexp": 2e-3, "maxplus": 1e-5}
SEMIRINGS = {"logsumexp": LOGSUMEXP, "maxplus": MAXPLUS}
MACHINES = {
    "allclass": lambda: testmachines.build_allclass_transducer(5, list("AC")),
    "indel": lambda: testmachines.build_indel_transducer(6, list("ACGT")),
    "dense8": lambda: testmachines.build_random_transducer(8, list("ACGT"),
                                                           seed=15),
}
_cache = {}


def _case(name, sr_name):
    key = (name, sr_name)
    if key not in _cache:
        m = MACHINES[name]()
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        mats = tuple(np.asarray(x) for x in LoweredMachine(
            ev, dtype=np.float32).matrices_2d(sr_name))
        rng = np.random.RandomState(11)
        B, Li, Lo = 4, 7, 6
        it = rng.randint(0, mats[1].shape[0], (B, Li)).astype(np.int32)
        ot = rng.randint(0, mats[2].shape[0], (B, Lo)).astype(np.int32)
        il = np.array([Li, 3, 0, Li], np.int32)
        ol = np.array([Lo, Lo, 2, 0], np.int32)
        if name == "dense8":            # diag only: equal lengths score
            il = np.array([6, 3, 0, 5], np.int32)
            ol = il.copy()
        _cache[key] = (mats, it, ot, il, ol)
    return _cache[key]


def _jax_sr(sr_name):
    from machineboss_tpu.ops import semiring as jsr
    return jsr.LOGSUMEXP if sr_name == "logsumexp" else jsr.MAXPLUS


def _close(a, b, bound):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.array_equal(a > -1e29, b > -1e29)
    live = a > -1e29
    if live.any():
        assert np.abs(a[live] - b[live]).max() <= bound


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
@pytest.mark.parametrize("name", list(MACHINES))
def test_wavefront_2d_diagonals_matches_jax(name, sr_name):
    import jax.numpy as jnp
    from machineboss_tpu.ops.wavefront import wavefront_2d_diagonals as j_diag
    mats, it, ot, _, _ = _case(name, sr_name)
    ref = np.asarray(j_diag(*[jnp.array(x) for x in mats], jnp.array(it),
                            jnp.array(ot), sr=_jax_sr(sr_name)))
    got = wf.wavefront_2d_diagonals(
        *[torch.from_numpy(x) for x in mats], torch.from_numpy(it),
        torch.from_numpy(ot), sr=SEMIRINGS[sr_name])
    assert got.shape == (it.shape[1] + ot.shape[1] + 1, it.shape[0],
                         it.shape[1] + 1, mats[3].shape[0])
    _close(got.numpy(), ref, BOUND[sr_name])


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
@pytest.mark.parametrize("name", list(MACHINES))
def test_forward_2d_wavefront_matches_jax_and_f64(name, sr_name):
    import jax.numpy as jnp
    from machineboss_tpu.ops.wavefront import forward_2d_wavefront as j_fwd
    mats, it, ot, il, ol = _case(name, sr_name)
    ref = np.asarray(j_fwd(*[jnp.array(x) for x in mats], jnp.array(it),
                           jnp.array(ot), jnp.array(il), jnp.array(ol),
                           sr=_jax_sr(sr_name)))
    got = wf.forward_2d_wavefront(
        *[torch.from_numpy(x) for x in mats],
        *[torch.from_numpy(x) for x in (it, ot, il, ol)],
        sr=SEMIRINGS[sr_name]).numpy()
    _close(got, ref, BOUND[sr_name])
    oracle = forward_2d_f64 if sr_name == "logsumexp" else viterbi_2d_f64
    m64 = [x.astype(np.float64) for x in mats]
    f64 = np.array([oracle(*m64, it[b][:il[b]], ot[b][:ol[b]])
                    for b in range(len(il))])
    _close(got, np.maximum(f64, -1e30), 2e-3)


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_readout_is_the_diagonals_final_cell(sr_name):
    mats, it, ot, il, ol = _case("allclass", sr_name)
    t = [torch.from_numpy(x) for x in mats]
    diags = wf.wavefront_2d_diagonals(*t, torch.from_numpy(it),
                                      torch.from_numpy(ot),
                                      sr=SEMIRINGS[sr_name])
    res = wf.forward_2d_wavefront(
        *t, *[torch.from_numpy(x) for x in (it, ot, il, ol)],
        sr=SEMIRINGS[sr_name])
    lat = wf.lattice_from_diagonals(diags, it.shape[1], ot.shape[1])
    for b in range(len(il)):
        assert lat[b, il[b], ol[b], -1] == res[b].item()


def test_lattice_from_diagonals_equals_jax():
    from machineboss_tpu.ops.wavefront import lattice_from_diagonals as j_lat
    rng = np.random.RandomState(0)
    Li, Lo, B, S = 5, 3, 2, 4
    diags = rng.randn(Li + Lo + 1, B, Li + 3, S).astype(np.float32)
    ours = wf.lattice_from_diagonals(torch.from_numpy(diags), Li, Lo)
    assert ours.shape == (B, Li + 1, Lo + 1, S)
    assert np.array_equal(ours, j_lat(diags, Li, Lo))
    assert np.array_equal(wf.lattice_from_diagonals(diags, Li, Lo), ours)
    assert ours[1, 2, 3, 0] == diags[5, 1, 2, 0]


def test_one_empty_alphabet_scores():
    """A generator has no input alphabet: its left and diag classes have no
    token and contribute nothing."""
    m = testmachines.build_generator_1d(5)
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    mats = tuple(np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).matrices_2d())
    assert mats[1].shape[0] == 0
    rng = np.random.RandomState(2)
    ot = rng.randint(0, 4, (3, 9)).astype(np.int32)
    ol = np.array([9, 4, 0], np.int32)
    it = np.zeros((3, 1), np.int32)
    il = np.zeros(3, np.int32)
    got = wf.forward_2d_wavefront(
        *[torch.from_numpy(x) for x in mats],
        *[torch.from_numpy(x) for x in (it, ot, il, ol)]).numpy()
    m64 = [x.astype(np.float64) for x in mats]
    f64 = np.array([forward_2d_f64(*m64, it[b][:0], ot[b][:ol[b]])
                    for b in range(3)])
    _close(got, f64, 2e-3)
