"""The port's routed 1D engine (ops/dp1d.py) against the JAX package's.

forward_1d_scan and make_batched, Forward and Viterbi, on the same
matrices and tokens: float32 with the same order of operations, 1e-5 nats
relative to the score's size (a log-likelihood of -80 carries 8e-6 of f32
rounding by itself). A float64 loop bounds both at 1e-4 nats.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from machineboss_tpu.ops import dp1d as jd
from machineboss_tpu.ops import semiring as js
from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.ops import dp1d as td
from machineboss_tpu_torch.ops import semiring as ts
from machineboss_tpu_torch.ops.lowering import LoweredMachine

TOL = 1e-5
SEMIRINGS = {"logsumexp": (js.LOGSUMEXP, ts.LOGSUMEXP),
             "maxplus": (js.MAXPLUS, ts.MAXPLUS)}
_cache = {}


def _mats(sr_name):
    if sr_name not in _cache:
        m = testmachines.build_generator_1d(6, seed=5)
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        lm = LoweredMachine(ev, dtype=np.float32)
        _cache[sr_name] = tuple(np.asarray(x) for x in lm.emit_matrices_1d(
            output_side=True, semiring=sr_name))
    return _cache[sr_name]


def _batch(B=5, L=37, seed=3):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 4, (B, L)).astype(np.int32)
    lens = np.array([L, 0, 1, 20, 33], np.int32)[:B]
    return toks, lens


def _close(port, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(port, np.float64), ref, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_start_vector(sr_name):
    jsr, tsr = SEMIRINGS[sr_name]
    _, closure = _mats(sr_name)
    S = closure.shape[0]
    _close(td._start_vector(S, torch.from_numpy(closure), tsr,
                            torch.float32).numpy(),
           jd._start_vector(S, jnp.array(closure), jsr, jnp.float32))


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_forward_1d_scan_single(sr_name):
    jsr, tsr = SEMIRINGS[sr_name]
    trans, closure = _mats(sr_name)
    toks, lens = _batch()
    for b in range(len(lens)):
        got = td.forward_1d_scan(torch.from_numpy(trans),
                                 torch.from_numpy(closure),
                                 torch.from_numpy(toks[b]), int(lens[b]),
                                 sr=tsr)
        assert got.shape == ()
        _close(got.numpy(), jd.forward_1d_scan(
            jnp.array(trans), jnp.array(closure), jnp.array(toks[b]),
            int(lens[b]), sr=jsr))


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_make_batched_matches_jax(sr_name):
    jsr, tsr = SEMIRINGS[sr_name]
    trans, closure = _mats(sr_name)
    toks, lens = _batch()
    got = td.make_batched(td.forward_1d_scan, sr=tsr)(
        torch.from_numpy(trans), torch.from_numpy(closure),
        torch.from_numpy(toks), torch.from_numpy(lens))
    assert got.shape == (len(lens),) and got.dtype == torch.float32
    _close(got.numpy(), jd.make_batched(jd.forward_1d_scan, sr=jsr)(
        jnp.array(trans), jnp.array(closure), jnp.array(toks),
        jnp.array(lens)))


def test_batched_equals_single():
    trans, closure = (torch.from_numpy(x) for x in _mats("logsumexp"))
    toks, lens = _batch()
    batched = td.forward_1d_scan(trans, closure, torch.from_numpy(toks),
                                 torch.from_numpy(lens)).numpy()
    for b in range(len(lens)):
        single = td.forward_1d_scan(trans, closure,
                                    torch.from_numpy(toks[b]), int(lens[b]))
        assert abs(float(single) - float(batched[b])) <= TOL


def test_forward_matches_f64_loop():
    trans, closure = _mats("logsumexp")
    toks, lens = _batch(L=90, seed=7)
    lens = np.array([90, 64, 1, 77, 0], np.int32)
    got = td.forward_1d_scan(torch.from_numpy(trans),
                             torch.from_numpy(closure),
                             torch.from_numpy(toks), torch.from_numpy(lens))
    ref = testmachines.forward_1d_f64(trans, closure, toks, lens)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
