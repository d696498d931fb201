"""The port's row-scan 2D engine (ops/dp2d.py, forward half) against the JAX
package's, for both semirings.

The same numpy matrices and tokens go through both. Bounds: 2e-3 nats for
LOGSUMEXP (max-shifted float32 matmuls on both sides) and 1e-5 nats for
MAXPLUS (float32 adds and maxes in the same order of neighbours).
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import ForwardMatrix, ViterbiMatrix
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
from machineboss_tpu_torch.ops import dp2d
from machineboss_tpu_torch.ops.lowering import LoweredMachine
from machineboss_tpu_torch.ops.semiring import LOGSUMEXP, MAXPLUS

BOUND = {"logsumexp": 2e-3, "maxplus": 1e-5}
SEMIRINGS = {"logsumexp": LOGSUMEXP, "maxplus": MAXPLUS}
MACHINES = {
    "allclass": (lambda: testmachines.build_allclass_transducer(
        5, list("AC")), "AC"),
    "indel": (lambda: testmachines.build_indel_transducer(
        6, list("ACGT")), "ACGT"),
    "tiefree": (testmachines.build_tiefree_machine, "ACG"),
}
LENS = [(6, 5), (0, 4), (3, 0), (0, 0)]
_cache = {}


def _case(name, sr_name):
    key = (name, sr_name)
    if key not in _cache:
        m = MACHINES[name][0]()
        ev = EvaluatedMachine(m, m.get_param_defs(True))
        mats = tuple(np.asarray(x) for x in LoweredMachine(
            ev, dtype=np.float32).matrices_2d(sr_name))
        rng = np.random.RandomState(5)
        toks = [(rng.randint(0, mats[1].shape[0], li).astype(np.int32),
                 rng.randint(0, mats[2].shape[0], lo).astype(np.int32))
                for li, lo in LENS]
        _cache[key] = (ev, mats, toks)
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
def test_forward_2d_lattice_matches_jax(name, sr_name):
    import jax.numpy as jnp
    from machineboss_tpu.ops.dp2d import forward_2d_lattice as j_lat
    _, mats, toks = _case(name, sr_name)
    for it, ot in toks:
        ref = np.asarray(j_lat(*[jnp.array(x) for x in mats], jnp.array(it),
                               jnp.array(ot), sr=_jax_sr(sr_name)))
        got = dp2d.forward_2d_lattice(
            *[torch.from_numpy(x) for x in mats], torch.from_numpy(it),
            torch.from_numpy(ot), sr=SEMIRINGS[sr_name])
        assert got.shape == (len(ot) + 1, len(it) + 1, mats[3].shape[0])
        _close(got.numpy(), ref, BOUND[sr_name])


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
@pytest.mark.parametrize("name", list(MACHINES))
def test_forward_2d_matches_jax_and_host(name, sr_name):
    import jax.numpy as jnp
    from machineboss_tpu.ops.dp2d import forward_2d as j_fwd
    ev, mats, toks = _case(name, sr_name)
    alphabet = MACHINES[name][1]
    host_cls = ForwardMatrix if sr_name == "logsumexp" else ViterbiMatrix
    for it, ot in toks:
        ref = float(j_fwd(*[jnp.array(x) for x in mats], jnp.array(it),
                          jnp.array(ot), len(it), len(ot),
                          sr=_jax_sr(sr_name)))
        got = float(dp2d.forward_2d(
            *[torch.from_numpy(x) for x in mats], torch.from_numpy(it),
            torch.from_numpy(ot), len(it), len(ot), sr=SEMIRINGS[sr_name]))
        _close([got], [ref], BOUND[sr_name])
        host = host_cls(ev, SeqPair(
            NamedSeq("i", [alphabet[t] for t in it]),
            NamedSeq("o", [alphabet[t] for t in ot]))).log_like()
        # the host Forward sums through a 1e-4-spaced lookup table
        _close([got], [max(host, -1e30)], 2e-3)


def test_a_shorter_prefix_reads_the_same_lattice():
    _, mats, toks = _case("allclass", "maxplus")
    it, ot = toks[0]
    t = [torch.from_numpy(x) for x in mats]
    lat = dp2d.forward_2d_lattice(*t, torch.from_numpy(it),
                                  torch.from_numpy(ot), sr=MAXPLUS)
    for li, lo in ((3, 2), (0, 5), (6, 0)):
        got = dp2d.forward_2d(*t, torch.from_numpy(it), torch.from_numpy(ot),
                              li, lo, sr=MAXPLUS)
        assert got == lat[lo, li, -1]


@pytest.mark.parametrize("call", [
    lambda t, it, ot: dp2d.forward_2d_lattice(*t, it, ot, assoc=True),
    lambda t, it, ot: dp2d.forward_2d(*t, it, ot, 1, 1, assoc=True),
    lambda t, it, ot: dp2d.backward_2d_lattice(*t, it, ot),
    lambda t, it, ot: dp2d.forward_2d_banded(*t, it, ot, None, None, 1, 1)])
def test_unported_parts_name_their_roadmap_item(call):
    _, mats, toks = _case("allclass", "logsumexp")
    t = [torch.from_numpy(x) for x in mats]
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        call(t, torch.from_numpy(toks[0][0]), torch.from_numpy(toks[0][1]))
