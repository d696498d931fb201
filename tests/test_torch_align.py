"""The alignment slice as a whole: the port's device_viterbi_matrices on the
CPU against the host engine and the JAX package.

For engine "kernel" (the closure-folded fill's plain version) and
"wavefront" (the torch diagonal engine), full and banded, with the device
walk and with the full readback: log_like within 1e-4 nats of the host
ViterbiMatrix (float64) and of the JAX package's device_viterbi_matrices
(the JAX tests' TOL), and the traceback's transitions equal to the host's.
The three in-repo cases of tests/test_device_align.py are here with their
seeds: banded == host banded, no readback on the tie-free walk, damaged
records fall back safely.
"""

import json

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import ViterbiMatrix
from machineboss_tpu_torch.algo.viterbi_device import (
    DeviceViterbiMatrix, SparseDeviceViterbiMatrix, device_viterbi_matrices)
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.seqpair import Envelope, NamedSeq, SeqPair
from machineboss_tpu_torch.ops.host_oracle import viterbi_2d_f64
from machineboss_tpu_torch.ops.kernels import viterbi_kernel as vk
from machineboss_tpu_torch.ops.lowering import LoweredMachine

TOL = 1e-4
ENGINES = ["kernel", "wavefront"]
_cache = {}


def _dense6():
    if "dense6" not in _cache:
        m = testmachines.build_random_transducer(6, list("ACGT"), seed=2)
        _cache["dense6"] = (m, EvaluatedMachine(m, m.get_param_defs(True)))
    return _cache["dense6"]


def _pair(seed, L):
    """The pair of the JAX package's device-align tests: two independent
    random sequences, aligned column by column."""
    rng = np.random.RandomState(seed)
    xs = ["ACGT"[c] for c in rng.randint(0, 4, L)]
    ys = ["ACGT"[c] for c in rng.randint(0, 4, L)]
    return SeqPair(NamedSeq("x", xs), NamedSeq("y", ys), list(zip(xs, ys)))


def _trans(path):
    return [(t.in_, t.out, t.dest) for t in path.trans]


def _jax_matrix(m, sp, env=None, engine="auto"):
    """The JAX package's device matrix for the same machine and pair."""
    from machineboss_tpu.algo.viterbi_device import \
        device_viterbi_matrices as j_matrices
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu.core.seqpair import (Envelope as JEnvelope,
                                              NamedSeq as JNamedSeq,
                                              SeqPair as JSeqPair)
    jm = JMachine.from_json(json.loads(m.to_json_str()))
    jev = JEvaluated(jm, jm.get_param_defs(True))
    jsp = JSeqPair(JNamedSeq("x", sp.input.seq), JNamedSeq("y", sp.output.seq),
                   sp.alignment)
    envs = None
    if env is not None:
        jenv = JEnvelope(jsp)
        jenv.in_start, jenv.in_end = list(env.in_start), list(env.in_end)
        envs = [jenv]
    return jm, j_matrices(jev, [jsp], envelopes=envs, engine=engine,
                          interpret=True)[0]


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
def test_banded_device_align_matches_host_banded(engine, sparse):
    m, ev = _dense6()
    spa = _pair(1, 24)
    env = Envelope(spa, width=4)
    host = ViterbiMatrix(ev, spa, env=env)
    dev = device_viterbi_matrices(ev, [spa], envelopes=[env], engine=engine,
                                  sparse_traceback=sparse, device="cpu")[0]
    assert isinstance(dev, SparseDeviceViterbiMatrix if sparse
                      else DeviceViterbiMatrix)
    assert abs(dev.log_like() - host.log_like()) < TOL
    assert _trans(host.traceback(m)) == _trans(dev.traceback(m))
    jm, jdev = _jax_matrix(m, spa, env)
    assert abs(dev.log_like() - jdev.log_like()) < TOL
    assert _trans(jdev.traceback(jm)) == _trans(dev.traceback(m))


@pytest.mark.parametrize("engine", ENGINES)
def test_sparse_device_traceback_avoids_readback(engine):
    """The device walk must serve the whole traceback from the sparse
    path-neighborhood records, with no full-lattice materialization, and
    reproduce the host alignment exactly (banded AND full-lattice)."""
    m, ev = _dense6()
    spa = _pair(7, 24)
    host = ViterbiMatrix(ev, spa)
    hp = host.traceback(m)

    dev = device_viterbi_matrices(ev, [spa], engine=engine, device="cpu")[0]
    assert isinstance(dev, SparseDeviceViterbiMatrix)
    assert abs(dev.log_like() - host.log_like()) < TOL
    dp = dev.traceback(m)
    assert dev._full is None, "sparse traceback fell back to full readback"
    assert _trans(hp) == _trans(dp)
    _, jdev = _jax_matrix(m, spa, engine="pallas" if engine == "kernel"
                          else "wavefront")
    assert abs(dev.log_like() - jdev.log_like()) < TOL

    env = Envelope(spa, width=4)
    hostb = ViterbiMatrix(ev, spa, env=env)
    devb = device_viterbi_matrices(ev, [spa], envelopes=[env], engine=engine,
                                   device="cpu")[0]
    assert isinstance(devb, SparseDeviceViterbiMatrix)
    dpb = devb.traceback(m)
    assert devb._full is None, "banded sparse traceback fell back"
    assert _trans(hostb.traceback(m)) == _trans(dpb)


@pytest.mark.parametrize("banded", [False, True])
def test_sparse_device_traceback_fallback_is_safe(banded):
    """If the sparse record set is damaged (simulating a device/host tie
    divergence), the traceback must transparently fall back to the full
    lattice and still produce the host alignment."""
    m, ev = _dense6()
    spa = _pair(9, 12)
    envs = [Envelope(spa, width=3)] if banded else None
    dev = device_viterbi_matrices(ev, [spa], envelopes=envs, device="cpu")[0]
    assert isinstance(dev, SparseDeviceViterbiMatrix)
    # drop half the records: the walk is now incomplete mid-path
    keys = sorted(dev._cells)
    for k in keys[: len(keys) // 2]:
        if k != (12, 12):
            del dev._cells[k]
    host = ViterbiMatrix(ev, spa, env=envs[0] if banded else None)
    dp = dev.traceback(m)
    assert dev._full is not None, "expected the fallback to trigger"
    assert _trans(host.traceback(m)) == _trans(dp)


@pytest.mark.parametrize("engine", ENGINES)
def test_ragged_batch_with_empty_sides_and_a_pathless_pair(engine):
    """One batched fill and one walk serve pairs of different lengths, an
    empty input, an empty pair, and a pair the machine cannot emit."""
    m = testmachines.build_allclass_transducer(5, list("AC"))
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    rng = np.random.RandomState(3)

    def sp(li, lo):
        return SeqPair(NamedSeq("i", ["AC"[t] for t in rng.randint(0, 2, li)]),
                       NamedSeq("o", ["AC"[t] for t in rng.randint(0, 2, lo)]))

    pairs = [sp(6, 5), sp(0, 4), sp(3, 0), sp(0, 0), sp(2, 6)]
    devs = device_viterbi_matrices(ev, pairs, engine=engine, device="cpu")
    mats = [np.asarray(x, np.float64) for x in LoweredMachine(
        ev, dtype=np.float64).matrices_2d("maxplus")]
    n_paths = 0
    for spb, dm in zip(pairs, devs):
        host = ViterbiMatrix(ev, spb)
        it0 = np.array(ev.input_tokenizer.tokenize(spb.input.seq)) - 1
        ot0 = np.array(ev.output_tokenizer.tokenize(spb.output.seq)) - 1
        f64 = viterbi_2d_f64(*mats, it0, ot0)
        if host.log_like() == -np.inf:
            assert dm.log_like() < -1e20 and f64 < -1e29
            assert dm._full is None       # no readback for a -inf score
            continue
        n_paths += 1
        assert abs(dm.log_like() - host.log_like()) < TOL
        assert abs(dm.log_like() - f64) < TOL
        assert _trans(dm.path(m)) == _trans(host.traceback(m))
    assert 2 <= n_paths < len(pairs)


def test_pathless_pair_scores_minus_infinity_without_readback():
    m = testmachines.build_tiefree_machine()
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    # the machine emits no G without reading one
    sp = SeqPair(NamedSeq("x", list("AC")), NamedSeq("y", list("G")))
    dm = device_viterbi_matrices(ev, [sp], engine="kernel", device="cpu")[0]
    assert dm.log_like() <= -1e29 and dm._full is None
    assert ViterbiMatrix(ev, sp).log_like() == -np.inf


@pytest.mark.parametrize("engine", ENGINES)
def test_tiefree_machine_aligns_as_the_host(engine):
    m = testmachines.build_tiefree_machine()
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    sp = testmachines.tiefree_pair()
    env = Envelope(sp, width=2)
    host = ViterbiMatrix(ev, sp, env=env)
    for envs in (None, [env]):
        dm = device_viterbi_matrices(ev, [sp], envelopes=envs, engine=engine,
                                     device="cpu")[0]
        assert abs(dm.log_like() - host.log_like()) < TOL
        path = dm.path(m)
        assert dm._full is None
        assert _trans(path) == _trans(host.traceback(m))
        assert SeqPair.alignment_from_path(path) == sp.alignment


def test_default_fill_is_the_row_engine():
    """DeviceViterbiMatrix without a fill_fn fills by ops/dp2d rows."""
    m, ev = _dense6()
    spa = _pair(5, 7)
    host = ViterbiMatrix(ev, spa)
    dm = DeviceViterbiMatrix(ev, spa, device="cpu")
    assert abs(dm.log_like() - host.log_like()) < TOL
    live = host.cell > -np.inf
    assert np.array_equal(dm.cell > -1e29, live)
    assert np.abs(dm.cell[live] - host.cell[live]).max() < TOL
    assert _trans(dm.path(m)) == _trans(host.traceback(m))


def test_full_envelopes_take_the_batched_route():
    _, ev = _dense6()
    spa = _pair(4, 6)
    before = vk.viterbi_banded_wavefront.launches
    dm = device_viterbi_matrices(ev, [spa], envelopes=[Envelope.full(spa)],
                                 engine="kernel", device="cpu")[0]
    assert isinstance(dm, SparseDeviceViterbiMatrix)
    assert abs(dm.log_like() - ViterbiMatrix(ev, spa).log_like()) < TOL
    assert vk.viterbi_banded_wavefront.launches == before


def test_entry_point_arguments():
    _, ev = _dense6()
    spa = _pair(4, 6)
    with pytest.raises(ValueError, match="engine must be"):
        device_viterbi_matrices(ev, [spa], engine="fast", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_viterbi_matrices(ev, [spa])
    # the JAX package's names are accepted
    a = device_viterbi_matrices(ev, [spa], engine="pallas", interpret=True,
                                device="cpu")[0]
    b = device_viterbi_matrices(ev, [spa], engine="kernel", device="cpu")[0]
    assert a.log_like() == b.log_like()
    assert device_viterbi_matrices(ev, [], device="cpu") == []
