"""The port's Plan7Fused (ops/fused_plan7.py) against the JAX class.

Both sides parse the same HMMER3 text and transducer JSON with their own
copies of the host layer; the JAX class's tables (its `_j` dict and, for the
flat solver, `_em_stack`, `_mb`, `_mloop_star`) are carried into the port's
class as numpy arrays by convert.plan7_from_numpy, so the two compute from
identical numbers and differ only in float32 rounding of the same
recurrences. Bounds: 1e-4 nats against the JAX class (scores are -9 to
-60 nats, float32 spacing up to 4e-6, a few dozen log-space operations per
row); 5e-3 nats against the float64 composed-machine oracle and 1e-4
against the float64 product-graph Viterbi oracle, the reference tests' own
bounds. The solver, oracle and api tests are in
tests/test_torch_fused_plan7_solvers.py, which imports this file's
helpers: pytest-xdist's `--dist loadfile` gives each file to one worker.
"""

import numpy as np
import pytest

from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
from machineboss_tpu.core.hmmer import HmmerModel as JHmmer
from machineboss_tpu.core.machine import Machine as JMachine
from machineboss_tpu.ops.fused_plan7 import Plan7Fused as JPlan7

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import ForwardMatrix
from machineboss_tpu_torch.convert import plan7_from_numpy
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.hmmer import HmmerModel
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
from machineboss_tpu_torch.ops.fused_plan7 import Plan7Fused
from one_thread import one_torch_thread  # noqa: F401

VS_JAX = 1e-4
VS_F64 = 5e-3
COMBOS = [("core", False, False), ("core", True, False),
          ("plan7", True, False), ("plan7", True, True)]
IDS = ["core_global", "core_local", "plan7_single", "plan7_multihit"]
SCALARS = ("log_loop", "log_exit", "b_to_m1", "b_to_i0", "b_to_d1",
           "i0_to_m1", "i0_to_i0")
_cache = {}


def models(profile):
    """((JAX hmm, JAX td_ev), (port hmm, td, td_ev)) of the toy DNA profile
    with its noise transducer, or of a seeded 19-node amino profile with
    bench.py's noise transducer."""
    if profile not in _cache:
        if profile == "toy":
            text, td_json = testmachines.TOY_HMM_TEXT, testmachines.TOY_TD_JSON
        else:
            text = testmachines.random_plan7_hmm_text(
                19, testmachines.AMINO, seed=3)
            td_json = testmachines.noise_transducer_json(testmachines.AMINO)
        jh = JHmmer()
        jh.read(text)
        jtd = JMachine.from_json(td_json)
        th = HmmerModel()
        th.read(text)
        ttd = Machine.from_json(td_json)
        _cache[profile] = (
            (jh, JEvaluated(jtd, jtd.get_param_defs(True))),
            (th, ttd, EvaluatedMachine(ttd, ttd.get_param_defs(True))))
    return _cache[profile]


def jax_tables(jf, flat=False):
    """The JAX class's tables as numpy, in plan7_from_numpy's arguments."""
    kw = {"tables": {n: np.asarray(v) for n, v in jf._j.items()
                     if v is not None},
          "entry": jf._entry_np,
          "scalars": {n: getattr(jf, n) for n in SCALARS}}
    if flat:
        if not hasattr(jf, "_fb"):
            jf._init_flat()
        kw["em_stack"] = np.asarray(jf._em_stack)
        if hasattr(jf, "_mb"):
            kw["mb"] = {n: np.asarray(v) for n, v in jf._mb.items()}
            kw["mloop_star"] = np.asarray(jf._mloop_star)
    return kw


def pair(profile, flat=False, **config):
    """(JAX Plan7Fused, port Plan7Fused on the CPU computing from the JAX
    one's tables)."""
    (jh, jev), (th, _, tev) = models(profile)
    jf = JPlan7(jh, jev, **config)
    tf = plan7_from_numpy(th, tev, device="cpu", **jax_tables(jf, flat),
                          **config)
    return jf, tf


def oracle(profile, gen, seq, matrix=ForwardMatrix):
    _, (_, td, _) = models(profile)
    comp = Machine.compose(gen, td)
    ev = EvaluatedMachine(comp, comp.get_param_defs(True))
    return matrix(ev, SeqPair(NamedSeq("i", []),
                              NamedSeq("o", list(seq)))).log_like()


def generator(profile, mode, local, multihit):
    th = models(profile)[1][0]
    return th.machine(local) if mode == "core" else \
        th.plan7_machine(multihit=multihit, length=10.0)


def toy_reads(seed, n, lo=1, hi=9):
    rng = np.random.RandomState(seed)
    return [["ACGT"[i] for i in rng.randint(0, 4, rng.randint(lo, hi))]
            for _ in range(n)]


def test_own_tables_equal_the_jax_tables():
    """The host precompute is a copy: the port's own float32 tables are the
    JAX class's bit for bit, for both semirings and both row solvers."""
    (jh, jev), (th, _, tev) = models("toy")
    for semiring in ("logsumexp", "maxplus"):
        for solver in ("prefix", "scan"):
            cfg = dict(mode="plan7", multihit=True, length=10.0,
                       solver=solver, semiring=semiring)
            jf = JPlan7(jh, jev, **cfg)
            tf = Plan7Fused(th, tev, device="cpu", **cfg)
            assert set(tf._j) == set(jf._j)
            for n, v in jf._j.items():
                assert np.array_equal(np.asarray(v), tf._j[n].numpy()), n
            for n in SCALARS:
                assert getattr(jf, n) == getattr(tf, n)


@pytest.mark.parametrize("solver", ["prefix", "scan"])
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_forward_matches_jax(combo, solver):
    mode, local, multihit = combo
    jf, tf = pair("toy", mode=mode, local=local, multihit=multihit,
                  length=10.0, n_hit=4, solver=solver)
    assert tf._solver == solver
    for seq in ("ACG", "TTACGACGTT", "", "GT", "A"):
        want = jf.forward(list(seq))
        got = tf.forward(list(seq))
        if want < -1e20:
            assert got < -1e20, (seq, got)
        else:
            assert abs(got - want) <= VS_JAX, (seq, want, got)


@pytest.mark.parametrize("combo", COMBOS[1:], ids=IDS[1:])
def test_prob_space_matches_log_and_jax(combo):
    mode, local, multihit = combo
    reads = toy_reads(4, 8, lo=2)
    jf, tf = pair("toy", flat=True, mode=mode, local=local,
                  multihit=multihit, length=10.0, solver="prefix",
                  prob_space=True)
    _, t_log = pair("toy", flat=True, mode=mode, local=local,
                    multihit=multihit, length=10.0, solver="prefix",
                    prob_space=False)
    assert tf.prob_space and not t_log.prob_space
    a = t_log.forward_batch(reads, impl="flat")
    b = tf.forward_batch(reads, impl="flat")
    assert np.abs(a - b).max() <= VS_JAX
    assert np.abs(b - jf.forward_batch(reads, impl="flat")).max() <= VS_JAX


@pytest.mark.parametrize("impl", ["auto", "flat", "vmap", "kernel"])
def test_forward_stream_matches_blocking(impl):
    """Every batch enqueued before one copy back: the same scores as the
    blocking calls; 'auto' on the CPU is the flat solver."""
    _, (th, _, tev) = models("toy")
    f = Plan7Fused(th, tev, mode="plan7", multihit=True, length=10.0,
                   solver="prefix", device="cpu")
    rng = np.random.RandomState(7)
    batches = []
    for n in (4, 4, 6):
        toks = rng.randint(1, 5, (n, 8)).astype(np.int32)
        lens = rng.randint(1, 9, n).astype(np.int32)
        batches.append((toks, lens))
    streamed = f.forward_stream(batches, impl=impl)
    assert [len(s) for s in streamed] == [4, 4, 6]
    for (toks, lens), got in zip(batches, streamed):
        want = f.forward_batch_tokens(toks, lens, impl=impl)
        np.testing.assert_allclose(got, want, atol=1e-6)
    if impl == "auto":
        flat = f.forward_batch_tokens(*batches[0], impl="flat")
        assert np.array_equal(streamed[0], flat)
    assert f.forward_stream([], impl=impl) == []


def test_stream_token_cache_is_bounded_and_keeps_its_arrays():
    """The kernel route's device-token cache holds at most 64 entries,
    first in first out, and serves an array it has seen without a new
    copy."""
    _, (th, _, tev) = models("toy")
    f = Plan7Fused(th, tev, mode="plan7", length=10.0, device="cpu")
    rng = np.random.RandomState(1)
    first = (rng.randint(1, 5, (2, 4)).astype(np.int32),
             np.array([4, 2], np.int32))
    f.forward_stream([first], impl="kernel")
    cached = f._dev_cache[id(first[0])]
    assert cached[0] is first[0]
    f.forward_stream([first], impl="kernel")
    assert f._dev_cache[id(first[0])][1] is cached[1]
    keep = []
    for _ in range(40):
        b = (rng.randint(1, 5, (2, 4)).astype(np.int32),
             np.array([4, 3], np.int32))
        keep.append(b)
        f.forward_stream([b], impl="kernel")
    assert len(f._dev_cache) == 64
    assert id(first[0]) not in f._dev_cache


def test_kernel_gate_and_impl_names():
    """_kernel_supported is the JAX class's _pallas_supported; 'auto' on
    the CPU never takes the kernel; an unknown impl raises."""
    (jh, jev), (th, _, tev) = models("toy")
    for cfg in (dict(mode="plan7", multihit=True),
                dict(mode="plan7", multihit=False),
                dict(mode="core", local=True),
                dict(mode="plan7", semiring="maxplus"),
                dict(mode="plan7", prob_space=True)):
        jf = JPlan7(jh, jev, **cfg)
        tf = Plan7Fused(th, tev, device="cpu", **cfg)
        assert tf._kernel_supported() == jf._pallas_supported() \
            == tf._pallas_supported()
        assert tf._pick_impl("auto") == "flat"
        assert tf._pick_impl("pallas") == "kernel"
    with pytest.raises(ValueError, match="impl"):
        tf.forward_batch_tokens(np.ones((1, 2), np.int32), [2], impl="xla")
