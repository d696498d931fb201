"""The port's row-scan 2D engine (ops/dp2d.py) against the JAX package's,
for both semirings.

The same numpy matrices and tokens go through both. Bounds: 2e-3 nats for
the sequential row scan's LOGSUMEXP (max-shifted float32 matmuls on both
sides) and 1e-5 nats for MAXPLUS (float32 adds and maxes in the same
order of neighbours). The associative row solver, the Backward lattice,
the banded fill and ops/fwdback's tokenize_batch and posterior_lattice
are held to their JAX counterparts at 1e-4 nats, the associative solver
also to the sequential one at 5e-3 and every score to the float64 host
engine at 0.01. The card tests (marker cuda) hold the card's float32
calls to the same calls on the CPU in float64 at 1e-3 nats.
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.algo.dp_host import BackwardMatrix, \
    ForwardMatrix, ViterbiMatrix
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.seqpair import Envelope, NamedSeq, SeqPair
from machineboss_tpu_torch.ops import dp2d, fwdback
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


NEW_BOUND = 1e-4          # nats: a new function against its JAX twin
ASSOC_BOUND = 5e-3        # nats: the associative solver against the scan
HOST_BOUND = 0.01         # nats: the f64 host engine (the contract)
CARD_BOUND = 1e-3         # nats: card float32 against CPU float64


def _torch(mats, it, ot):
    return ([torch.from_numpy(x) for x in mats], torch.from_numpy(it),
            torch.from_numpy(ot))


def _jax(mats, it, ot):
    import jax.numpy as jnp
    return [jnp.array(x) for x in mats], jnp.array(it), jnp.array(ot)


def _seqpair(name, it, ot):
    alphabet = MACHINES[name][1]
    return SeqPair(NamedSeq("i", [alphabet[t] for t in it]),
                   NamedSeq("o", [alphabet[t] for t in ot]))


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
@pytest.mark.parametrize("name", list(MACHINES))
def test_assoc_rows_match_jax_and_the_scan(name, sr_name):
    """assoc=True: the log-depth row solver, against the JAX package's
    associative solver (1e-4) and the sequential scan (5e-3)."""
    from machineboss_tpu.ops.dp2d import forward_2d_lattice as j_lat
    _, mats, toks = _case(name, sr_name)
    for it, ot in toks:
        jm, ji, jo = _jax(mats, it, ot)
        ref = np.asarray(j_lat(*jm, ji, jo, sr=_jax_sr(sr_name), assoc=True))
        tm, ti, to = _torch(mats, it, ot)
        got = dp2d.forward_2d_lattice(*tm, ti, to, sr=SEMIRINGS[sr_name],
                                      assoc=True)
        _close(got.numpy(), ref, NEW_BOUND)
        scan = dp2d.forward_2d_lattice(*tm, ti, to, sr=SEMIRINGS[sr_name])
        _close(got.numpy(), scan.numpy(), ASSOC_BOUND)
        score = dp2d.forward_2d(*tm, ti, to, len(it), len(ot),
                                sr=SEMIRINGS[sr_name], assoc=True)
        assert float(score) == float(got[len(ot), len(it), -1])


def test_assoc_rows_hold_scores_far_below_the_affine_one():
    """A deliberate difference: a pair scoring below -88 nats, where the
    JAX package's float32 associative solver loses v beside the augmented
    one and returns -1e30; the port's (float64, shifted) gives the f64
    score."""
    from machineboss_tpu.ops.dp2d import forward_2d as j_fwd
    from machineboss_tpu_torch.ops.host_oracle import forward_2d_f64
    _, mats, _ = _case("tiefree", "logsumexp")
    it = np.zeros(40, np.int32)                 # A against C: -2.4 a step
    ot = np.ones(40, np.int32)
    tm, ti, to = _torch(mats, it, ot)
    got = float(dp2d.forward_2d(*tm, ti, to, 40, 40, assoc=True))
    assert got < -88
    _close([got], [forward_2d_f64(*mats, it, ot)], HOST_BOUND)
    _close([got], [float(dp2d.forward_2d(*tm, ti, to, 40, 40))],
           ASSOC_BOUND)
    jm, ji, jo = _jax(mats, it, ot)
    assert float(j_fwd(*jm, ji, jo, 40, 40, assoc=True)) <= -1e29


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
@pytest.mark.parametrize("name", list(MACHINES))
def test_backward_lattice_matches_jax_and_host(name, sr_name):
    from machineboss_tpu.ops.dp2d import backward_2d_lattice as j_bwd
    ev, mats, toks = _case(name, sr_name)
    for it, ot in toks:
        jm, ji, jo = _jax(mats, it, ot)
        tm, ti, to = _torch(mats, it, ot)
        for assoc in (False, True):
            got = dp2d.backward_2d_lattice(*tm, ti, to,
                                           sr=SEMIRINGS[sr_name], assoc=assoc)
            assert got.shape == (len(ot) + 1, len(it) + 1, mats[3].shape[0])
            _close(got.numpy(), np.asarray(j_bwd(
                *jm, ji, jo, sr=_jax_sr(sr_name), assoc=assoc)), NEW_BOUND)
        # backward total = forward total
        fwd = dp2d.forward_2d(*tm, ti, to, len(it), len(ot),
                              sr=SEMIRINGS[sr_name])
        _close([float(got[0, 0, 0])], [float(fwd)], ASSOC_BOUND)
        if sr_name == "logsumexp":
            host = BackwardMatrix(ev, _seqpair(name, it, ot)).cell
            ref = np.maximum(np.transpose(host, (1, 0, 2)), -1e30)
            _close(got.numpy(), ref, HOST_BOUND)


def _banded_case(name, width, n_cols=9):
    """A pair with a path alignment and its Envelope, as the JAX package's
    tests/test_device_dp.py builds one: the n_cols columns of a random
    path."""
    ev, mats, _ = _case(name, "logsumexp")
    rng = np.random.RandomState(width + 3)
    alphabet = MACHINES[name][1]
    cols = []
    for k in rng.randint(0, 3, n_cols):
        a = alphabet[rng.randint(len(alphabet))] if k != 2 else ""
        b = alphabet[rng.randint(len(alphabet))] if k != 1 else ""
        cols.append((a, b))
    sp = SeqPair(NamedSeq("i", [a for a, _ in cols if a]),
                 NamedSeq("o", [b for _, b in cols if b]), cols)
    env = Envelope(sp, width=width)
    it = np.array([ev.input_tokenizer.sym2tok[c] - 1 for c in sp.input.seq],
                  np.int32)
    ot = np.array([ev.output_tokenizer.sym2tok[c] - 1
                   for c in sp.output.seq], np.int32)
    return ev, mats, sp, env, it, ot


@pytest.mark.parametrize("width", [0, 1, 3])
@pytest.mark.parametrize("name", ["allclass", "indel"])
def test_banded_forward_matches_jax_and_host(name, width):
    import jax.numpy as jnp
    from machineboss_tpu.ops.dp2d import forward_2d_banded as j_band
    ev, mats, sp, env, it, ot = _banded_case(name, width)
    jm, ji, jo = _jax(mats, it, ot)
    ref = float(j_band(*jm, ji, jo, jnp.array(env.in_start),
                       jnp.array(env.in_end), len(it), len(ot)))
    tm, ti, to = _torch(mats, it, ot)
    got = float(dp2d.forward_2d_banded(
        *tm, ti, to, torch.tensor(env.in_start), torch.tensor(env.in_end),
        len(it), len(ot)))
    _close([got], [ref], NEW_BOUND)
    host = ForwardMatrix(ev, sp, env).log_like()
    _close([got], [max(host, -1e30)], HOST_BOUND)
    full = ForwardMatrix(ev, sp, Envelope.full(sp)).log_like()
    assert got <= full + HOST_BOUND


def test_batched_rows_equal_single_pairs():
    """(B, Li) tokens and (B,) lengths: each pair's score is the one its
    own single-pair call gives (the batch's padding never reaches it)."""
    _, mats, _ = _case("allclass", "logsumexp")
    rng = np.random.RandomState(9)
    il = np.array([6, 0, 3, 5], np.int64)
    ol = np.array([5, 4, 0, 5], np.int64)
    it = rng.randint(0, 2, (4, 6))
    ot = rng.randint(0, 2, (4, 5))
    t = [torch.from_numpy(x) for x in mats]
    got = dp2d.forward_2d(*t, torch.from_numpy(it), torch.from_numpy(ot),
                          torch.from_numpy(il), torch.from_numpy(ol))
    assert got.shape == (4,)
    for b in range(4):
        one = dp2d.forward_2d(*t, torch.from_numpy(it[b, :il[b]]),
                              torch.from_numpy(ot[b, :ol[b]]), int(il[b]),
                              int(ol[b]))
        _close([float(got[b])], [float(one)], 1e-5)


def test_tokenize_batch_and_posterior_match_jax():
    import json
    from machineboss_tpu.core.eval import EvaluatedMachine as JEvaluated
    from machineboss_tpu.core.machine import Machine as JMachine
    from machineboss_tpu.core.seqpair import NamedSeq as JNamed, \
        SeqPair as JPair
    from machineboss_tpu.ops import fwdback as j_fb
    ev, mats, toks = _case("allclass", "logsumexp")
    jm_ = JMachine.from_json(json.loads(ev.machine.to_json_str()))
    jev = JEvaluated(jm_, jm_.get_param_defs(True))
    pairs = [("ACCA", "CA"), ("", "AAC"), ("CCCAC", "")]
    ours = fwdback.tokenize_batch(
        ev, [SeqPair(NamedSeq("i", list(a)), NamedSeq("o", list(b)))
             for a, b in pairs], bucket=True, device="cpu")
    theirs = j_fb.tokenize_batch(
        jev, [JPair(JNamed("i", list(a)), JNamed("o", list(b)))
              for a, b in pairs], bucket=True)
    for a, b in zip(ours, theirs):
        assert a.device.type == "cpu"
        assert np.array_equal(a.numpy(), np.asarray(b))
    it, ot = toks[0]
    jm, ji, jo = _jax(mats, it, ot)
    tm, ti, to = _torch(mats, it, ot)
    got = fwdback.posterior_lattice(*tm, ti, to)
    ref = np.asarray(j_fb.posterior_lattice(*jm, ji, jo))
    live = ref > -1e20
    assert np.array_equal(got.numpy() > -1e20, live)
    assert np.abs(got.numpy()[live] - ref[live]).max() <= NEW_BOUND
    # the end state at the last cell carries every path
    assert abs(float(got[-1, -1, -1])) <= NEW_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MACHINES))
def test_engines_on_card_match_cpu_f64(name):
    """The row scan, the associative solver, the Backward lattice and the
    banded fill on the card (float32) against the same calls on the CPU
    in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, mats, toks = _case(name, "logsumexp")
    dev = torch.device("cuda")
    it, ot = toks[0]
    c64 = [torch.from_numpy(x.astype(np.float64)) for x in mats]
    card = [torch.from_numpy(x).to(dev) for x in mats]
    ti, to = torch.from_numpy(it), torch.from_numpy(ot)
    for assoc in (False, True):
        want = dp2d.forward_2d_lattice(*c64, ti, to, assoc=assoc)
        got = dp2d.forward_2d_lattice(*card, ti.to(dev), to.to(dev),
                                      assoc=assoc)
        _close(got.cpu().numpy(), want.numpy(), CARD_BOUND)
        want = dp2d.backward_2d_lattice(*c64, ti, to, assoc=assoc)
        got = dp2d.backward_2d_lattice(*card, ti.to(dev), to.to(dev),
                                       assoc=assoc)
        _close(got.cpu().numpy(), want.numpy(), CARD_BOUND)
    start = torch.tensor([0, 0, 1, 1, 2, 3])
    end = torch.tensor([3, 4, 5, 6, 7, 7])
    want = dp2d.forward_2d_banded(*c64, ti, to, start, end, len(it), len(ot))
    got = dp2d.forward_2d_banded(*card, ti.to(dev), to.to(dev),
                                 start.to(dev), end.to(dev), len(it), len(ot))
    _close([float(got)], [float(want)], CARD_BOUND)
