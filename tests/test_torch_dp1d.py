"""The port's 1D engines (ops/dp1d.py) against the JAX package's.

forward_1d_scan and make_batched, Forward and Viterbi, on the same
matrices and tokens: float32 with the same order of operations, 1e-5 nats
relative to the score's size (a log-likelihood of -80 carries 8e-6 of f32
rounding by itself). A float64 loop bounds both at 1e-4 nats. The
associative product, the lattices, the probability-space batch scan and
the blocked engine are held to their JAX twins at 1e-4 nats, the
associative and blocked engines also to the sequential scan at 5e-3. The
card tests (marker cuda) hold the card's float32 calls to the same calls
on the CPU in float64 at 1e-3 nats; this file imports the JAX package
only inside its JAX tests.
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.ops import dp1d as td
from machineboss_tpu_torch.ops import semiring as ts
from machineboss_tpu_torch.ops.lowering import LoweredMachine

TOL = 1e-5
NEW_BOUND = 1e-4          # nats: a new engine against its JAX twin
ASSOC_BOUND = 5e-3        # nats: assoc and blocked against the scan
CARD_BOUND = 1e-3         # nats: card float32 against CPU float64
SEMIRINGS = {"logsumexp": ts.LOGSUMEXP, "maxplus": ts.MAXPLUS}
_cache = {}


class _Jax:
    """The JAX package's dp1d, jnp and semirings, imported at first use."""

    def __getattr__(self, name):
        import jax.numpy as jnp
        from machineboss_tpu.ops import dp1d, semiring
        return {"jnp": jnp, "dp1d": dp1d, "LOGSUMEXP": semiring.LOGSUMEXP,
                "MAXPLUS": semiring.MAXPLUS}[name]


J = _Jax()


def _srs(sr_name):
    """(JAX semiring, port semiring)."""
    return (J.LOGSUMEXP if sr_name == "logsumexp" else J.MAXPLUS,
            SEMIRINGS[sr_name])


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
    jsr, tsr = _srs(sr_name)
    _, closure = _mats(sr_name)
    S = closure.shape[0]
    _close(td._start_vector(S, torch.from_numpy(closure), tsr,
                            torch.float32).numpy(),
           J.dp1d._start_vector(S, J.jnp.array(closure), jsr, J.jnp.float32))


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_forward_1d_scan_single(sr_name):
    jsr, tsr = _srs(sr_name)
    trans, closure = _mats(sr_name)
    toks, lens = _batch()
    for b in range(len(lens)):
        got = td.forward_1d_scan(torch.from_numpy(trans),
                                 torch.from_numpy(closure),
                                 torch.from_numpy(toks[b]), int(lens[b]),
                                 sr=tsr)
        assert got.shape == ()
        _close(got.numpy(), J.dp1d.forward_1d_scan(
            J.jnp.array(trans), J.jnp.array(closure), J.jnp.array(toks[b]),
            int(lens[b]), sr=jsr))


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_make_batched_matches_jax(sr_name):
    jsr, tsr = _srs(sr_name)
    trans, closure = _mats(sr_name)
    toks, lens = _batch()
    got = td.make_batched(td.forward_1d_scan, sr=tsr)(
        torch.from_numpy(trans), torch.from_numpy(closure),
        torch.from_numpy(toks), torch.from_numpy(lens))
    assert got.shape == (len(lens),) and got.dtype == torch.float32
    jnp = J.jnp
    _close(got.numpy(), J.dp1d.make_batched(J.dp1d.forward_1d_scan, sr=jsr)(
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


def _live_close(port, ref, bound):
    """Impossible scores impossible in both (<= -1e29), the rest within
    `bound` nats."""
    port = np.asarray(port, np.float64)
    ref = np.maximum(np.asarray(ref, np.float64), -1e30)
    assert port.shape == ref.shape
    assert np.array_equal(port > -1e29, ref > -1e29)
    live = ref > -1e29
    if live.any():
        assert np.abs(port[live] - ref[live]).max() <= bound


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_forward_1d_assoc_matches_jax_and_scan(sr_name):
    jsr, tsr = _srs(sr_name)
    jnp = J.jnp
    trans, closure = _mats(sr_name)
    toks, lens = _batch()
    t = torch.from_numpy(trans), torch.from_numpy(closure)
    batched = td.forward_1d_assoc(*t, torch.from_numpy(toks),
                                  torch.from_numpy(lens), sr=tsr)
    scan = td.forward_1d_scan(*t, torch.from_numpy(toks),
                              torch.from_numpy(lens), sr=tsr)
    _live_close(batched.numpy(), scan.numpy(), ASSOC_BOUND)
    for b in range(len(lens)):
        got = td.forward_1d_assoc(*t, torch.from_numpy(toks[b]),
                                  int(lens[b]), sr=tsr)
        ref = J.dp1d.forward_1d_assoc(jnp.array(trans), jnp.array(closure),
                                      jnp.array(toks[b]), int(lens[b]),
                                      sr=jsr)
        _live_close([float(got)], [float(ref)], NEW_BOUND)
        assert abs(float(got) - float(batched[b])) <= 1e-5


@pytest.mark.parametrize("sr_name", list(SEMIRINGS))
def test_lattices_match_jax(sr_name):
    """forward_1d_all and backward_1d_all: the (L+1, S) lattices; the
    backward lattice's start state reads the forward total."""
    jsr, tsr = _srs(sr_name)
    jnp = J.jnp
    trans, closure = _mats(sr_name)
    toks, lens = _batch()
    t = torch.from_numpy(trans), torch.from_numpy(closure)
    for b in (0, 3):
        args = (jnp.array(trans), jnp.array(closure), jnp.array(toks[b]),
                int(lens[b]))
        f = td.forward_1d_all(*t, torch.from_numpy(toks[b]), int(lens[b]),
                              sr=tsr)
        bw = td.backward_1d_all(*t, torch.from_numpy(toks[b]), int(lens[b]),
                                sr=tsr)
        assert f.shape == bw.shape == (toks.shape[1] + 1, trans.shape[-1])
        _live_close(f.numpy(), J.dp1d.forward_1d_all(*args, sr=jsr),
                    NEW_BOUND)
        _live_close(bw.numpy(), J.dp1d.backward_1d_all(*args, sr=jsr),
                    NEW_BOUND)
        total = tsr.reduce(f[0] + bw[0], axis=-1)
        fwd = td.forward_1d_scan(*t, torch.from_numpy(toks[b]), int(lens[b]),
                                 sr=tsr)
        _live_close([float(total)], [float(fwd)], ASSOC_BOUND)
    # batched lattices are the single ones, row by row
    fb = td.forward_1d_all(*t, torch.from_numpy(toks),
                           torch.from_numpy(lens), sr=tsr)
    bb = td.backward_1d_all(*t, torch.from_numpy(toks),
                            torch.from_numpy(lens), sr=tsr)
    _live_close(fb[3].numpy(), td.forward_1d_all(
        *t, torch.from_numpy(toks[3]), int(lens[3]), sr=tsr).numpy(), 1e-5)
    _live_close(bb[3].numpy(), td.backward_1d_all(
        *t, torch.from_numpy(toks[3]), int(lens[3]), sr=tsr).numpy(), 1e-5)


def _seeded_tensors(S, n_tok, sparse, seed=3):
    """The seeded transfer tensors of the JAX package's
    tests/test_device_dp.py: 40% nonzero entries and an identity closure
    (probs scan), or Dirichlet columns (blocked)."""
    rng = np.random.RandomState(seed)
    if sparse:
        with np.errstate(divide="ignore"):
            trans = np.log(np.where(rng.uniform(0, 1, (n_tok, S, S)) < 0.4,
                                    rng.uniform(0.05, 1.0, (n_tok, S, S)),
                                    0.0))
        closure = np.where(np.eye(S) > 0, 0.0, -np.inf)
        return (np.maximum(trans, -1e30).astype(np.float32),
                np.maximum(closure, -1e30).astype(np.float32), rng)
    p = rng.dirichlet(np.ones(S), size=(n_tok, S)).transpose(0, 2, 1)
    trans = np.log(p).astype(np.float32)
    closure = np.where(np.eye(S, dtype=bool), 0.0, -1e30).astype(np.float32)
    return trans, closure, rng


def test_probs_batch_scan_matches_jax_and_scan():
    """Ragged lengths, an empty sequence and dead lanes, as the JAX
    package's test_forward_1d_scan_probs_batch_matches_scan."""
    jnp = J.jnp
    trans, closure, rng = _seeded_tensors(10, 4, True)
    B, L = 9, 41
    toks = rng.randint(0, 4, (B, L)).astype(np.int32)
    lens = np.array([41, 30, 1, 0, 41, 7, 23, 2, 41], np.int32)
    t = torch.from_numpy(trans), torch.from_numpy(closure)
    got = td.forward_1d_scan_probs_batch(*t, torch.from_numpy(toks),
                                         torch.from_numpy(lens))
    ref = J.dp1d.forward_1d_scan_probs_batch(
        jnp.array(trans), jnp.array(closure), jnp.array(toks),
        jnp.array(lens))
    _live_close(got.numpy(), ref, NEW_BOUND)
    scan = td.forward_1d_scan(*t, torch.from_numpy(toks),
                              torch.from_numpy(lens))
    _live_close(got.numpy(), scan.numpy(), NEW_BOUND)


def test_probs_batch_scan_warns_past_3000_steps():
    trans, closure, rng = _seeded_tensors(3, 2, False)
    toks = torch.from_numpy(rng.randint(0, 2, (1, 3001)))
    t = torch.from_numpy(trans), torch.from_numpy(closure)
    with pytest.warns(UserWarning, match="3000-step"):
        got = td.forward_1d_scan_probs_batch(*t, toks, torch.tensor([5]))
    _live_close(got.numpy(), td.forward_1d_scan(
        *t, toks, torch.tensor([5])).numpy(), NEW_BOUND)


def test_blocked_matches_jax_and_scan():
    """The blocked engine on the JAX test's seeded Dirichlet tensors,
    ragged lengths and padding included."""
    jnp = J.jnp
    trans, closure, rng = _seeded_tensors(24, 4, False)
    B, L = 7, 301
    toks = rng.randint(0, 4, (B, L)).astype(np.int32)
    lens = np.array([301, 300, 256, 17, 1, 0, 128], np.int32)
    fn = td.make_forward_1d_blocked(torch.from_numpy(trans),
                                    torch.from_numpy(closure))
    got = fn(torch.from_numpy(toks), torch.from_numpy(lens))
    assert got.shape == (B,) and got.device.type == "cpu"
    ref = J.dp1d.make_forward_1d_blocked(jnp.array(trans),
                                         jnp.array(closure))(
        jnp.array(toks), jnp.array(lens))
    _live_close(got.numpy(), ref, NEW_BOUND)
    scan = td.forward_1d_scan(torch.from_numpy(trans),
                              torch.from_numpy(closure),
                              torch.from_numpy(toks), torch.from_numpy(lens))
    _live_close(got.numpy(), scan.numpy(), ASSOC_BOUND)
    # the table may also come from numpy arrays, placed on the CPU on ask
    fn_np = td.make_forward_1d_blocked(trans, closure, k=2, device="cpu")
    _live_close(fn_np(toks, lens).numpy(), scan.numpy(), ASSOC_BOUND)


def test_new_engines_match_f64_loop():
    """The new engines against the float64 oracle at a longer length."""
    trans, closure = _mats("logsumexp")
    toks, _ = _batch(L=90, seed=7)
    lens = np.array([90, 64, 1, 77, 0], np.int32)
    ref = testmachines.forward_1d_f64(trans, closure, toks, lens)
    t = torch.from_numpy(trans), torch.from_numpy(closure)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(lens)
    for got in (td.forward_1d_assoc(*t, tt, tl),
                td.forward_1d_scan_probs_batch(*t, tt, tl),
                td.make_forward_1d_blocked(*t)(tt, tl),
                td.forward_1d_all(*t, tt, tl)[:, -1, -1]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_engines_on_card_match_cpu_f64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    trans, closure = _mats("logsumexp")
    toks, lens = _batch(L=90, seed=7)
    t64 = torch.from_numpy(trans.astype(np.float64)), \
        torch.from_numpy(closure.astype(np.float64))
    tc = tuple(x.to(dev).float() for x in t64)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(lens)
    for fn in (td.forward_1d_assoc, td.forward_1d_scan_probs_batch,
               lambda a, b, c, d: td.forward_1d_all(a, b, c, d)[:, -1, -1],
               lambda a, b, c, d: td.backward_1d_all(a, b, c, d)[:, 0, 0],
               lambda a, b, c, d: td.make_forward_1d_blocked(
                   a, b, dtype=a.dtype)(c, d)):
        want = fn(*t64, tt, tl)
        got = fn(*tc, tt.to(dev), tl.to(dev))
        assert got.device.type == "cuda"
        _live_close(got.cpu().numpy(), want.numpy(), CARD_BOUND)
