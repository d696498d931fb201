"""The port's 1D scan (ops/kernels/scan1d_kernel.py) against the JAX kernel
and a float64 loop.

scan1d_forward_plain (the CPU path of make_forward_1d_kernel) is held to
the JAX package's make_forward_1d_pallas in its own CPU mode
(interpret=True) and to a float64 probability-space loop, with ragged
lengths, a -1 pad token inside a sequence, a sequence that loses all its
mass, and L long enough for many renormalisations. Bound: 1e-4 nats (f32
products over up to 150 positions; the final log runs in f64 on both
sides). On a CUDA card the kernel is held to the plain version: the
exponents and dead flags equal, the log-likelihoods within 1e-3 nats.

The JAX package is imported inside the tests that use it, so that the card
tests run where only torch is installed:
    python -m pytest --noconftest tests/test_torch_scan1d.py -m cuda
"""

import numpy as np
import pytest
import torch

from machineboss_tpu_torch import testmachines
from machineboss_tpu_torch.convert import scan1d_from_numpy
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.ops.kernels import scan1d_kernel as sk
from machineboss_tpu_torch.ops.lowering import LoweredMachine

BOUND = 1e-4        # nats, plain vs JAX interpret and vs the f64 loop
CARD_BOUND = 1e-3   # nats, kernel vs plain on the card
CASES = ["small", "long", "wide"]
_cache = {}


def _case(name):
    """(trans, closure, toks, lens) as numpy, from seeds. 'small' is the
    JAX kernel's own CPU size (S=6, L=37, B=5); 'long' has 150 positions
    (37 renormalisations) and a dead sequence; 'wide' has 41 states with
    End, two warps of destination threads (or two states a thread when
    the block is given 32)."""
    if name in _cache:
        return _cache[name]
    S, B, L, seed = {"small": (6, 5, 37, 1), "long": (6, 6, 150, 2),
                     "wide": (40, 3, 70, 3)}[name]
    m = testmachines.build_generator_1d(S, seed=seed)
    ev = EvaluatedMachine(m, m.get_param_defs(True))
    trans, closure = (np.asarray(x) for x in LoweredMachine(
        ev, dtype=np.float32).emit_matrices_1d(output_side=True))
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, trans.shape[0], (B, L)).astype(np.int32)
    lens = rng.randint(L // 2, L + 1, B).astype(np.int32)
    lens[0] = L
    if name != "wide":
        lens[1] = 0
        toks[2, 5] = -1          # a pad token inside a sequence: skipped
        toks[4, lens[4]:] = -1   # and as padding past a sequence's end
    if name == "long":
        toks[3, 40] = trans.shape[0]     # outside the alphabet: no mass
        lens[3] = L
    _cache[name] = (trans, closure, toks, lens)
    return _cache[name]


def _port(name, device="cpu", renorm_every=4):
    trans, closure, toks, lens = _case(name)
    fn = sk.make_forward_1d_kernel(trans, closure, *toks.shape,
                                   device=device, renorm_every=renorm_every)
    return fn(toks, lens)


def _assert_close(got, ref, bound):
    for b in range(len(ref)):
        if ref[b] <= -1e29:
            assert got[b] <= -1e29, (b, got[b])
        else:
            assert abs(got[b] - ref[b]) <= bound, (b, got[b], ref[b])


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_interpret(name):
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.scan1d_kernel import \
        make_forward_1d_pallas
    trans, closure, toks, lens = _case(name)
    jfn = make_forward_1d_pallas(trans, closure, *toks.shape, interpret=True)
    got = _port(name)
    assert got.dtype == np.float64 and got.shape == lens.shape
    _assert_close(got, jfn(jnp.array(toks), jnp.array(lens)), BOUND)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_f64_loop(name):
    trans, closure, toks, lens = _case(name)
    ref = testmachines.forward_1d_f64(trans, closure, toks, lens)
    if name != "wide":
        # the scan adds the shift g back as len * g, as the JAX kernel
        # does, so a skipped position inside a sequence still counts one g
        # (negative tokens are meant for the padding past the length)
        ref[2] += sk.prepare_scan1d(trans, closure)[2]
    got = _port(name)
    _assert_close(got, ref, BOUND)
    if name == "long":
        assert got[3] <= -1e29 and np.isfinite(got[[0, 2, 4, 5]]).all()
        assert got[1] == pytest.approx(np.log(0.05), abs=1e-6)


def test_host_prep_equals_jax_operands():
    """em is the JAX factory's exp-shifted matrix before its transpose,
    c0 its start column, bit for bit (the factory closes them into its
    jitted call as constants)."""
    import jax
    import jax.numpy as jnp
    from machineboss_tpu.ops.pallas.scan1d_kernel import \
        make_forward_1d_pallas
    trans, closure, toks, lens = _case("small")
    B, L = toks.shape
    jfn = make_forward_1d_pallas(trans, closure, B, L, interpret=True)
    jit_eqn = [e for e in jax.make_jaxpr(jfn.device_call)(
        jnp.array(toks), jnp.array(lens)).jaxpr.eqns
        if "jaxpr" in e.params][0]
    consts = {np.asarray(c).shape: np.asarray(c)
              for c in jit_eqn.params["jaxpr"].consts}
    em, c0, g = sk.prepare_scan1d(trans, closure)
    n_tok, S, _ = em.shape
    em_t = consts[(n_tok * S, S)].reshape(n_tok, S, S)
    assert np.array_equal(np.transpose(em, (0, 2, 1)), em_t)
    c0b = [v for k, v in consts.items() if len(k) == 2 and k[0] == S
           and k != (n_tok * S, S)][0]
    assert np.array_equal(c0b[:, 0], c0)
    assert g == float(np.max(trans.astype(np.float64)))
    ops = scan1d_from_numpy(trans, closure, device="cpu")
    assert np.array_equal(ops.em.numpy(), em) and ops.g == g


@pytest.mark.parametrize("renorm_every", [1, 3, 16])
def test_renorm_schedule_is_exact(renorm_every):
    # the scaling is an exact power of two, so the schedule changes no bit
    # of mantissa * 2^exponent as long as nothing underflows
    trans, closure, toks, lens = _case("small")
    ops = scan1d_from_numpy(trans, closure, device="cpu")
    t, n = torch.from_numpy(toks), torch.from_numpy(lens)
    a = sk.scan1d_forward_plain(ops, t, n, renorm_every).double()
    b = sk.scan1d_forward_plain(ops, t, n, 4).double()
    assert torch.equal(a[0] * 2.0 ** a[1], b[0] * 2.0 ** b[1])
    assert torch.equal(a[2], b[2])


def test_exponent_convention_is_the_kernels():
    """A max in [1, 2) leaves the exponent alone; the plain version scales
    by the power of two of the biased-exponent field, as the kernel does,
    not by frexp's (one more)."""
    em = np.zeros((1, 2, 2), np.float32)
    em[0] = [[1.5, 0.0], [0.0, 3.0]]
    ops = sk.scan1d_operands(em, np.array([1.0, 1.0], np.float32), 0.0,
                             torch.device("cpu"))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    out = sk.scan1d_forward_plain(ops, toks, torch.tensor([4]), 1)
    # renormalised every step, the maxima are 3, 4.5, 3.375 and 5.0625:
    # exponents 1 + 2 + 1 + 2, and 3^4 = 81 leaves the mantissa 81 / 64 in
    # [1, 2) (frexp's convention would give 81 / 128 and 7)
    assert float(out[1, 0]) == 6.0
    assert float(out[0, 0]) == 81.0 / 64.0


def test_cpu_wrapper_takes_plain_without_launch():
    trans, closure, toks, lens = _case("small")
    ops = scan1d_from_numpy(trans, closure, device="cpu")
    t, n = torch.from_numpy(toks), torch.from_numpy(lens)
    before = sk.scan1d_forward.launches
    out = sk.scan1d_forward(ops, t, n)
    assert sk.scan1d_forward.launches == before
    assert torch.equal(out, sk.scan1d_forward_plain(ops, t, n))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [None, 32, 128])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name, threads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trans, closure, toks, lens = _case(name)
    dev = torch.device("cuda")
    ops = scan1d_from_numpy(trans, closure, device=dev)
    t = torch.from_numpy(toks).to(dev)
    n = torch.from_numpy(lens).to(dev)
    before = sk.scan1d_forward.launches
    kern = sk.scan1d_forward(ops, t, n, threads=threads)
    assert sk.scan1d_forward.launches == before + 1
    plain = sk.scan1d_forward_plain(ops, t, n)
    assert torch.equal(kern[1:], plain[1:])      # exponents and dead flags
    _assert_close(sk.scan1d_loglike(kern.cpu().numpy(), lens, ops.g),
                  _port(name), CARD_BOUND)
