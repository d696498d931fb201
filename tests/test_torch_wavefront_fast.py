"""The port's torch wavefront engine against the JAX package's.

forward_2d_wavefront_fast in both packages runs the same f32 algorithm
(closure per cell, per-diagonal max rescale), differing only in the order
of sums: the bound is 1e-4 nats at L <= 20. Both are also held to the f64
oracle at the contract's 0.01 nats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machineboss_tpu.ops.wavefront_fast import \
    forward_2d_wavefront_fast as j_wavefront

from machineboss_tpu_torch.convert import lowered_from_numpy
from machineboss_tpu_torch.ops.wavefront_fast import \
    forward_2d_wavefront_fast as t_wavefront
from test_torch_lowrank import CASES, _assert_close, _case, _f64

BOUND = 1e-4         # nats, same f32 algorithm, other summation order
ORACLE_BOUND = 0.01  # nats, the device/host contract


def _port(name):
    mats, it, ot, il, ol = _case(name)
    tm = lowered_from_numpy(*mats, device="cpu")
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    return t_wavefront(*tm, *batch).numpy()


@pytest.mark.parametrize("name", CASES)
def test_wavefront_fast_matches_jax(name):
    mats, it, ot, il, ol = _case(name)
    jres = np.array(j_wavefront(*(jnp.array(x) for x in mats),
                                jnp.array(it), jnp.array(ot), jnp.array(il),
                                jnp.array(ol)))
    _assert_close(_port(name), jres, BOUND)


@pytest.mark.parametrize("name", CASES)
def test_wavefront_fast_matches_f64(name):
    _assert_close(_port(name), _f64(name), ORACLE_BOUND)


def test_wavefront_fast_takes_the_jax_keywords():
    """The JAX engine's parameters, precision too: accepted and ignored
    (the port computes in float32 with TF32 off), so a precision= call
    scores as a call without it, bit for bit."""
    import inspect
    assert list(inspect.signature(t_wavefront).parameters) \
        == list(inspect.signature(j_wavefront).parameters)
    mats, it, ot, il, ol = _case(CASES[0])
    tm = lowered_from_numpy(*mats, device="cpu")
    batch = [torch.from_numpy(x) for x in (it, ot, il, ol)]
    assert torch.equal(t_wavefront(*tm, *batch, precision="highest"),
                       t_wavefront(*tm, *batch))
