"""The port's semirings against the JAX package's, function by function.

Same inputs (numpy seeds) through both; float32 with the same order of
operations, so the bound is 1e-5 nats (relative for the probability-space
products, whose values are not logs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from machineboss_tpu.ops import semiring as js
from machineboss_tpu_torch.ops import semiring as ts

TOL = 1e-5
NAMES = ["logsumexp", "maxplus", "prob"]
PAIRS = {"logsumexp": (js.LOGSUMEXP, ts.LOGSUMEXP),
         "maxplus": (js.MAXPLUS, ts.MAXPLUS), "prob": (js.PROB, ts.PROB)}


def _log_arrays(seed, *shapes):
    """Log-space float32 arrays with a share of NEG_INF entries and one
    all-NEG_INF row/column, so the shifted products see empty lines."""
    rng = np.random.RandomState(seed)
    out = []
    for shape in shapes:
        a = rng.uniform(-8.0, 0.0, shape).astype(np.float32)
        a[rng.uniform(size=shape) < 0.2] = js.NEG_INF
        if a.ndim >= 2:
            a[..., 0, :] = js.NEG_INF
        out.append(a)
    return out


def _operands(name, seed, *shapes):
    """(first, second) operands per semiring convention: PROB's first
    operand is a probability-space carry."""
    arrs = _log_arrays(seed, *shapes)
    if name == "prob":
        arrs[0] = np.exp(np.maximum(arrs[0], -60.0)).astype(np.float32)
    return arrs


def _close(t, j):
    t = t.numpy()
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def test_constants_and_lookup():
    assert ts.NEG_INF == js.NEG_INF
    for name in NAMES:
        j, t = PAIRS[name]
        assert (t.name, t.zero, t.one) == (j.name, j.zero, j.one)
    for alias in ("logsumexp", "sum", "forward"):
        assert ts.get_semiring(alias) is ts.LOGSUMEXP
    for alias in ("maxplus", "max", "viterbi"):
        assert ts.get_semiring(alias) is ts.MAXPLUS
    with pytest.raises(ValueError, match="Unknown semiring"):
        ts.get_semiring("prob")


@pytest.mark.parametrize("name", NAMES)
def test_add_reduce_cx(name):
    j, t = PAIRS[name]
    a, b = _operands(name, 1, (4, 6), (4, 6))
    if name == "prob":
        b = np.exp(np.maximum(b, -60.0)).astype(np.float32)
    _close(t.add(torch.from_numpy(a), torch.from_numpy(b)),
           j.add(jnp.array(a), jnp.array(b)))
    for axis in (-1, 0):
        _close(t.reduce(torch.from_numpy(a), axis=axis),
               j.reduce(jnp.array(a), axis=axis))
    _close(t.cx(np.float32(-0.7), torch.from_numpy(a)),
           j.cx(np.float32(-0.7), jnp.array(a)))


@pytest.mark.parametrize("fn", ["matmul", "matmul_small"])
@pytest.mark.parametrize("name", NAMES)
def test_matmul(name, fn):
    j, t = PAIRS[name]
    a, b = _operands(name, 2, (3, 5, 7), (3, 7, 4))
    _close(getattr(t, fn)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(j, fn)(jnp.array(a), jnp.array(b)))


@pytest.mark.parametrize("fn", ["vecmat", "vecmat_small"])
@pytest.mark.parametrize("name", NAMES)
def test_vecmat(name, fn):
    j, t = PAIRS[name]
    v, m = _operands(name, 3, (3, 7), (3, 7, 4))
    _close(getattr(t, fn)(torch.from_numpy(v), torch.from_numpy(m)),
           getattr(j, fn)(jnp.array(v), jnp.array(m)))
    # an unbatched vector against one matrix
    _close(getattr(t, fn)(torch.from_numpy(v[0]), torch.from_numpy(m[0])),
           getattr(j, fn)(jnp.array(v[0]), jnp.array(m[0])))


@pytest.mark.parametrize("name", NAMES)
def test_matvec(name):
    j, t = PAIRS[name]
    m, v = _log_arrays(4, (3, 5, 7), (3, 7))
    if name == "prob":     # matvec takes the LOG matrix first
        v = np.exp(np.maximum(v, -60.0)).astype(np.float32)
    _close(t.matvec(torch.from_numpy(m), torch.from_numpy(v)),
           j.matvec(jnp.array(m), jnp.array(v)))


@pytest.mark.parametrize("shapes", [((40, 5, 7), (40, 7, 4)),
                                    ((6, 1, 5, 7), (1, 9, 7, 4)),
                                    ((5, 7), (40, 7, 4))])
def test_maxplus_matmul_in_chunks_is_bit_equal(shapes, monkeypatch):
    """Past MAXPLUS_TEMP_ELEMS summed terms the max-plus product takes its
    leading batch in chunks (broadcast batches too); its result is the
    one-shot product's, bit for bit, and matches the JAX one."""
    a, b = _log_arrays(6, *shapes)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = ts.MAXPLUS.matmul(ta, tb)
    monkeypatch.setattr(ts, "MAXPLUS_TEMP_ELEMS", 3 * 5 * 7 * 4)
    chunked = ts.MAXPLUS.matmul(ta, tb)
    assert torch.equal(chunked, whole)
    assert torch.equal(chunked, ts._maxplus_matmul(ta, tb))
    _close(chunked, js.MAXPLUS.matmul(jnp.array(a), jnp.array(b)))
