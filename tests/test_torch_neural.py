"""The port's weight-expression compiler and neural DP (ops/exprjit.py,
ops/dp_neural.py) against the JAX package's and the float64 host Forward.

compile_expr's closures equal the JAX closures in value and gradient for
every opcode; log_trans_tensor equals the JAX tensor with scalar and
broadcast fields; on a machine with no silent transition the neural
Forward equals the JAX function in value and gradient (rtol 1e-4). On
dnapsw, whose silent transitions the JAX function's closure counts many
times over, the port's score equals the host Forward (1e-4) where the JAX
function is more than a nat off; its gradients equal central differences
of the host score.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machineboss_tpu.core.machine import Machine as JMachine
from machineboss_tpu.core.presets import make_preset as j_make_preset
from machineboss_tpu.ops import dp_neural as j_dp
from machineboss_tpu.ops import exprjit as j_ex
from machineboss_tpu_torch.algo.dp_host import ForwardMatrix, ViterbiMatrix
from machineboss_tpu_torch.convert import params_from_numpy
from machineboss_tpu_torch.core.eval import EvaluatedMachine
from machineboss_tpu_torch.core.machine import Machine
from machineboss_tpu_torch.core.params import param_assign_from_json
from machineboss_tpu_torch.core.presets import make_preset
from machineboss_tpu_torch.core.seqpair import NamedSeq, SeqPair
from machineboss_tpu_torch.ops import dp_neural, exprjit
from machineboss_tpu_torch.ops.semiring import MAXPLUS
from machineboss_tpu_torch.testmachines import bitnoise_json
from one_thread import one_torch_thread  # noqa: F401

RTOL = 1e-4
HOST_TOL = 1e-4                  # nats: float32 DP against float64 host

EXPRS = {
    "number": 0.3,
    "true": True,
    "none": None,
    "param": "a",
    "mul": ("*", "a", "b"),
    "add": ("+", "a", "b"),
    "sub": ("-", "a", "b"),
    "div": ("/", "a", "b"),
    "pow": ("pow", "a", "b"),
    "log": ("log", "a"),
    "exp": ("exp", "a"),
    "defs_chain": ("*", "a", "d"),
    "constants": ("+", ("log", 2.0), ("pow", ("/", 3.0, 4.0), 2.0)),
    "nested": ("/", ("exp", ("-", "a", "b")), ("+", 1.0, ("pow", "b", 0.5))),
}
DEFS = {"d": ("+", "c", 1), "c": ("*", "b", 2)}


def _as_np(x):
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_compile_expr_equals_jax_in_value_and_gradient(name):
    expr = EXPRS[name]
    rng = np.random.RandomState(len(name))
    a = rng.uniform(0.2, 2.0, (3, 4)).astype(np.float32)
    b = rng.uniform(0.2, 2.0, (4,)).astype(np.float32)
    j_fn = j_ex.compile_expr(expr, DEFS)
    t_fn = exprjit.compile_expr(expr, DEFS)
    j_val = j_fn({"a": jnp.asarray(a), "b": jnp.asarray(b)})
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    t_val = t_fn({"a": ta, "b": tb})
    np.testing.assert_allclose(_as_np(t_val.detach() if torch.is_tensor(t_val)
                                      else t_val), _as_np(j_val), rtol=RTOL)
    if not torch.is_tensor(t_val) or not t_val.requires_grad:
        return
    j_grads = jax.grad(lambda x, y: jnp.sum(j_fn({"a": x, "b": y})),
                       argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    t_val.sum().backward()
    for t_grad, j_grad in zip((ta.grad, tb.grad), j_grads):
        got = np.zeros_like(a if t_grad is ta.grad else b) \
            if t_grad is None else t_grad.numpy()
        np.testing.assert_allclose(got, _as_np(j_grad), rtol=RTOL,
                                   atol=1e-6)


def test_compile_expr_constants_follow_jax():
    """A constant expression stays a number, computed as jnp computes it:
    log(0) is -inf and 0 ** -1 inf, not a Python error; a constant
    division by zero raises ZeroDivisionError in both."""
    for expr in (("log", 0.0), ("exp", 1.0), ("pow", 0.0, -1.0),
                 ("pow", 2.0, 0.5)):
        got = exprjit.compile_expr(expr)({})
        want = float(j_ex.compile_expr(expr)({}))
        assert isinstance(got, float)
        assert got == want or got == pytest.approx(want, rel=1e-6)
    for mod in (j_ex, exprjit):
        with pytest.raises(ZeroDivisionError):
            mod.compile_expr(("/", 1.0, 0.0))({})


def test_compile_expr_cycle_detection_names_the_chain():
    defs = {"a": ("+", "b", 1), "b": "a"}
    messages = []
    for mod in (j_ex, exprjit):
        with pytest.raises(ValueError) as err:
            mod.compile_expr("a", defs)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "Cyclic definition: a -> b -> a"
    with pytest.raises(ValueError, match="Unknown opcode"):
        exprjit.compile_expr(("max", "a", "b"))


def test_expr_params_equal():
    for expr in EXPRS.values():
        if isinstance(expr, bool):
            continue
        assert exprjit.expr_params(expr, DEFS) == \
            j_ex.expr_params(expr, DEFS)


def _dnapsw_fields(L1, L2, seed):
    rng = np.random.RandomState(seed)
    m = make_preset("dnapsw")
    base = {k: float(v) for k, v in m.get_param_defs(True).defs.items()}
    fields = dict(base)
    fields["gapOpen"] = rng.uniform(0.2, 0.6, (L1, L2)).astype(np.float32)
    fields["subAC"] = rng.uniform(0.1, 0.4, (L1, 1)).astype(np.float32)
    return fields


@pytest.mark.parametrize("fields", ["scalars", "broadcast"])
def test_log_trans_tensor_equals_jax(fields):
    params = _dnapsw_fields(3, 4, 1)
    if fields == "scalars":
        params = {k: float(np.asarray(v).ravel()[0]) for k, v in
                  params.items()}
    pm = exprjit.ParameterizedMachine(make_preset("dnapsw"), device="cpu")
    jpm = j_ex.ParameterizedMachine(j_make_preset("dnapsw"))
    got = pm.log_trans_tensor(params_from_numpy(params, "cpu")).numpy()
    want = np.asarray(jpm.log_trans_tensor(
        {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}))
    assert got.shape == want.shape
    assert got.shape[-4:] == (5, 5, 8, 8)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _bitnoise_case(Li, Lo, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 2, Li)
    y = rng.randint(0, 2, Lo)
    params = {"p": rng.uniform(0.5, 0.9, (Li + 1, Lo + 1)),
              "q": np.float32(0.08),
              "r": rng.uniform(0.01, 0.1, (Li + 1,))}
    return x, y, {k: np.asarray(v, np.float32) for k, v in params.items()}


@pytest.mark.parametrize("Li,Lo,seed", [(3, 3, 0), (5, 7, 1), (0, 2, 2),
                                        (6, 0, 3)])
def test_neural_forward_equals_jax_without_silent_transitions(Li, Lo, seed):
    """The bitnoise-shaped channel: diagonal, left and up moves and no
    silent one, so the JAX closure is exact. Value and gradient of every
    parameter, fields and scalar, rtol 1e-4."""
    x, y, params = _bitnoise_case(Li, Lo, seed)
    machine = bitnoise_json()
    pm = exprjit.ParameterizedMachine(Machine.from_json(machine),
                                      device="cpu")
    jpm = j_ex.ParameterizedMachine(JMachine.from_json(machine))
    assert pm.in_alph == jpm.in_alph and pm.out_alph == jpm.out_alph
    it = [pm.in_alph.index(str(c)) for c in x]
    ot = [pm.out_alph.index(str(c)) for c in y]

    def j_loss(p):
        return j_dp.neural_log_forward(jpm, jnp.asarray(it, jnp.int32),
                                       jnp.asarray(ot, jnp.int32), p)

    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_val = float(j_loss(j_params))
    j_grad = jax.grad(j_loss)(j_params)
    t_params = {k: v.requires_grad_() for k, v in
                params_from_numpy(params, "cpu").items()}
    t_val = dp_neural.neural_log_forward(pm, it, ot, t_params)
    assert abs(float(t_val.detach()) - j_val) <= RTOL * abs(j_val) + 1e-5
    t_val.backward()
    for k in params:
        np.testing.assert_allclose(t_params[k].grad.numpy(),
                                   np.asarray(j_grad[k]), rtol=RTOL,
                                   atol=1e-5)


def _dnapsw_pair(L):
    rng = np.random.RandomState(L)
    return list(rng.choice(list("ACGT"), L)), list(rng.choice(list("ACGT"),
                                                              L))


def _dnapsw_tokens(ev, x, y):
    return ([ev.input_tokenizer.sym2tok[c] - 1 for c in x],
            [ev.output_tokenizer.sym2tok[c] - 1 for c in y])


@pytest.mark.parametrize("L", [1, 3, 12])
def test_dnapsw_port_is_the_host_forward_where_jax_is_off(L):
    """dnapsw's silent edges: the port's closure equals the host Forward
    within 1e-4 nats; the JAX function counts silent paths C(n, j) times
    and is more than a nat above (49.9 nats at L=12)."""
    m = make_preset("dnapsw")
    params = m.get_param_defs(True)
    ev = EvaluatedMachine(m, params)
    x, y = _dnapsw_pair(L)
    host = ForwardMatrix(ev, SeqPair(NamedSeq("x", x),
                                     NamedSeq("y", y))).log_like()
    it, ot = _dnapsw_tokens(ev, x, y)
    values = {k: float(v) for k, v in params.defs.items()}
    pm = exprjit.ParameterizedMachine(m, device="cpu")
    got = float(dp_neural.neural_log_forward(pm, it, ot, values))
    assert abs(got - host) <= HOST_TOL, (got, host)
    jpm = j_ex.ParameterizedMachine(j_make_preset("dnapsw"))
    jax_score = float(j_dp.neural_log_forward(
        jpm, jnp.asarray(it, jnp.int32), jnp.asarray(ot, jnp.int32),
        {k: jnp.float32(v) for k, v in values.items()}))
    assert jax_score - host > 1.0, (jax_score, host)


def test_dnapsw_silent_iterations_converge_to_the_host():
    """The silent graph of dnapsw is 3 edges deep: n_silent_iters >= 3 is
    exact, 2 is not."""
    m = make_preset("dnapsw")
    params = m.get_param_defs(True)
    ev = EvaluatedMachine(m, params)
    x, y = _dnapsw_pair(3)
    host = ForwardMatrix(ev, SeqPair(NamedSeq("x", x),
                                     NamedSeq("y", y))).log_like()
    it, ot = _dnapsw_tokens(ev, x, y)
    values = {k: float(v) for k, v in params.defs.items()}
    pm = exprjit.ParameterizedMachine(m, device="cpu")
    got = {n: float(dp_neural.neural_log_forward(pm, it, ot, values,
                                                 n_silent_iters=n))
           for n in (2, 3, 4)}
    assert abs(got[3] - host) <= HOST_TOL and abs(got[4] - host) <= HOST_TOL
    assert abs(got[2] - host) > 1e-3


def test_dnapsw_maxplus_is_the_host_viterbi():
    m = make_preset("dnapsw")
    params = m.get_param_defs(True)
    ev = EvaluatedMachine(m, params)
    x, y = _dnapsw_pair(7)
    host = ViterbiMatrix(ev, SeqPair(NamedSeq("x", x),
                                     NamedSeq("y", y))).log_like()
    it, ot = _dnapsw_tokens(ev, x, y)
    pm = exprjit.ParameterizedMachine(m, device="cpu")
    got = float(dp_neural.neural_log_forward(
        pm, it, ot, {k: float(v) for k, v in params.defs.items()},
        sr=MAXPLUS))
    assert abs(got - host) <= HOST_TOL, (got, host)


def test_dnapsw_gradients_are_central_differences_of_the_host():
    """Field gradients summed over the cells equal the scalar gradient,
    and that equals a central difference of the float64 host score."""
    L, eps = 12, 1e-4
    m = make_preset("dnapsw")
    params = m.get_param_defs(True)
    ev = EvaluatedMachine(m, params)
    x, y = _dnapsw_pair(L)
    sp = SeqPair(NamedSeq("x", x), NamedSeq("y", y))
    it, ot = _dnapsw_tokens(ev, x, y)
    values = {k: float(v) for k, v in params.defs.items()}
    pm = exprjit.ParameterizedMachine(m, device="cpu")
    names = ("gapOpen", "gapExtend")
    scalars = {k: torch.tensor(values[k], requires_grad=True) for k in names}
    dp_neural.neural_log_forward(pm, it, ot, {**values, **scalars}).backward()
    fields = {k: torch.full((L + 1, L + 1), values[k], requires_grad=True)
              for k in names}
    dp_neural.neural_log_forward(pm, it, ot, {**values, **fields}).backward()
    for k in names:
        g_scalar = float(scalars[k].grad)
        g_field = float(fields[k].grad.sum())
        assert abs(g_field - g_scalar) <= 1e-3 * abs(g_scalar) + 1e-6

        def host(v):
            p = params.combine(param_assign_from_json({k: v}), True)
            return ForwardMatrix(EvaluatedMachine(m, p), sp).log_like()
        fd = (host(values[k] + eps) - host(values[k] - eps)) / (2 * eps)
        assert abs(g_scalar - fd) <= 1e-2 * abs(fd), (k, g_scalar, fd)
