"""Weight-expression -> torch closure compilation.

Counterpart of machineboss_tpu's ops/exprjit.py. Turns the symbolic
weight-expression AST (core/weight.py) into functions of a parameter dict
built from torch operations, following definition chains with circularity
detection. This is the bridge between symbolic machines and
differentiable, position-dependent parameterization: callers can supply
per-position parameter tensors and backpropagate through the whole DP
(ops/dp_neural.py).
"""

import numpy as np
import torch

from ..core import weight as W
from ..utils.device import resolve_device
from .semiring import NEG_INF


def _unary(torch_fn, np_fn):
    """A tensor operation that also takes a Python number, and then
    computes in float64 as a number: jnp's log(0) = -inf, not an error."""
    def op(x):
        if isinstance(x, (int, float)):
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                return float(np_fn(x))
        return torch_fn(torch.as_tensor(x))
    return op


_log = _unary(torch.log, np.log)
_exp = _unary(torch.exp, np.exp)


def _pow(a, b):
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            return float(np.power(np.float64(a), b))
    return torch.pow(a, b)


def compile_expr(expr, defs=None):
    """Compile a weight expression to fn(params_dict) -> value.

    defs maps param names to further expressions; chains are resolved at
    compile time with cycle detection. Params not in defs are looked up in
    the runtime dict (values may be Python numbers or tensors of any shape:
    broadcasting applies, enabling position-dependent parameters). A
    constant subexpression stays a Python number."""
    defs = defs or {}

    def build(e, visiting):
        if e is None:
            return lambda p: 0.0
        if isinstance(e, bool):
            v = 1.0 if e else 0.0
            return lambda p: v
        if W.is_number(e):
            v = float(e)
            return lambda p: v
        if isinstance(e, str):
            if e in defs:
                if e in visiting:
                    chain = " -> ".join(list(visiting) + [e])
                    raise ValueError("Cyclic definition: " + chain)
                inner = build(defs[e], visiting + [e])
                return inner
            name = e
            return lambda p: p[name]
        op = e[0]
        if op == "log":
            a = build(e[1], visiting)
            return lambda p: _log(a(p))
        if op == "exp":
            a = build(e[1], visiting)
            return lambda p: _exp(a(p))
        a = build(e[1], visiting)
        b = build(e[2], visiting)
        if op == "*":
            return lambda p: a(p) * b(p)
        if op == "+":
            return lambda p: a(p) + b(p)
        if op == "-":
            return lambda p: a(p) - b(p)
        if op == "/":
            return lambda p: a(p) / b(p)
        if op == "pow":
            return lambda p: _pow(a(p), b(p))
        raise ValueError("Unknown opcode %r" % (op,))

    return build(expr, [])


def expr_params(expr, defs=None):
    """Free parameter names after resolving definitions."""
    return W.params_of(expr, defs or {})


def log_of_probs(probs):
    """log(probs) where probs > 0, NEG_INF elsewhere; the gradient of an
    entry that is not positive is 0, never NaN."""
    pos = probs > 0
    return torch.where(pos, torch.log(torch.where(pos, probs, 1.0)),
                       NEG_INF)


class ParameterizedMachine:
    """A machine whose transition weights are torch closures of a
    parameter dict (Python numbers or broadcastable tensors), on `device`
    (None: the CUDA card, raising when CUDA is absent; "cpu" for the CPU).

    Used by the neural DP (ops/dp_neural.py): the caller supplies
    per-parameter tensors -- e.g. the output of a neural network, shaped
    (Li+1, Lo+1) or broadcastable -- and every DP cell evaluates its
    transition weights at that cell's coordinates. torch.autograd through
    the DP trains the network (neural transducer)."""

    def __init__(self, machine, device=None):
        self.machine = machine
        self.device = resolve_device(device)
        self.defs = dict(machine.funcs.defs)
        self.n_states = machine.n_states()
        self.in_alph = machine.input_alphabet()
        self.out_alph = machine.output_alphabet()
        in_tok = {s: i + 1 for i, s in enumerate(self.in_alph)}
        out_tok = {s: i + 1 for i, s in enumerate(self.out_alph)}
        self.edges = []  # (src, dst, in_tok, out_tok, weight_fn)
        self.param_names = set()
        for s, ms in enumerate(machine.states):
            for t in ms.trans:
                fn = compile_expr(t.weight, self.defs)
                self.param_names |= W.params_of(t.weight, self.defs)
                self.edges.append((s, t.dest, in_tok.get(t.in_, 0),
                                   out_tok.get(t.out, 0), fn))
        cols = list(zip(*self.edges)) if self.edges else [()] * 4
        # each edge's tokens, and its (src, dst) entry in a flat S*S row
        self.edge_in = torch.tensor(cols[2], dtype=torch.long,
                                    device=self.device)
        self.edge_out = torch.tensor(cols[3], dtype=torch.long,
                                     device=self.device)
        self.edge_entry = torch.tensor(
            [s * self.n_states + d for s, d in zip(cols[0], cols[1])],
            dtype=torch.long, device=self.device)

    def edge_values(self, params):
        """(E, *batch) float32 probabilities, one row per edge, at the
        parameters' broadcast shape `batch`."""
        vals = [torch.as_tensor(fn(params), dtype=torch.float32,
                                device=self.device)
                for _, _, _, _, fn in self.edges]
        if not vals:
            return torch.zeros(0, device=self.device)
        batch_shape = torch.broadcast_shapes(*[v.shape for v in vals])
        return torch.stack([v.expand(batch_shape) for v in vals])

    def log_trans_tensor(self, params):
        """Dense (n_in, n_out, S, S) log tensor for given parameter values.

        If any parameter is a tensor with dimensions, the result gains
        leading broadcast dims: (..., n_in, n_out, S, S). Parallel edges
        add their probabilities; an entry with no probability is -1e30."""
        n_in = len(self.in_alph) + 1
        n_out = len(self.out_alph) + 1
        S = self.n_states
        vals = self.edge_values(params)                    # (E, *batch)
        batch_shape = vals.shape[1:]
        flat = (self.edge_in * n_out + self.edge_out) * (S * S) \
            + self.edge_entry
        probs = torch.zeros((n_in * n_out * S * S,) + tuple(batch_shape),
                            dtype=torch.float32, device=self.device)
        probs = probs.index_put((flat,), vals, accumulate=True)
        probs = probs.reshape((n_in, n_out, S, S) + tuple(batch_shape))
        probs = probs.permute(*range(4, probs.dim()), 0, 1, 2, 3)
        return log_of_probs(probs)
