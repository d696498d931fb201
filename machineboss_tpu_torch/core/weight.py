"""Symbolic weight-expression algebra.

Transducer transition weights are symbolic expressions over named parameters.
This module is the TPU framework's host-side equivalent of the reference
weight algebra (ref: src/weight.h:54-114, src/weight.cpp), with the same
constant-folding rules and JSON round-trip so machine JSON output is
byte-compatible with the reference toolkit.

Representation (immutable, hashable):
  - int / float      : numeric constant
  - str              : named parameter
  - ('*',  l, r)     : product            - ('+', l, r) : sum
  - ('-',  l, r)     : difference         - ('/', l, r) : quotient
  - ('pow', a, b)    : power
  - ('log', x), ('exp', x) : unary

Downstream, expressions are either evaluated to doubles on the host (EM
M-step, EvaluatedMachine lowering) or compiled to JAX-traceable closures for
the differentiable/neural DP path (ops/exprjit.py).
"""

import math

from ..utils.jsonfmt import cpp_double, write_escaped

ZERO = 0
ONE = 1

_BINOPS = ("*", "+", "-", "/", "pow")
_UNOPS = ("log", "exp")


# ---------------------------------------------------------------------------
# constructors with reference-identical constant folding (src/weight.cpp:88-186)

def int_constant(v):
    return int(v)


def double_constant(v):
    if v == 0:
        return 0
    if v == 1:
        return 1
    return float(v)


def param(name):
    return name


def is_expr_node(w):
    return isinstance(w, tuple)


def is_number(w):
    return isinstance(w, (int, float)) and not isinstance(w, bool)


def as_double(w):
    if not is_number(w):
        raise ValueError("WeightExpr is not numeric: %r" % (w,))
    return float(w)


def is_zero(w):
    return is_number(w) and w == 0


def is_one(w):
    return is_number(w) and w == 1


def _is_int(w):
    return isinstance(w, int) and not isinstance(w, bool)


def multiply(l, r):
    if is_one(l):
        return r
    if is_one(r):
        return l
    if is_zero(l) or is_zero(r):
        return ZERO
    if _is_int(l) and _is_int(r):
        return int_constant(l * r)
    if is_number(l) and is_number(r):
        return double_constant(float(l) * float(r))
    return ("*", l, r)


def add(l, r):
    if is_zero(l):
        return r
    if is_zero(r):
        return l
    if is_expr_node(r) and r[0] == "-" and is_zero(r[1]):
        return subtract(l, r[2])
    if _is_int(l) and _is_int(r):
        return int_constant(l + r)
    if is_number(l) and is_number(r):
        return double_constant(float(l) + float(r))
    return ("+", l, r)


def subtract(l, r):
    if is_zero(r):
        return l
    return ("-", l, r)


def divide(l, r):
    if is_one(r):
        return l
    if is_zero(l):
        return ZERO
    # fold only if at least one side is a float (Int/Int stays symbolic)
    if is_number(l) and is_number(r) and (isinstance(l, float) or isinstance(r, float)):
        return double_constant(float(l) / float(r))
    return ("/", l, r)


def power(a, b):
    if is_one(b):
        return a
    if is_zero(b):
        return ONE
    return ("pow", a, b)


def log_of(p):
    if is_one(p):
        return ZERO
    if is_expr_node(p) and p[0] == "exp":
        return p[1]
    return ("log", p)


def exp_of(p):
    if is_zero(p):
        return ONE
    if is_expr_node(p) and p[0] == "log":
        return p[1]
    return ("exp", p)


def minus(x):
    """0 - x, kept as an explicit Sub node (ref: WeightAlgebra::minus)."""
    return ("-", ZERO, x)


def negate(p):
    """1 - p."""
    return subtract(ONE, p)


def reciprocal(p):
    """1 / p."""
    return divide(ONE, p)


def geometric_sum(p):
    """1 / (1 - p): sums the geometric series of a self-loop weight."""
    return reciprocal(negate(p))


# ---------------------------------------------------------------------------
# structural ops

def bind(w, defs):
    """Substitute parameter definitions into an expression."""
    if is_number(w):
        return w
    if isinstance(w, str):
        return bind(defs[w], defs) if w in defs else w
    op = w[0]
    if op in _UNOPS:
        return (op, bind(w[1], defs))
    return (op, bind(w[1], defs), bind(w[2], defs))


def evaluate(w, defs, _excluded=None):
    """Numerically evaluate; defs may map params to numbers or expressions."""
    if w is None:
        return 0.0
    if isinstance(w, bool):
        return 1.0 if w else 0.0
    if is_number(w):
        return float(w)
    if isinstance(w, str):
        if w not in defs or (_excluded and w in _excluded):
            raise KeyError("Parameter %s not defined" % w)
        val = defs[w]
        if is_number(val):
            return float(val)
        inner = set(_excluded) if _excluded else set()
        inner.add(w)
        return evaluate(val, defs, inner)
    op = w[0]
    if op == "log":
        v = evaluate(w[1], defs, _excluded)
        if v > 0:
            return math.log(v)
        return -math.inf if v == 0 else math.nan
    if op == "exp":
        try:
            return math.exp(evaluate(w[1], defs, _excluded))
        except OverflowError:
            return math.inf
    l = evaluate(w[1], defs, _excluded)
    r = evaluate(w[2], defs, _excluded)
    if op == "*":
        return l * r
    if op == "/":
        try:
            return l / r
        except ZeroDivisionError:
            return math.nan if l == 0 else math.copysign(math.inf, l) * math.copysign(1.0, r)
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "pow":
        return math.pow(l, r)
    raise ValueError("Unknown opcode %r" % op)


def deriv(w, defs, p):
    """Symbolic derivative d(w)/d(p), following definitions in defs."""
    if is_number(w) or w is None:
        return ZERO
    if isinstance(w, str):
        if w == p:
            return ONE
        if w in defs:
            inner = dict(defs)
            inner.pop(w, None)
            return deriv(defs[w], inner, p)
        return ZERO
    op = w[0]
    if op == "exp":
        return multiply(deriv(w[1], defs, p), w)
    if op == "log":
        return divide(deriv(w[1], defs, p), w[1])
    dl = deriv(w[1], defs, p)
    dr = deriv(w[2], defs, p)
    if op == "*":
        return add(multiply(dl, w[2]), multiply(w[1], dr))
    if op == "/":
        return subtract(divide(dl, w[2]), multiply(dr, divide(w, w[2])))
    if op == "+":
        return add(dl, dr)
    if op == "-":
        return subtract(dl, dr)
    if op == "pow":
        # w = a^b : w' = w * (b' log a + a' b / a)
        return multiply(w, add(multiply(dr, log_of(w[1])),
                               multiply(dl, divide(w[2], w[1]))))
    raise ValueError("Unknown opcode %r" % op)


def params_of(w, defs=None):
    """Set of free parameters (following definitions)."""
    defs = defs or {}
    out = set()
    _collect_params(w, defs, out, set())
    return out


def _collect_params(w, defs, out, visiting):
    if w is None or is_number(w):
        return
    if isinstance(w, str):
        if w in defs and w not in visiting:
            _collect_params(defs[w], {k: v for k, v in defs.items() if k != w},
                            out, visiting | {w})
        elif w not in defs:
            out.add(w)
        return
    op = w[0]
    if op in _UNOPS:
        _collect_params(w[1], defs, out, visiting)
    else:
        _collect_params(w[1], defs, out, visiting)
        _collect_params(w[2], defs, out, visiting)


def toposort_params(defs):
    """Topologically sort parameter definitions; raise on cyclic chains."""
    visited = set()
    order = []

    def visit(name, stack):
        if name in visited:
            if name in stack:
                cycle = stack[stack.index(name):]
                raise ValueError("Cyclic definition: %s -> %s"
                                 % (" -> ".join(cycle), name))
            return
        visited.add(name)
        stack.append(name)
        for dep in sorted(params_of(defs[name], {})):
            if dep in defs:
                visit(dep, stack)
        order.append(name)
        stack.pop()

    for name in sorted(defs):
        visit(name, [])
    return order


# ---------------------------------------------------------------------------
# JSON round trip (byte-compatible with reference toJsonStream/fromJson)

def to_json_str(w, memos=None):
    """Serialize to the reference's exact JSON text form."""
    if memos and w in memos and is_expr_node(w):
        return '"' + write_escaped(memos[w]) + '"'
    if w is None:
        return ""
    if isinstance(w, bool):
        return "1" if w else "0"
    if is_zero(w):
        return "0"
    if is_one(w):
        return "1"
    if _is_int(w):
        return str(w)
    if isinstance(w, float):
        return cpp_double(w, 15)
    if isinstance(w, str):
        return '"' + write_escaped(w) + '"'
    op = w[0]
    if op == "log" or op == "exp":
        return '{"%s":%s}' % (op, to_json_str(w[1], memos))
    if op == "pow":
        return '{"pow":[%s,%s]}' % (to_json_str(w[1], memos), to_json_str(w[2], memos))
    l, r = w[1], w[2]
    if op == "/":
        if is_one(l) and is_expr_node(r) and r[0] == "-" and is_one(r[1]):
            return '{"geomsum":%s}' % to_json_str(r[2], memos)
        return '{"/":[%s,%s]}' % (to_json_str(l, memos), to_json_str(r, memos))
    if op == "-":
        if is_one(l):
            return '{"not":%s}' % to_json_str(r, memos)
        return '{"-":[%s,%s]}' % (to_json_str(l, memos), to_json_str(r, memos))
    if op == "*" or op == "+":
        return '{"%s":[%s,%s]}' % (op, to_json_str(l, memos), to_json_str(r, memos))
    raise ValueError("Unknown opcode %r" % op)


def to_json(w, memos=None):
    import json as _json
    s = to_json_str(w, memos)
    return _json.loads(s) if s else None


def from_json(j, defs=None):
    """Parse the JSON expression form (ref schema/expr.json)."""
    if j is None:
        return None
    if isinstance(j, bool):
        return ONE if j else ZERO
    if isinstance(j, int):
        return int(j) if j not in (0, 1) else (ONE if j else ZERO)
    if isinstance(j, float):
        return double_constant(j)
    if isinstance(j, str):
        if defs and j in defs:
            return defs[j]
        return j
    if isinstance(j, list):
        raise ValueError("Unexpected type in WeightExpr: array")
    if not isinstance(j, dict) or not j:
        raise ValueError("WeightExpr must be a non-empty JSON object")
    opcode, args = next(iter(j.items()))
    if opcode == "log":
        return log_of(from_json(args, defs))
    if opcode == "exp":
        return exp_of(from_json(args, defs))
    if opcode == "not":
        return negate(from_json(args, defs))
    if opcode == "geomsum":
        return geometric_sum(from_json(args, defs))
    if opcode == "*":
        return multiply(from_json(args[0], defs), from_json(args[1], defs))
    if opcode == "/":
        return divide(from_json(args[0], defs), from_json(args[1], defs))
    if opcode == "+":
        return add(from_json(args[0], defs), from_json(args[1], defs))
    if opcode == "-":
        return subtract(from_json(args[0], defs), from_json(args[1], defs))
    if opcode == "pow":
        return power(from_json(args[0], defs), from_json(args[1], defs))
    if opcode == "expr":
        from .exprparse import parse_weight_expr
        return parse_weight_expr(args)
    raise ValueError("Unknown opcode %s in JSON" % opcode)


# ---------------------------------------------------------------------------
# infix printer (ref WeightAlgebra::toString, for DOT output and debug)

def to_string(w, defs=None, parent_prec=0):
    defs = defs or {}
    if w is None:
        return "0"
    if _is_int(w):
        return str(w)
    if isinstance(w, float):
        return "%f" % w  # C++ std::to_string
    if isinstance(w, str):
        if w in defs:
            inner = {k: v for k, v in defs.items() if k != w}
            return to_string(defs[w], inner, parent_prec)
        return w
    op = w[0]
    if op in ("log", "exp"):
        return "%s(%s)" % (op, to_string(w[1], defs))
    if op == "pow":
        return "pow(%s,%s)" % (to_string(w[1], defs), to_string(w[2], defs))
    prec = {"*": 2, "/": 2, "-": 1, "+": 1}[op]
    lprec = {"*": 2, "/": 2, "-": 0, "+": 0}[op]
    rprec = {"*": 2, "/": 3, "-": 2, "+": 0}[op]
    s = to_string(w[1], defs, lprec) + op + to_string(w[2], defs, rprec)
    if parent_prec > prec:
        s = "(" + s + ")"
    return s


# ---------------------------------------------------------------------------
# symbol-weighting macros (ref WeightAlgebra::makeSymbolExprs)

SYMBOL_PLACEHOLDER = "%"
ALPHABET_SIZE_PLACEHOLDER = "#"
DEFAULT_MACRO = "$p%"
UNIFORM_PRIOR_MACRO = "1/#"


def make_symbol_exprs(alphabet, macro=DEFAULT_MACRO):
    from .exprparse import parse_weight_expr
    out = {}
    m1 = (" " + macro + " ").replace(ALPHABET_SIZE_PLACEHOLDER, str(len(alphabet)))
    for sym in alphabet:
        s = m1.replace(SYMBOL_PLACEHOLDER, sym)
        out[sym] = parse_weight_expr(s)
    return out


def count_subexpr_refs(exprs):
    """Count references to each shared subexpression across a list of exprs.

    Used by Machine JSON output with define-exprs (memoized repeated
    subexpressions). Since Python tuples are structurally hashed, identical
    subtrees are a single key here, mirroring the reference's hash-consing.
    """
    counts = {}

    def walk(w):
        if not is_expr_node(w):
            if isinstance(w, str):
                counts[w] = counts.get(w, 0) + 1
            return
        c = counts.get(w, 0)
        counts[w] = c + 1
        if c:
            return
        if w[0] in _UNOPS:
            walk(w[1])
        else:
            walk(w[1])
            walk(w[2])

    for e in exprs:
        walk(e)
    return counts
