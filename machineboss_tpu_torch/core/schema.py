"""JSON input validation.

Hand-written validators with the same acceptance rules as the reference's
JSON-Schema set (ref: schema/*.json, enforced via src/schema.cpp on every
read). Invalid documents raise SchemaError, which callers convert to a
nonzero exit — mirroring the reference's input-fault rejection behavior.
"""


class SchemaError(ValueError):
    pass


def _fail(name, msg):
    raise SchemaError("%s JSON does not fit schema: %s" % (name, msg))


_MACHINE_OPS_BINARY = ("compose", "compose-sum", "compose-unsort", "concat",
                       "intersect", "intersect-sum", "intersect-unsort",
                       "union", "loop")
_MACHINE_OPS_UNARY = ("opt", "star", "plus", "eliminate", "merge",
                      "reverse", "revcomp", "transpose")

_EXPR_BINARY = ("*", "+", "/", "-", "pow")
_EXPR_UNARY = ("log", "exp", "geomsum", "not")


def _validate_expr(j):
    if isinstance(j, (bool, int, float, str)):
        return
    if isinstance(j, dict):
        if len(j) != 1:
            _fail("expr", "expression object must have exactly one key")
        (op, args), = j.items()
        if op == "expr":
            if not isinstance(args, str):
                _fail("expr", "'expr' value must be a string")
            return
        if op in _EXPR_UNARY:
            _validate_expr(args)
            return
        if op in _EXPR_BINARY:
            if not isinstance(args, list) or len(args) != 2:
                _fail("expr", "binary op %r needs a 2-element array" % op)
            for a in args:
                _validate_expr(a)
            return
        _fail("expr", "unknown opcode %r" % op)
    _fail("expr", "invalid expression %r" % (j,))


def _validate_machine(j):
    if not isinstance(j, dict):
        _fail("machine", "must be an object")
    for op in _MACHINE_OPS_BINARY:
        if op in j:
            if set(j.keys()) != {op}:
                _fail("machine", "extra keys beside %r" % op)
            if not isinstance(j[op], list) or len(j[op]) != 2:
                _fail("machine", "%r needs a 2-element array" % op)
            for sub in j[op]:
                _validate_machine(sub)
            return
    for op in _MACHINE_OPS_UNARY:
        if op in j:
            if set(j.keys()) != {op}:
                _fail("machine", "extra keys beside %r" % op)
            _validate_machine(j[op])
            return
    if "state" not in j:
        _fail("machine", "missing 'state'")
    extra = set(j.keys()) - {"state", "defs", "cons", "params"}
    if extra:
        _fail("machine", "unknown keys %r" % sorted(extra))
    if not isinstance(j["state"], list):
        _fail("machine", "'state' must be an array")
    for js in j["state"]:
        if not isinstance(js, dict):
            _fail("machine", "state must be an object")
        if "id" not in js and "n" not in js:
            _fail("machine", "state needs 'id' or 'n'")
        if set(js.keys()) - {"id", "n", "trans"}:
            _fail("machine", "unknown state keys")
        if "id" in js and isinstance(js["id"], (int, float)) and not isinstance(js["id"], bool):
            _fail("machine", "state id can't be a number")
        if "n" in js and not isinstance(js["n"], (int, float)):
            _fail("machine", "state n must be a number")
        for jt in js.get("trans", ()):
            if not isinstance(jt, dict):
                _fail("machine", "transition must be an object")
            if "to" not in jt:
                _fail("machine", "transition needs 'to'")
            keys = set(jt.keys())
            if "weight" in keys:
                if keys - {"to", "in", "out", "weight"}:
                    _fail("machine", "unknown transition keys")
                _validate_expr(jt["weight"])
            elif "expr" in keys:
                if keys - {"to", "in", "out", "expr"}:
                    _fail("machine", "unknown transition keys")
                if not isinstance(jt["expr"], str):
                    _fail("machine", "'expr' must be a string")
            else:
                if keys - {"to", "in", "out"}:
                    _fail("machine", "unknown transition keys")
            for io in ("in", "out"):
                if io in jt and not isinstance(jt[io], str):
                    _fail("machine", "'%s' must be a string" % io)
    if "defs" in j:
        _validate_defs(j["defs"])
    if "cons" in j:
        _validate_constraints(j["cons"])
    if "params" in j:
        if not isinstance(j["params"], list) or any(
                not isinstance(p, str) for p in j["params"]):
            _fail("machine", "'params' must be an array of strings")


def _validate_defs(j):
    if not isinstance(j, dict):
        _fail("defs", "must be an object")
    for v in j.values():
        _validate_expr(v)


def _validate_params(j):
    if not isinstance(j, dict):
        _fail("params", "must be an object")
    for v in j.values():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            _fail("params", "values must be numbers")


def _validate_constraints(j):
    if not isinstance(j, dict):
        _fail("constraints", "must be an object")
    if set(j.keys()) - {"prob", "rate", "norm"}:
        _fail("constraints", "unknown keys")
    for key in ("prob", "rate"):
        if key in j:
            if not isinstance(j[key], list) or any(
                    not isinstance(p, str) for p in j[key]):
                _fail("constraints", "'%s' must be an array of strings" % key)
    if "norm" in j:
        if not isinstance(j["norm"], list):
            _fail("constraints", "'norm' must be an array")
        for c in j["norm"]:
            if not isinstance(c, list) or len(c) < 1 or any(
                    not isinstance(p, str) for p in c):
                _fail("constraints", "norm groups must be non-empty string arrays")


def _validate_namedsequence(j):
    if not isinstance(j, dict):
        _fail("namedsequence", "must be an object")
    if "sequence" not in j:
        _fail("namedsequence", "missing 'sequence'")
    if set(j.keys()) - {"name", "sequence"}:
        _fail("namedsequence", "unknown keys")
    if not isinstance(j["sequence"], list) or any(
            not isinstance(s, str) for s in j["sequence"]):
        _fail("namedsequence", "'sequence' must be an array of strings")


def _validate_seqpair(j):
    if not isinstance(j, dict):
        _fail("seqpair", "must be an object")
    if "alignment" in j:
        if set(j.keys()) - {"input", "output", "alignment", "meta"}:
            _fail("seqpair", "unknown keys")
        if not isinstance(j["alignment"], list):
            _fail("seqpair", "'alignment' must be an array")
        for col in j["alignment"]:
            if (not isinstance(col, list) or len(col) != 2
                    or any(not isinstance(s, str) for s in col)):
                _fail("seqpair", "alignment columns must be string pairs")
        for io in ("input", "output"):
            if io in j:
                sub = j[io]
                if not isinstance(sub, dict) or "name" not in sub or \
                        set(sub.keys()) - {"name", "sequence"}:
                    _fail("seqpair", "bad %s spec" % io)
                if "sequence" in sub and (not isinstance(sub["sequence"], list) or any(
                        not isinstance(s, str) for s in sub["sequence"])):
                    _fail("seqpair", "bad %s sequence" % io)
    else:
        if "input" not in j or "output" not in j:
            _fail("seqpair", "needs 'input' and 'output'")
        if set(j.keys()) - {"input", "output", "meta"}:
            _fail("seqpair", "unknown keys")
        _validate_namedsequence(j["input"])
        _validate_namedsequence(j["output"])


def _validate_seqpairlist(j):
    if not isinstance(j, list):
        _fail("seqpairlist", "must be an array")
    for sp in j:
        _validate_seqpair(sp)


_VALIDATORS = {
    "machine": _validate_machine,
    "expr": _validate_expr,
    "defs": _validate_defs,
    "params": _validate_params,
    "constraints": _validate_constraints,
    "namedsequence": _validate_namedsequence,
    "seqpair": _validate_seqpair,
    "seqpairlist": _validate_seqpairlist,
}


def validate_or_die(name, j):
    _VALIDATORS[name](j)
