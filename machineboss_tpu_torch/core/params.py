"""Parameter bindings and fitting constraints.

Host-side equivalents of the reference Params/Constraints
(ref: src/params.{h,cpp}, src/constraints.{h,cpp}). Definitions are kept in
insertion order internally but serialized in sorted key order, matching the
reference's std::map iteration.
"""

from . import weight as W
from ..utils.jsonfmt import write_escaped


class Params:
    """Mapping param name -> weight expression (numbers are plain numbers)."""

    def __init__(self, defs=None):
        self.defs = dict(defs) if defs else {}

    def copy(self):
        return Params(self.defs)

    def combine(self, other, overwrite=False):
        c = Params(self.defs)
        for name, d in other.defs.items():
            if not overwrite and name in c.defs:
                a = W.to_json_str(c.defs[name])
                b = W.to_json_str(d)
                if a != b:
                    raise ValueError(
                        "Inconsistent parameter definitions for %s: %s vs %s"
                        % (name, a, b))
            else:
                c.defs[name] = d
        return c

    def clear(self):
        self.defs = {}

    # -- JSON ---------------------------------------------------------------

    @classmethod
    def from_json(cls, j, numeric_only=False):
        from .schema import validate_or_die
        validate_or_die("params" if numeric_only else "defs", j)
        p = cls()
        for k in j:
            p.defs[k] = W.from_json(j[k])
        W.toposort_params(p.defs)  # raises on cyclic definitions
        return p

    def to_json_str(self):
        items = sorted(self.defs.items())
        return "{" + ",".join(
            '"%s":%s' % (write_escaped(k), W.to_json_str(v)) for k, v in items
        ) + "}"

    def __repr__(self):
        return "Params(%s)" % self.to_json_str()


def param_assign_from_json(j):
    """Numeric-only parameter assignments (ref ParamAssign)."""
    return Params.from_json(j, numeric_only=True)


def param_funcs_from_json(j):
    """Arbitrary expression definitions (ref ParamFuncs)."""
    return Params.from_json(j, numeric_only=False)


def _norm_cons_text(c):
    return "[" + ",".join('"%s"' % write_escaped(p) for p in c) + "]"


class Constraints:
    """prob (each in [0,1]), rate (>=0), norm (groups summing to 1)."""

    def __init__(self, prob=None, rate=None, norm=None):
        self.prob = list(prob) if prob else []
        self.rate = list(rate) if rate else []
        self.norm = [list(c) for c in norm] if norm else []

    def empty(self):
        return not (self.prob or self.rate or self.norm)

    def clear(self):
        self.prob, self.rate, self.norm = [], [], []

    @classmethod
    def from_json(cls, j):
        from .schema import validate_or_die
        validate_or_die("constraints", j)
        c = cls()
        for n in j.get("norm", []):
            c.norm.append([str(p) for p in n])
        c.prob = [str(p) for p in j.get("prob", [])]
        c.rate = [str(r) for r in j.get("rate", [])]
        return c

    def default_params(self):
        """Uniform distributions / 0.5 probs / unit rates (ref defaultParams)."""
        p = Params()
        for c in self.norm:
            for cp in c:
                p.defs[cp] = W.double_constant(1.0 / len(c))
        for pp in self.prob:
            p.defs[pp] = W.double_constant(0.5)
        for rp in self.rate:
            p.defs[rp] = W.int_constant(1)
        return p

    def by_param(self):
        t = {}
        for p in self.prob:
            t[p] = "prob[%s]" % p
        for r in self.rate:
            t[r] = "rate[%s]" % r
        for c in self.norm:
            ctype = "norm" + _norm_cons_text(c)
            for p in c:
                t[p] = ctype
        return t

    def combine(self, cons):
        result = Constraints(self.prob, self.rate, self.norm)
        types = self.by_param()

        def check(p, t):
            if p in types:
                if types[p] != t:
                    raise ValueError("Inconsistent constraints for %s: %s vs %s"
                                     % (p, types[p], t))
                return True
            return False

        for p in cons.prob:
            if not check(p, "prob[%s]" % p):
                result.prob.append(p)
                types[p] = "prob[%s]" % p
        for r in cons.rate:
            if not check(r, "rate[%s]" % r):
                result.rate.append(r)
                types[r] = "rate[%s]" % r
        for c in cons.norm:
            ctype = "norm" + _norm_cons_text(c)
            redundant = False
            for p in c:
                redundant = check(p, ctype) or redundant
            if not redundant:
                result.norm.append(list(c))
                for p in c:
                    types[p] = ctype
        return result

    def to_json_str(self):
        """Exact reference text layout (ref src/constraints.cpp writeJson)."""
        out = [" {"]
        l = 0
        if self.norm:
            l += 1
            out.append('"norm":\n  [')
            out.append(",\n   ".join(_norm_cons_text(c) for c in self.norm))
            out.append("]")
        if self.prob:
            out.append((",\n  " if l else "") + '"prob":[')
            l += 1
            out.append(",".join('"%s"' % write_escaped(p) for p in self.prob))
            out.append("]")
        if self.rate:
            out.append((",\n  " if l else "") + '"rate":[')
            l += 1
            out.append(",".join('"%s"' % write_escaped(r) for r in self.rate))
            out.append("]")
        out.append("}\n")
        return "".join(out)

    def __repr__(self):
        return "Constraints(prob=%r, rate=%r, norm=%r)" % (
            self.prob, self.rate, self.norm)
