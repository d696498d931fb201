"""E-step expected counts and M-step constrained objective.

MachineCounts accumulates posterior transition counts from Forward+Backward
(ref: src/counts.cpp:24-107). MachineObjective builds the symbolic M-step
objective E = -sum c*log(w) with the reference's constraint
reparameterizations (stick-breaking for norm groups, exp(-x^2) for probs,
x^2 for rates; ref src/counts.cpp:110-223), minimized by BFGS.

On TPU, the E-step runs batched on device (ops/fwdback.py) and per-shard
count tensors are merged with a single psum (parallel/em.py); this module is
the host-side M-step shared by both paths.
"""

import math

import numpy as np

from ..core import weight as W
from ..core.params import Params
from ..core.seqpair import Envelope
from .dp_host import ForwardMatrix, BackwardMatrix

TRANSFORMED_PARAM_PREFIX = "$x"

# GSL bfgs2 equivalents (ref src/counts.cpp:12-15)
STEP_SIZE = 0.1
LINE_SEARCH_TOL = 1e-4
EPSILON_ABSOLUTE = 1e-3
MAX_ITERATIONS = 100


class MachineCounts:
    def __init__(self, ev=None, data=None, envelopes=None):
        self.count = []
        self.loglike = 0.0
        if ev is not None:
            self.init(ev)
            if data is not None:
                from ..core.seqpair import SeqPair, SeqPairList
                if isinstance(data, SeqPair):
                    self.add(ev, data)
                else:
                    envs = list(envelopes) if envelopes else []
                    for n, sp in enumerate(data.seq_pairs):
                        env = envs[n] if n < len(envs) else Envelope(sp)
                        self.add(ev, sp, env)

    def init(self, ev):
        self.loglike = 0.0
        self.count = [np.zeros(ev.state[s].n_transitions)
                      for s in range(ev.n_states())]

    def add(self, ev, seq_pair, env=None):
        env = env if env is not None else Envelope(seq_pair)
        fwd = ForwardMatrix(ev, seq_pair, env)
        back = BackwardMatrix(ev, seq_pair, env)
        back.get_counts(fwd, counts=self)
        result = fwd.log_like()
        self.loglike += result
        return result

    def add_counts(self, other):
        for s in range(len(self.count)):
            self.count[s] += other.count[s]
        return self

    def param_counts(self, machine, prob):
        """Expected d(logLike)/d(log theta) per parameter (ref counts.cpp:90)."""
        param_count = {}
        for s, ms in enumerate(machine.states):
            for ti, trans in enumerate(ms.trans):
                c = self.count[s][ti]
                trans_params = W.params_of(trans.weight, {})
                if not trans_params:
                    continue
                w_val = W.evaluate(trans.weight, prob.defs)
                for p in trans_params:
                    d = W.deriv(trans.weight, {}, p)
                    param_count[p] = param_count.get(p, 0.0) + (
                        c * W.evaluate(d, prob.defs)
                        * float(prob.defs[p]) / w_val)
        return param_count

    def to_json_str(self):
        from ..utils.jsonfmt import cpp_double6
        rows = ["[" + ",".join(cpp_double6(v) for v in c) + "]"
                for c in self.count]
        return "[" + ",\n ".join(rows) + "]\n"

    def param_counts_json_str(self, machine, prob):
        from ..utils.jsonfmt import cpp_double6, write_escaped
        pc = self.param_counts(machine, prob)
        return "{" + ",".join(
            '"%s":%s' % (write_escaped(k), cpp_double6(v))
            for k, v in sorted(pc.items())) + "}"


def _make_square(tr_param):
    return W.multiply(tr_param, tr_param)


def _make_exp(tr_param):
    return W.exp_of(W.minus(_make_square(tr_param)))


class MachineObjective:
    """Constrained M-step objective with unconstrained reparameterization."""

    def __init__(self, machine, counts, cons, constants):
        self.constraints = machine.cons.combine(cons)
        self.constant_defs = machine.funcs.combine(constants).defs
        objective = W.ZERO
        for s, ms in enumerate(machine.states):
            for ti, trans in enumerate(ms.trans):
                term = W.multiply(W.double_constant(counts.count[s][ti]),
                                  W.log_of(trans.weight))
                objective = W.subtract(objective, term)
        self.objective = objective

        p = W.params_of(objective, {})
        self.transformed_param = []
        self.transformed_param_index = {}
        self.param_transform_defs = {}
        tr_idx = [0]

        def make_name(pname):
            while True:
                tr_idx[0] += 1
                tr = TRANSFORMED_PARAM_PREFIX + str(tr_idx[0])
                if tr not in p:
                    break
            self.transformed_param_index[pname] = len(self.transformed_param)
            self.transformed_param.append(tr)
            return tr

        # norm groups: p_i = (1 - exp(-x_i^2)) * prod_{k<i} exp(-x_k^2)
        for c in self.constraints.norm:
            not_prev = W.ONE
            for n, c_param in enumerate(c):
                if n + 1 == len(c):
                    self.param_transform_defs[c_param] = not_prev
                else:
                    tr = make_name(c_param)
                    not_this = _make_exp(tr)
                    self.param_transform_defs[c_param] = W.multiply(
                        not_prev, W.negate(not_this))
                    not_prev = W.multiply(not_prev, not_this)
        for p_param in self.constraints.prob:
            self.param_transform_defs[p_param] = _make_exp(make_name(p_param))
        for r_param in self.constraints.rate:
            self.param_transform_defs[r_param] = _make_square(make_name(r_param))

        self.all_defs = dict(self.constant_defs)
        self.all_defs.update(self.param_transform_defs)

        self.deriv = [W.deriv(self.objective, self.all_defs, tp)
                      for tp in self.transformed_param]

    def _eval_at(self, x):
        defs = dict(self.all_defs)
        for n, tp in enumerate(self.transformed_param):
            defs[tp] = W.double_constant(float(x[n]))
        return defs

    def optimize(self, seed):
        """BFGS minimize over transformed params, seeded from current values."""
        from scipy.optimize import minimize

        n = len(self.transformed_param)
        x0 = np.zeros(n)
        # invert the transforms to seed x (ref src/counts.cpp:233-259)
        for c in self.constraints.norm:
            p_sum = 0.0
            for k in range(len(c) - 1):
                c_param = c[k]
                p = float(W.evaluate(seed.defs[c_param], seed.defs))
                # once the leading members hold all the mass (1 - p_sum
                # rounds to 0 beside members of ~1e-17), the rest seed at
                # x = 0, p = 0; the reference divides by zero here
                rest = 1 - p_sum
                z = 1 - p / rest if rest > 0 else 1.0
                val = math.sqrt(max(-math.log(max(z, 1e-300)), 0.0))
                p_sum += p
                x0[self.transformed_param_index[c_param]] = val
        for p_param in self.constraints.prob:
            p = float(W.evaluate(seed.defs[p_param], seed.defs))
            x0[self.transformed_param_index[p_param]] = \
                math.sqrt(max(-math.log(max(p, 1e-300)), 0.0))
        for r_param in self.constraints.rate:
            r = float(W.evaluate(seed.defs[r_param], seed.defs))
            x0[self.transformed_param_index[r_param]] = math.sqrt(max(r, 0.0))

        def f(x):
            defs = self._eval_at(x)
            return W.evaluate(self.objective, defs)

        def g(x):
            defs = self._eval_at(x)
            return np.array([W.evaluate(d, defs) for d in self.deriv])

        if n:
            res = minimize(f, x0, jac=g, method="BFGS",
                           options={"gtol": EPSILON_ABSOLUTE,
                                    "maxiter": MAX_ITERATIONS})
            x = res.x
        else:
            x = x0

        final_defs = self._eval_at(x)
        final = Params(seed.defs)
        for pname, transform in self.param_transform_defs.items():
            final.defs[pname] = W.double_constant(
                W.evaluate(transform, final_defs))
        return final
