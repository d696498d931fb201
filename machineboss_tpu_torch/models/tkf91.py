"""TKF91 statistical-alignment model family (Thorne, Kishino & Felsenstein
1991; ref preset tkf91root/tkf91branch generators js/tkf91*.js).

The root machine generates an ancestral sequence at insertion-deletion
equilibrium; the branch machine is the time-dependent transducer from
ancestor to descendant. Composing root (x) branch gives the pairwise joint;
chaining branch machines gives multi-branch evolution down a tree.
"""

import math

from ..core.presets import make_preset
from ..core.params import param_assign_from_json


def root_machine():
    """Equilibrium ancestral-sequence generator (preset tkf91root)."""
    return make_preset("tkf91root")


def branch_machine():
    """Ancestor -> descendant transducer (preset tkf91branch)."""
    return make_preset("tkf91branch")


def tkf91_params(ins_rate, del_rate, t=None):
    """Numeric TKF91 parameter assignment: insertion rate, deletion rate
    (ins_rate < del_rate for a proper equilibrium), and branch time for the
    branch machine. The presets' defs derive alpha/beta/kappa symbolically
    from these rates (ref js/tkf91*.js generator scripts)."""
    if not (0 < ins_rate < del_rate):
        raise ValueError("TKF91 requires 0 < insRate < delRate")
    p = {"insRate": ins_rate, "delRate": del_rate}
    if t is not None:
        p["time"] = t
    return param_assign_from_json(p)


def pair_machine():
    """Descendant-sequence generator: root composed with branch
    (ref: boss tkf91root '=>' tkf91branch). Conditioning on an ancestor
    instead is just the branch machine with the ancestor as input."""
    from ..core.machine import Machine
    return Machine.compose(root_machine(), branch_machine())
