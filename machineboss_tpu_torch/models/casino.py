"""Occasionally-dishonest-casino HMM model family.

The classic two-state Durbin et al. HMM the reference ships as its tutorial
workload (ref tutorial/casino.json, tutorial/casino-param.json,
tutorial/casino-cons.json; BASELINE.json workload #1). Provides the fixed
generator, the parameterized variant + constraints for EM refitting, and
decode/fit helpers.
"""

from ..core.machine import Machine
from ..core.params import Constraints

DICE = ["1", "2", "3", "4", "5", "6"]

# canonical tutorial parameter values
DEFAULTS = {
    "pEnd": 0.01,
    "changeToLoadedDie": 0.05,
    "changeToFairDie": 0.1,
    "loadedP6": 0.5,
}


def casino_machine(parameterized=False):
    """The two-state casino generator.

    parameterized=False: numeric weights (tutorial/casino.json values);
    parameterized=True: symbolic weights over {pEnd, changeToLoadedDie,
    changeToFairDie, loadedP6} with defs, ready for EM fitting
    (tutorial/casino-param.json shape)."""
    if not parameterized:
        fair_stay = 0.99 * 0.95 / 6.0
        fair_sw = 0.99 * 0.05 / 6.0
        loaded_other = 0.99 * 0.9 * 0.1
        loaded_p6 = 0.99 * 0.9 * 0.5
        sw_other = 0.99 * 0.1 * 0.1
        sw_p6 = 0.99 * 0.1 * 0.5
        states = [
            {"id": "Fair", "trans":
             [{"out": d, "to": "Fair", "weight": round(fair_stay, 5)}
              for d in DICE]
             + [{"out": d, "to": "Loaded", "weight": round(fair_sw, 5)}
                for d in DICE]
             + [{"to": "End", "weight": 0.01}]},
            {"id": "Loaded", "trans":
             [{"out": d, "to": "Loaded",
               "weight": loaded_p6 if d == "6" else loaded_other}
              for d in DICE]
             + [{"out": d, "to": "Fair",
                 "weight": sw_p6 if d == "6" else sw_other}
                for d in DICE]
             + [{"to": "End", "weight": 0.01}]},
            {"id": "End", "trans": []},
        ]
        return Machine.from_json({"state": states})

    def mul(*xs):
        return {"*": list(xs)}

    defs = {
        "pContinue": {"not": "pEnd"},
        "loadedPOther": {"/": [{"not": "loadedP6"}, 5]},
        "fairDie": {"/": [1, 6]},
        "fairStay": mul("pContinue", {"not": "changeToLoadedDie"}),
        "fairSwitch": mul("pContinue", "changeToLoadedDie"),
        "loadedStay": mul("pContinue", {"not": "changeToFairDie"}),
        "loadedSwitch": mul("pContinue", "changeToFairDie"),
    }
    states = [
        {"id": "Fair", "trans":
         [{"out": d, "to": "Fair", "weight": mul("fairStay", "fairDie")}
          for d in DICE]
         + [{"out": d, "to": "Loaded",
             "weight": mul("fairSwitch", "fairDie")} for d in DICE]
         + [{"to": "End", "weight": "pEnd"}]},
        {"id": "Loaded", "trans":
         [{"out": d, "to": "Loaded",
           "weight": mul("loadedStay",
                         "loadedP6" if d == "6" else "loadedPOther")}
          for d in DICE]
         + [{"out": d, "to": "Fair",
             "weight": mul("loadedSwitch",
                           "loadedP6" if d == "6" else "loadedPOther")}
            for d in DICE]
         + [{"to": "End", "weight": "pEnd"}]},
        {"id": "End", "trans": []},
    ]
    return Machine.from_json({"state": states, "defs": defs})


def casino_constraints():
    """Probability constraints for the four free parameters
    (tutorial/casino-cons.json)."""
    return Constraints.from_json(
        {"prob": ["pEnd", "changeToLoadedDie", "changeToFairDie",
                  "loadedP6"]})


def decode(rolls, parameterized=False, params=None):
    """Viterbi-decode a roll string to the Fair/Loaded state path.

    Returns (loglike, [state names])."""
    from .. import api
    m = casino_machine(parameterized)
    ll, path = api.viterbi_align(m, "", rolls, params=params)
    names = [m.states[t.dest].name for t in path.trans]
    return ll, names


def fit(roll_seqs, seed=None, device=None, **kw):
    """Baum-Welch fit of the parameterized casino to observed roll strings.

    With engine="device" the E-step runs on `device` (None: the CUDA
    card; "cpu" for the CPU). Returns the fitted Params."""
    from .. import api
    m = casino_machine(parameterized=True)
    seed = dict(seed or DEFAULTS)
    return api.baum_welch_fit(m, [("", r) for r in roll_seqs],
                              constraints=casino_constraints(),
                              seed=seed, device=device, **kw)
