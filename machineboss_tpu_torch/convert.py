"""Carry a machine across from the JAX package's host output.

The JAX package writes a machine as JSON (Machine.to_json_str()) and its
parameters as JSON, and lowers a machine to numpy tensors
(LoweredMachine.matrices_2d(), emit_matrices_1d()), and its kernel factories
prepare host tensors from those. These helpers build the port's objects
from exactly that output, so both packages can be fed the same machine and
the same arrays.
"""

import json

import numpy as np
import torch

from .dispatch import CompiledMachine
from .ops.fused_plan7 import Plan7Fused
from .ops.fwdback import CountModel
from .ops.kernels.scan1d_kernel import prepare_scan1d, scan1d_operands
from .ops.kernels.viterbi_kernel import viterbi_operands
from .ops.kernels.wavefront_kernel import merged_operands
from .utils.device import resolve_device


def params_from_numpy(params, device=None):
    """A parameter dict of numbers and numpy arrays -> the same dict with
    float32 tensors on `device` (numbers stay numbers), for
    exprjit/dp_neural calls fed the values a JAX call is fed."""
    dev = resolve_device(device)
    return {k: v if isinstance(v, (int, float)) else
            torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in params.items()}


def lowered_from_numpy(a_diag, a_left, a_up, closure, device=None):
    """matrices_2d() numpy output -> float32 tensors on `device`."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
                 for x in (a_diag, a_left, a_up, closure))


def count_model_from_numpy(src, dst, itok, otok, logw, n_states, n_in,
                           n_out, device=None):
    """A JAX CountModel's arrays (np.asarray of its src, dst, itok, otok
    and logw) and sizes (n_states, n_in, n_out) -> the port's CountModel
    on `device`, holding the same edges and the same float32 log-weights,
    so both E-steps can run on identical inputs."""
    logw = torch.as_tensor(np.array(logw))
    return CountModel.from_edges(src, dst, itok, otok, logw, n_states, n_in,
                                 n_out, dtype=logw.dtype, device=device)


def compiled_from_json(machine_json, params_json=None, device=None):
    """The port's CompiledMachine from machine JSON text (and optional
    parameter JSON text, numeric assignments) on `device`."""
    machine = json.loads(machine_json)
    params = json.loads(params_json) if params_json is not None else None
    return CompiledMachine(machine, params, device=device)


def scan1d_from_numpy(trans, closure, device=None):
    """emit_matrices_1d() numpy output (log transfer matrices with the
    closure folded, and the closure) -> the 1D scan's operands on
    `device`."""
    return scan1d_operands(*prepare_scan1d(trans, closure),
                           resolve_device(device))


def merged_from_jax_layout(m_ud, m_left, c0, w, Ti, To, classes, sink,
                           device=None):
    """The JAX merged kernel family's host tensors -> MergedOperands on
    `device`.

    m_ud is the JAX factory's stacked matrix: one row block of Sa per
    output token (plus one "no output token" block when the left class
    rides along), column groups [up Sa][diag Ti*Sa][left Ti*Sa] for the
    present classes; m_left (Sa, Ti*Sa) is used only by a left-only
    machine. c0 and w are (Sa, 1) or (Sa,); classes is (has_up, has_left,
    has_diag). Each class's token blocks are cut out as they stand
    (destination x source), so the operands compute from the JAX package's
    own numbers."""
    has_up, has_left, has_diag = classes
    unify = has_left and (has_up or has_diag)
    c0 = np.asarray(c0, np.float32).reshape(-1)
    Sa = c0.shape[0]
    m_ud = np.asarray(m_ud, np.float32)
    mats = {}
    col = 0
    if has_up:
        mats["up"] = np.array([m_ud[t * Sa:(t + 1) * Sa, :Sa]
                               for t in range(To)]).reshape(To, Sa, Sa)
        col += Sa
    if has_diag:
        mats["diag"] = np.array(
            [m_ud[to * Sa:(to + 1) * Sa, col + ti * Sa:col + (ti + 1) * Sa]
             for ti in range(Ti) for to in range(To)]) \
            .reshape(Ti * To, Sa, Sa)
        col += Ti * Sa
    if has_left:
        src = m_ud[:Sa, col:] if unify else np.asarray(m_left, np.float32)
        mats["left"] = np.array([src[:, t * Sa:(t + 1) * Sa]
                                 for t in range(Ti)]).reshape(Ti, Sa, Sa)
    plan = {"Ti": Ti, "To": To, "Sa": Sa, "sink": bool(sink),
            "classes": tuple(bool(c) for c in classes),
            "mats": {k: np.ascontiguousarray(v) for k, v in mats.items()},
            "c0": c0, "w": np.asarray(w, np.float32).reshape(-1)}
    return merged_operands(plan, resolve_device(device))


def viterbi_from_numpy(mu, md, ml, c0, classes, device=None):
    """The JAX package's maxplus_class_mats output (numpy: the
    closure-folded, destination-major class matrices mu (To*S, S), md
    (To*S, Ti*S), ml (Ti*S, S), the start column c0 (S, 1) and the
    (has_up, has_left, has_diag) flags) -> the Viterbi fills' operands on
    `device`, so that both packages compute from the same numbers."""
    return viterbi_operands(
        (np.asarray(mu), np.asarray(md), np.asarray(ml), np.asarray(c0),
         tuple(bool(c) for c in classes)), resolve_device(device))


def plan7_from_numpy(hmm, td_ev, tables, em_stack=None, mb=None,
                     mloop_star=None, entry=None, scalars=None, device=None,
                     **config):
    """A port Plan7Fused that computes from another implementation's
    tables. `hmm` and `td_ev` are the port's own HmmerModel and
    EvaluatedMachine of the same profile and transducer, and `config` the
    constructor's options (mode, local, multihit, length, n_hit, solver,
    semiring, prob_space, dtype). `tables` maps the names of the JAX class's `_j`
    dict to numpy arrays; `em_stack`, `mb` (a dict) and `mloop_star` are
    its flat solver's `_em_stack`, `_mb` and `_mloop_star` where it has
    built them, `entry` its `_entry_np`, and `scalars` a dict of its
    log_loop, log_exit, b_to_* and i0_to_* floats."""
    fused = Plan7Fused(hmm, td_ev, device=device, **config)
    if entry is not None:
        fused._entry_np = np.asarray(entry, np.float64)
    for name, value in (scalars or {}).items():
        if not hasattr(fused, name):
            raise ValueError("Plan7Fused has no scalar %r" % name)
        setattr(fused, name, float(value))
    tables = {n: v for n, v in tables.items()
              if n != "entry" and v is not None}
    unknown = set(tables) - set(fused._j)
    if unknown:
        raise ValueError("unknown Plan7Fused tables %s" % sorted(unknown))
    fused._install(tables)

    if em_stack is not None:
        fused._em_stack = fused._tensor(em_stack)
    if mb is not None:
        if mloop_star is None:
            raise ValueError("mb needs mloop_star beside it")
        fused._mb = {n: fused._tensor(v) for n, v in mb.items()}
        fused._mloop_star = fused._tensor(mloop_star)
    return fused
