"""Carry a machine across from the JAX package's host output.

The JAX package writes a machine as JSON (Machine.to_json_str()) and its
parameters as JSON, and lowers a machine to numpy tensors
(LoweredMachine.matrices_2d()). These helpers build the port's objects from
exactly that output, so both packages can be fed the same machine.
"""

import json

import numpy as np
import torch

from .dispatch import CompiledMachine
from .utils.device import resolve_device


def lowered_from_numpy(a_diag, a_left, a_up, closure, device=None):
    """matrices_2d() numpy output -> float32 tensors on `device`."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
                 for x in (a_diag, a_left, a_up, closure))


def compiled_from_json(machine_json, params_json=None, device=None):
    """The port's CompiledMachine from machine JSON text (and optional
    parameter JSON text, numeric assignments) on `device`."""
    machine = json.loads(machine_json)
    params = json.loads(params_json) if params_json is not None else None
    return CompiledMachine(machine, params, device=device)
