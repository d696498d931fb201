"""Device meshes on torch.distributed (counterpart of machineboss_tpu's
parallel/mesh.py).

The framework's parallelism axes:
  'data'   : sequence batches (data parallel; EM counts merged by a SUM
             all_reduce)
  'len'    : sequence length (length-sharded associative scans, the
             context-parallel analog for WFST DP)
  'state'  : machine state dimension (sharded semiring matmuls for very
             large compositions, the tensor-parallel analog)

torch.distributed is SPMD: one process (rank) per device. A mesh is a
DeviceMesh over global ranks with those axis names; every rank calls the
parallel functions with the same global tensors and takes its own block
by its coordinate on an axis, and the collectives run on that axis's
group. A mesh on the card uses NCCL, a mesh on the CPU gloo. Where no
process group exists, `make_mesh` and `data_mesh` start a world of one in
this process (an in-memory store: no environment variables, no network);
a world of more ranks is the caller's (torchrun, or a launcher that calls
init_process_group), as jax.distributed.initialize is for multi-host JAX.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.device import resolve_device

AXES = ("data", "len", "state")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
WORLD_OF_ONE_TIMEOUT = datetime.timedelta(seconds=300)
# one tensor out, gathered in the group's order: all_gather_into_tensor,
# which newer torch renames all_gather_single (the card's 2.11 has only
# the first)
_GATHER_INTO = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _default_backend(device_type):
    """The default group's backend for `device_type` ("gloo", or per type
    when the group was made with several: "cpu:gloo,cuda:nccl")."""
    name = dist.get_backend()
    if ":" not in name:
        return name
    per_type = dict(part.split(":") for part in name.split(","))
    return per_type.get(device_type)


def _world(device):
    """The default process group for `device` (None: the card), started as
    a world of one where none exists. Returns the rank's device type."""
    dev = resolve_device(device)
    want = BACKENDS[dev.type]
    if dist.is_initialized():
        have = _default_backend(dev.type)
        if have != want:
            raise ValueError("a mesh on %s needs the %s backend; the default "
                             "process group uses %s" % (dev.type, want, have))
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device()
                                  if dev.index is None else dev.index)
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=WORLD_OF_ONE_TIMEOUT)
    return dev.type


def _ranks(devices):
    return list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]


def make_mesh(data=None, length=1, state=1, devices=None, device=None):
    """A (data, len, state) mesh over `devices`, a list of global ranks
    (default the whole world), on `device` (None: the card, "cpu")."""
    device_type = _world(device)
    ranks = _ranks(devices)
    n = len(ranks)
    if data is None:
        data = n // (length * state)
    shape = (data, length, state)
    if int(np.prod(shape)) != n:
        raise ValueError("mesh %s does not cover %d devices" % (shape, n))
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=AXES)


def data_mesh(devices=None, device=None):
    """A one-axis ('data') mesh over `devices` (default the world)."""
    return DeviceMesh(_world(device), torch.tensor(_ranks(devices)),
                      mesh_dim_names=("data",))


def replicated(mesh):
    """DTensor placements replicating a tensor over every mesh axis (for
    torch.distributed.tensor.distribute_tensor(t, mesh, placements))."""
    return [Replicate()] * mesh.ndim


def batch_sharding(mesh, axis="data"):
    """DTensor placements sharding dim 0 over `axis`, replicated over the
    other axes. distribute_tensor scatters the blocks in the axis group's
    rank order, which is the mesh's where the mesh lists each axis's ranks
    in increasing order (as make_mesh does by default); the functions of
    this package slice by mesh coordinate and take no placements."""
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


# -- what the parallel functions use -------------------------------------

def _dim(mesh, axis):
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError("the mesh has no axis %r (axes %s)" % (axis, names))
    return names.index(axis)


def axis_size(mesh, axis):
    """mesh.shape[axis] of a JAX mesh."""
    return int(mesh.mesh.shape[_dim(mesh, axis)])


def axis_index(mesh, axis):
    """This rank's coordinate on `axis` (jax.lax.axis_index). The
    coordinate, not the rank in the axis group: a group orders its ranks
    by global rank, which need not follow the mesh."""
    return int(mesh.get_coordinate()[_dim(mesh, axis)])


def mesh_device(mesh):
    """The device this rank computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class MeshAxis:
    """One axis of a mesh as this rank sees it: its size, this rank's
    coordinate, its process group, and the collectives on that group in
    coordinate order. A parallel function makes one when it is built."""

    def __init__(self, mesh, axis):
        self.size = axis_size(mesh, axis)
        self.index = axis_index(mesh, axis)
        self.group = mesh.get_group(axis)
        # the axis's global ranks in coordinate order, as positions in the
        # group's order
        coord = list(mesh.get_coordinate())
        coord[_dim(mesh, axis)] = slice(None)
        in_group = dist.get_process_group_ranks(self.group)
        order = [in_group.index(r) for r in mesh.mesh[tuple(coord)].tolist()]
        self.order = None if order == sorted(order) else order

    def block(self, n):
        """This rank's slice of n rows split evenly over the axis."""
        return slice(self.index * (n // self.size),
                     (self.index + 1) * (n // self.size))

    def all_gather(self, x):
        """(size, *x.shape): every rank's `x`, in coordinate order
        (jax.lax.all_gather, untiled)."""
        out = x.new_empty(self.size * x.numel())
        _GATHER_INTO(out, x.contiguous().reshape(-1), group=self.group)
        out = out.view((self.size,) + tuple(x.shape))
        return out if self.order is None else out[self.order]

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        """psum / pmax: `x` reduced in place and returned."""
        dist.all_reduce(x, op=op, group=self.group)
        return x


def all_gather(x, mesh, axis):
    """MeshAxis(mesh, axis).all_gather(x), for a single call."""
    return MeshAxis(mesh, axis).all_gather(x)
