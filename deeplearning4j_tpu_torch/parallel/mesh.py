"""Device-mesh construction (port of deeplearning4j_tpu/parallel/mesh.py).

The reference lays its devices out as a `jax.sharding.Mesh` with named
axes; the port lays out the ranks of the process group the same way, as
a `torch.distributed.device_mesh.DeviceMesh` with the same axis names in
the same order, ``AXES = ("pipe", "data", "seq", "model", "expert")``:

  data  — data parallelism (batch dim; gradient all-reduce)
  seq   — sequence/context parallelism (time dim; ring / Ulysses)
  model — tensor parallelism (hidden/head dims; megatron f / g)
  pipe  — pipeline parallelism (layer stages; send / recv)
  expert— must be 1 for training: expert parallelism rides 'data'

Rank ``ranks[i]`` sits at ``np.unravel_index(i, sizes)``, the position
``np.array(devices).reshape(sizes)`` gives device i in the reference, so
a parameter's shard lands on the same rank index on both sides.

The reference's `pcast_varying` (marking a constant as device-varying
for JAX's replication type system) has no counterpart: a torch rank's
tensors are its own, and nothing is typed by its replication.

A `Mesh` of one rank needs no process group: its groups are None and
every collective over it is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch._device import resolve_device

AXES = ("pipe", "data", "seq", "model", "expert")


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`: one entry a leading dimension, each
    an axis name, a tuple of axis names or None (not sharded); missing
    trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in its order."""
    return tuple(a for part in spec if part is not None
                 for a in ((part,) if isinstance(part, str) else part))


def shard_of(x, spec, mesh: "Mesh"):
    """This rank's block of the full array ``x`` (numpy or torch) under
    ``spec``: a dimension sharded over axes (a, b) is cut into
    size(a) * size(b) blocks and block coords[a] * size(b) + coords[b]
    kept, as `jax.sharding.NamedSharding` places them."""
    idx = []
    for dim, part in enumerate(spec):
        if part is None:
            idx.append(slice(None))
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + mesh.coords[a]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not divide over {axes} ({n})")
        size = x.shape[dim] // n
        idx.append(slice(i * size, (i + 1) * size))
    return x[tuple(idx)]


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Unspecified axes default to 1 (absent)."""
    data: int = 1
    seq: int = 1
    model: int = 1
    pipe: int = 1
    expert: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {"pipe": self.pipe, "data": self.data, "seq": self.seq,
                "model": self.model, "expert": self.expert}

    @property
    def n_devices(self) -> int:
        n = 1
        for v in self.axis_sizes().values():
            n *= v
        return n


class Mesh:
    """The ranks ``ranks`` laid out over `AXES` with the sizes of
    ``spec``, seen from this process: ``shape`` (axis -> size, as
    `jax.sharding.Mesh.shape`), ``coords`` (axis -> this rank's index,
    `lax.axis_index`), ``group(axis)`` (the process group of the ranks
    that differ from this one only along ``axis``; None at size 1),
    ``world`` (the group of all the mesh's ranks) and ``device``.
    ``member`` is False on a process of the job outside the mesh."""

    axis_names = AXES

    def __init__(self, spec: MeshSpec, ranks: Sequence[int], device,
                 device_mesh=None, world=None):
        self.spec = spec
        self.shape = spec.axis_sizes()
        self.ranks = tuple(int(r) for r in ranks)
        self.device = device
        self.device_mesh = device_mesh
        self.world = world
        me = dist.get_rank() if dist.is_initialized() else 0
        self.member = me in self.ranks
        self.rank = me
        sizes = [self.shape[a] for a in AXES]
        self._grid = np.array(self.ranks).reshape(sizes)
        if self.member:
            pos = np.argwhere(self._grid == me)[0]
            self.coords = {a: int(i) for a, i in zip(AXES, pos)}
        else:
            self.coords = {a: 0 for a in AXES}

    @property
    def size(self) -> int:
        return len(self.ranks)

    def group(self, axis: str):
        if self.shape[axis] == 1 or self.device_mesh is None:
            return None
        return self.device_mesh.get_group(mesh_dim=axis)

    def peer(self, axis: str, index: int) -> int:
        """The global rank at this rank's coordinates but ``index`` along
        ``axis``."""
        pos = [self.coords[a] for a in AXES]
        pos[AXES.index(axis)] = index
        return int(self._grid[tuple(pos)])

    def __repr__(self):
        sizes = ", ".join(f"{a}={self.shape[a]}" for a in AXES)
        return f"Mesh({sizes}; ranks={list(self.ranks)})"


# meshes already laid out, by (spec, ranks, device): a DeviceMesh makes
# one process group an axis, collectively, so a second layout of the same
# ranks reuses the first's
_MESHES: Dict[Tuple, Mesh] = {}


def make_mesh(spec: Optional[MeshSpec] = None, devices=None, *,
              device=None, **axes) -> Mesh:
    """Build a Mesh over ``devices`` (global ranks; default every rank of
    the process group, or rank 0 alone without one). Axis order is
    (pipe, data, seq, model, expert), as in the reference. ``device`` is
    this rank's device (default: the one `initialize_multihost` chose,
    else CUDA unless ``device="cpu"``). Every process of the group must
    call it with the same arguments (the axis groups are made
    collectively); a process outside ``devices`` gets a Mesh with
    ``member`` False."""
    if spec is None:
        spec = MeshSpec(**axes)
    elif axes:
        raise ValueError("pass either a MeshSpec or axis kwargs, not both")
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    devices = list(range(world)) if devices is None else list(devices)
    n = spec.n_devices
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    ranks = tuple(devices[:n])
    if device is None:
        from deeplearning4j_tpu_torch.parallel.multihost import rank_device
        device = rank_device()
    dev = resolve_device(device)
    key = (spec, ranks, str(dev))
    if key in _MESHES:
        return _MESHES[key]
    device_mesh = group = None
    if n > 1:
        if not joined:
            raise ValueError(f"a mesh of {n} ranks needs a process group: "
                             "call initialize_multihost first")
        from torch.distributed.device_mesh import DeviceMesh
        sizes = [spec.axis_sizes()[a] for a in AXES]
        device_mesh = DeviceMesh(dev.type,
                                 torch.tensor(ranks).reshape(sizes),
                                 mesh_dim_names=AXES)
        group = (dist.group.WORLD if n == world
                 else dist.new_group(list(ranks)))
    mesh = Mesh(spec, ranks, dev, device_mesh, group)
    _MESHES[key] = mesh
    return mesh


def data_parallel_mesh(n: Optional[int] = None, devices=None, *,
                       device=None) -> Mesh:
    """All ranks on the 'data' axis — the ParallelWrapper topology."""
    if devices is None:
        joined = dist.is_available() and dist.is_initialized()
        devices = list(range(dist.get_world_size() if joined else 1))
    devices = list(devices)
    n = len(devices) if n is None else n
    return make_mesh(MeshSpec(data=n), devices=devices, device=device)
