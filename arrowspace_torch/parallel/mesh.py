"""Shard meshes: the corpus axis N split over devices and processes.

PyTorch counterpart of ``arrowspace_tpu.parallel.mesh``.  The reference's
only parallelism is rayon fan-out inside one process; the JAX package
shards the N axis over a device mesh, where the build tiles, the λτ
batch and query scoring are data-parallel over N and only the query
top-k merge needs a collective (an all-gather of per-shard candidates,
the analogue of the reference's per-thread-heap merge at
core.rs:865-888).

A ``Mesh`` here is a (dcn, ici) grid of shards.  ``devices`` are the
shards this process holds, one ``torch.device`` each; a device may
repeat, so four shards on ``cuda:0`` are the counterpart of JAX's
virtual devices.  The processes of the default ``torch.distributed``
group (1 when none is initialised) each hold the same number of shards,
global shard ``s = rank·len(devices) + local``; while a group is
initialised (``grouped``, at any world size) the mesh's collectives go
through it; a mesh session switches its flagged rows from the strided
repair to the exact pass only when more than one process holds shards
(``multiprocess``), as the JAX package does.  In one process every
shard is local and a 2-D grid's dcn groups are virtual; across
processes each process holds whole ici groups.

Arrays split over the mesh are ``ShardedTensor``s: N cut into equal,
contiguous row shards (N must be a multiple of the shard count, as in
the JAX package), each on its shard's device.  No shard is ever moved
to another device by the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

ITEMS_AXIS = "items"

__all__ = ["ITEMS_AXIS", "Mesh", "ShardedTensor", "make_mesh",
           "make_mesh_2d", "items_sharding", "replicated_sharding",
           "shard_rows", "world"]


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) when
    torch.distributed is not initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _group_initialised() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A (dcn, ici) grid of shards; this process holds ``devices``."""

    def __init__(self, devices: Sequence, shape: Optional[Tuple[int, int]]
                 = None):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        assert self.devices, "a mesh needs at least one shard"
        self.rank, self.procs = world()
        self.grouped = _group_initialised()
        n_local = len(self.devices)
        if shape is None:
            shape = (self.procs, n_local)
        dcn, ici = int(shape[0]), int(shape[1])
        assert dcn * ici == n_local * self.procs, (
            f"a ({dcn}, {ici}) mesh needs {dcn * ici} shards; "
            f"{self.procs} process(es) hold {n_local} each")
        assert dcn % self.procs == 0 and n_local % ici == 0, (
            f"each of {self.procs} process(es) must hold whole ici groups "
            f"of {ici} shards")
        self.shape = (dcn, ici)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def first_device(self) -> torch.device:
        """Where replicated operands live and gathered results land."""
        return self.devices[0]

    @property
    def multiprocess(self) -> bool:
        """More than one process holds shards."""
        return self.procs > 1

    @property
    def local_shards(self) -> range:
        """Global shard ids of this process's shards, in order."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh of this process's shards, one per device of ``devices``
    (default: every visible CUDA device), over the processes of the
    default group.  The CPU is used only when the caller passes CPU
    devices (``devices=["cpu"] * 8``)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[...] for a mesh on other devices")
    devices = list(devices)
    if n_devices is not None:
        assert len(devices) >= n_devices, (
            f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


def make_mesh_2d(dcn: int, ici: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """(dcn, ici) mesh for the hierarchical merge: the items axis is
    split over both axes, and only k candidates per ici group cross the
    dcn axis.  Across processes dcn counts processes (each holding
    dcn / procs groups); in one process its groups are virtual."""
    _rank, procs = world()
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n_local = dcn * ici // procs
    assert len(devices) >= n_local, (
        f"need {n_local} devices in this process, have {len(devices)}")
    return Mesh(list(devices)[:n_local], shape=(dcn, ici))


@dataclass(frozen=True)
class ItemsSharding:
    """Rows split over the mesh's shards (the JAX package's
    ``NamedSharding(mesh, P("items", ...))``)."""
    mesh: Mesh
    ndim: int = 2


@dataclass(frozen=True)
class ReplicatedSharding:
    """One copy on the mesh's first device (``P()``)."""
    mesh: Mesh


def items_sharding(mesh: Mesh, axis_name: str = ITEMS_AXIS,
                   ndim: int = 2) -> ItemsSharding:
    return ItemsSharding(mesh, ndim)


def replicated_sharding(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


class ShardedTensor:
    """A global (N, ...) array split into equal contiguous row shards;
    ``shards`` are this process's, shard j on ``mesh.devices[j]``."""

    def __init__(self, shards: List[torch.Tensor], mesh: Mesh, n: int):
        assert len(shards) == mesh.n_local
        self.shards, self.mesh, self.n = list(shards), mesh, int(n)
        self.shard_n = self.n // mesh.size

    @property
    def shape(self) -> tuple:
        return (self.n,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def global_offset(self, j: int) -> int:
        """First global row of local shard j."""
        return self.mesh.local_shards[j] * self.shard_n

    def local(self) -> torch.Tensor:
        """This process's rows, concatenated on the mesh's first device."""
        dev = self.mesh.first_device
        return torch.cat([s.to(dev) for s in self.shards])

    def full(self) -> torch.Tensor:
        """The whole array on the mesh's first device (an all-gather
        across processes)."""
        from .multiprocess import all_gather_rows
        return all_gather_rows(self.local(), self.mesh)

    def numpy(self) -> np.ndarray:
        return self.full().cpu().numpy()

    def map(self, fn) -> "ShardedTensor":
        """fn applied to each local shard, on its device."""
        return ShardedTensor([fn(s) for s in self.shards], self.mesh, self.n)


def shard_rows(x, mesh: Mesh, dtype=None) -> ShardedTensor:
    """Split a global (N, ...) array (numpy, tensor, or already a
    ShardedTensor of this mesh) into the mesh's row shards.  Every
    process passes the same full value and keeps its own rows; a tensor
    already on a shard's device is sliced, not copied.  N must be a
    multiple of the mesh's shard count."""
    if isinstance(x, ShardedTensor):
        assert x.mesh is mesh or (x.mesh.size == mesh.size
                                  and x.mesh.devices == mesh.devices), \
            "a ShardedTensor of another mesh"
        return x if dtype is None else x.map(lambda s: s.to(dtype))
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    n = x.shape[0]
    assert n % mesh.size == 0, (
        f"N={n} must be padded to a multiple of the mesh size {mesh.size}")
    shard_n = n // mesh.size
    shards = []
    for j, s in enumerate(mesh.local_shards):
        part = x[s * shard_n:(s + 1) * shard_n]
        shards.append(part.to(device=mesh.devices[j],
                              dtype=dtype or part.dtype))
    return ShardedTensor(shards, mesh, n)
