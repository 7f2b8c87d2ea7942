"""The device mesh for data parallelism over streams (port of
audio_analyzer_rs_tpu/parallel/mesh.py).

Scale-out is data parallelism over the stream (or segment) axis: each rank
analyzes its share of independent streams, and the only collectives are
the fleet statistics and the gathers that put the shares back together.

JAX is single-controller: one process holds global arrays, and a `Mesh`
with a `NamedSharding` places their shards on its devices.
torch.distributed is multi-controller: every rank of a process group runs
the same program on its own share.  The counterparts keep JAX's contract
where a caller sees it:
  - `make_mesh` is a one-dimensional `DeviceMesh` named "data" over the
    process group's ranks; `mesh.size()` is JAX's `mesh.size`;
  - `batch_sharding(mesh)` is `NamedSharding(mesh, P("data"))`: `shard`
    takes this rank's contiguous share of every leaf's leading axis (what
    `jax.device_put` leaves on this rank's device), `gather` all-gathers
    the shares in rank order into the global array, on every rank;
  - `replicated(mesh)` is `NamedSharding(mesh, P())`: every rank holds the
    whole value; its `sum` is JAX's `psum` (an all-reduce).

Collectives run on the mesh's group.  NCCL moves CUDA tensors; gloo (the
CPU backend, and the one that runs two ranks on one card, where NCCL
refuses) has no CUDA path for an all-gather, so with a backend other than
NCCL a CUDA tensor is staged through the host by design: copied to the
CPU, collected there, copied back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"


def make_mesh(device_type: str = "cuda", world: int | None = None,
              axis_name: str = DATA_AXIS) -> DeviceMesh:
    """A 1-D data-parallel mesh over ranks [0, world) of the default process
    group (`world=None`: all of them).  Every rank of the group calls it
    (torch builds the mesh's group on all of them); a rank outside the
    mesh passes it to no entry point."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the process group first "
                           "(torch.distributed.init_process_group)")
    size = dist.get_world_size()
    world = size if world is None else int(world)
    if not 1 <= world <= size:
        raise ValueError(f"make_mesh: world {world} must be in [1, {size}]")
    return DeviceMesh(device_type, torch.arange(world),
                      mesh_dim_names=(axis_name,))


def check_mesh(mesh, device) -> None:
    """Raise unless `mesh` is a 1-D DeviceMesh of `device`'s type that holds
    this rank."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (make_mesh) or "
                        f"None, got {type(mesh).__name__}")
    if mesh.ndim != 1:
        raise ValueError(f"mesh must have one dimension, got {mesh.ndim}")
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"mesh is a {mesh.device_type} mesh, the analysis "
                         f"runs on {device}")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")


def _tree_map(fn, tree):
    """fn over the tensor and array leaves of tuples, lists and NamedTuples."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    raise TypeError(f"unsupported leaf {type(tree).__name__}")


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """t on the device the group's backend collects on (the host for a CUDA
    tensor unless the backend is NCCL), bools as uint8."""
    if t.device.type == "cuda" and "nccl" not in str(dist.get_backend(group)):
        t = t.cpu()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


class BatchSharding:
    """The leading axis split over the mesh in equal contiguous shares, rank
    r holding [r * n / size, (r + 1) * n / size)."""

    def __init__(self, mesh: DeviceMesh, axis_name: str = DATA_AXIS):
        self.mesh = mesh
        self.size = mesh.size()
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        self.rank = coord[0]
        self.group = mesh.get_group(axis_name)

    def bounds(self, n: int) -> tuple[int, int]:
        """This rank's share [lo, hi) of a leading axis of n."""
        if n % self.size:
            raise ValueError(f"a leading axis of {n} does not split over "
                             f"{self.size} ranks")
        share = n // self.size
        return self.rank * share, (self.rank + 1) * share

    def shard(self, tree):
        """This rank's share of every leaf's leading axis."""
        return _tree_map(lambda a: a[slice(*self.bounds(a.shape[0]))], tree)

    def gather(self, tree):
        """Every rank's share of every tensor leaf, concatenated in rank order
        along the leading axis: the global tensors, on every rank, on the
        leaves' device."""
        return _tree_map(self._gather_one, tree)

    def _gather_one(self, t: torch.Tensor) -> torch.Tensor:
        staged = _staged(t.contiguous(), self.group)
        parts = [torch.empty_like(staged) for _ in range(self.size)]
        dist.all_gather(parts, staged, group=self.group)
        return torch.cat(parts).to(device=t.device, dtype=t.dtype)


class Replicated:
    """Every rank holds the whole value; `sum` all-reduces over the mesh."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.group = mesh.get_group()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the mesh's ranks (JAX's `psum`), the same on
        every rank, on t's device."""
        staged = _staged(t, self.group).clone()
        dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=self.group)
        return staged.to(device=t.device, dtype=t.dtype)


def batch_sharding(mesh: DeviceMesh,
                   axis_name: str = DATA_AXIS) -> BatchSharding:
    """Shard the leading (stream or segment) axis across the mesh."""
    return BatchSharding(mesh, axis_name)


def replicated(mesh: DeviceMesh) -> Replicated:
    return Replicated(mesh)
