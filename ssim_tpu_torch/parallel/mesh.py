"""Device-mesh helpers: the counterpart of `ssim_tpu/parallel/mesh.py` on
`torch.distributed.device_mesh`.

A JAX mesh names its axes; here they become the `DeviceMesh`'s
`mesh_dim_names`, so `mesh.get_group(axis)` and
`mesh.get_local_rank(axis)` stand for the axis' collectives and
`jax.lax.axis_index(axis)`. One process drives one rank. The caller
initialises the default process group (`torch.distributed.
init_process_group`, with its own address, world size and rank, or
`multihost.initialize`); these helpers never create one.

A `DTensor` on such a mesh stands for a `jax.Array` under a
`NamedSharding`: each rank holds its block, and `dtensor_layout` reads
which axis splits which dimension (the PartitionSpec).
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "torch.distributed.init_process_group (its backend, address, "
            "world size and rank) before making a mesh"
        )
    return dist.get_world_size()


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """An explicit mesh of every rank of the default group, in rank order,
    shaped `shape` with the named axes. prod(shape) must equal the world
    size (the JAX helper takes the first prod(shape) devices; here each
    rank is a process, and every process joins the mesh)."""
    n = int(np.prod(shape))
    world = _world()
    if n != world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the group has {world}")
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(shape)} axes need as many names, got {tuple(axis_names)}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def default_mesh(axis_name: str = "data", n: Optional[int] = None,
                 device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over all ranks (n, if given, must be the world size)."""
    return make_mesh((_world() if n is None else n,), (axis_name,), device_type)


class MeshAxis:
    """One mesh axis as this rank sees it: its process group, size and
    this rank's index along it (`jax.lax.axis_index`)."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"the mesh has no axis {axis!r} (its axes: {names})")
        self.name = axis
        self.group = mesh.get_group(axis)
        self.n = dist.get_world_size(self.group)
        self.k = mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks of the mesh live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x, concatenated along dim in the group's order (a list
    all_gather, which gloo and nccl both serve)."""
    if dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def dtensor_layout(x: DTensor, mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: tensor dimension} for each mesh axis that splits the
    DTensor x (the others replicate it): the counterpart of reading a JAX
    array's PartitionSpec. Raises ValueError where x lies on another mesh,
    is a partial sum, has two axes on one dimension or a dimension the axis
    does not split evenly: the local block would not be what a caller
    reads it as."""
    if x.device_mesh != mesh:
        raise ValueError("the DTensor lies on another mesh than the one passed")
    names = tuple(mesh.mesh_dim_names or ())
    local = x.to_local()
    layout = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Replicate):
            continue
        if not isinstance(p, Shard):
            raise ValueError(f"a DTensor placed {p} on axis {names[i]!r} has no "
                             f"local block to read (Shard or Replicate only)")
        if p.dim in layout.values():
            raise ValueError(f"two mesh axes split dimension {p.dim} of the DTensor")
        n = mesh.size(i)
        if x.shape[p.dim] % n or local.shape[p.dim] * n != x.shape[p.dim]:
            raise ValueError(
                f"axis {names[i]!r} ({n}) splits dimension {p.dim} of "
                f"{tuple(x.shape)} unevenly (local {tuple(local.shape)})")
        layout[names[i]] = p.dim
    return layout


def dtensor_placements(mesh: DeviceMesh, layout: Dict[str, int]):
    """The placements of a DTensor with that layout: Shard(dim) on each
    named axis, Replicate on the others."""
    return [Shard(layout[name]) if name in layout else Replicate()
            for name in mesh.mesh_dim_names]
