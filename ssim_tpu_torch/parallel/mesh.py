"""Device-mesh helpers: the counterpart of `ssim_tpu/parallel/mesh.py` on
`torch.distributed.device_mesh`.

A JAX mesh names its axes; here they become the `DeviceMesh`'s
`mesh_dim_names`, so `mesh.get_group(axis)` and
`mesh.get_local_rank(axis)` stand for the axis' collectives and
`jax.lax.axis_index(axis)`. One process drives one rank. The caller
initialises the default process group (`torch.distributed.
init_process_group`, with its own address, world size and rank); these
helpers never create one.
"""

from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


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
