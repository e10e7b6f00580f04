"""Multi-process execution: the counterpart of `ssim_tpu/parallel/multihost.py`.

One process drives one rank (one GPU, or one CPU process for debugging).
`initialize` joins the processes into the default process group, as
`jax.distributed.initialize` wires a cluster; `global_mesh` is a mesh over
every rank of it; `distribute_batch` turns each process's own images into
one global batch split over a mesh axis (a `DTensor`, the counterpart of
`jax.make_array_from_process_local_data`), which `ssim_batch_sharded` and
`mean_ssim_sharded` take as it is. No process holds the global batch.

Under torchrun (`torchrun --nproc-per-node=N ...`) call `initialize()`
with no arguments: it reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE
(`env://`), as a TPU pod's processes find their topology on their own. For
a run without a launcher pass all three arguments.
"""

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..errors import UnsupportedError
from .mesh import MeshAxis, _world, dtensor_placements, make_mesh, mesh_device


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
) -> None:
    """Join (or create) the default process group of a multi-process run.

    coordinator_address ("host:port", rank 0's store), num_processes and
    process_id: all three, or none for torchrun's environment (`env://`).
    device "cuda": nccl, and this process's GPU is LOCAL_RANK (else its
    rank modulo the GPUs here); raises UnsupportedError where there is no
    GPU, never moving to the CPU. device "cpu": gloo. A second call in a
    process that already has a group does nothing.
    """
    device = torch.device(device).type
    if device == "cuda":
        if not torch.cuda.is_available():
            raise UnsupportedError(
                'initialize(device="cuda") needs a GPU and none is available; '
                'pass device="cpu" for gloo on the CPU')
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f'device must be "cuda" or "cpu", got {device!r}')
    given = [x is not None for x in (coordinator_address, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError("pass coordinator_address, num_processes and process_id "
                         "together, or none of them (torchrun's environment)")
    if dist.is_initialized():
        return
    if all(given):
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
        rank = int(process_id)
    else:
        kw = dict(init_method="env://")
        rank = int(os.environ.get("RANK", "0"))
    if device == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)


def global_mesh(shape: Sequence[int], axis_names: Sequence[str]):
    """A mesh over every rank of every process, in rank order (the leading
    axis varies slowest), on the group's device type: make_mesh over the
    whole world. prod(shape) must be the number of ranks: more raises
    "need n ranks", fewer leaves a process outside the mesh and raises
    "every process must own part of the mesh", the JAX package's errors."""
    n = int(np.prod(tuple(shape)))
    world = _world()
    if n > world:
        raise ValueError(f"need {n} ranks across all processes, have {world}")
    if n < world:
        raise ValueError(
            f"mesh shape {tuple(shape)} covers {n} of {world} processes; "
            f"every process must own part of the mesh (use more mesh devices "
            f"or fewer processes)")
    device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"
    return make_mesh(tuple(shape), tuple(axis_names), device_type)


def distribute_batch(local_batch, mesh, axis: str = "data") -> DTensor:
    """The global batch made of each process's own images: local_batch
    (B_local, H, W), an array or tensor, goes to the mesh's device as this
    rank's block of a DTensor split on dim 0 over `axis` (replicated on
    the other axes), whose global shape is (B_local * axis size, H, W).
    Every rank's block must have the same shape."""
    MeshAxis(mesh, axis)
    if not isinstance(local_batch, torch.Tensor):
        local_batch = torch.from_numpy(np.ascontiguousarray(local_batch))
    local = local_batch.to(mesh_device(mesh))
    return DTensor.from_local(local, mesh, dtensor_placements(mesh, {axis: 0}),
                              run_check=False)
