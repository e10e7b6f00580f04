"""Distributed execution on torch.distributed.

Counterpart of `ssim_tpu/parallel/`, with its names:

- mesh.py      — `make_mesh` / `default_mesh`: a `DeviceMesh` whose
                 dimension names play the role of the JAX mesh's axis
                 names, over a process group the caller has initialised;
- batch.py     — data parallelism: a batch of image pairs split over a
                 mesh axis, each rank's images through the kernels' routes,
                 the per-image partials gathered, the map kept sharded (a
                 `DTensor`), the mean one all-reduce (the `psum`);
- spatial.py   — one large image split by rows over a mesh axis; the r
                 halo rows each side move between ranks with point-to-point
                 sends (the counterpart of `ppermute`), and each band runs
                 the forward kernel's row modes with halo operands, or the
                 backward kernel's halo mode;
- multihost.py — one process per rank: `initialize` (tcp:// or torchrun's
                 env://; nccl on the GPU, gloo on the CPU), `global_mesh`
                 over every process, and `distribute_batch`, each process's
                 own images as one global batch (a `DTensor`).
"""

from .mesh import default_mesh, make_mesh
from .batch import mean_ssim_sharded, ssim_batch_sharded
from .spatial import (
    mean_ssim_spatial,
    ssim_grad_spatial_sharded,
    ssim_spatial_sharded,
)
from . import multihost

__all__ = [
    "make_mesh",
    "default_mesh",
    "ssim_batch_sharded",
    "mean_ssim_sharded",
    "ssim_spatial_sharded",
    "ssim_grad_spatial_sharded",
    "mean_ssim_spatial",
    "multihost",
]
