"""Distributed execution on torch.distributed.

Counterpart of `ssim_tpu/parallel/` for the slices ported so far:

- mesh.py    — `make_mesh` / `default_mesh`: a `DeviceMesh` whose dimension
               names play the role of the JAX mesh's axis names, over a
               process group the caller has initialised;
- spatial.py — one large image split by rows over a mesh axis; the r
               halo rows each side move between ranks with point-to-point
               sends (the counterpart of `ppermute`), and each band runs
               the forward kernel's row modes with halo operands, or the
               backward kernel's halo mode.

`parallel/batch.py` and `parallel/multihost.py` of the JAX package are not
ported yet (ROADMAP).
"""

from .mesh import default_mesh, make_mesh
from .spatial import (
    mean_ssim_spatial,
    ssim_grad_spatial_sharded,
    ssim_spatial_sharded,
)

__all__ = [
    "make_mesh",
    "default_mesh",
    "ssim_spatial_sharded",
    "ssim_grad_spatial_sharded",
    "mean_ssim_spatial",
]
