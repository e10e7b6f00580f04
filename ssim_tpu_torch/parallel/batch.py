"""Batch data parallelism: image pairs sharded over a mesh axis.

Counterpart of `ssim_tpu/parallel/batch.py` on torch.distributed, with its
names and keywords. Work units are whole image pairs: each rank of the
axis computes its block of the batch through the same per-image route as
the single-device engine (`ops/routing.ssim_parts_auto`: the packed batch
stream for batches of small images, the tile grid's streaming kScore /
kMap otherwise), the per-image partials are gathered over the axis, the
map stays sharded on its device (a `DTensor`), and the mean is one
all-reduce (the counterpart of `psum`).

Inputs are either the whole (B, H, W) batch on every rank (tensors or
arrays, moved to the mesh's device; a rank copies only its block there),
or a `DTensor` split on dim 0 over `axis` (`multihost.distribute_batch`:
each process holds its own images and no process the whole batch), the
counterpart of a `jax.Array` under `NamedSharding(mesh, P(axis))`. Other
mesh axes replicate the work, as in JAX.

No gradient: the JAX functions have no VJP, and neither have these.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..dispatch import Implementation, select_impl
from ..engine import validate_window
from ..errors import UnsupportedError
from .mesh import MeshAxis, dtensor_layout, dtensor_placements, gather, mesh_device


def _parts_fn(impl, window):
    """The per-rank compute path (JAX's `_parts_fn`): the kernels'
    routing for "auto" / "cuda", the plain path for "torch"."""
    impl = select_impl("auto" if impl is None else impl)
    if impl == Implementation.CUDA:
        from ..ops.routing import ssim_parts_auto

        def parts(a, b, with_map, data_range):
            return ssim_parts_auto(a, b, with_map=with_map,
                                   data_range=data_range, **window)

        return parts
    if impl == Implementation.TORCH:
        from ..ops.ssim_torch import ssim_parts_torch

        def parts(a, b, with_map, data_range):
            return ssim_parts_torch(a, b, with_map=with_map,
                                    data_range=data_range, **window)

        return parts
    raise UnsupportedError(
        f"the sharded batch runs impl 'auto' / 'cuda' (the kernels) or "
        f"'torch' (the plain path), not {impl.value!r}"
    )


def _blocks(a, b, mesh, axis: str):
    """(this rank's blocks of a and b on the mesh's device, the axis, the
    global batch size B). Raises ValueError where the inputs are not
    (B, H, W) pairs of one shape, B does not divide the axis, or a DTensor
    is laid out otherwise than split on dim 0 over `axis`."""
    ax = MeshAxis(mesh, axis)
    device = mesh_device(mesh)
    a, b = (x if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    shape = tuple(a.shape)
    if len(shape) != 3 or shape != tuple(b.shape):
        raise ValueError(f"the sharded batch takes (B, H, W) pairs, got "
                         f"{shape} vs {tuple(b.shape)}")
    batch = shape[0]
    if batch % ax.n:
        raise ValueError(f"B={batch} must divide the {axis!r} axis ({ax.n})")
    blocks = []
    for x in (a, b):
        if isinstance(x, DTensor):
            if dtensor_layout(x, mesh) != {axis: 0}:
                raise ValueError(
                    f"a DTensor batch must be split on dim 0 over {axis!r} "
                    f"and replicated on the other axes, got {x.placements}")
            x = x.to_local()
        else:
            bd = batch // ax.n
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x[ax.k * bd:(ax.k + 1) * bd]))
            else:
                x = x.narrow(0, ax.k * bd, bd)
        blocks.append(x.to(device))
    return blocks[0], blocks[1], ax, batch


def ssim_batch_sharded(
    a,
    b,
    mesh,
    *,
    axis: str = "data",
    with_map: bool = False,
    data_range: float = 255.0,
    impl="auto",
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[torch.Tensor, Optional[DTensor]]:
    """Per-image SSIM over a batch sharded over `axis`.

    a, b: (B, H, W) with B divisible by the axis size: the whole batch on
    every rank, or a DTensor split on dim 0 over `axis`. Returns
    (partials (B, K) f32 per-image partial sums, gathered on every rank;
    map or None), the map a DTensor split on dim 0 over `axis`, which
    never leaves its device (`.to_local()` is this rank's images,
    `.full_tensor()` the global map). Finalize with
    engine.finalize_mean(partials, H*W). radius/sigma/k1/k2: the
    custom-window extension (see engine.compute).
    """
    validate_window(radius, sigma, k1, k2, data_range)
    parts = _parts_fn(impl, dict(radius=int(radius), sigma=sigma, k1=k1, k2=k2))
    a_s, b_s, ax, _ = _blocks(a, b, mesh, axis)
    with torch.no_grad():
        partials, ssim_map = parts(a_s, b_s, with_map, data_range)
        # Every rank's block has the same shape, so the same route and the
        # same K: the gathered blocks agree.
        partials = gather(partials, ax.group, 0)
    if not with_map:
        return partials, None
    return partials, DTensor.from_local(
        ssim_map, mesh, dtensor_placements(mesh, {axis: 0}), run_check=False)


def mean_ssim_sharded(
    a,
    b,
    mesh,
    *,
    axis: str = "data",
    data_range: float = 255.0,
    impl="auto",
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over a batch sharded over `axis` (inputs as in
    ssim_batch_sharded): each rank sums its images' scores in f64 (the
    engine's finalize), one all-reduce adds the sums over the axis. Returns
    a 0-d f32 tensor, the same on every rank (JAX: a replicated f32
    scalar). radius/sigma/k1/k2: the custom-window extension."""
    validate_window(radius, sigma, k1, k2, data_range)
    parts = _parts_fn(impl, dict(radius=int(radius), sigma=sigma, k1=k1, k2=k2))
    a_s, b_s, ax, batch = _blocks(a, b, mesh, axis)
    npix = a_s.shape[-2] * a_s.shape[-1]
    with torch.no_grad():
        partials, _ = parts(a_s, b_s, False, data_range)
        total = (partials.to(torch.float64).sum(-1) / npix).sum()
        if ax.n > 1:
            dist.all_reduce(total, group=ax.group)
    return (total / batch).to(torch.float32)
