"""Shared dtype routing for the fused kernel vs the plain PyTorch path.

Counterpart of `ssim_tpu/ops/routing.py`, with the same policy:

- uint8 pairs: the fused kernel's native path;
- float32/float64/float16/bfloat16 pairs and uint16 pairs: cast to f32
  (exact for u16 and the narrow floats) and take the kernel's sanitised
  float path;
- radius > MAX_FUSED_RADIUS and everything else (mixed dtypes, other
  integers): `ssim_parts_torch`.

The JAX package's lane-packed branch for batches of small images is TPU
lane machinery; here such batches take the same kernel, whose grid holds
one block per tile of every image, with the same one-score-per-image
output contract.
"""

from typing import Optional, Tuple

import torch

from .ssim_cuda import MAX_FUSED_RADIUS, ssim_parts_cuda
from .ssim_torch import ssim_parts_torch


def _is_float_routable(dt: torch.dtype) -> bool:
    return dt.is_floating_point or dt == torch.uint16


def ssim_parts_auto(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    with_map: bool = False,
    data_range: float = 255.0,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    **tile_kwargs,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused kernel when the dtype allows it, ssim_parts_torch otherwise.
    tile_kwargs (tile_h, tile_w) pin the kernel's tile."""
    window = dict(radius=radius, sigma=sigma, k1=k1, k2=k2)
    if radius > MAX_FUSED_RADIUS or not pallas_routable(a, b):
        return ssim_parts_torch(
            a, b, with_map=with_map, data_range=data_range, **window
        )
    if a.dtype == torch.uint8:
        return ssim_parts_cuda(
            a.contiguous(), b.contiguous(), with_map=with_map,
            data_range=data_range, **window, **tile_kwargs,
        )
    return ssim_parts_cuda(
        a.to(torch.float32).contiguous(), b.to(torch.float32).contiguous(),
        with_map=with_map, data_range=data_range, allow_float=True,
        **window, **tile_kwargs,
    )


def pallas_routable(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ssim_parts_auto would pick the fused kernel (for a radius
    it serves). The name follows the JAX package."""
    return (a.dtype == torch.uint8 and b.dtype == torch.uint8) or (
        a.dtype == b.dtype and _is_float_routable(a.dtype)
    )
