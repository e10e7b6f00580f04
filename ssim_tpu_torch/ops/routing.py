"""Shared dtype routing for the fused kernel vs the plain PyTorch path.

Counterpart of `ssim_tpu/ops/routing.py`, with the same policy:

- uint8 pairs: the fused kernel's native path;
- float32/float64/float16/bfloat16 pairs and uint16 pairs: cast to f32
  (exact for u16 and the narrow floats) and take the kernel's sanitised
  float path;
- radius > MAX_FUSED_RADIUS and everything else (mixed dtypes, other
  integers): `ssim_parts_torch`.

`relaxed=True` (the relaxed tier, accuracy="relaxed") passes to the
kernel on both of its routes, whose wrappers apply it at W >= 512 on the
tile grid and always on the batch route (ssim_tpu/ops/routing.py:43-55);
`ssim_parts_torch` computes the standard tier regardless, as the JAX
package's XLA fallback does.

`precise=True` (the precise tier) passes to the kernel's fp64 modes on
both kernel routes. It never runs `ssim_parts_torch`, whose formula is
f32: with a radius over MAX_FUSED_RADIUS, a pair the kernel does not
take, or float64 inputs (the f32 cast would round them before the fp64
formula) it raises, and the caller takes the f64 oracle
(`engine.compute(precision="f64")` routes those cases there).

Batches of small images take the batch route where the JAX package
takes its lane-packed one (`batch_routable`, the gate of
ssim_tpu/ops/routing.py:74-87 letter for letter): the kernel's batch
modes, one partial pair per image, (B, 2) [sum(ssim - 1), H*W], for
uint8 and for the floats cast to f32, in both tiers. The packing itself
is TPU lane machinery and has no counterpart: only the route and the
per-image output contract carry over. A map, a pinned tile, a single
image or a width over PACK_MAX_W keep the tile grid, as in JAX.
"""

from typing import Optional, Tuple

import torch

from .ssim_cuda import (
    MAX_FUSED_RADIUS, pack_preferred, ssim_parts_batch_cuda, ssim_parts_cuda,
)
from .ssim_torch import ssim_parts_torch

_EXACT_F32 = ("uint8", "uint16", "float16", "bfloat16", "float32")


def _dtype_name(dt) -> str:
    """A NumPy (ml_dtypes included) or torch dtype's name without the
    "torch." prefix, so the two kinds compare."""
    return str(dt).removeprefix("torch.")


def _exact_f32_cast(dt) -> bool:
    """Dtypes that embed exactly in float32, so the precise tier loses
    nothing casting to the kernel's f32 input: u8 (native), u16, f16,
    bf16, f32 itself. f64 inputs would round before the fp64 formula
    could see the low bits; those keep the host f64 oracle. NumPy and
    torch dtypes alike (the port's copy of ssim_tpu/engine.py:102)."""
    return _dtype_name(dt) in _EXACT_F32


def precise_routable(a, b, radius: int) -> bool:
    """Whether the kernel's fp64 modes serve this pair exactly: one dtype
    that embeds exactly in f32 and radius <= MAX_FUSED_RADIUS. a, b:
    NumPy arrays or tensors. The rest (f64 inputs, mixed dtypes, larger
    radii) take the f64 oracle, as in ssim_tpu/engine.py:277-292."""
    return (
        radius <= MAX_FUSED_RADIUS
        and _dtype_name(a.dtype) == _dtype_name(b.dtype)
        and _exact_f32_cast(a.dtype)
    )


def _is_float_routable(dt: torch.dtype) -> bool:
    return dt.is_floating_point or dt == torch.uint16


def batch_routable(shape, *, with_map: bool, data_range: float,
                   itemsize: int, tile_kwargs) -> bool:
    """Whether a (B, H, W) input of the kernel's route takes the batch
    modes: the JAX package's pack_routable (ssim_tpu/ops/routing.py:74-87)
    letter for letter. No map, no pinned tile, a 3-D batch, data_range >=
    1e-6, pack_preferred(W, B, itemsize) (itemsize 1 for uint8, 4 for the
    f32 cast) and H * W < 2^24 (the count rides as an exact f32)."""
    return (
        not with_map
        and not tile_kwargs
        and len(shape) == 3
        and data_range >= 1e-6
        and pack_preferred(shape[-1], shape[0], itemsize=itemsize)
        and shape[-2] * shape[-1] < 1 << 24
    )


def ssim_parts_auto(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    with_map: bool = False,
    data_range: float = 255.0,
    precise: bool = False,
    relaxed: bool = False,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    **tile_kwargs,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused kernel when the dtype allows it, ssim_parts_torch otherwise;
    of the kernel's routes, the batch modes ((B, 2) partials per image, no
    map) where batch_routable, else the tile grid. precise: the kernel's
    precise tier (f64 partials); raises where the kernel cannot serve it.
    relaxed: the kernel's relaxed tier (an accuracy hint; the plain path
    ignores it). tile_kwargs (tile_h, tile_w) pin the tile grid's tile."""
    window = dict(radius=radius, sigma=sigma, k1=k1, k2=k2)
    gate = dict(with_map=with_map, data_range=data_range,
                tile_kwargs=tile_kwargs)
    if precise and not precise_routable(a, b, radius):
        raise ValueError(
            f"precise=True takes radius <= {MAX_FUSED_RADIUS} and pairs of "
            "one dtype that embeds exactly in f32 (u8, u16, f16, bf16, f32), "
            f"got {a.dtype}/{b.dtype} at radius {radius} — use the f64 "
            "oracle (engine.compute(precision='f64'))"
        )
    if radius > MAX_FUSED_RADIUS or not pallas_routable(a, b):
        return ssim_parts_torch(
            a, b, with_map=with_map, data_range=data_range, **window
        )
    if a.dtype == torch.uint8:
        a, b = a.contiguous(), b.contiguous()
        if batch_routable(a.shape, itemsize=1, **gate):
            return ssim_parts_batch_cuda(
                a, b, data_range=data_range, precise=precise, relaxed=relaxed,
                **window,
            ), None
        return ssim_parts_cuda(
            a, b, with_map=with_map, data_range=data_range, precise=precise,
            relaxed=relaxed, **window, **tile_kwargs,
        )
    af = a.to(torch.float32).contiguous()
    bf = b.to(torch.float32).contiguous()
    if batch_routable(af.shape, itemsize=4, **gate):
        return ssim_parts_batch_cuda(
            af, bf, data_range=data_range, allow_float=True, precise=precise,
            relaxed=relaxed, **window,
        ), None
    return ssim_parts_cuda(
        af, bf, with_map=with_map, data_range=data_range, allow_float=True,
        precise=precise, relaxed=relaxed, **window, **tile_kwargs,
    )


def pallas_routable(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ssim_parts_auto would pick the fused kernel (for a radius
    it serves). The name follows the JAX package."""
    return (a.dtype == torch.uint8 and b.dtype == torch.uint8) or (
        a.dtype == b.dtype and _is_float_routable(a.dtype)
    )
