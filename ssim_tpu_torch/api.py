"""Public API.

Counterpart of `ssim_tpu/api.py` for the eager entry points:

- `compute_ssim` takes images (NumPy arrays, torch tensors, ImageViews)
  or one `Params`, and returns the global SSIM as a Python float, or a
  (B,) float64 array for a batch, f64-finalized; with the map, also the
  per-pixel map as a float32 NumPy array.
- `compute_ssim_map` returns (score, map).
- `compute_ssim_legacy` returns the score, or the negated errno as a
  float on failure.

The JAX package's differentiable tensor functions `ssim`, `ssim_and_map`
and `ssim_loss` come with the port's backward kernel, in a later slice.
"""

import numpy as np
import torch

from . import engine
from .errors import InvalidArgumentError, SsimError
from .params import ImageView, Params, write_strided_map


def _unwrap(img):
    if isinstance(img, ImageView):
        return img.data
    if isinstance(img, torch.Tensor):
        return img
    return np.asarray(img)


def compute_ssim(
    a,
    b=None,
    *,
    with_map: bool = False,
    impl=None,
    data_range: float = 255.0,
    precision=None,
    downsample=None,
    accuracy=None,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    device=None,
):
    """Global SSIM of two single-channel images (or batches of them).

    Accepts either (a, b) as arrays/tensors/ImageViews, or a single
    `Params`. Returns `float` (or (B,) float64 array), or `(score, map)`
    when `with_map`. Keyword arguments as in `ssim_tpu.compute_ssim`,
    plus `device` (see engine.compute).
    """
    params = None
    if isinstance(a, Params):
        params = a
        if b is not None:
            raise TypeError("pass either Params or two images, not both")
        a, b = params.img_a.data, params.img_b.data
        with_map = params.with_map or params.map_buffer is not None
        impl = params.implementation
        data_range = params.data_range
    if downsample is not None and params is not None and params.map_buffer is not None:
        # Only an effective pooling conflicts with the full-image-sized
        # map_buffer; "auto" on a small image and downsample=1 are no-ops.
        arr = _unwrap(a)
        if engine.resolve_downsample(downsample, arr.shape[-2], arr.shape[-1]) > 1:
            raise InvalidArgumentError(
                "downsample produces a pooled-size map; a strided map_buffer "
                "is laid out for the full image — drop one of the two"
            )
    score, ssim_map = engine.compute(
        _unwrap(a), _unwrap(b), with_map=with_map, impl=impl,
        data_range=data_range, precision=precision, downsample=downsample,
        accuracy=accuracy, radius=radius, sigma=sigma, k1=k1, k2=k2,
        device=device,
    )
    if params is not None and params.map_buffer is not None:
        stride = params.map_stride
        if stride is None:
            stride = ssim_map.shape[-1] * params.map_step
        write_strided_map(
            params.map_buffer, ssim_map, params.map_step, stride,
            params.map_offset,
        )
    score = float(score) if np.ndim(score) == 0 else score
    if params.with_map if params is not None else with_map:
        return score, ssim_map
    return score


def compute_ssim_map(a, b, *, impl="auto", data_range: float = 255.0, device=None):
    """Convenience: return (global_ssim, per-pixel map)."""
    return compute_ssim(a, b, with_map=True, impl=impl, data_range=data_range,
                        device=device)


def compute_ssim_legacy(a, b=None, **kwargs) -> float:
    """The reference's deprecated float-returning overload: returns the
    global SSIM, or the negated errno as a float on failure instead of
    raising. Accepts the same arguments as compute_ssim."""
    try:
        result = compute_ssim(a, b, **kwargs)
    except SsimError as e:
        return -float(e.errno)
    return result[0] if isinstance(result, tuple) else result
