"""Public API.

Counterpart of `ssim_tpu/api.py` for the eager entry points:

- `compute_ssim` takes images (NumPy arrays, torch tensors, ImageViews)
  or one `Params`, and returns the global SSIM as a Python float, or a
  (B,) float64 array for a batch, f64-finalized; with the map, also the
  per-pixel map as a float32 NumPy array.
- `compute_ssim_map` returns (score, map).
- `compute_ssim_legacy` returns the score, or the negated errno as a
  float on failure.
- `ssim` / `ssim_and_map` return the score as an f32 tensor on the
  inputs' device (and the map), and are differentiable for float inputs.
- `ssim_loss` is the differentiable 1 - mean(SSIM) loss.

For float32 images the gradient of the tensor functions is the fused
backward kernel (`ops/ssim_grad.py`, `csrc/ssim_bwd.cu`), wired through a
`torch.autograd.Function` as the JAX package wires its Pallas backward
through `jax.custom_vjp`. Every entry point runs on the inputs' device: a
tensor's own, or for NumPy input `cuda` unless `device` asks for the CPU
(engine.resolve_device).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from . import engine
from .dispatch import Implementation, select_impl
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
    plus `device` (see engine.compute). precision="f64" (or the
    SSIM_TPU_TORCH_PRECISION=f64 default) runs the forward kernel's fp64
    mode on the card, and the f64 oracle only for the inputs the JAX
    package sends there too (engine.compute).
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
    """Convenience: return (global_ssim, per-pixel map), at the
    configured default precision (Config.precision)."""
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


def _device_finalize(partials: torch.Tensor, n: int) -> torch.Tensor:
    """The mean of f32 partial sums, summed in native fp64 on the device
    and returned as f32 (the JAX package's compensated df32 tree has no
    use on a card with fp64 units). Differentiable."""
    return (partials.to(torch.float64).sum(-1) / n).to(torch.float32)


def _finish(parts, n: int, with_map: bool):
    partials, ssim_map = parts
    score = _device_finalize(partials, n)
    return (score, ssim_map) if with_map else score


class _FusedSsim(torch.autograd.Function):
    """Fused-kernel forward (ops/routing.ssim_parts_auto). The backward is
    the fused backward kernel when `kernel_vjp` (f32 images that
    grad_cuda_supported takes; the counterpart of api.py's
    _pallas_with_pallas_vjp), else autograd of the plain path
    ssim_parts_torch (_pallas_forward_with_xla_vjp)."""

    @staticmethod
    def forward(ctx, a, b, with_map, data_range, window, kernel_vjp, relaxed):
        from .ops.routing import ssim_parts_auto

        n = a.shape[-1] * a.shape[-2]
        out = _finish(
            ssim_parts_auto(a, b, with_map=with_map, data_range=data_range,
                            relaxed=relaxed, **window),
            n, with_map,
        )
        ctx.save_for_backward(a, b)
        ctx.set_materialize_grads(False)
        ctx.n, ctx.with_map, ctx.data_range = n, with_map, data_range
        ctx.window, ctx.kernel_vjp, ctx.relaxed = window, kernel_vjp, relaxed
        return out

    @staticmethod
    def backward(ctx, *grads):
        a, b = ctx.saved_tensors
        g_score, g_map = grads if ctx.with_map else (grads[0], None)
        none = (None,) * 5
        if g_score is None and g_map is None:
            return (None, None) + none
        if ctx.kernel_vjp:
            from .ops import ssim_grad

            w_s = 0.0 if g_score is None else g_score.to(torch.float32) / ctx.n
            if g_map is not None:
                g_map = g_map.to(torch.float32).contiguous()
            da, db = ssim_grad.ssim_grad_cuda(
                a.contiguous(), b.contiguous(), w_s, 0.0, g_map,
                data_range=ctx.data_range, relaxed=ctx.relaxed, **ctx.window,
            )
        else:
            from .ops.ssim_torch import ssim_parts_torch

            # Only float pairs reach here (integer inputs carry no
            # gradient), so both inputs can be differentiated.
            with torch.enable_grad():
                xa = a.detach().requires_grad_()
                xb = b.detach().requires_grad_()
                out = _finish(
                    ssim_parts_torch(xa, xb, with_map=ctx.with_map,
                                     data_range=ctx.data_range, **ctx.window),
                    ctx.n, ctx.with_map,
                )
                outs = out if ctx.with_map else (out,)
                pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
                da, db = torch.autograd.grad(
                    [o for o, _ in pairs], (xa, xb), [g for _, g in pairs])
        return (
            da if ctx.needs_input_grad[0] else None,
            db if ctx.needs_input_grad[1] else None,
        ) + none


def _run_metric(a, b, impl, data_range, with_map, accuracy, radius, sigma,
                k1, k2, device):
    """Shared body of ssim / ssim_and_map / ssim_loss: validation, then the
    routing of api.py:_run_metric in the JAX package:

    - impl other than auto/cuda, dtypes the kernel does not take, and
      radius > 16: the plain path ssim_parts_torch, ordinary autograd;
    - uint8: the fused forward kernel (no gradient);
    - float32 that grad_cuda_supported takes: fused forward and fused
      backward kernel;
    - other routable floats (f64, f16, bf16, u16): the fused forward with
      autograd of ssim_parts_torch as its gradient.

    accuracy="relaxed" reaches the forward kernel and the backward kernel
    (JAX api.py:284, :304), whose gates apply it at W >= 512 (and on the
    batch route); the plain path computes the standard tier."""
    from .ops.routing import pallas_routable, ssim_parts_auto
    from .ops.ssim_cuda import MAX_FUSED_RADIUS
    from .ops.ssim_grad import grad_cuda_supported
    from .ops.ssim_torch import ssim_parts_torch

    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    if not isinstance(b, torch.Tensor):
        b = np.asarray(b)
    engine.validate_pair(a, b)
    engine.validate_window(radius, sigma, k1, k2, data_range)
    relaxed = engine.accuracy_is_relaxed(accuracy)
    window = dict(radius=int(radius), sigma=sigma, k1=k1, k2=k2)
    resolved = select_impl(impl)
    dev = engine.resolve_device(device, a, b)
    a = engine._as_tensor(a, dev)
    b = engine._as_tensor(b, dev)
    h, w = a.shape[-2], a.shape[-1]
    n = h * w
    if (
        resolved != Implementation.CUDA
        or not pallas_routable(a, b)
        or window["radius"] > MAX_FUSED_RADIUS
    ):
        return _finish(
            ssim_parts_torch(a, b, with_map=with_map, data_range=data_range,
                             **window),
            n, with_map,
        )
    if a.dtype == torch.uint8:
        return _finish(
            ssim_parts_auto(a, b, with_map=with_map, data_range=data_range,
                            relaxed=relaxed, **window),
            n, with_map,
        )
    kernel_vjp = a.dtype == torch.float32 and grad_cuda_supported(
        h, w, window["radius"])
    return _FusedSsim.apply(a, b, with_map, data_range, window, kernel_vjp,
                            relaxed)


def ssim(
    a, b, *, data_range: float = 255.0, impl: str = "auto",
    accuracy: str = "standard", radius: int = 5, sigma: float = 1.5,
    k1: float = 0.01, k2: float = 0.03, device=None,
) -> torch.Tensor:
    """Global SSIM as an f32 tensor on the inputs' device. a, b: (H, W) or
    (B, H, W) tensors (or NumPy arrays). Returns a scalar for 2-D inputs,
    (B,) for batched. Differentiable for float inputs: f32 pairs take the
    fused backward kernel. Keyword arguments as in ssim_tpu.ssim, plus
    `device` (engine.resolve_device)."""
    return _run_metric(a, b, impl, data_range, False, accuracy, radius,
                       sigma, k1, k2, device)


def ssim_and_map(
    a, b, *, data_range: float = 255.0, impl: str = "auto",
    accuracy: str = "standard", radius: int = 5, sigma: float = 1.5,
    k1: float = 0.01, k2: float = 0.03, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global SSIM, per-pixel f32 map), differentiable like ssim(): for
    f32 inputs both cotangents go to the fused backward kernel (the map's
    as its per-pixel g_map input)."""
    return _run_metric(a, b, impl, data_range, True, accuracy, radius,
                       sigma, k1, k2, device)


def ssim_loss(
    a, b, *, data_range: float = 1.0, impl: str = "auto",
    accuracy: str = "standard", radius: int = 5, sigma: float = 1.5,
    k1: float = 0.01, k2: float = 0.03, device: Optional[str] = None,
) -> torch.Tensor:
    """Differentiable perceptual loss: 1 - mean SSIM over the batch.
    data_range defaults to 1.0 (float images in [0, 1]); pass 255.0 for
    u8-range inputs. impl="torch" differentiates the plain path."""
    score = _run_metric(a, b, impl, data_range, False, accuracy, radius,
                        sigma, k1, k2, device)
    return 1.0 - score.mean()
