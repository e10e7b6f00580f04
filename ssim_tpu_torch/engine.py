"""Core engine: validation, dispatch, and high-precision finalization.

Counterpart of `ssim_tpu/engine.py`: validate inputs, select an
implementation, move the images to the compute device, run the per-tile
path, and reduce the f32 partial sums into the global score in f64 on
the host (the reference's always-double accumulation, src/ssim.cpp:594).

What differs from the JAX engine:

- `compute` takes `device`: by default the input tensor's own device (the
  caller's choice, as in any PyTorch op), and for NumPy input `cuda`. On a
  machine without a GPU, NumPy input with no `device`, or an explicit
  `cuda`, raises UnsupportedError: the CPU is used only when asked for
  (`device="cpu"`, or CPU tensors). Only the host oracle needs no device:
  `impl="reference"`, and the `precision="f64"` calls the kernel does not
  serve (below).
- `precision="f64"` is routed as the JAX engine routes it
  (ssim_tpu/engine.py:277-292): impl `cuda`/`auto`, radius <= 16 and a
  pair of one dtype that embeds exactly in f32 (u8, u16, f16, bf16, f32)
  run the forward kernel's precise mode, which evaluates the blurs, the
  formula and the tile sums in native fp64 where the TPU kernel blurs in
  f32 and uses compensated df32; f64 inputs (the f32 cast would round
  them before the formula), mixed dtypes, radius > 16, `impl="torch"` and `impl="reference"` take
  the f64 oracle, as in the JAX package.
- The tile settings (`Config.max_tile_h/_w`) pin the kernel's tile after
  `ops.ssim_cuda.fit_tile` brings them into the range it takes; a
  setting below 1 raises InvalidArgumentError.
- `accuracy="relaxed"` reaches the kernel as the JAX engine passes it
  (ssim_tpu/engine.py:359): its relaxed modes at W >= 512 and on the
  batch route; the plain path computes the standard tier.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from .dispatch import Implementation, select_impl
from .errors import InvalidArgumentError, UnsupportedError

_TORCH_INTS = {
    torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.uint16, torch.uint32, torch.uint64,
}


def _is_ml_float(dt: np.dtype) -> bool:
    """ml_dtypes floats (bfloat16, float8s) are kind "V" to NumPy."""
    return dt.kind == "V" and dt.name.startswith(("bfloat16", "float"))


def _dtype_ok(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype.is_floating_point or x.dtype in _TORCH_INTS
    dt = np.dtype(x.dtype)
    return (
        np.issubdtype(dt, np.integer) or np.issubdtype(dt, np.floating)
        or _is_ml_float(dt)
    )


def validate_pair(a, b) -> None:
    """Input validation (reference EINVAL paths, src/ssim.cpp:962-978) for
    NumPy arrays and torch tensors alike."""
    if a.ndim not in (2, 3):
        raise InvalidArgumentError(
            f"images must be (H, W) or (B, H, W); got {tuple(a.shape)}"
        )
    if tuple(a.shape) != tuple(b.shape):
        raise InvalidArgumentError(
            f"image shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}"
        )
    if a.shape[-1] < 1 or a.shape[-2] < 1:
        raise InvalidArgumentError(f"empty image: {tuple(a.shape)}")
    if a.ndim == 3 and a.shape[0] < 1:
        raise InvalidArgumentError("empty batch")
    for x in (a, b):
        if not _dtype_ok(x):
            raise InvalidArgumentError(f"unsupported dtype {x.dtype}")


def validate_window(radius, sigma, k1, k2, data_range=None) -> None:
    """Validate the custom-window parameters (defaults are the reference
    contract: radius 5, sigma 1.5, k1 0.01, k2 0.03). With data_range
    given, also enforce the degeneracy floor c1*c2 >= 9e-32 for every
    compute path."""
    if isinstance(radius, bool) or not isinstance(radius, (int, np.integer)):
        raise InvalidArgumentError(f"radius must be an int >= 1, got {radius!r}")
    if radius < 1:
        raise InvalidArgumentError(f"radius must be >= 1, got {radius}")
    vals = {"sigma": sigma, "k1": k1, "k2": k2}
    for name, v in vals.items():
        if isinstance(v, bool) or not isinstance(
            v, (int, float, np.integer, np.floating)
        ):
            raise InvalidArgumentError(
                f"{name} must be a finite number > 0, got {v!r}"
            )
        if not (float(v) > 0.0 and np.isfinite(float(v))):
            raise InvalidArgumentError(
                f"{name} must be finite and > 0, got {v!r}"
            )
    if data_range is not None:
        c1 = (float(k1) * float(data_range)) ** 2
        c2 = (float(k2) * float(data_range)) ** 2
        if c1 * c2 < 9e-32:
            raise InvalidArgumentError(
                f"k1/k2 too small for data_range {data_range}: c1*c2 = "
                f"{c1 * c2:g} degenerates in f32 (needs >= 9e-32)"
            )


def accuracy_is_relaxed(accuracy) -> bool:
    """Validate an accuracy tier name and return whether it is the
    relaxed one."""
    if accuracy is None:
        return False
    if accuracy not in ("standard", "relaxed"):
        raise InvalidArgumentError(
            f'accuracy must be "standard" or "relaxed", got {accuracy!r}'
        )
    return accuracy == "relaxed"


def finalize_mean(partials: np.ndarray, npix: int) -> np.ndarray:
    """f64 host reduction of f32 partial sums -> global SSIM. partials:
    (..., K) per-row or per-tile f32 sums; returns (...) float64."""
    ps = np.asarray(partials, dtype=np.float64)
    # einsum, not ps.sum(axis=-1): NumPy's reduction over a short last axis
    # runs one small loop per row, which cost the batch route's (B, 2)
    # partials more host time at B = 8192 than its kernel saved (PERF.md).
    # Its other order of the f64 adds moves a score by a few ulps at most.
    return np.einsum("...k->...", ps) / np.float64(npix)


def downsample_factor(h: int, w: int) -> int:
    """The Wang-reference automatic prefilter factor f = round(min/256),
    rounding half away from zero like MATLAB."""
    return max(1, int(min(h, w) / 256.0 + 0.5))


def resolve_downsample(downsample, h: int, w: int) -> int:
    """Validate a downsample argument and resolve "auto" to the Wang
    factor for an h x w image. None -> 1 (no pooling)."""
    if downsample is None:
        return 1
    if downsample == "auto":
        return downsample_factor(h, w)
    if (
        isinstance(downsample, bool)
        or not isinstance(downsample, (int, np.integer))
        or downsample < 1
    ):
        raise InvalidArgumentError(
            f'downsample must be "auto" or an int >= 1, got {downsample!r}'
        )
    return int(downsample)


def box_decimate(x: np.ndarray, k: int) -> np.ndarray:
    """Host k x k box mean + decimation in f64, emitted f32 (the oracle
    path's pooling)."""
    h, w = x.shape[-2], x.shape[-1]
    hh, ww = h // k, w // k
    if hh < 1 or ww < 1:
        raise InvalidArgumentError(
            f"downsample factor {k} collapses a {h}x{w} image"
        )
    x = x[..., : hh * k, : ww * k].astype(np.float64)
    x = x.reshape(x.shape[:-2] + (hh, k, ww, k)).mean(axis=(-3, -1))
    return x.astype(np.float32)


def resolve_device(device, a=None, b=None) -> torch.device:
    """The compute device: `device` if given, else the first input
    tensor's own device, else cuda. Raises UnsupportedError for cuda on a
    machine without a GPU."""
    if device is None:
        for x in (a, b):
            if isinstance(x, torch.Tensor):
                return x.device
        if not torch.cuda.is_available():
            raise UnsupportedError(
                "NumPy input computes on the GPU by default and no GPU is "
                'available; pass device="cpu" to compute on the CPU'
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise UnsupportedError(f"device {device} requested but no GPU is available")
    return device


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """A NumPy array or tensor as a tensor on `device`, dtype kept
    (NumPy bfloat16 is reinterpreted bit for bit; other ml_dtypes floats
    widen exactly to f32 on the host)."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        if x.dtype.name == "bfloat16":
            x = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
        elif _is_ml_float(x.dtype):
            x = torch.from_numpy(x.astype(np.float32))
        else:
            x = torch.from_numpy(x)
    return x.to(device)


def _as_numpy(x) -> np.ndarray:
    """A tensor or array as a host NumPy array (bf16 widens to f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def compute(
    a,
    b,
    *,
    with_map: bool = False,
    impl=None,
    data_range: float = 255.0,
    precision: Optional[str] = None,
    downsample=None,
    accuracy: Optional[str] = None,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    device=None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Run SSIM end to end on NumPy arrays or torch tensors.

    a, b: (H, W) or (B, H, W). precision: "f32" or "f64" (the
    reference's RMGR_SSIM_USE_DOUBLE build: the kernel's fp64 mode, or
    the f64 oracle for the inputs listed in the module docstring).
    accuracy: "standard" or "relaxed" (the kernel's bf16x3 tensor-core
    blurs at W >= 512 and on the batch route; standard elsewhere). downsample: None, "auto" or an int k >= 1 (k x k box-mean
    prefilter, on the compute device; with precision="f64" on the
    kernel's route too, in f32 before the fp64 formula, as the JAX
    engine pools; the oracle pools on the host in f64).
    radius/sigma/k1/k2: the window; radius > 16 takes the plain PyTorch
    path (with precision="f64", the oracle). device: see the module
    docstring.
    Returns (global_ssim float64 scalar or (B,), map f32 NumPy or None).
    """
    from .config import get_config

    cfg = get_config()
    if impl is None or impl == "auto":
        impl = cfg.impl
    if precision is None:
        precision = cfg.precision
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    if not isinstance(b, torch.Tensor):
        b = np.asarray(b)
    validate_pair(a, b)
    validate_window(radius, sigma, k1, k2, data_range)
    radius = int(radius)
    downsample = resolve_downsample(downsample, a.shape[-2], a.shape[-1])
    if precision not in ("f32", "f64"):
        raise InvalidArgumentError(f"precision must be f32 or f64, got {precision!r}")
    relaxed = accuracy_is_relaxed(accuracy)
    if relaxed and precision == "f64":
        raise InvalidArgumentError(
            'accuracy="relaxed" contradicts precision="f64" — pick one tier'
        )
    impl = select_impl(impl)
    precise = precision == "f64"
    if precise:
        from .ops.routing import precise_routable

        if not (impl == Implementation.CUDA and precise_routable(a, b, radius)):
            # What the kernel's fp64 mode cannot serve exactly: f64 inputs
            # (the f32 cast would round them first), mixed dtypes,
            # radius > 16 and the other impls.
            impl = Implementation.REFERENCE

    if impl == Implementation.REFERENCE:
        from . import reference

        a, b = _as_numpy(a), _as_numpy(b)
        if downsample > 1:
            a = box_decimate(a, downsample)
            b = box_decimate(b, downsample)
        g, m = reference.compute_ssim(
            a, b, with_map=with_map, data_range=data_range, radius=radius,
            sigma=sigma, k1=k1, k2=k2,
        )
        m = None if m is None else m.astype(np.float32)
        if a.ndim == 2:
            return np.float64(g), m
        return np.asarray(g, dtype=np.float64), m

    dev = resolve_device(device, a, b)
    a = _as_tensor(a, dev)
    b = _as_tensor(b, dev)
    if downsample > 1:
        from .ops.pool import box_decimate_device

        a = box_decimate_device(a, downsample)
        b = box_decimate_device(b, downsample)
    h, w = a.shape[-2], a.shape[-1]
    window = dict(radius=radius, sigma=sigma, k1=k1, k2=k2)

    if impl == Implementation.CUDA:
        from .ops.routing import ssim_parts_auto

        tile_kwargs = {}
        if cfg.max_tile_h is not None or cfg.max_tile_w is not None:
            from .ops.ssim_cuda import fit_tile

            for name, v in (("max_tile_h", cfg.max_tile_h),
                            ("max_tile_w", cfg.max_tile_w)):
                if v is not None and v < 1:
                    raise InvalidArgumentError(f"{name} must be >= 1, got {v}")
            # Clamped into the kernel's range as the JAX engine clamps; any
            # setting keeps a batch of small images on the tile grid.
            tile_kwargs["tile_h"], tile_kwargs["tile_w"] = fit_tile(
                cfg.max_tile_h, cfg.max_tile_w, radius, precise)
        partials, ssim_map = ssim_parts_auto(
            a, b, with_map=with_map, data_range=data_range, precise=precise,
            relaxed=relaxed, **window, **tile_kwargs,
        )
    else:
        from .ops.ssim_torch import ssim_parts_torch

        partials, ssim_map = ssim_parts_torch(
            a, b, with_map=with_map, data_range=data_range, **window,
        )

    global_ssim = finalize_mean(partials.detach().cpu().numpy(), h * w)
    if ssim_map is not None:
        ssim_map = ssim_map.detach().cpu().numpy()
    return global_ssim, ssim_map
