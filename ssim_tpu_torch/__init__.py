"""ssim_tpu_torch — the PyTorch and CUDA port of ssim_tpu.

Counterpart of `ssim_tpu/__init__.py` for the slices ported so far:

- the eager API (`compute_ssim`, `compute_ssim_map`, `compute_ssim_legacy`)
  on uint8 and float images, single or batched, at the standard f32 tier
  and the precise tier (`precision="f64"`), with or without the per-pixel
  map;
- training: the differentiable tensor functions `ssim`, `ssim_and_map`
  and `ssim_loss`;
- multi-scale SSIM, `ms_ssim` and `compute_ms_ssim`, for inference and
  training (`models/`).

They run through two hand-written CUDA kernels for Hopper, built with nvcc
at first use: the fused forward (`csrc/ssim_fwd.cu`; standard, map,
precise fp64, MS-SSIM components and pooled-components modes) and the
fused analytic
backward (`csrc/ssim_bwd.cu`), on CUDA tensors, and through each kernel's
plain PyTorch twin on CPU tensors. This package imports torch and NumPy,
never JAX or ssim_tpu.
"""

from .version import __version__, get_version
from .errors import SsimError, InvalidArgumentError, UnsupportedError
from .params import ImageView, Params, write_strided_map
from .windows import gaussian_taps, gaussian_kernel_2d, RADIUS, SIGMA, C1, C2
from .api import (
    compute_ssim, compute_ssim_legacy, compute_ssim_map, ssim, ssim_and_map,
    ssim_loss,
)
from .models import MS_SSIM_WEIGHTS, compute_ms_ssim, ms_ssim
from .dispatch import Implementation, select_impl, available_impls
from .config import Config, get_config, set_config
from . import reference

__all__ = [
    "__version__",
    "get_version",
    "SsimError",
    "InvalidArgumentError",
    "UnsupportedError",
    "ImageView",
    "Params",
    "write_strided_map",
    "gaussian_taps",
    "gaussian_kernel_2d",
    "RADIUS",
    "SIGMA",
    "C1",
    "C2",
    "compute_ssim",
    "compute_ssim_legacy",
    "compute_ssim_map",
    "ssim",
    "ssim_and_map",
    "ssim_loss",
    "ms_ssim",
    "compute_ms_ssim",
    "MS_SSIM_WEIGHTS",
    "Implementation",
    "select_impl",
    "available_impls",
    "Config",
    "get_config",
    "set_config",
    "reference",
]
