"""ssim_tpu_torch — the PyTorch and CUDA port of ssim_tpu.

Counterpart of `ssim_tpu/__init__.py` for the slice ported so far: the
eager API (`compute_ssim`, `compute_ssim_map`, `compute_ssim_legacy`) on
uint8 and float images, single or batched, at the standard f32 tier with
or without the per-pixel map. It runs through one hand-written CUDA
kernel for Hopper (`csrc/ssim_fwd.cu`, built with nvcc at first use) on
CUDA tensors, and through that kernel's plain PyTorch twin on CPU
tensors. This package imports torch and NumPy, never JAX or ssim_tpu.
"""

from .version import __version__, get_version
from .errors import SsimError, InvalidArgumentError, UnsupportedError
from .params import ImageView, Params, write_strided_map
from .windows import gaussian_taps, gaussian_kernel_2d, RADIUS, SIGMA, C1, C2
from .api import compute_ssim, compute_ssim_legacy, compute_ssim_map
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
    "Implementation",
    "select_impl",
    "available_impls",
    "Config",
    "get_config",
    "set_config",
    "reference",
]
