"""ssim_tpu_torch — the PyTorch and CUDA port of ssim_tpu.

Counterpart of `ssim_tpu/__init__.py`:

- the eager API (`compute_ssim`, `compute_ssim_map`, `compute_ssim_legacy`)
  on uint8 and float images, single or batched, at the standard f32 tier
  and the precise tier (`precision="f64"`), with or without the per-pixel
  map;
- training: the differentiable tensor functions `ssim`, `ssim_and_map`
  and `ssim_loss`;
- multi-scale SSIM, `ms_ssim` and `compute_ms_ssim`, for inference and
  training (`models/`);
- distributed execution on torch.distributed (`parallel/`): batches of
  image pairs split over a mesh axis (`ssim_batch_sharded`,
  `mean_ssim_sharded`), one large image split by rows
  (`ssim_spatial_sharded`, `mean_ssim_spatial`,
  `ssim_grad_spatial_sharded`), and one process per rank
  (`parallel.multihost`: nccl or gloo, torchrun's environment, DTensor
  inputs); the entry points `entry.entry` and
  `entry.dryrun_multichip` (a distributed training step), and runnable
  examples (`examples/`);
- the relaxed accuracy tier (`accuracy="relaxed"`) of the eager,
  training and MS-SSIM functions: the heavy blurs as bf16x3 band
  products on the tensor cores;
- the edge-pad-and-align op, `ops.pad_align`, which no SSIM path calls
  (as in the JAX package);
- the user surface: the CLI (`python -m ssim_tpu_torch.cli`), the
  channel policies (`multichannel`), image I/O and the directory loader
  (`utils.imageio`, `utils.dataset`), profiling hooks (`utils.profiling`)
  and the native C++ host backend (`impl="host"`, `ops/host.py`, built
  with g++ at first use; no GPU);
- the testing layer (`testing/`): the frozen ground-truth scalars, the
  steady-state throughput harness (`testing.devicebench`, a CUDA-graph
  loop on the card) and the accuracy and throughput report
  (`python -m ssim_tpu_torch.testing.report`).

They run through three hand-written CUDA kernels for Hopper, built with
nvcc at first use: the fused forward (`csrc/ssim_fwd.cu`; standard, map,
precise fp64, MS-SSIM components and pooled-components, small-image
batch and row modes, and relaxed instantiations), the fused analytic
backward (`csrc/ssim_bwd.cu`, also relaxed) and the pad (`csrc/pad.cu`),
on CUDA tensors, and through each kernel's plain PyTorch twin on CPU
tensors. This package imports torch and NumPy, never JAX or ssim_tpu.
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
