"""Numeric paths: the plain PyTorch path and the fused CUDA kernel.

Counterpart of `ssim_tpu/ops/`. The CUDA kernel is built from
`ssim_tpu_torch/csrc/` at first launch, never at import.
"""

from .ssim_torch import ssim_parts_torch, blur_separable
from .ssim_cuda import ssim_parts_cuda, ssim_parts_plain
from .routing import ssim_parts_auto, pallas_routable

__all__ = [
    "ssim_parts_torch",
    "blur_separable",
    "ssim_parts_cuda",
    "ssim_parts_plain",
    "ssim_parts_auto",
    "pallas_routable",
]
