"""Numeric paths: the plain PyTorch path and the fused CUDA kernels
(forward and backward).

Counterpart of `ssim_tpu/ops/`. The CUDA kernels are built from
`ssim_tpu_torch/csrc/` at first launch, never at import.
"""

from .ssim_torch import ssim_parts_torch, blur_separable
from .ssim_cuda import (
    ssim_components_cuda, ssim_components_plain, ssim_components_pooled_cuda,
    ssim_components_pooled_plain, ssim_parts_cuda, ssim_parts_plain,
    ssim_parts_precise_plain,
)
from .routing import ssim_parts_auto, pallas_routable
from .ssim_grad import grad_cuda_supported, ssim_grad_cuda, ssim_grad_plain

__all__ = [
    "ssim_parts_torch",
    "blur_separable",
    "ssim_parts_cuda",
    "ssim_parts_plain",
    "ssim_parts_precise_plain",
    "ssim_components_cuda",
    "ssim_components_plain",
    "ssim_components_pooled_cuda",
    "ssim_components_pooled_plain",
    "ssim_parts_auto",
    "pallas_routable",
    "grad_cuda_supported",
    "ssim_grad_cuda",
    "ssim_grad_plain",
]
