"""Metric "model families".

Counterpart of `ssim_tpu/models/`: multi-scale SSIM (Wang, Simoncelli &
Bovik 2003), built on the same fused kernels as the core metric.
"""

from .msssim import ms_ssim, compute_ms_ssim, MS_SSIM_WEIGHTS

__all__ = ["ms_ssim", "compute_ms_ssim", "MS_SSIM_WEIGHTS"]
