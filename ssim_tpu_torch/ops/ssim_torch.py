"""Plain PyTorch SSIM path.

Counterpart of `ssim_tpu/ops/ssim_xla.py`: edge padding, five separable
blurs (a, b, a*a, b*b, a*b) with symmetric tap pairs added smallest taps
first, the SSIM formula in f32, and per-row f32 sums that the engine
finalizes in f64. It serves `impl="torch"`, windows wider than the fused
kernel's `MAX_FUSED_RADIUS`, and dtypes the kernel does not take. It runs
on whatever device its tensors are on, and torch autograd differentiates
it.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ..windows import RADIUS, SIGMA, gaussian_taps


def _pad_edge(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Clamp-to-edge padding of the last two dims by `radius` (works for
    images smaller than the radius, down to 1x1)."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(-radius, h + radius, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-radius, w + radius, device=x.device).clamp_(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def blur_separable(x: torch.Tensor, taps: np.ndarray, radius: int = RADIUS) -> torch.Tensor:
    """Separable Gaussian blur over the last two dims of an edge-padded
    tensor. Input (..., H+2r, W+2r) -> output (..., H, W)."""
    h = x.shape[-2] - 2 * radius
    w = x.shape[-1] - 2 * radius
    t = [float(v) for v in taps]
    c = int(radius)
    # Row pass: (..., H+2r, W+2r) -> (..., H+2r, W)
    acc = None
    for d in range(radius, 0, -1):
        term = t[c - d] * (x[..., c - d : c - d + w] + x[..., c + d : c + d + w])
        acc = term if acc is None else acc + term
    acc = acc + t[c] * x[..., c : c + w]
    # Column pass: (..., H+2r, W) -> (..., H, W)
    out = None
    for d in range(radius, 0, -1):
        term = t[c - d] * (acc[..., c - d : c - d + h, :] + acc[..., c + d : c + d + h, :])
        out = term if out is None else out + term
    return out + t[c] * acc[..., c : c + h, :]


def ssim_from_padded(
    ap: torch.Tensor,
    bp: torch.Tensor,
    *,
    with_map: bool = False,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    data_range: float = 255.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """SSIM over already edge-padded f32 inputs (..., H+2r, W+2r).
    Returns (row_sums (..., H) f32, map (..., H, W) f32 or None)."""
    taps = gaussian_taps(np.float32, radius, sigma)
    c1 = float(np.float32((k1 * data_range) ** 2))
    c2 = float(np.float32((k2 * data_range) ** 2))

    mu_a = blur_separable(ap, taps, radius)
    mu_b = blur_separable(bp, taps, radius)
    s_a2 = blur_separable(ap * ap, taps, radius)
    s_b2 = blur_separable(bp * bp, taps, radius)
    s_ab = blur_separable(ap * bp, taps, radius)

    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_a2 = s_a2 - mu_a2
    sigma_b2 = s_b2 - mu_b2
    sigma_ab = s_ab - mu_ab

    num = (2.0 * mu_ab + c1) * (2.0 * sigma_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2)
    ssim_map = num / den
    return ssim_map.sum(dim=-1), (ssim_map if with_map else None)


def ssim_parts_torch(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    with_map: bool = False,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    data_range: float = 255.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """a, b: (..., H, W) tensors of any integer or float dtype. Returns
    (row_sums (..., H) f32, map (..., H, W) f32 or None)."""
    ap = _pad_edge(a.to(torch.float32), radius)
    bp = _pad_edge(b.to(torch.float32), radius)
    return ssim_from_padded(
        ap, bp, with_map=with_map, radius=radius, sigma=sigma,
        data_range=data_range, k1=k1, k2=k2,
    )
