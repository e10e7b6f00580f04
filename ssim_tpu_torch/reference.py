"""Naive high-precision SSIM oracle (host NumPy, no JAX).

Counterpart of `ssim_tpu/reference.py`, copied as it is: the port is held
against the same f64 oracle as the JAX package.

Rebuild of the reference's test-only naive implementation
(tests/ssim_naive.h:230-339): the ground truth every optimized path is
differentially tested against. Semantics pinned by it and reproduced here:

- clamp-to-edge (edge replication) borders — the reference replicates
  margins during tile fetch (tests/ssim_naive.h:156-222, src/ssim.cpp:515-583),
  which over the whole image is exactly `np.pad(..., mode="edge")`,
- 11x11 sigma=1.5 window normalized to sum 1 (see windows.py),
- SSIM(x,y) = ((2 muA muB + c1)(2 sigmaAB + c2)) /
              ((muA^2 + muB^2 + c1)(sigmaA^2 + sigmaB^2 + c2)),
  with the "blur the squares, subtract squared means" variance formulation
  (tests/ssim_naive.h:296-311, src/ssim.cpp:683-692),
- global SSIM = mean over all W*H per-pixel values (tests/ssim_naive.h:332).

Validated against the reference's frozen quad-precision scalars
(tests/rmgr-ssim-tests.cpp:352-465) to <= 1.2e-14 in float64 — within the
reference's own oracle tolerance REF_TOLERANCE = 1e-13
(tests/rmgr-ssim-tests.cpp:70-73).
"""

from typing import Optional, Tuple

import numpy as np

from .windows import C1, C2, RADIUS, SIGMA, gaussian_taps


def _blur_separable(x: np.ndarray, taps: np.ndarray, radius: int) -> np.ndarray:
    """Edge-padded separable blur over the last two axes, all in
    `x.dtype`; leading axes (batch) broadcast through."""
    h, w = x.shape[-2:]
    pad = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (radius, radius)]
    xp = np.pad(x, pad, mode="edge")
    rows = np.zeros(x.shape[:-2] + (h + 2 * radius, w), dtype=x.dtype)
    for i in range(2 * radius + 1):
        rows += taps[i] * xp[..., :, i : i + w]
    out = np.zeros(x.shape, dtype=x.dtype)
    for i in range(2 * radius + 1):
        out += taps[i] * rows[..., i : i + h, :]
    return out


def compute_ssim(
    a: np.ndarray,
    b: np.ndarray,
    *,
    dtype=np.float64,
    with_map: bool = False,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    data_range: float = 255.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[float, Optional[np.ndarray]]:
    """Oracle SSIM of two single-channel images.

    a, b: (H, W) arrays; uint8 or float. Returns (global_ssim, map or None);
    the map has dtype `dtype`, the global score is float64. Batched
    (B, H, W) pairs vectorize through the same NumPy blurs (one pass over
    the whole stack instead of a Python loop per image — the engine's
    f64-oracle batch route) and return ((B,) float64, (B, H, W) map).

    radius/sigma/k1/k2 generalize the window and stabilization constants
    (extension; defaults are the reference contract, src/ssim.cpp:227-228
    and :956-960).
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim not in (2, 3) or a.shape != b.shape:
        raise ValueError(
            f"expected matching (H, W) or (B, H, W) images, got "
            f"{a.shape} vs {b.shape}"
        )
    t = gaussian_taps(dtype, radius, sigma)
    af = a.astype(dtype)
    bf = b.astype(dtype)
    mu_a = _blur_separable(af, t, radius)
    mu_b = _blur_separable(bf, t, radius)
    sigma_a2 = _blur_separable(af * af, t, radius) - mu_a * mu_a
    sigma_b2 = _blur_separable(bf * bf, t, radius) - mu_b * mu_b
    sigma_ab = _blur_separable(af * bf, t, radius) - mu_a * mu_b
    c1 = dtype((k1 * data_range) ** 2)
    c2 = dtype((k2 * data_range) ** 2)
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * sigma_ab + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (sigma_a2 + sigma_b2 + c2)
    ssim_map = num / den
    if a.ndim == 2:
        global_ssim = float(ssim_map.mean(dtype=np.float64))
    else:
        global_ssim = ssim_map.mean(axis=(-2, -1), dtype=np.float64)
    return global_ssim, (ssim_map if with_map else None)
