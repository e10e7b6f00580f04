"""Multi-scale SSIM (MS-SSIM).

Counterpart of `ssim_tpu/models/msssim.py`, the standard recipe of Wang,
Simoncelli & Bovik, "Multi-scale structural similarity for image quality
assessment" (Asilomar 2003):

- 5 scales, exponents (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
- the contrast-structure term cs averaged at every scale but the last,
  the full SSIM mean (l * cs) at the last,
- dyadic 2x2 mean pooling between scales.

Window, constants and borders are the core metric's (11x11, sigma 1.5 by
default, clamp-to-edge, c1/c2 from data_range).

Two pyramids, routed as the JAX package routes them:

- the kernels (`impl` "auto" or "cuda" on uint8 or float32 pairs):
  uint8 runs the pooled components kernel at every scale but the last,
  whose pooled images feed the next scale (f32 from scale 1 on), and the
  components kernel at the last; float32 runs the components kernel at
  every scale through `_CsSsimSums`, whose backward is the fused backward
  kernel (w_s + w_cs), with `downsample2` between scales as a plain
  differentiable op (XLA's reduce_window in the JAX package);
  accuracy="relaxed" passes to every kernel, forward and backward, whose
  gates apply it at the scales with W >= 512 (JAX msssim.py:73-148);
- the plain pyramid `_ms_torch_forward` (every other impl, dtype or mixed
  pair), differentiated by autograd.

On CPU tensors each kernel wrapper runs its plain twin. The per-scale
partials are summed per image in fp64 on the device.
"""

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import engine
from ..dispatch import Implementation, select_impl
from ..ops import ssim_cuda, ssim_grad
from ..ops.pool import downsample2 as _downsample2
from ..ops.ssim_torch import _pad_edge, blur_separable
from ..windows import RADIUS, SIGMA, gaussian_taps

#: The canonical 5-scale exponents (Wang et al. 2003, table 1).
MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _l_cs_maps(a, b, c1, c2, taps):
    """Luminance-term and contrast-structure-term maps of one scale.
    a, b: float (..., H, W)."""
    ap = _pad_edge(a, RADIUS)
    bp = _pad_edge(b, RADIUS)
    s = ap + bp
    d = ap - bp
    sig = torch.stack([ap, bp, s * s, d * d], dim=0)
    mu_a, mu_b, ss, dd = blur_separable(sig, taps, RADIUS)
    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_ab_x4 = (ss - dd) - 4.0 * mu_ab
    sigma_sum_x2 = (ss + dd) - 2.0 * (mu_a2 + mu_b2)
    l_map = (2.0 * mu_ab + c1) / (mu_a2 + mu_b2 + c1)
    cs_map = (0.5 * sigma_ab_x4 + c2) / (0.5 * sigma_sum_x2 + c2)
    return l_map, cs_map


def _check_levels(a, levels):
    min_side = min(a.shape[-1], a.shape[-2])
    if min_side < (2 * RADIUS + 1) * 2 ** (levels - 1):
        raise ValueError(
            f"image side {min_side} too small for {levels} scales; "
            f"needs >= {(2 * RADIUS + 1) * 2 ** (levels - 1)} (pass fewer weights)"
        )


def _term(mean, w):
    """One scale's factor from its mean cs (the coarsest scale: its full
    SSIM mean, Wang 2003 eq. 7). Negative means are clamped (a^w is
    undefined for a < 0; the eps keeps gradients finite)."""
    return mean.clamp_min(1e-6) ** w


class _CsSsimSums(torch.autograd.Function):
    """Per-image differentiable (..., 2) fp64 [sum cs, sum ssim] of one
    scale: the components kernel forward, the fused backward kernel as its
    VJP (counterpart of msssim.py:_cs_ssim_sums_diff). The cotangent's
    [..., 0] is w_cs, its [..., 1] w_s."""

    @staticmethod
    def forward(ctx, xa, xb, data_range, window, relaxed):
        parts = ssim_cuda.ssim_components_cuda(xa, xb, data_range=data_range,
                                               relaxed=relaxed, **window)
        ctx.save_for_backward(xa, xb)
        ctx.data_range, ctx.window, ctx.relaxed = data_range, window, relaxed
        return parts.to(torch.float64).sum(-2)

    @staticmethod
    def backward(ctx, g):
        xa, xb = ctx.saved_tensors
        da, db = ssim_grad.ssim_grad_cuda(
            xa, xb, g[..., 1], g[..., 0], data_range=ctx.data_range,
            relaxed=ctx.relaxed, **ctx.window,
        )
        return (da if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None, None, None, None)


def _ms_cuda_forward(a, b, data_range, weights, window, relaxed=False):
    """The kernels' pyramid (counterpart of _ms_pallas_forward) on a
    uint8 or float32 pair; returns f32 (...). relaxed: the kernels'
    relaxed tier at every scale (each kernel's gate decides)."""
    levels = len(weights)
    diff = a.dtype == torch.float32
    x_a, x_b = a.contiguous(), b.contiguous()
    result = None
    for lvl, w in enumerate(weights):
        n = x_a.shape[-2] * x_a.shape[-1]
        last = lvl == levels - 1
        if diff:
            sums = _CsSsimSums.apply(x_a, x_b, data_range, window, relaxed)
        elif last:
            sums = ssim_cuda.ssim_components_cuda(
                x_a, x_b, data_range=data_range, relaxed=relaxed, **window,
            ).to(torch.float64).sum(-2)
        else:
            parts, pool_a, pool_b = ssim_cuda.ssim_components_pooled_cuda(
                x_a, x_b, data_range=data_range, relaxed=relaxed, **window,
            )
            sums = parts.to(torch.float64).sum(-2)
        term = _term(sums[..., 1 if last else 0] / n, w)
        result = term if result is None else result * term
        if not last:
            x_a, x_b = ((_downsample2(x_a), _downsample2(x_b)) if diff
                        else (pool_a, pool_b))
    return result.to(torch.float32)


def _ms_torch_forward(a, b, data_range, weights, sigma=SIGMA, k1=0.01, k2=0.03):
    """The plain pyramid (counterpart of _ms_xla_forward), differentiable
    by autograd; returns f32 (...)."""
    levels = len(weights)
    taps = gaussian_taps(np.float32, RADIUS, sigma)
    c1 = float(np.float32((k1 * data_range) ** 2))
    c2 = float(np.float32((k2 * data_range) ** 2))
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    result = None
    for lvl, w in enumerate(weights):
        l_map, cs_map = _l_cs_maps(af, bf, c1, c2, taps)
        if lvl == levels - 1:
            term = _term((l_map * cs_map).mean(dim=(-2, -1)), w)
        else:
            term = _term(cs_map.mean(dim=(-2, -1)), w)
        result = term if result is None else result * term
        if lvl < levels - 1:
            af = _downsample2(af)
            bf = _downsample2(bf)
    return result


def _kernel_eligible(a, b) -> bool:
    """Every pyramid scale is a pair the components kernels take: uint8 or
    float32 pairs of one dtype (counterpart of _pallas_eligible)."""
    return a.dtype == b.dtype and a.dtype in (torch.uint8, torch.float32)


def ms_ssim(
    a,
    b,
    *,
    data_range: float = 255.0,
    weights: Tuple[float, ...] = MS_SSIM_WEIGHTS,
    impl: str = "auto",
    accuracy: str = "standard",
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
    device=None,
) -> torch.Tensor:
    """MS-SSIM as an f32 tensor on the inputs' device. a, b: (H, W) or
    (B, H, W) tensors (or NumPy arrays); needs min(H, W) >= 11 * 2^(L-1)
    for L weights. Returns a scalar for 2-D inputs, (B,) for batched.

    Differentiable: float32 pairs take the components kernel forward and
    the fused backward kernel at every scale; the plain pyramid is
    differentiated by autograd. impl: "auto" or "cuda" (the kernels),
    "torch" (the plain pyramid). accuracy: "standard" or "relaxed" (the
    kernels' bf16x3 tensor-core blurs at the scales with W >= 512; the
    plain pyramid computes the standard tier).
    sigma/k1/k2: custom window spread and constants at every scale (the
    radius stays 5). device: see engine.resolve_device.
    """
    relaxed = engine.accuracy_is_relaxed(accuracy)
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    if not isinstance(b, torch.Tensor):
        b = np.asarray(b)
    engine.validate_pair(a, b)
    engine.validate_window(RADIUS, sigma, k1, k2, data_range)
    weights = tuple(float(w) for w in weights)
    _check_levels(a, len(weights))
    resolved = select_impl(impl)
    dev = engine.resolve_device(device, a, b)
    a = engine._as_tensor(a, dev)
    b = engine._as_tensor(b, dev)
    if resolved == Implementation.CUDA and _kernel_eligible(a, b):
        window = dict(radius=RADIUS, sigma=sigma, k1=k1, k2=k2)
        return _ms_cuda_forward(a, b, data_range, weights, window, relaxed)
    return _ms_torch_forward(a, b, data_range, weights, sigma, k1, k2)


def compute_ms_ssim(a, b, *, data_range: float = 255.0,
                    weights: Sequence[float] = MS_SSIM_WEIGHTS,
                    impl: str = "auto", accuracy: str = "standard",
                    sigma: float = SIGMA, k1: float = 0.01,
                    k2: float = 0.03, device=None):
    """Eager convenience wrapper: a float, or a (B,) float32 NumPy array
    for a batch."""
    res = ms_ssim(a, b, data_range=data_range, weights=tuple(weights),
                  impl=impl, accuracy=accuracy, sigma=sigma, k1=k1, k2=k2,
                  device=device)
    out = res.detach().cpu().numpy()
    return float(out) if out.ndim == 0 else out
