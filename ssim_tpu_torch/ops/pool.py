"""Device-side box-mean decimation: the `downsample` prefilter and the
MS-SSIM pyramid's 2x2 step.

Counterpart of `ssim_tpu/ops/pool.py` and of
`ssim_tpu/models/msssim.py::_downsample2`, in plain PyTorch (the JAX
package pools with XLA's reduce_window, outside any kernel). The k x k
window sums are exact for uint8 inputs whenever k^2 * 255 < 2^24; the
division by k^2 rounds once in f32.
"""

import torch

from ..errors import InvalidArgumentError


def box_decimate_device(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box mean + decimation on the tensor's device (avg_pool,
    stride k, no padding); trailing h % k / w % k pixels are dropped,
    matching engine.box_decimate. Returns float32."""
    h, w = x.shape[-2], x.shape[-1]
    hh, ww = h // k, w // k
    if hh < 1 or ww < 1:
        raise InvalidArgumentError(
            f"downsample factor {k} collapses a {h}x{w} image"
        )
    x = x[..., : hh * k, : ww * k].to(torch.float32)
    s = x.reshape(x.shape[:-2] + (hh, k, ww, k)).sum(dim=(-3, -1))
    return s / float(k * k)


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean of the last two dims as float32, an odd trailing row or
    column dropped: vertical pairs first, then horizontal, then * 0.25,
    the order of the pooled components kernel (csrc/ssim_fwd.cu), so the
    two agree bit for bit. Exact for uint8; a NaN reaches only its own
    pooled pixel. Differentiable."""
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., : 2 * h2, : 2 * w2].to(torch.float32)
    y = x[..., 0::2, :] + x[..., 1::2, :]
    return (y[..., 0::2] + y[..., 1::2]) * 0.25
