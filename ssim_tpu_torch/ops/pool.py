"""Device-side box-mean decimation (the `downsample` prefilter).

Counterpart of `ssim_tpu/ops/pool.py`, in plain PyTorch (the JAX package
has no kernel here either). The k x k window sums are exact for uint8
inputs whenever k^2 * 255 < 2^24; the division by k^2 rounds once in f32.
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
