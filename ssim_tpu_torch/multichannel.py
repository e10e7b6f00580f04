"""Channel policies for multi-channel images.

Counterpart of `ssim_tpu/multichannel.py`, with the reference CLI's
channel policy:
- per-channel SSIM plus the average (the default);
- a single selected channel (-0..-3);
- BT.601 luminance of RGB (-y; the bit-exact fixed-point conversion in
  utils.imageio.luminance_bt601), which falls back to channel 0 below
  three channels.

The channels are stacked on the leading axis and one batched
`engine.compute` call computes all of them. `device` is passed through to
the engine: the card unless the caller asks for the CPU.
"""

from typing import List, NamedTuple, Optional

import numpy as np

from . import engine
from .errors import InvalidArgumentError


class ChannelResult(NamedTuple):
    per_channel: List[float]
    average: float
    maps: Optional[np.ndarray]  # (C, H, W) f32 or None


def _chw(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        return img[None]
    if img.ndim == 3:
        return np.moveaxis(img, -1, 0)  # interleaved (H, W, C) -> (C, H, W)
    raise InvalidArgumentError(f"expected (H, W) or (H, W, C) image, got {img.shape}")


def compute_ssim_channels(
    a,
    b,
    *,
    channel: Optional[int] = None,
    luminance: bool = False,
    with_map: bool = False,
    impl="auto",
    data_range: float = 255.0,
    downsample=None,
    accuracy=None,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    device=None,
) -> ChannelResult:
    """Multi-channel SSIM with the reference CLI's channel policy.

    downsample: None / "auto" / int k, the box-mean prefilter (see
    engine.compute), applied per channel after the channel policy, so -y
    pools the luminance plane. accuracy: None / "standard" or "relaxed".
    radius/sigma/k1/k2: the custom window. device: see
    engine.resolve_device."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        raise InvalidArgumentError(f"image shapes differ: {a.shape} vs {b.shape}")

    if luminance and (a.ndim == 3 and a.shape[2] >= 3):
        from .utils import luminance_bt601

        a_stack = luminance_bt601(a)[None]
        b_stack = luminance_bt601(b)[None]
    elif luminance:
        # Below 3 channels -y degrades to channel 0, as in the reference.
        a_stack = _chw(a)[:1]
        b_stack = _chw(b)[:1]
    else:
        a_stack = _chw(a)
        b_stack = _chw(b)
        if channel is not None:
            if not (0 <= channel < a_stack.shape[0]):
                raise InvalidArgumentError(
                    f"channel {channel} out of range for {a_stack.shape[0]} channels"
                )
            a_stack = a_stack[channel : channel + 1]
            b_stack = b_stack[channel : channel + 1]

    scores, maps = engine.compute(
        a_stack, b_stack, with_map=with_map, impl=impl, data_range=data_range,
        downsample=downsample, accuracy=accuracy, radius=radius, sigma=sigma,
        k1=k1, k2=k2, device=device,
    )
    scores = np.atleast_1d(np.asarray(scores, dtype=np.float64))
    per_channel = [float(s) for s in scores]
    return ChannelResult(per_channel, float(scores.mean()), maps)
