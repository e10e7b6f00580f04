"""Parameter surface: logical image views and computation params.

Counterpart of `ssim_tpu/params.py`, copied as it is (NumPy only).
`ImageView` holds host NumPy data in both packages; CPU torch tensors
are accepted through `__array__`.

Parity with the reference's parameter structs (include/rmgr/ssim.h):

- `rmgr_ssim_ImgParams {topLeft, step, stride}` (:489-499) fully generalizes
  pixel layout: addr = topLeft + x*step + y*stride, negative strides allowed
  (src/ssim.cpp:516,553). JAX has no pointer model, so `ImageView` exposes
  the same *semantics* as logical views: `from_interleaved` /
  `from_planar` mirror `rmgr_ssim_init_interleaved` / `_planar`
  (include/rmgr/ssim.h:560-575, src/ssim.cpp:156-217), and `from_strided`
  gives exact step/stride parity (including negative strides) over a raw
  buffer via NumPy stride tricks.
- `rmgr_ssim_Params` (:505-525) becomes the `Params` dataclass. The
  allocator fields (`alloc`/`dealloc`, include/rmgr/ssim.h:438-439 and
  src/ssim.cpp:88-149) have no analogue — XLA owns memory — which is a
  documented divergence, not an omission.
"""

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .errors import InvalidArgumentError


def _as_numpy(data: Any) -> np.ndarray:
    """Accept NumPy/JAX arrays, lists, or PIL images (which expose
    __array_interface__ rather than __array__)."""
    if (
        hasattr(data, "__array__")
        or hasattr(data, "__array_interface__")
        or isinstance(data, (list, tuple))
    ):
        return np.asarray(data)
    raise InvalidArgumentError(f"cannot interpret {type(data)!r} as an image array")


@dataclass(frozen=True)
class ImageView:
    """A logical single-channel (H, W) view of image data."""

    data: np.ndarray  # (H, W), any real dtype (uint8 is the parity dtype)

    def __post_init__(self):
        arr = _as_numpy(self.data)
        if arr.ndim != 2:
            raise InvalidArgumentError(f"ImageView needs a 2-D array, got shape {arr.shape}")
        if arr.shape[0] < 1 or arr.shape[1] < 1:
            raise InvalidArgumentError(f"empty image: shape {arr.shape}")
        object.__setattr__(self, "data", arr)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @classmethod
    def from_gray(cls, data: Any) -> "ImageView":
        """A plain (H, W) single-channel image."""
        return cls(_as_numpy(data))

    @classmethod
    def from_interleaved(cls, data: Any, channel: int = 0) -> "ImageView":
        """Channel `channel` of an interleaved (H, W, C) image.

        Mirrors rmgr_ssim_init_interleaved (include/rmgr/ssim.h:560,
        src/ssim.cpp:177-193): step = channel count, stride = row bytes.
        """
        arr = _as_numpy(data)
        if arr.ndim == 2:
            if channel != 0:
                raise InvalidArgumentError("grayscale image has only channel 0")
            return cls(arr)
        if arr.ndim != 3:
            raise InvalidArgumentError(f"interleaved image must be (H, W, C), got {arr.shape}")
        if not (0 <= channel < arr.shape[2]):
            raise InvalidArgumentError(f"channel {channel} out of range for C={arr.shape[2]}")
        return cls(arr[:, :, channel])

    @classmethod
    def from_planar(cls, data: Any, channel: int = 0) -> "ImageView":
        """Channel `channel` of a planar (C, H, W) image.

        Mirrors rmgr_ssim_init_planar (include/rmgr/ssim.h:575,
        src/ssim.cpp:196-217): step = 1, plane base = channel * plane size.
        """
        arr = _as_numpy(data)
        if arr.ndim == 2:
            if channel != 0:
                raise InvalidArgumentError("grayscale image has only channel 0")
            return cls(arr)
        if arr.ndim != 3:
            raise InvalidArgumentError(f"planar image must be (C, H, W), got {arr.shape}")
        if not (0 <= channel < arr.shape[0]):
            raise InvalidArgumentError(f"channel {channel} out of range for C={arr.shape[0]}")
        return cls(arr[channel])

    @classmethod
    def from_strided(
        cls,
        buffer: Any,
        width: int,
        height: int,
        step: int,
        stride: int,
        offset: int = 0,
    ) -> "ImageView":
        """Exact step/stride parity over a flat buffer, in *elements*.

        pixel(x, y) = buffer[offset + x*step + y*stride] — the reference's
        addressing contract (include/rmgr/ssim.h:481-488). Negative steps
        and strides are supported, matching the reference's bottom-up /
        mirrored traversal support (include/rmgr/ssim.h:516,553,590-592).
        """
        buf = np.ascontiguousarray(_as_numpy(buffer)).reshape(-1)
        if width < 1 or height < 1:
            raise InvalidArgumentError("width and height must be >= 1")
        # Bounds check across all four corners (works for negative strides).
        corners = [
            offset,
            offset + (width - 1) * step,
            offset + (height - 1) * stride,
            offset + (width - 1) * step + (height - 1) * stride,
        ]
        if min(corners) < 0 or max(corners) >= buf.size:
            raise InvalidArgumentError("strided view escapes the buffer")
        x = np.arange(width) * step
        y = np.arange(height) * stride
        return cls(np.ascontiguousarray(buf[offset + y[:, None] + x[None, :]]))


def write_strided_map(
    buffer: np.ndarray,
    ssim_map: np.ndarray,
    step: int,
    stride: int,
    offset: int = 0,
) -> np.ndarray:
    """Write a contiguous (H, W) SSIM map into a flat float buffer with
    the reference's map addressing: value(x, y) lands at
    buffer[offset + x*step + y*stride] (ssimStep/ssimStride in *floats*,
    include/rmgr/ssim.h:514-516; negative strides supported like the
    image-side contract, :516,553).

    The device always produces contiguous maps (the documented TPU-side
    divergence: XLA owns layout); this host-side writer restores the
    reference's arbitrary-output-layout capability, e.g. interleaved
    per-channel maps (step = channel count, the CLI's usage,
    src/ssim-cli.cpp:119-121) or bottom-up buffers. Returns `buffer`.
    """
    ssim_map = np.asarray(ssim_map, dtype=np.float32)
    if ssim_map.ndim != 2:
        raise InvalidArgumentError(f"need a 2-D map, got shape {ssim_map.shape}")
    if not isinstance(buffer, np.ndarray):
        # np.asarray of a list/array.array would write into a silently
        # discarded copy; the reference contract is write-into-caller's-
        # buffer (ssimMap pointer), so demand a real writable ndarray.
        raise InvalidArgumentError(
            f"map buffer must be a NumPy array (got {type(buffer).__name__}); "
            "a copy would silently discard the map"
        )
    buf = buffer
    if buf.ndim != 1 or not np.issubdtype(buf.dtype, np.floating):
        raise InvalidArgumentError("map buffer must be a flat float array")
    if not buf.flags.writeable:
        raise InvalidArgumentError("map buffer is read-only")
    h, w = ssim_map.shape
    corners = [
        offset,
        offset + (w - 1) * step,
        offset + (h - 1) * stride,
        offset + (w - 1) * step + (h - 1) * stride,
    ]
    if min(corners) < 0 or max(corners) >= buf.size:
        raise InvalidArgumentError("strided map write escapes the buffer")
    x = np.arange(w) * step
    y = np.arange(h) * stride
    buf[offset + y[:, None] + x[None, :]] = ssim_map
    return buf


@dataclass(frozen=True)
class Params:
    """Computation parameters (reference rmgr_ssim_Params,
    include/rmgr/ssim.h:505-525)."""

    img_a: ImageView
    img_b: ImageView
    with_map: bool = False  # reference: ssimMap != NULL
    implementation: str = "auto"  # reference: Implementation enum (tests only)
    data_range: float = 255.0  # reference: L, fixed to 255 for u8 (src/ssim.cpp:958)
    #: Optional strided map output (reference ssimMap/ssimStep/ssimStride,
    #: include/rmgr/ssim.h:510-516): a flat float buffer the computed map
    #: is written into via write_strided_map. map_stride=None means W.
    map_buffer: Any = None
    map_step: int = 1
    map_stride: Any = None
    map_offset: int = 0
    extras: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.img_a.data.shape != self.img_b.data.shape:
            raise InvalidArgumentError(
                f"image shapes differ: {self.img_a.data.shape} vs {self.img_b.data.shape}"
            )
