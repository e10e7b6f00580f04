"""Native C++ host (CPU) backend bridge.

Counterpart of `ssim_tpu/ops/host.py`: the OpenMP and autovectorised
separable SSIM of `csrc/host/ssim_host.cpp` (the port's own copy of the
JAX package's `native/ssim_host.cpp`), loaded through ctypes. The library
is built at first use by `ops/_build.build_host` into
`ssim_tpu_torch/_build/`, keyed by a hash of its source, the compiler's
version and the CPU target; it needs g++ and OpenMP, no GPU. `is_available()` reports whether it builds and loads;
where it does not, `compute` (and `impl="host"`) raise UnsupportedError
carrying the compiler's message, and never run another implementation
in its place.

Semantics as in the JAX package: uint8 images only, the reference window
(radius 5, sigma 1.5, k1 0.01, k2 0.03), one library call per image,
scores in f64 and maps in f32.
"""

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import InvalidArgumentError, UnsupportedError

_lock = threading.Lock()
_LIB = None
_ERROR: Optional[str] = None


def _load():
    """The loaded library, or None with `_ERROR` set; tried once per
    process."""
    global _LIB, _ERROR
    with _lock:
        if _LIB is None and _ERROR is None:
            from . import _build

            try:
                lib = ctypes.CDLL(_build.build_host())
            except (RuntimeError, OSError) as e:
                _ERROR = str(e)
                return None
            lib.ssim_host_compute.restype = ctypes.c_int
            lib.ssim_host_compute.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),  # a
                ctypes.POINTER(ctypes.c_uint8),  # b
                ctypes.c_int,  # width
                ctypes.c_int,  # height
                ctypes.c_double,  # data_range
                ctypes.POINTER(ctypes.c_double),  # out global ssim
                ctypes.POINTER(ctypes.c_float),  # out map (or NULL)
            ]
            _LIB = lib
        return _LIB


def is_available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library did not build or load (the compiler's message), or
    None where it is available."""
    _load()
    return _ERROR


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compute(
    a,
    b,
    *,
    with_map: bool = False,
    data_range: float = 255.0,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """SSIM of uint8 (H, W) or (B, H, W) pairs (NumPy arrays or tensors on
    any device) on the host. Returns (np.float64 score, map) for a pair,
    ((B,) f64 scores, (B, H, W) f32 maps) for a batch; maps None unless
    with_map."""
    lib = _load()
    if lib is None:
        raise UnsupportedError(f"the host backend did not build: {_ERROR}")
    a = _host_array(a)
    b = _host_array(b)
    if a.dtype != np.uint8 or b.dtype != np.uint8:
        # The C backend takes u8 buffers; an implicit astype would silently
        # truncate floats or wrap wider integers.
        raise InvalidArgumentError(
            f"impl='host' supports uint8 images only, got {a.dtype}/"
            f"{b.dtype}; use impl='auto'/'cuda'/'torch' for float or "
            f"wider-integer inputs"
        )
    squeeze = a.ndim == 2
    if squeeze:
        a = a[None]
        b = b[None]
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    batch, h, w = a.shape
    scores = np.zeros(batch, dtype=np.float64)
    maps = np.zeros((batch, h, w), dtype=np.float32) if with_map else None
    for i in range(batch):
        out = ctypes.c_double()
        map_ptr = (
            maps[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            if with_map
            else ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
        )
        rc = lib.ssim_host_compute(
            a[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            b[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w,
            h,
            data_range,
            ctypes.byref(out),
            map_ptr,
        )
        if rc != 0:
            raise RuntimeError(f"host backend error {rc}")
        scores[i] = out.value
    if squeeze:
        return np.float64(scores[0]), (None if maps is None else maps[0])
    return scores, maps
