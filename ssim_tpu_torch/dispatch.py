"""Implementation registry and selection.

Counterpart of `ssim_tpu/dispatch.py`:

| ssim_tpu    | ssim_tpu_torch | what runs                                        |
|-------------|----------------|--------------------------------------------------|
| `reference` | `reference`    | host NumPy f64 oracle (`reference.py`)           |
| `xla`       | `torch`        | plain PyTorch path (`ops/ssim_torch.py`)         |
| `pallas`    | `cuda`         | fused CUDA kernel (`ops/ssim_cuda.py`) on CUDA tensors, its plain twin on CPU tensors |
| `host`      | `host`         | not ported yet: raises UnsupportedError          |
| `auto`      | `auto`         | `cuda`                                           |

`auto` always resolves to `cuda`: the wrapper itself picks kernel or twin
from the tensors' device, the counterpart of the JAX package's "compiled
on TPU, interpreted elsewhere". Which device the tensors are on is the
engine's `device` argument.
"""

import enum
from typing import Tuple

from .errors import UnsupportedError


class Implementation(enum.Enum):
    AUTO = "auto"
    REFERENCE = "reference"
    TORCH = "torch"
    CUDA = "cuda"
    HOST = "host"

    @classmethod
    def parse(cls, value) -> "Implementation":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            raise UnsupportedError(
                f"unknown implementation {value!r}; one of "
                f"{[m.value for m in cls]}"
            ) from None


_AVAILABLE = (Implementation.REFERENCE, Implementation.TORCH, Implementation.CUDA)


def available_impls() -> Tuple[Implementation, ...]:
    """The support set (reference: select_impl's bitmask)."""
    return _AVAILABLE


def select_impl(impl="auto") -> Implementation:
    """Resolve `impl` to a concrete available implementation."""
    impl = Implementation.parse(impl)
    if impl == Implementation.AUTO:
        return Implementation.CUDA
    if impl not in _AVAILABLE:
        raise UnsupportedError(
            f"implementation {impl.value!r} is not available in the port yet"
        )
    return impl
