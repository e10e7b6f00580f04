"""Implementation registry and selection.

Counterpart of `ssim_tpu/dispatch.py`:

| ssim_tpu    | ssim_tpu_torch | what runs                                        |
|-------------|----------------|--------------------------------------------------|
| `reference` | `reference`    | host NumPy f64 oracle (`reference.py`)           |
| `xla`       | `torch`        | plain PyTorch path (`ops/ssim_torch.py`)         |
| `pallas`    | `cuda`         | fused CUDA kernel (`ops/ssim_cuda.py`) on CUDA tensors, its plain twin on CPU tensors |
| `host`      | `host`         | native C++ CPU backend (`ops/host.py`), when it builds |
| `auto`      | `auto`         | `cuda`                                           |

`auto` always resolves to `cuda`: the wrapper itself picks kernel or twin
from the tensors' device, the counterpart of the JAX package's "compiled
on TPU, interpreted elsewhere". Which device the tensors are on is the
engine's `device` argument. `host` needs no GPU: it is available where
g++ builds its library (`ops/host.is_available`, tried once per process),
and selecting it where the build failed raises UnsupportedError with the
compiler's message.
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


_ALWAYS = (Implementation.REFERENCE, Implementation.TORCH, Implementation.CUDA)


def _host_available() -> bool:
    from .ops import host

    return host.is_available()


def available_impls() -> Tuple[Implementation, ...]:
    """The support set (reference: select_impl's bitmask): `host` joins
    where its library builds and loads."""
    return _ALWAYS + ((Implementation.HOST,) if _host_available() else ())


def select_impl(impl="auto") -> Implementation:
    """Resolve `impl` to a concrete available implementation."""
    impl = Implementation.parse(impl)
    if impl == Implementation.AUTO:
        return Implementation.CUDA
    if impl == Implementation.HOST and not _host_available():
        from .ops import host

        raise UnsupportedError(
            f"implementation 'host' is not available here: {host.unavailable_reason()}"
        )
    return impl
