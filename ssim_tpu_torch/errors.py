"""Error handling.

Counterpart of `ssim_tpu/errors.py`, copied as it is (standard library
only): the same classes and errno values, so callers of either package
translate errors the same way.

The reference reports errors errno-style: 0 / EINVAL / ENOMEM / ECHILD
(include/rmgr/ssim.h:600-603), with a deprecated API encoding errno as a
negative float (include/rmgr/ssim.h:724-728). A Python/JAX framework raises
exceptions instead; each exception carries the errno the reference would
have returned so callers can translate mechanically.

Divergence (documented per SURVEY.md §2 quirks): the reference swallows the
thread-pool error when no global score is requested (src/ssim.cpp:1094-1097),
silently returning a partial map. We never swallow errors.
"""

import errno as _errno


class SsimError(Exception):
    """Base class for ssim_tpu errors. `.errno` mirrors the reference C API."""

    errno: int = -1


class InvalidArgumentError(SsimError, ValueError):
    """Bad parameters (reference: EINVAL paths, src/ssim.cpp:962-978)."""

    errno = _errno.EINVAL


class OutOfMemoryError(SsimError, MemoryError):
    """Allocation failure (reference: ENOMEM, src/ssim.cpp:1052-1055)."""

    errno = _errno.ENOMEM


class DispatchError(SsimError, RuntimeError):
    """Parallel-dispatch failure (reference: ECHILD, src/ssim.cpp:1096-1097)."""

    errno = _errno.ECHILD


class UnsupportedError(SsimError, RuntimeError):
    """Requested implementation unavailable on this backend.

    Reference analogue: requesting an ISA the CPU lacks, gated by the
    select_impl() support bitmask (src/ssim.cpp:808-896).
    """

    errno = _errno.ENOSYS
