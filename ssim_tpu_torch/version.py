"""Version introspection.

Counterpart of `ssim_tpu/version.py`, copied as it is.

Parity with the reference's `rmgr_ssim_get_version` (src/ssim.cpp:1129-1142,
template src/ssim-version.h.in:25-28). The reference tracks v2.1.0 of
rmgr::ssim; we track our own framework version and report the capability
level of the reference API we implement.
"""

from typing import NamedTuple


class Version(NamedTuple):
    major: int
    minor: int
    patch: int

    def __str__(self) -> str:
        return f"{self.major}.{self.minor}.{self.patch}"


#: Version of this framework.
VERSION = Version(0, 1, 0)

#: Version of the reference library whose capability surface we match.
REFERENCE_API_VERSION = Version(2, 1, 0)

__version__ = str(VERSION)


def get_version() -> Version:
    """Return the framework version (reference: src/ssim.cpp:1129-1142)."""
    return VERSION
