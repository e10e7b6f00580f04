"""Test and measurement support: the frozen ground-truth scalars
(`frozen`), the steady-state device throughput harness (`devicebench`)
and the accuracy and throughput report (`report`).

Counterpart of `ssim_tpu/testing/`, with the same exports.
"""

from .frozen import (
    EINSTEIN_SUITE,
    BBB360,
    BBB1080,
    BBB255,
    BBB257,
    images_dir,
)

__all__ = ["EINSTEIN_SUITE", "BBB360", "BBB1080", "BBB255", "BBB257", "images_dir"]
