"""Image I/O, the directory loader and profiling hooks.

Counterpart of `ssim_tpu/utils/`: `imageio` (load, BT.601 luminance, map
export), `dataset` (decode-ahead batches of image pairs) and `profiling`
(torch.profiler traces).
"""

from .imageio import load_image, luminance_bt601, save_map

__all__ = ["load_image", "luminance_bt601", "save_map"]
