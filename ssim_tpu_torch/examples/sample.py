"""Minimal usage sample: per-channel SSIM of two image files, through the
interleaved-channel API (the counterpart of examples/sample.py, parity
with sample/rmgr-ssim-sample.cpp:41-108).

    python -m ssim_tpu_torch.examples.sample [--device cpu] <image1> <image2>
"""

import argparse
import sys

from ssim_tpu_torch import ImageView, compute_ssim
from ssim_tpu_torch.utils import load_image


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Per-channel SSIM of two images.")
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    img1 = load_image(args.image1)
    img2 = load_image(args.image2)
    if img1.shape != img2.shape:
        print("Images must have identical dimensions", file=sys.stderr)
        return 1
    channels = 1 if img1.ndim == 2 else img1.shape[2]
    for c in range(channels):
        score = compute_ssim(
            ImageView.from_interleaved(img1, c),
            ImageView.from_interleaved(img2, c),
            device=args.device,
        )
        print(f"Channel {c}: SSIM = {score:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
