"""SSIM as a differentiable perceptual loss: denoising a batch of images
by gradient descent on 1 - SSIM with Adam (the counterpart of
examples/training.py). The loss runs the forward and backward kernels.

    python -m ssim_tpu_torch.examples.training [--steps 120] [--device cpu]
"""

import argparse

import numpy as np
import torch

from ssim_tpu_torch import ssim_loss
from ssim_tpu_torch.engine import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description="Denoise by descent on 1 - SSIM.")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    clean = rng.random((4, 96, 128), dtype=np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.15, clean.shape).astype(np.float32), 0, 1)

    params = torch.from_numpy(noisy).to(device).requires_grad_()
    target = torch.from_numpy(clean).to(device)
    opt = torch.optim.Adam([params], lr=0.02)
    losses = []
    for step in range(args.steps):
        opt.zero_grad()
        loss = ssim_loss(params, target)
        loss.backward()
        opt.step()
        with torch.no_grad():
            params.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
        if step % 20 == 0:
            print(f"step {step:3d}  1-SSIM = {losses[-1]:.4f}")
    with torch.no_grad():
        final = float(ssim_loss(params, target))
    print(f"final  1-SSIM = {final:.4f}")
    return losses + [final]


if __name__ == "__main__":
    main()
