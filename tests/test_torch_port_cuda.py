"""The fused CUDA kernel against its plain twin, on the card.

Marked `cuda`: it skips without a CUDA device (here, on the CPU). This
file imports neither JAX nor the repo's conftest, so it also runs on a
GPU machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances (the port-against-counterpart tier of torch_port_util.py):
2e-7 global, never tighter than 2e-5 / sqrt(npix), and 1e-5 per pixel,
5e-5 at radius 1.
"""

import numpy as np
import pytest
import torch

from ssim_tpu_torch.ops import ssim_cuda
from ssim_tpu_torch.windows import gaussian_taps


def _pair(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.normal(0, 12, shape).astype(np.int32)
    b = np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,window",
    [
        ((2, 257, 65), dict(radius=5, sigma=1.5)),
        ((2, 7, 5), dict(radius=16, sigma=3.0)),
        ((2, 1, 1), dict(radius=5, sigma=1.5)),
        ((1, 64, 1000), dict(radius=1, sigma=0.8)),
    ],
)
def test_kernel_matches_twin_on_card(shape, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    rng = np.random.default_rng(0x55)
    a, b = _pair(rng, shape)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    before = ssim_cuda.LAUNCHES
    pk, mk = ssim_cuda.ssim_parts_cuda(at, bt, with_map=True, **window)
    torch.cuda.synchronize()
    assert ssim_cuda.LAUNCHES == before + 1
    assert pk.is_cuda and mk.is_cuda
    pp, mp = ssim_cuda.ssim_parts_plain(
        at, bt, with_map=True,
        taps=gaussian_taps(np.float32, window["radius"], window["sigma"]),
        c1=(0.01 * 255.0) ** 2, c2=(0.03 * 255.0) ** 2, clip_bound=131072.0,
    )
    npix = shape[1] * shape[2]
    gk = pk.double().sum(-1).cpu().numpy() / npix
    gp = pp.double().sum(-1).cpu().numpy() / npix
    assert np.abs(gk - gp).max() <= max(2e-7, 2e-5 / npix**0.5)
    pixel = 5e-5 if window["radius"] == 1 else 1e-5
    assert (mk - mp).abs().max().item() <= pixel
