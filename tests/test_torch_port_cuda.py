"""The fused CUDA kernels (forward in its standard, precise, components
and pooled-components modes, and backward) against their plain twins, on
the card, and the launches of the training and MS-SSIM paths.

Marked `cuda`: it skips without a CUDA device (here, on the CPU). This
file imports neither JAX nor the repo's conftest, so it also runs on a
GPU machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances (the port-against-counterpart tier of torch_port_util.py):
2e-7 global, never tighter than 2e-5 / sqrt(npix), and 1e-5 per pixel,
5e-5 at radius 1. The backward kernel against its twin: 1e-6 * max(1,
max|g|); both are built to round alike, so they are expected to agree
exactly. Pooled images, and the precise modes' maps: equal to the twin's
bit for bit; precise scores within 1e-12 relative.
"""

import numpy as np
import pytest
import torch

import ssim_tpu_torch
from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")


@pytest.mark.cuda
@pytest.mark.parametrize("with_g", [False, True])
def test_backward_kernel_matches_twin_on_card(with_g):
    _need_card()
    rng = np.random.default_rng(0x56)
    shape = (2, 257, 65)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    ws = torch.tensor([0.7, -0.3], device="cuda")
    wcs = torch.tensor([0.1, 0.25], device="cuda")
    g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).cuda() if with_g else None
    before = ssim_grad.LAUNCHES
    da, db = ssim_grad.ssim_grad_cuda(at, bt, ws, wcs, g, data_range=1.0)
    torch.cuda.synchronize()
    assert ssim_grad.LAUNCHES == before + 1
    pa, pb = ssim_grad.ssim_grad_plain(
        at, bt, ws, wcs, g, taps=gaussian_taps(np.float32, 5, 1.5),
        c1=1e-4, c2=9e-4, clip_bound=131072.0,
    )
    tol = 1e-6 * max(1.0, pa.abs().max().item())
    assert (da - pa).abs().max().item() <= tol
    assert (db - pb).abs().max().item() <= tol


@pytest.mark.cuda
def test_ssim_loss_backward_launches_the_kernel():
    _need_card()
    rng = np.random.default_rng(0x57)
    a = torch.from_numpy(rng.random((2, 96, 130), dtype=np.float32)).cuda()
    x = torch.from_numpy(rng.random((2, 96, 130), dtype=np.float32)).cuda()
    x.requires_grad_()
    fwd, bwd = ssim_cuda.LAUNCHES, ssim_grad.LAUNCHES
    ssim_tpu_torch.ssim_loss(x, a).backward()
    torch.cuda.synchronize()
    assert ssim_cuda.LAUNCHES == fwd + 1 and ssim_grad.LAUNCHES == bwd + 1
    assert x.grad.is_cuda and torch.isfinite(x.grad).all()
    y = x.detach().cpu().requires_grad_()
    ssim_tpu_torch.ssim_loss(y, a.cpu()).backward()
    assert (x.grad.cpu() - y.grad).abs().max().item() <= 1e-6


def _twin_kw(data_range):
    return dict(taps=gaussian_taps(np.float32, 5, 1.5),
                c1=(0.01 * data_range) ** 2, c2=(0.03 * data_range) ** 2,
                clip_bound=max(131072.0, 4.0 * data_range))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [("u8", (2, 257, 65)), ("u8", (1, 7, 9)),
                                         ("f32", (2, 131, 301))])
def test_components_modes_match_twins_on_card(dtype, shape):
    _need_card()
    rng = np.random.default_rng(0x58)
    if dtype == "u8":
        a, b = _pair(rng, shape)
        data_range = 255.0
    else:
        a = rng.random(shape, dtype=np.float32)
        b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
        a[0, 100, 200] = np.nan
        data_range = 1.0
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    before = (ssim_cuda.COMPONENTS_LAUNCHES, ssim_cuda.POOLED_LAUNCHES)
    ck = ssim_cuda.ssim_components_cuda(at, bt, data_range=data_range)
    pk, pak, pbk = ssim_cuda.ssim_components_pooled_cuda(at, bt, data_range=data_range)
    torch.cuda.synchronize()
    assert (ssim_cuda.COMPONENTS_LAUNCHES, ssim_cuda.POOLED_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(ck.isnan(), pk.isnan())
    assert torch.equal(ck.nan_to_num(), pk.nan_to_num())
    ct, pat, pbt = ssim_cuda.ssim_components_pooled_plain(at, bt, **_twin_kw(data_range))
    for got, want in ((pak, pat), (pbk, pbt)):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    npix = shape[1] * shape[2]
    mk = ck.double().sum(-2).cpu().numpy() / npix
    mt = ct.double().sum(-2).cpu().numpy() / npix
    assert np.array_equal(np.isnan(mk), np.isnan(mt))
    assert np.nanmax(np.abs(mk - mt), initial=0.0) <= max(2e-7, 2e-5 / npix**0.5)
    if dtype == "f32":
        assert np.isnan(mk[0]).all() and np.isfinite(mk[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,with_map", [("u8", False), ("u8", True),
                                            ("f32", False), ("f32", True)])
def test_precise_kernel_matches_twin_on_card(dtype, with_map):
    """The precise modes (kPrecise, kPreciseMap) against their twin: maps
    bit for bit (both built to round alike), per-image fp64 scores within
    1e-12 relative (only the order of the tile sums differs)."""
    _need_card()
    rng = np.random.default_rng(0x5A)
    shape = (2, 257, 301)
    if dtype == "u8":
        a, b = _pair(rng, shape)
        data_range = 255.0
    else:
        a = rng.random(shape, dtype=np.float32)
        b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
        a[0, 100, 200] = np.nan
        data_range = 1.0
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    before = (ssim_cuda.LAUNCHES, ssim_cuda.PRECISE_LAUNCHES)
    pk, mk = ssim_cuda.ssim_parts_cuda(at, bt, with_map=with_map, precise=True,
                                       data_range=data_range,
                                       allow_float=dtype == "f32")
    torch.cuda.synchronize()
    assert (ssim_cuda.LAUNCHES, ssim_cuda.PRECISE_LAUNCHES) == (before[0], before[1] + 1)
    assert pk.dtype == torch.float64 and pk.is_cuda
    pp, mp = ssim_cuda.ssim_parts_precise_plain(at, bt, with_map=with_map,
                                                **_twin_kw(data_range))
    if with_map:
        assert torch.equal(mk.isnan(), mp.isnan())
        assert torch.equal(mk.nan_to_num(), mp.nan_to_num())
    else:
        assert mk is None
    npix = shape[1] * shape[2]
    gk = pk.sum(-1).cpu().numpy() / npix
    gp = pp.sum(-1).cpu().numpy() / npix
    assert np.array_equal(np.isnan(gk), np.isnan(gp))
    assert np.nanmax(np.abs(gk - gp) / np.abs(gp), initial=0.0) <= 1e-12
    if dtype == "f32":
        assert np.isnan(gk[0]) and np.isfinite(gk[1])


@pytest.mark.cuda
def test_ms_ssim_launches_the_kernels():
    _need_card()
    rng = np.random.default_rng(0x59)
    a, b = _pair(rng, (2, 176, 192))
    counts = lambda: np.array([ssim_cuda.LAUNCHES, ssim_cuda.COMPONENTS_LAUNCHES,
                               ssim_cuda.POOLED_LAUNCHES, ssim_grad.LAUNCHES])
    before = counts()
    got = ssim_tpu_torch.compute_ms_ssim(a, b)
    after = counts()
    assert (after - before).tolist() == [0, 1, 4, 0]
    want = ssim_tpu_torch.compute_ms_ssim(a, b, device="cpu")
    assert np.abs(got - want).max() <= 2e-5
    x = torch.from_numpy(a.astype(np.float32) / 255).cuda().requires_grad_()
    y = torch.from_numpy(b.astype(np.float32) / 255).cuda()
    (1 - ssim_tpu_torch.ms_ssim(x, y, data_range=1.0)).sum().backward()
    torch.cuda.synchronize()
    assert (counts() - after).tolist() == [0, 5, 0, 5]
    assert torch.isfinite(x.grad).all()
