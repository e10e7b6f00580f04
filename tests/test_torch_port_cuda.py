"""The fused CUDA kernels (forward in its standard, precise, components,
pooled-components, batch and row modes, with and without halo operands,
and backward, with and without them; both in their relaxed modes) and the
pad kernel against their plain twins, on the card, and the launches of the
training, MS-SSIM, small-image batch and pad paths.

The forward kernel's main-path modes and the backward kernel's standard
tier stream rows down column strips: their cases pin the segment length
(two tiles) to put H, W, the tiles, the halo operands and non-finite
pixels on the segment, strip and tile boundaries.

Marked `cuda`: it skips without a CUDA device (here, on the CPU). This
file imports neither JAX nor the repo's conftest, so it also runs on a
GPU machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances (the port-against-counterpart tier of torch_port_util.py):
2e-7 global, never tighter than 2e-5 / sqrt(npix), and 1e-5 per pixel,
5e-5 at radius 1. The backward kernel against its twin: 1e-6 * max(1,
max|g|); both are built to round alike, so they are expected to agree
exactly. Pooled images, and the precise modes' maps: equal to the twin's
bit for bit; precise scores within 1e-12 relative. The pad kernel moves
bytes: equal to its twin's byte for byte.
"""

import numpy as np
import pytest
import torch

import ssim_tpu_torch
from ssim_tpu_torch.ops import pad, ssim_cuda, ssim_grad
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
    # A batch of two 130-wide images: the forward takes the batch mode, as
    # the JAX package's router packs it.
    fwd, batch, bwd = ssim_cuda.LAUNCHES, ssim_cuda.BATCH_LAUNCHES, ssim_grad.LAUNCHES
    ssim_tpu_torch.ssim_loss(x, a).backward()
    torch.cuda.synchronize()
    assert ssim_cuda.LAUNCHES == fwd and ssim_cuda.BATCH_LAUNCHES == batch + 1
    assert ssim_grad.LAUNCHES == bwd + 1
    assert x.grad.is_cuda and torch.isfinite(x.grad).all()
    y = x.detach().cpu().requires_grad_()
    ssim_tpu_torch.ssim_loss(y, a.cpu()).backward()
    assert (x.grad.cpu() - y.grad).abs().max().item() <= 1e-6


def _twin_kw(data_range, precise=False):
    """The twins' keywords; the precise twins take the f64 taps."""
    return dict(taps=gaussian_taps(np.float64 if precise else np.float32, 5, 1.5),
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
                                                **_twin_kw(data_range, True))
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
                               ssim_cuda.POOLED_LAUNCHES, ssim_grad.LAUNCHES,
                               ssim_cuda.STREAM_LAUNCHES])
    before = counts()
    got = ssim_tpu_torch.compute_ms_ssim(a, b)
    after = counts()
    # Every scale is under STREAM_COMP_MIN_PIX: the tile body, no stream.
    assert (after - before).tolist() == [0, 1, 4, 0, 0]
    want = ssim_tpu_torch.compute_ms_ssim(a, b, device="cpu")
    assert np.abs(got - want).max() <= 2e-5
    x = torch.from_numpy(a.astype(np.float32) / 255).cuda().requires_grad_()
    y = torch.from_numpy(b.astype(np.float32) / 255).cuda()
    (1 - ssim_tpu_torch.ms_ssim(x, y, data_range=1.0)).sum().backward()
    torch.cuda.synchronize()
    assert (counts() - after).tolist() == [0, 5, 0, 5, 0]
    assert torch.isfinite(x.grad).all()


#: The batch modes' shapes on the card: whole images to a block
#: (64x32x40), one image's rows in segments (3x300x64), phase 8's routed
#: batches (chip_smoke.BATCH_CONFIGS), its odd shapes and its tall short
#: batch (2, 8192, 64).
_BATCH_CARD_SHAPES = [(64, 32, 40), (3, 300, 64), (8192, 32, 32), (4096, 64, 64),
                      (1024, 128, 128), (512, 192, 192), (256, 64, 64), (4, 64, 64),
                      (3, 33, 47), (2, 30, 200), (5, 11, 11), (3, 50, 1), (5, 16, 2048),
                      (2, 8192, 64), (2, 1, 1), (2, 7, 5)]


def _batch_tile_body(at, bt, precise, data_range):
    """The batch mode on the tile body (batch_geometry's tiles), pinned."""
    kw = ssim_cuda._prepare(at, bt, data_range=data_range, radius=5, sigma=1.5, k1=0.01,
                            k2=0.03, precise=precise)
    tile_h, tile_w, ipb, groups = ssim_cuda.batch_geometry(*at.shape)
    return ssim_cuda._launch(at, bt, mode="batch_precise" if precise else "batch",
                             tile_h=tile_h, tile_w=tile_w, ipb=ipb, groups=groups,
                             tile_body=True, **kw)


def _hold_batch(name, pk, wants, npix, precise):
    """Per-image scores of pk against each of wants: 2e-7 (precise 1e-12
    relative), NaN in the same images."""
    gk = pk.double().sum(-1).cpu().numpy() / npix
    for label, want in wants.items():
        gw = want.double().sum(-1).cpu().numpy() / npix
        assert np.array_equal(np.isnan(gk), np.isnan(gw)), (name, label)
        err = np.nanmax(np.abs(gk - gw) / (np.abs(gw) if precise else 1.0), initial=0.0)
        assert err <= (1e-12 if precise else 2e-7), (name, label, err)
    return gk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precise", [("u8", False), ("u8", True),
                                           ("f32", False), ("f32", True)])
def test_batch_modes_match_twin_on_card(dtype, precise):
    """The batch modes (kBatch, kBatchPrecise) at radius 5, the packed
    stream (one STREAM_LAUNCHES and one mode launch each), against their
    twin, the tile modes and the tile body's batch mode: one partial pair
    per image, scores within 2e-7 (precise 1e-12 relative), the count
    exact; in f32 a NaN in image 1 reaches only image 1."""
    _need_card()
    rng = np.random.default_rng(0x5B)
    for shape in _BATCH_CARD_SHAPES:
        if dtype == "u8":
            a, b = _pair(rng, shape)
            data_range = 255.0
        else:
            a = rng.random(shape, dtype=np.float32)
            b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
            a[1, shape[1] // 2, shape[2] // 2] = np.nan
            data_range = 1.0
        at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        counter = "BATCH_PRECISE_LAUNCHES" if precise else "BATCH_LAUNCHES"
        before = (getattr(ssim_cuda, counter), ssim_cuda.STREAM_LAUNCHES)
        pk = ssim_cuda.ssim_parts_batch_cuda(at, bt, data_range=data_range,
                                             precise=precise, allow_float=dtype == "f32")
        torch.cuda.synchronize()
        assert (getattr(ssim_cuda, counter), ssim_cuda.STREAM_LAUNCHES) == (
            before[0] + 1, before[1] + 1), shape
        assert pk.shape == (shape[0], 2) and pk.is_cuda
        assert pk.dtype == (torch.float64 if precise else torch.float32)
        npix = shape[1] * shape[2]
        assert bool((pk[:, 1] == npix).all())
        wants = {
            "twin": ssim_cuda.ssim_parts_batch_plain(at, bt, precise,
                                                     **_twin_kw(data_range, precise)),
            "tile modes": ssim_cuda.ssim_parts_cuda(at, bt, data_range=data_range,
                                                    precise=precise,
                                                    allow_float=dtype == "f32")[0],
            "tile body": _batch_tile_body(at, bt, precise, data_range),
        }
        gk = _hold_batch(shape, pk, wants, npix, precise)
        if dtype == "f32":
            assert np.isnan(gk[1]) and np.isfinite(np.delete(gk, 1)).all()


#: Pinned packs of the batch stream: (shape, (k, segment rows)): a short
#: last packed row, images straddling strips, 12 narrow images to a strip,
#: 12 pieces a strip, segments of tall images and of the routed shapes.
_BATCH_PACKS = [((6, 20, 32), (4, 20)), ((5, 18, 64), (2, 18)),
                ((3, 12, 192), (2, 12)), ((3, 14, 65), (3, 14)),
                ((3, 40, 47), (3, 16)), ((18, 7, 5), (12, 7)),
                ((17, 9, 8), (12, 9)), ((24, 6, 12), (22, 6)),
                ((3, 10, 128), (1, 10)),
                ((2, 100, 64), (2, 32)), ((2, 8192, 64), (2, 64)),
                ((4096, 64, 64), (2, 32)), ((512, 192, 192), (2, 192))]


@pytest.mark.cuda
@pytest.mark.parametrize("precise", [False, True])
def test_batch_stream_pinned_packs_match_twin_on_card(precise):
    """The packed stream at pinned (k, segment rows) against the twin: f32
    with a NaN in image 2 (its neighbours in its packed row and the next
    stay finite), scores within 2e-7 (precise 1e-12 relative)."""
    _need_card()
    rng = np.random.default_rng(0x5E)
    for shape, pack in _BATCH_PACKS:
        a = rng.random(shape, dtype=np.float32)
        b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
        a[2 % shape[0], shape[1] - 1, 0] = np.nan
        at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        kw = ssim_cuda._prepare(at, bt, data_range=1.0, radius=5, sigma=1.5, k1=0.01,
                                k2=0.03, precise=precise)
        pk = ssim_cuda._launch(at, bt, mode="batch_precise" if precise else "batch",
                               tile_h=32, tile_w=64, pack=pack, **kw)
        want = ssim_cuda.ssim_parts_batch_plain(at, bt, precise, **_twin_kw(1.0, precise))
        gk = _hold_batch((shape, pack), pk, {"twin": want}, shape[1] * shape[2], precise)
        bad = 2 % shape[0]
        assert np.isnan(gk[bad]) and np.isfinite(np.delete(gk, bad)).all()


#: The runtime-radius batch stream's radii on the card: the band's k-step
#: edge (8 / 9) and the ends.
_BATCH_RT_RADII = {1: 0.8, 8: 2.5, 9: 2.5, 16: 3.0}


@pytest.mark.cuda
@pytest.mark.parametrize("radius", list(_BATCH_RT_RADII))
def test_batch_stream_runtime_radius_matches_twin_on_card(radius):
    """The packed stream at a runtime radius (ssim_fwd_batch_rt.cu) in
    kBatch, kBatchPrecise and the relaxed kBatch at the pinned packs of
    _BATCH_PACKS (whole images to a block, images straddling strips, 12
    pieces a strip, segments and the second pass), one STREAM_LAUNCHES a
    launch, against the twins at that radius: f32 with a NaN in image 2
    (no other image NaN), scores within 2e-7 (precise 1e-12 relative;
    relaxed 2e-6)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0x60 + radius)
    sigma = _BATCH_RT_RADII[radius]
    for shape, pack in _BATCH_PACKS:
        a = rng.random(shape, dtype=np.float32)
        b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
        a[2 % shape[0], shape[1] - 1, 0] = np.nan
        at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        for precise, relaxed in ((False, False), (True, False), (False, True)):
            kw = ssim_cuda._prepare(at, bt, data_range=1.0, radius=radius, sigma=sigma,
                                    k1=0.01, k2=0.03, precise=precise)
            before = ssim_cuda.STREAM_LAUNCHES
            pk = ssim_cuda._launch(at, bt, mode="batch_precise" if precise else "batch",
                                   tile_h=32, tile_w=64, pack=pack, relaxed=relaxed, **kw)
            torch.cuda.synchronize()
            assert ssim_cuda.STREAM_LAUNCHES == before + 1, (shape, pack)
            want = ssim_cuda.ssim_parts_batch_plain(at, bt, precise, relaxed=relaxed, **kw)
            npix = shape[1] * shape[2]
            if relaxed:
                _like_relaxed_twin("batch", pk, want.cpu(), npix)
                gk = pk[:, 0].cpu().numpy()
            else:
                gk = _hold_batch((shape, pack, radius), pk, {"twin": want}, npix, precise)
            bad = 2 % shape[0]
            assert np.isnan(gk[bad]) and np.isfinite(np.delete(gk, bad)).all()


#: NaN pixels in the first row a batch stream block stages, in a column of
#: a warp other than warp 0 (whose thread clears the block's NaN mask):
#: (shape, (image, y, x)).
_BATCH_ROW0_NANS = [((4, 64, 64), (1, 0, 40)), ((8, 32, 32), (5, 0, 31)),
                    ((3, 16, 192), (1, 0, 100)), ((2, 8192, 64), (1, 32 * 64 - 5, 20))]


@pytest.mark.cuda
@pytest.mark.parametrize("precise", [False, True])
def test_batch_stream_nan_in_first_staged_row_on_card(precise):
    """A non-finite pixel in the first row that a block stages (the
    prologue's, before the block's first step; in (2, 8192, 64) the first
    halo row of a segment) marks its image, in each of 20 launches: its
    score is NaN and no other image's is."""
    _need_card()
    rng = np.random.default_rng(0x5F)
    for shape, (img, y, x) in _BATCH_ROW0_NANS:
        a = rng.random(shape, dtype=np.float32)
        b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
        a[img, y, x] = np.nan
        at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        for _ in range(20):
            pk = ssim_cuda.ssim_parts_batch_cuda(at, bt, data_range=1.0, precise=precise,
                                                 allow_float=True)
            g = pk[:, 0].cpu().numpy()
            assert np.isnan(g[img]) and np.isfinite(np.delete(g, img)).all(), (shape, g)


@pytest.mark.cuda
def test_small_batches_launch_the_batch_modes():
    """compute_ssim on a routed batch launches kBatch (f64: kBatchPrecise;
    relaxed: the relaxed kBatch) on the packed stream, one STREAM_LAUNCHES
    each, and the ssim_loss step kBatch and K3; at radius 4 both batch
    modes stream too (the runtime-radius packed stream)."""
    _need_card()
    rng = np.random.default_rng(0x5C)
    a, b = _pair(rng, (64, 32, 40))
    counts = lambda: np.array([ssim_cuda.LAUNCHES, ssim_cuda.PRECISE_LAUNCHES,
                               ssim_cuda.BATCH_LAUNCHES, ssim_cuda.BATCH_PRECISE_LAUNCHES,
                               ssim_grad.LAUNCHES, ssim_cuda.STREAM_LAUNCHES,
                               ssim_cuda.RELAXED_LAUNCHES])
    before = counts()
    got = ssim_tpu_torch.compute_ssim(a, b)
    got64 = ssim_tpu_torch.compute_ssim(a, b, precision="f64")
    assert (counts() - before).tolist() == [0, 0, 1, 1, 0, 2, 0]
    want = ssim_tpu_torch.compute_ssim(a, b, device="cpu")
    assert np.abs(got - want).max() <= 2e-7 and np.abs(got64 - want).max() <= 2e-7
    before = counts()
    r4 = ssim_tpu_torch.compute_ssim(a, b, radius=4, sigma=1.2)
    ssim_tpu_torch.compute_ssim(a, b, precision="f64", radius=4, sigma=1.2)
    ssim_tpu_torch.compute_ssim(a, b, accuracy="relaxed")
    assert (counts() - before).tolist() == [0, 0, 1, 1, 0, 3, 1]
    assert np.abs(r4 - ssim_tpu_torch.compute_ssim(a, b, radius=4, sigma=1.2,
                                                   device="cpu")).max() <= 2e-7
    x = torch.from_numpy(a.astype(np.float32) / 255).cuda().requires_grad_()
    y = torch.from_numpy(b.astype(np.float32) / 255).cuda()
    before = counts()
    ssim_tpu_torch.ssim_loss(x, y).backward()
    torch.cuda.synchronize()
    assert (counts() - before).tolist() == [0, 0, 1, 0, 1, 1, 0]
    assert torch.isfinite(x.grad).all()


def _halo(x, lo, hi, rows, flags):
    """The rows above [lo, hi) and below it as a mesh ring would send them
    (the other end's rows at a flagged edge), contiguous on the card."""
    top = x[..., lo - rows:lo, :] if not flags[0] else x[..., -rows:, :]
    bot = x[..., hi:hi + rows, :] if not flags[1] else x[..., :rows, :]
    return top.contiguous(), bot.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,flags", [("u8", (0, 0)), ("u8", (1, 0)),
                                         ("u8", (0, 1)), ("f32", (1, 1))])
def test_row_modes_with_halo_match_twin_on_card(dtype, flags):
    """kRowsum and kRowsumMap with halo operands against the row twin:
    maps bit for bit (the same per-pixel arithmetic), row sums within W *
    1e-5 (other orders of the adds; the f32 rounding of W + sum)."""
    _need_card()
    rng = np.random.default_rng(0x5D)
    if dtype == "u8":
        a, b = _pair(rng, (2, 301, 517))
    else:
        a = rng.random((2, 301, 517)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
        a[1, 120, 40] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    lo, hi = 100, 237  # a ragged band of 137 rows
    band_a, band_b = at[:, lo:hi].contiguous(), bt[:, lo:hi].contiguous()
    a_top, a_bot = _halo(at, lo, hi, 5, flags)
    b_top, b_bot = _halo(bt, lo, hi, 5, flags)
    vh = (a_top, a_bot, b_top, b_bot)
    dr = 255.0 if dtype == "u8" else 1.0
    kw = dict(vhalo=vh, vmask=flags, data_range=dr, allow_float=dtype == "f32")
    before = (ssim_cuda.ROWSUM_LAUNCHES, ssim_cuda.ROWSUM_MAP_LAUNCHES)
    rows, _ = ssim_cuda.ssim_parts_cuda(band_a, band_b, rowsum=True, **kw)
    rows_m, smap = ssim_cuda.ssim_rows_cuda(band_a, band_b, with_map=True, **kw)
    none, pmap = ssim_cuda.ssim_parts_cuda(band_a, band_b, with_map=True, **kw)
    torch.cuda.synchronize()
    assert (ssim_cuda.ROWSUM_LAUNCHES,
            ssim_cuda.ROWSUM_MAP_LAUNCHES) == (before[0] + 1, before[1] + 2)
    want_rows, want_map = ssim_cuda.ssim_rows_plain(
        band_a, band_b, with_map=True, vhalo=vh, vmask=flags, **_twin_kw(dr))
    assert none is None
    for got_map in (smap, pmap):
        assert torch.equal(got_map.isnan(), want_map.isnan())
        fin = ~want_map.isnan()
        assert torch.equal(got_map[fin], want_map[fin])
    for got in (rows, rows_m):
        assert torch.equal(got.isnan(), want_rows.isnan())
        ok = ~want_rows.isnan()
        assert (got[ok] - want_rows[ok]).abs().max().item() <= 517 * 1e-5
    if dtype == "f32":
        assert rows[1, 120 - lo].isnan() and not rows[0].isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_backward_halo_mode_matches_twin_on_card(flags):
    """The backward kernel with 2r-row halo operands against its twin, at
    interior and edge flags (1e-6 * max(1, max|g|); both round alike);
    NaN-filled operands at a flagged edge are not read."""
    _need_card()
    rng = np.random.default_rng(0x5E)
    a = rng.random((2, 300, 517)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    lo, hi = 100, 237
    band_a, band_b = at[:, lo:hi].contiguous(), bt[:, lo:hi].contiguous()
    a_top, a_bot = _halo(at, lo, hi, 10, flags)
    b_top, b_bot = _halo(bt, lo, hi, 10, flags)
    if flags[0]:
        a_top.fill_(float("nan"))
    if flags[1]:
        b_bot.fill_(float("nan"))
    vh = (a_top, a_bot, b_top, b_bot)
    before = (ssim_grad.LAUNCHES, ssim_grad.VHALO_LAUNCHES)
    da, db = ssim_grad.ssim_grad_cuda(band_a, band_b, 1.0 / band_a.numel(), 0.2,
                                      vhalo=vh, vmask=flags, data_range=1.0)
    torch.cuda.synchronize()
    assert (ssim_grad.LAUNCHES, ssim_grad.VHALO_LAUNCHES) == (before[0], before[1] + 1)
    n = band_a.shape[0]
    w_s = torch.full((n,), 1.0 / band_a.numel(), device="cuda")
    w_cs = torch.full((n,), 0.2, device="cuda")
    pa, pb = ssim_grad.ssim_grad_plain(
        band_a, band_b, w_s, w_cs, None, vhalo=vh, vmask=flags, **_twin_kw(1.0))
    assert torch.isfinite(da).all() and torch.isfinite(db).all()
    tol = 1e-6 * max(1.0, pa.abs().max().item())
    assert (da - pa).abs().max().item() <= tol and (db - pb).abs().max().item() <= tol


def _hold_backward(da, db, pa, pb):
    """Kernel against twin: NaN masks equal, finite values within 1e-6 *
    max(1, max|g|) (both round alike)."""
    scale = 1.0
    for k, p in ((da, pa), (db, pb)):
        assert torch.equal(k.isnan(), p.isnan())
        fin = ~p.isnan()
        if fin.any():
            scale = max(scale, p[fin].abs().max().item())
    for k, p in ((da, pa), (db, pb)):
        fin = ~p.isnan()
        if fin.any():
            assert (k[fin] - p[fin]).abs().max().item() <= 1e-6 * scale


def _stream_launch(at, bt, w_s, w_cs, g_map, radius, sigma, seg, **halo):
    """The standard backward kernel at a pinned segment length, and its
    twin, on the same card tensors (data_range 1)."""
    kw = dict(taps=gaussian_taps(np.float32, radius, sigma), c1=1e-4, c2=9e-4,
              clip_bound=131072.0, **halo)
    before = (ssim_grad.LAUNCHES, ssim_grad.VHALO_LAUNCHES)
    got = ssim_grad._launch(at, bt, w_s, w_cs, g_map, segment=seg, **kw)
    torch.cuda.synchronize()
    want = (before[0], before[1] + 1) if halo else (before[0] + 1, before[1])
    assert (ssim_grad.LAUNCHES, ssim_grad.VHALO_LAUNCHES) == want
    return got, ssim_grad.ssim_grad_plain(at, bt, w_s, w_cs, g_map, **kw)


_SIGMA = {1: 0.8, 5: 1.5, 16: 3.0}


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 5, 16])
@pytest.mark.parametrize("case", ["seg-1", "seg", "seg+1", "2seg+1", "ragged_w", "w=r+1"])
def test_backward_stream_geometry_on_card(radius, case):
    """The standard kernel's row streaming at a segment of two NaN tiles:
    H one short of, equal to and one past the segment and 2S + 1; W not a
    multiple of the 128-column strip and W = r + 1; two images, g_map and
    w_cs; radius 5 (register windows) and 1, 16 (shared-memory rings)."""
    _need_card()
    seg = 2 * ssim_grad.default_tile(radius)[0]
    h, w = {"seg-1": (seg - 1, 300), "seg": (seg, 300), "seg+1": (seg + 1, 300),
            "2seg+1": (2 * seg + 1, 300), "ragged_w": (seg + 1, 517),
            "w=r+1": (seg + 1, radius + 1)}[case]
    rng = np.random.default_rng(0x62 + radius)
    a = rng.random((2, h, w), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    g = torch.from_numpy(rng.normal(0, 1, a.shape).astype(np.float32)).cuda()
    w_s = torch.tensor([0.7, -0.3], device="cuda")
    w_cs = torch.tensor([0.1, 0.25], device="cuda")
    (da, db), (pa, pb) = _stream_launch(at, bt, w_s, w_cs, g, radius,
                                        _SIGMA[radius], seg)
    assert torch.isfinite(da).all() and torch.isfinite(db).all()
    _hold_backward(da, db, pa, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 16])
@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_backward_stream_halo_radii_on_card(radius, flags):
    """The halo operands at radius 1 and 16 (the rings) with each flag
    pair, a band of 137 rows in segments of two NaN tiles."""
    _need_card()
    rng = np.random.default_rng(0x63 + radius)
    a = rng.random((2, 300, 517)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    lo, hi = 100, 237
    band_a, band_b = at[:, lo:hi].contiguous(), bt[:, lo:hi].contiguous()
    a_top, a_bot = _halo(at, lo, hi, 2 * radius, flags)
    b_top, b_bot = _halo(bt, lo, hi, 2 * radius, flags)
    w_s = torch.full((2,), 1.0 / band_a[0].numel(), device="cuda")
    w_cs = torch.full((2,), 0.2, device="cuda")
    seg = 2 * ssim_grad.default_tile(radius)[0]
    (da, db), (pa, pb) = _stream_launch(
        band_a, band_b, w_s, w_cs, None, radius, _SIGMA[radius], seg,
        vhalo=(a_top, a_bot, b_top, b_bot), vmask=flags)
    assert torch.isfinite(da).all() and torch.isfinite(db).all()
    _hold_backward(da, db, pa, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [5, 16])
def test_backward_stream_nonfinite_on_boundaries_on_card(radius):
    """Non-finite pixels on a segment's first and last rows, 2r rows above
    a segment's first row (the first row its block loads, staged before the
    block's first step) and on a strip's first and last columns: NaN over
    exactly the twin's tiles (the tiles within 2r), in their own image
    only."""
    _need_card()
    seg = 2 * ssim_grad.default_tile(radius)[0]
    rng = np.random.default_rng(0x64 + radius)
    a = rng.random((3, 2 * seg + 7, 400)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    a[0, seg, 200] = np.nan       # first row of segment 1
    a[0, seg - 2 * radius, 40] = np.nan  # segment 1's first stream row, strip 0
    a[1, seg - 1, 127] = np.inf   # last row of segment 0, last column of strip 0
    b[1, 3, 128] = -np.inf        # first column of strip 1
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    w_s = torch.full((3,), 0.5, device="cuda")
    w_cs = torch.full((3,), 0.1, device="cuda")
    (da, db), (pa, pb) = _stream_launch(at, bt, w_s, w_cs, None, radius,
                                        _SIGMA[radius], seg)
    _hold_backward(da, db, pa, pb)
    assert da[0, seg, 0].isnan() and da[1].isnan().any()
    assert torch.isfinite(da[2]).all() and torch.isfinite(db[2]).all()


def _float_pair(rng, shape):
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return a, b


def _fwd_stream(at, bt, mode, tile, seg, **halo):
    """The forward kernel in `mode` through the row-streaming instantiation
    at a pinned segment and tile, and the twin, on the same card tensors.
    Returns ((partials or rows, map or None) of the kernel, of the twin)."""
    dr = 1.0 if at.dtype == torch.float32 else 255.0
    kw = dict(_twin_kw(dr), tile_h=tile[0], tile_w=tile[1])
    assert ssim_cuda.stream_applies(mode, 5, tile[1])
    before = ssim_cuda.STREAM_LAUNCHES
    got = ssim_cuda._launch(at, bt, mode=mode, segment=seg, **halo, **kw)
    torch.cuda.synchronize()
    assert ssim_cuda.STREAM_LAUNCHES == before + 1
    if mode in ("rowsum", "rowsum_map"):
        want = ssim_cuda.ssim_rows_plain(at, bt, with_map=mode == "rowsum_map",
                                         **halo, **kw)
    else:
        want = ssim_cuda.ssim_parts_plain(at, bt, with_map=mode == "map", **kw)
    return got, want


def _hold_forward(got, want, shape, rows):
    """Kernel against twin on a (B, H, W) input: maps bit for bit (NaN at
    the same pixels); row sums within W * 1e-5, per-image scores within
    2e-7 (never tighter than 2e-5 / sqrt(npix)); NaN at the same rows or
    tiles."""
    (pk, mk), (pp, mp) = got, want
    assert (mk is None) == (mp is None)
    if mp is not None:
        assert torch.equal(mk.isnan(), mp.isnan())
        assert torch.equal(mk[~mp.isnan()], mp[~mp.isnan()])
    assert torch.equal(pk.isnan(), pp.isnan())
    if rows:
        ok = ~pp.isnan()
        if ok.any():
            assert (pk[ok] - pp[ok]).abs().max().item() <= 1e-5 * shape[-1]
        return
    npix = shape[-2] * shape[-1]
    gk = pk.double().sum(-1).cpu().numpy() / npix
    gp = pp.double().sum(-1).cpu().numpy() / npix
    assert np.array_equal(np.isnan(gk), np.isnan(gp))
    assert np.nanmax(np.abs(gk - gp), initial=0.0) <= max(2e-7, 2e-5 / npix**0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("tile", [(32, 32), (32, 64), (64, 128)])
@pytest.mark.parametrize("case", ["seg-1", "seg", "seg+1", "2seg+1", "ragged_w",
                                  "w<=2r", "h=1", "b=3"])
def test_forward_stream_geometry_on_card(case, tile, dtype):
    """The main-path modes' row streaming at a segment of two tiles: H one
    short of, equal to and one past the segment and 2S + 1; W not a
    multiple of the 128-column strip (the last strip ragged, u8 rows not
    a multiple of 4 or 16 bytes), W <= 2r, H = 1, three images; pinned
    tiles 32x32, 32x64, 64x128; u8 and f32. Maps (kMap, kRowsumMap) bit for
    bit the twin's, partials and row sums within the twin tolerance."""
    _need_card()
    seg = 2 * tile[0]
    bsz, h, w = {"seg-1": (2, seg - 1, 300), "seg": (2, seg, 300),
                 "seg+1": (2, seg + 1, 300), "2seg+1": (2, 2 * seg + 1, 300),
                 "ragged_w": (2, seg + 1, 517), "w<=2r": (2, seg + 1, 9),
                 "h=1": (2, 1, 301), "b=3": (3, seg + 3, 259)}[case]
    rng = np.random.default_rng(0x70 + len(case) + tile[1])
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, (bsz, h, w))
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    for mode in ("score", "map", "rowsum", "rowsum_map"):
        got, want = _fwd_stream(at, bt, mode, tile, seg)
        if got[1] is not None:
            assert torch.isfinite(got[1]).all()
        _hold_forward(got, want, at.shape, rows=mode.startswith("rowsum"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["map", "rowsum_map"])
@pytest.mark.parametrize("tile", [(32, 64), (32, 32), (16, 128)])
def test_forward_stream_nonfinite_on_boundaries_on_card(mode, tile):
    """Non-finite pixels on a tile edge, a strip's last and first column, a
    segment's first and last row, 2r rows above an interior segment's first
    row (the first row its block loads, staged before its first step: the
    P5 case) and the image's last pixel: NaN over exactly the twin's tiles,
    in the map and the partials or rows, in their own image only."""
    _need_card()
    seg = 2 * tile[0]
    rng = np.random.default_rng(0x74 + tile[1])
    a, b = _float_pair(rng, (3, 2 * seg + 7, 400))
    a[0, seg, 200] = np.nan
    a[0, seg - 10, 40] = np.nan
    a[1, seg - 1, 127] = np.inf
    b[1, 3, 128] = -np.inf
    a[2, tile[0] - 1, tile[1]] = np.nan
    b[2, 2 * seg + 6, 399] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    got, want = _fwd_stream(at, bt, mode, tile, seg)
    _hold_forward(got, want, at.shape, rows=mode == "rowsum_map")
    m = got[1]
    assert m[0, seg, 200].isnan() and m[0, seg - 10, 40].isnan()
    assert m[1, seg - 1, 127].isnan() and m[1, 3, 128].isnan()
    # Each NaN tile is whole, and holds a planted pixel.
    bad = m.isnan().cpu().numpy()
    th, tw = tile
    for i in range(3):
        for y in range(0, bad.shape[1], th):
            for x in range(0, bad.shape[2], tw):
                blk = bad[i, y:y + th, x:x + tw]
                assert blk.all() or not blk.any()
                planted = ~np.isfinite(a[i, y:y + th, x:x + tw]) | ~np.isfinite(
                    b[i, y:y + th, x:x + tw])
                assert blk.any() == planted.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_forward_stream_row_modes_with_halo_on_card(flags, dtype):
    """kRowsum and kRowsumMap at radius 5 with halo operands through the
    streaming kernel, a band of 137 rows in segments of two tiles, each
    flag pair, against ssim_rows_plain (map bit for bit, rows within W *
    1e-5); operands under a set flag NaN-filled (never read); in f32 a NaN
    in the band and one in the top operand (operand rows poison nothing)."""
    _need_card()
    rng = np.random.default_rng(0x78 + 2 * flags[0] + flags[1])
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, (2, 301, 517))
    if dtype == "f32":
        a[1, 120, 40] = np.nan
        a[0, 97, 30] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    lo, hi = 100, 237
    band_a, band_b = at[:, lo:hi].contiguous(), bt[:, lo:hi].contiguous()
    a_top, a_bot = _halo(at, lo, hi, 5, flags)
    b_top, b_bot = _halo(bt, lo, hi, 5, flags)
    if dtype == "f32":
        if flags[0]:
            a_top.fill_(float("nan"))
        if flags[1]:
            b_bot.fill_(float("nan"))
    halo = dict(vhalo=(a_top, a_bot, b_top, b_bot), vmask=flags)
    for mode in ("rowsum", "rowsum_map"):
        got, want = _fwd_stream(band_a, band_b, mode, (32, 64), 64, **halo)
        _hold_forward(got, want, band_a.shape, rows=True)
    rows = got[0]
    if dtype == "f32":
        assert rows[1, 120 - lo].isnan() and not rows[0].isnan().any()
    else:
        assert torch.isfinite(rows).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("mode", ["map", "rowsum_map"])
def test_forward_stream_matches_tile_body_on_card(mode, dtype):
    """The streaming kernel's map against the tile body's, which a pinned
    16x256 tile reaches (STREAM_LAUNCHES does not rise there; 32x256 does
    not fit a block's shared memory at radius 5), bit for bit; scores and
    row sums within the twin tolerance of each other."""
    _need_card()
    rng = np.random.default_rng(0x7C)
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, (2, 300, 700))
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    kw = dict(data_range=1.0 if dtype == "f32" else 255.0, allow_float=dtype == "f32")
    call = ssim_cuda.ssim_rows_cuda if mode == "rowsum_map" else ssim_cuda.ssim_parts_cuda
    before = ssim_cuda.STREAM_LAUNCHES
    p_tile, m_tile = call(at, bt, with_map=True, tile_h=16, tile_w=256, **kw)
    torch.cuda.synchronize()
    assert ssim_cuda.STREAM_LAUNCHES == before
    p_str, m_str = call(at, bt, with_map=True, **kw)
    torch.cuda.synchronize()
    assert ssim_cuda.STREAM_LAUNCHES == before + 1
    assert torch.equal(m_str, m_tile)
    if mode == "rowsum_map":
        assert (p_str - p_tile).abs().max().item() <= 700 * 1e-5
    else:
        npix = 300 * 700
        g_str = p_str.double().sum(-1) / npix
        g_tile = p_tile.double().sum(-1) / npix
        assert (g_str - g_tile).abs().max().item() <= 2e-7


def _comp_stream(at, bt, mode, tile, seg):
    """The components or pooled mode through the row-streaming
    instantiation at a pinned segment and tile, and its twin, on the same
    card tensors; the launch adds one to STREAM_LAUNCHES and to the mode's
    own counter. Returns (the kernel's parts or (parts, pooled_a,
    pooled_b), the twin's)."""
    dr = 1.0 if at.dtype == torch.float32 else 255.0
    kw = dict(_twin_kw(dr), tile_h=tile[0], tile_w=tile[1])
    assert ssim_cuda.stream_applies(mode, 5, tile[1])
    count = lambda: (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.COMPONENTS_LAUNCHES,
                     ssim_cuda.POOLED_LAUNCHES)
    before = count()
    got = ssim_cuda._launch(at, bt, mode=mode, segment=seg, **kw)
    torch.cuda.synchronize()
    pooled = mode == "pooled"
    assert count() == (before[0] + 1, before[1] + (not pooled), before[2] + pooled)
    twin = (ssim_cuda.ssim_components_pooled_plain if pooled
            else ssim_cuda.ssim_components_plain)(at, bt, **kw)
    return got, twin


def _same(x, y):
    """Equal bit for bit, NaN where NaN."""
    return torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())


def _hold_components(got, want, npix, tol=None):
    """Kernel against twin (or another design): pooled images bit for bit,
    NaN at the same pixels; per-image mean cs and ssim within max(2e-7,
    2e-5 / sqrt(npix)) (tol where given), NaN at the same tiles (means of
    the same images where the tile grids differ). Returns the parts."""
    if isinstance(got, tuple):
        for x, y in zip(got[1:], want[1:]):
            assert _same(x, y)
        got, want = got[0], want[0]
    if got.shape == want.shape:
        assert torch.equal(got.isnan(), want.isnan())
    mk = got.double().sum(-2).cpu().numpy() / npix
    mt = want.double().sum(-2).cpu().numpy() / npix
    assert np.array_equal(np.isnan(mk), np.isnan(mt))
    tol = max(2e-7, 2e-5 / npix**0.5) if tol is None else tol
    assert np.nanmax(np.abs(mk - mt), initial=0.0) <= tol
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("tile", [(32, 32), (32, 64), (64, 128)])
@pytest.mark.parametrize("case", ["seg-1", "seg", "seg+1", "2seg+1", "ragged_w",
                                  "odd_h_w", "w<=2r", "h=1", "b=3"])
def test_components_stream_geometry_on_card(case, tile, dtype):
    """The components and pooled modes' row streaming at a segment of two
    tiles: H one short of, equal to and one past the segment and 2S + 1
    (odd: the last pooled row dropped); W not a multiple of the 128-column
    strip and odd (the last pooled column dropped), W <= 2r, H = 1
    (components only: pooling needs H, W >= 2), three images; pinned
    tiles 32x32, 32x64, 64x128; u8 and f32. Pooled images bit for bit the
    twin's, mean cs and ssim within the twin tolerance, and the pooled
    mode's parts equal to the components mode's."""
    _need_card()
    seg = 2 * tile[0]
    bsz, h, w = {"seg-1": (2, seg - 1, 300), "seg": (2, seg, 300),
                 "seg+1": (2, seg + 1, 300), "2seg+1": (2, 2 * seg + 1, 300),
                 "ragged_w": (2, seg + 2, 517), "odd_h_w": (2, 2 * seg + 3, 301),
                 "w<=2r": (2, seg + 1, 9), "h=1": (2, 1, 301),
                 "b=3": (3, seg + 3, 259)}[case]
    rng = np.random.default_rng(0x90 + len(case) + tile[1])
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, (bsz, h, w))
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    got, want = _comp_stream(at, bt, "components", tile, seg)
    parts = _hold_components(got, want, h * w)
    assert torch.isfinite(parts).all()
    if h < 2:
        return
    got, want = _comp_stream(at, bt, "pooled", tile, seg)
    assert _same(_hold_components(got, want, h * w), parts)
    assert got[1].shape == (bsz, h // 2, w // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(32, 64), (32, 32), (16, 128)])
def test_components_stream_nonfinite_on_boundaries_on_card(tile):
    """Non-finite pixels on a tile edge, a strip's last and first column, a
    segment's first and last row, 2r rows above an interior segment's
    first row and the image's last pixel (outside the pooled images, W
    and H odd): NaN in both partials of exactly the twin's tiles, in their
    own image only; each NaN or inf reaches its own pooled pixel."""
    _need_card()
    seg = 2 * tile[0]
    rng = np.random.default_rng(0x98 + tile[1])
    a, b = _float_pair(rng, (3, 2 * seg + 7, 401))
    a[0, seg, 200] = np.nan
    a[0, seg - 10, 40] = np.nan
    a[1, seg - 1, 127] = np.inf
    b[1, 3, 128] = -np.inf
    a[2, tile[0] - 1, tile[1]] = np.nan
    b[2, 2 * seg + 6, 400] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    npix = a.shape[1] * a.shape[2]
    got, want = _comp_stream(at, bt, "components", tile, seg)
    parts = _hold_components(got, want, npix)
    assert parts.isnan().any() and not parts.isnan().all()
    got, want = _comp_stream(at, bt, "pooled", tile, seg)
    assert _same(_hold_components(got, want, npix), parts)
    pa, pb = got[1], got[2]
    assert pa[0, seg // 2, 100].isnan() and pa[1, seg // 2 - 1, 63].isinf()
    assert pb[1, 1, 64].isinf() and not pb[2].isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_components_stream_matches_tile_body_on_card(dtype):
    """The wrappers' components and pooled launches at 1.2 Mpix (over
    STREAM_COMP_MIN_PIX: the streaming kernel, one STREAM_LAUNCHES each)
    against the tile body, which a pinned 16x256 tile reaches (no
    STREAM_LAUNCHES there): pooled images bit for bit, per-image mean cs
    and ssim within 2e-7 of each other."""
    _need_card()
    rng = np.random.default_rng(0x9C)
    shape = (4, 301, 1001)
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, shape)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    dr = 1.0 if dtype == "f32" else 255.0
    kw = dict(_twin_kw(dr), tile_h=16, tile_w=256)
    for mode, fn in (("components", ssim_cuda.ssim_components_cuda),
                     ("pooled", ssim_cuda.ssim_components_pooled_cuda)):
        before = ssim_cuda.STREAM_LAUNCHES
        tile = ssim_cuda._launch(at, bt, mode=mode, **kw)
        torch.cuda.synchronize()
        assert ssim_cuda.STREAM_LAUNCHES == before
        got = fn(at, bt, data_range=dr)
        torch.cuda.synchronize()
        assert ssim_cuda.STREAM_LAUNCHES == before + 1
        _hold_components(got, tile, shape[1] * shape[2], tol=2e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["components", "pooled"])
def test_components_size_condition_on_card(mode):
    """The wrappers stream the components and pooled modes from
    STREAM_COMP_MIN_PIX pixels a launch (one STREAM_LAUNCHES) and run the
    tile body one row below it (none), each against its twin."""
    _need_card()
    rng = np.random.default_rng(0x9E)
    fn = {"components": ssim_cuda.ssim_components_cuda,
          "pooled": ssim_cuda.ssim_components_pooled_cuda}[mode]
    for h, streams in ((1024, True), (1023, False)):
        a, b = _pair(rng, (1, h, 1024))
        assert (h * 1024 >= ssim_cuda.STREAM_COMP_MIN_PIX) == streams
        at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        before = ssim_cuda.STREAM_LAUNCHES
        got = fn(at, bt)
        torch.cuda.synchronize()
        assert ssim_cuda.STREAM_LAUNCHES == before + streams
        want = (ssim_cuda.ssim_components_pooled_plain if mode == "pooled"
                else ssim_cuda.ssim_components_plain)(at, bt, **_twin_kw(255.0))
        _hold_components(got, want, h * 1024)


def _precise_stream(at, bt, mode, tile, seg):
    """A precise mode through the row-streaming instantiation at a pinned
    segment and tile, and the precise twin, on the same card tensors; the
    launch adds one to STREAM_LAUNCHES and to PRECISE_LAUNCHES. Returns
    ((partials, map or None) of the kernel, of the twin)."""
    dr = 1.0 if at.dtype == torch.float32 else 255.0
    kw = dict(_twin_kw(dr, True), tile_h=tile[0], tile_w=tile[1])
    assert ssim_cuda.stream_applies(mode, 5, tile[1])
    before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.PRECISE_LAUNCHES)
    got = ssim_cuda._launch(at, bt, mode=mode, segment=seg, **kw)
    torch.cuda.synchronize()
    assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.PRECISE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = ssim_cuda.ssim_parts_precise_plain(at, bt, with_map=mode == "precise_map",
                                              **kw)
    return got, want


def _hold_precise(got, want, shape):
    """Precise kernel against twin: maps bit for bit (NaN at the same
    pixels), f64 partials, NaN at the same tiles, per-image scores within
    1e-12 relative (only the order of the tile sums differs)."""
    (pk, mk), (pp, mp) = got, want
    assert pk.dtype == torch.float64 and (mk is None) == (mp is None)
    if mp is not None:
        assert torch.equal(mk.isnan(), mp.isnan())
        assert torch.equal(mk[~mp.isnan()], mp[~mp.isnan()])
    assert torch.equal(pk.isnan(), pp.isnan())
    npix = shape[-2] * shape[-1]
    gk = pk.sum(-1).cpu().numpy() / npix
    gp = pp.sum(-1).cpu().numpy() / npix
    assert np.array_equal(np.isnan(gk), np.isnan(gp))
    assert np.nanmax(np.abs(gk - gp) / np.abs(gp), initial=0.0) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("tile", [(32, 32), (32, 64), (64, 128)])
@pytest.mark.parametrize("case", ["seg-1", "seg", "seg+1", "2seg+1", "ragged_w",
                                  "w<=2r", "h=1", "b=3"])
def test_precise_stream_geometry_on_card(case, tile, dtype):
    """The precise modes' row streaming (fp64 blurs with the f64 taps) at a
    segment of two tiles: H one short of, equal to and one past the
    segment and 2S + 1; a ragged last strip, W <= 2r, H = 1, three images;
    pinned tiles 32x32, 32x64, 64x128; u8 and f32. kPreciseMap's map bit
    for bit the twin's, both modes' scores within 1e-12 relative."""
    _need_card()
    seg = 2 * tile[0]
    bsz, h, w = {"seg-1": (2, seg - 1, 300), "seg": (2, seg, 300),
                 "seg+1": (2, seg + 1, 300), "2seg+1": (2, 2 * seg + 1, 300),
                 "ragged_w": (2, seg + 1, 517), "w<=2r": (2, seg + 1, 9),
                 "h=1": (2, 1, 301), "b=3": (3, seg + 3, 259)}[case]
    rng = np.random.default_rng(0x90 + len(case) + tile[1])
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, (bsz, h, w))
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    for mode in ("precise", "precise_map"):
        got, want = _precise_stream(at, bt, mode, tile, seg)
        if got[1] is not None:
            assert torch.isfinite(got[1]).all()
        _hold_precise(got, want, at.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(32, 64), (32, 32), (16, 128)])
def test_precise_stream_nonfinite_on_boundaries_on_card(tile):
    """The precise modes' NaN contract through the stream: non-finite pixels
    on a tile edge, a strip's last and first column, a segment's first and
    last row, 2r rows above an interior segment's first row (staged before
    its first step: the P5 case) and the image's last pixel. NaN over
    exactly the twin's tiles, in the map and the f64 partials, in their own
    image only; each NaN tile whole and holding a planted pixel."""
    _need_card()
    seg = 2 * tile[0]
    rng = np.random.default_rng(0x94 + tile[1])
    a, b = _float_pair(rng, (4, 2 * seg + 7, 400))
    a[0, seg, 200] = np.nan
    a[0, seg - 10, 40] = np.nan
    a[1, seg - 1, 127] = np.inf
    b[1, 3, 128] = -np.inf
    a[2, tile[0] - 1, tile[1]] = np.nan
    b[2, 2 * seg + 6, 399] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    for mode in ("precise", "precise_map"):
        got, want = _precise_stream(at, bt, mode, tile, seg)
        _hold_precise(got, want, at.shape)
    pk, m = got
    assert pk[:3].isnan().any(dim=-1).all() and not pk[3].isnan().any()
    assert m[0, seg, 200].isnan() and m[0, seg - 10, 40].isnan()
    assert m[1, seg - 1, 127].isnan() and m[1, 3, 128].isnan()
    assert torch.isfinite(m[3]).all()
    bad = m.isnan().cpu().numpy()
    th, tw = tile
    for i in range(4):
        for y in range(0, bad.shape[1], th):
            for x in range(0, bad.shape[2], tw):
                blk = bad[i, y:y + th, x:x + tw]
                assert blk.all() or not blk.any()
                planted = ~np.isfinite(a[i, y:y + th, x:x + tw]) | ~np.isfinite(
                    b[i, y:y + th, x:x + tw])
                assert blk.any() == planted.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_precise_stream_matches_tile_body_on_card(dtype):
    """The streaming precise map against the tile body's, which a pinned
    tile_w of 256 reaches (8x256: the widest tile whose f64 planes fit a
    block's shared memory at radius 5), bit for bit; scores within 1e-12
    relative of each other. Each call adds one to
    PRECISE_LAUNCHES, and only the default tile's to STREAM_LAUNCHES."""
    _need_card()
    rng = np.random.default_rng(0x98)
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, (2, 300, 700))
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    kw = dict(data_range=1.0 if dtype == "f32" else 255.0, allow_float=dtype == "f32",
              precise=True, with_map=True)
    stream, precise = ssim_cuda.STREAM_LAUNCHES, ssim_cuda.PRECISE_LAUNCHES
    p_tile, m_tile = ssim_cuda.ssim_parts_cuda(at, bt, tile_h=8, tile_w=256, **kw)
    torch.cuda.synchronize()
    assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.PRECISE_LAUNCHES) == (stream, precise + 1)
    p_str, m_str = ssim_cuda.ssim_parts_cuda(at, bt, **kw)
    torch.cuda.synchronize()
    assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.PRECISE_LAUNCHES) == (
        stream + 1, precise + 2)
    assert torch.isfinite(m_str).all() and torch.equal(m_str, m_tile)
    g_str = p_str.sum(-1).cpu().numpy() / (300 * 700)
    g_tile = p_tile.sum(-1).cpu().numpy() / (300 * 700)
    assert np.abs(g_str - g_tile).max() <= 1e-12 * np.abs(g_tile).max()

# The relaxed tier: kernel against its relaxed twin. Both add the same
# three exact bf16 products per band pass, the kernel in the tensor cores'
# order, the twin in f32 matrix products (TF32 off), so they agree to a
# few f32 roundings per blur: 2e-6 global (never tighter than 2e-5 /
# sqrt(npix)) and 2e-5 per pixel, the backward 1e-4 * max|g| (chip_smoke.py
# phase 10 prints what they measure, several times below these).
_RELAXED_GLOBAL, _RELAXED_PIXEL, _RELAXED_GRAD = 2e-6, 2e-5, 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["score", "map", "components", "pooled", "batch"])
def test_relaxed_modes_match_twins_on_card(mode):
    """Each relaxed forward mode (W >= 512, or the batch route) against its
    relaxed twin, one RELAXED_LAUNCHES each; the result differs from the
    standard mode's."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0x60)
    shape = (64, 40, 48) if mode == "batch" else (2, 130, 700)
    a, b = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2))
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    npix = shape[1] * shape[2]
    kw = _twin_kw(255.0)
    before = ssim_cuda.RELAXED_LAUNCHES
    if mode in ("score", "map"):
        with_map = mode == "map"
        pk, mk = ssim_cuda.ssim_parts_cuda(at, bt, with_map=with_map, relaxed=True)
        _, ms = ssim_cuda.ssim_parts_cuda(at, bt, with_map=True)
        pp, mp = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, relaxed=True, **kw)
        if with_map:
            assert (mk - mp).abs().max().item() <= _RELAXED_PIXEL
            assert (mk - ms).abs().max().item() > 0
        got, want = pk.double().sum(-1), pp.double().sum(-1)
    elif mode == "batch":
        pk = ssim_cuda.ssim_parts_batch_cuda(at, bt, relaxed=True)
        pp = ssim_cuda.ssim_parts_batch_plain(at, bt, relaxed=True, **kw)
        got, want = pk[:, 0].double(), pp[:, 0].double()
        assert not torch.equal(pk, ssim_cuda.ssim_parts_batch_cuda(at, bt))
    else:
        pooled = mode == "pooled"
        fn = (ssim_cuda.ssim_components_pooled_cuda if pooled
              else ssim_cuda.ssim_components_cuda)
        out = fn(at, bt, relaxed=True)
        std = fn(at, bt)
        twin = (ssim_cuda.ssim_components_pooled_plain if pooled
                else ssim_cuda.ssim_components_plain)(at, bt, relaxed=True, **kw)
        if pooled:
            assert torch.equal(out[1], std[1]) and torch.equal(out[2], std[2])
            out, std, twin = out[0], std[0], twin[0]
        got, want = out.double().sum(-2), twin.double().sum(-2)
        assert not torch.equal(out, std)
    torch.cuda.synchronize()
    assert ssim_cuda.RELAXED_LAUNCHES == before + 1
    tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / npix**0.5)
    assert (got - want).abs().max().item() / npix <= tol


def _hold_relaxed(pk, mk, pp, mp, npix):
    """A relaxed kernel's partials (and map) against the relaxed twin's: NaN
    at the same tiles and pixels, per-image scores within 2e-6 (never
    tighter than 2 * 2e-5 / sqrt(npix)), pixels within 2e-5."""
    assert torch.equal(pk.isnan(), pp.isnan())
    gk, gp = pk.double().sum(-1) / npix, pp.double().sum(-1) / npix
    fin = ~gp.isnan()
    tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / npix**0.5)
    if fin.any():
        assert (gk[fin] - gp[fin]).abs().max().item() <= tol
    if mk is not None:
        assert torch.equal(mk.isnan(), mp.isnan())
        ok = ~mp.isnan()
        assert (mk[ok] - mp[ok]).abs().max().item() <= _RELAXED_PIXEL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1080p_b4", "ragged_nan", "f32_1080p_b4"])
def test_relaxed_stream_matches_twin_on_card(case):
    """Relaxed kScore and kMap through the row-streaming kernel (the heavy
    horizontal blurs as bf16x3 band products) against the relaxed twin at
    1080p x4 (u8 and f32) and a ragged (2, 300, 600) f32 pair with a NaN:
    within the tier's 2e-6 global and 2e-5 per pixel, NaN over exactly the
    twin's tiles, one STREAM_LAUNCHES and one RELAXED_LAUNCHES each, and a
    map that differs from the standard tier's."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0x62 + len(case))
    shape = (2, 300, 600) if case == "ragged_nan" else (4, 1080, 1920)
    f32 = case != "1080p_b4"
    a, b = (_float_pair if f32 else _pair)(rng, shape)
    if case == "ragged_nan":
        a[0, 123, 321] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    dr = 1.0 if f32 else 255.0
    kw = dict(data_range=dr, allow_float=f32)
    before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES, ssim_cuda.LAUNCHES)
    pk, _ = ssim_cuda.ssim_parts_cuda(at, bt, relaxed=True, **kw)
    pm, mk = ssim_cuda.ssim_parts_cuda(at, bt, with_map=True, relaxed=True, **kw)
    torch.cuda.synchronize()
    assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES, ssim_cuda.LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2])
    _, ms = ssim_cuda.ssim_parts_cuda(at, bt, with_map=True, **kw)
    pp, mp = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, relaxed=True, **_twin_kw(dr))
    npix = shape[1] * shape[2]
    _hold_relaxed(pk, None, pp, mp, npix)
    _hold_relaxed(pm, mk, pp, mp, npix)
    ok = ~mp.isnan()
    assert (mk[ok] - ms[ok]).abs().max().item() > 0
    if case == "ragged_nan":
        assert mk[0, 123, 321].isnan() and torch.isfinite(mk[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(32, 64), (7, 32), (32, 128)])
@pytest.mark.parametrize("case", ["seg-1", "seg+1", "2seg+1", "ragged_w", "h=1", "nan"])
def test_relaxed_stream_geometry_on_card(case, tile):
    """The relaxed streaming instantiation at a pinned segment of two tiles
    (ssim_cuda._launch(segment=...)): H one short of and one past the
    segment and 2S + 1, a ragged last strip, H = 1, tiles 32x64, 7x32 and
    32x128, and f32 NaN / inf pixels on a segment's first row and a strip's
    last and first column; kScore and kMap against the relaxed twin."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    seg = 2 * tile[0]
    bsz, h, w = {"seg-1": (2, seg - 1, 520), "seg+1": (2, seg + 1, 520),
                 "2seg+1": (1, 2 * seg + 1, 640), "ragged_w": (2, seg + 1, 777),
                 "h=1": (2, 1, 530), "nan": (3, 2 * seg + 7, 600)}[case]
    rng = np.random.default_rng(0x76 + len(case) + tile[1])
    f32 = case == "nan"
    a, b = (_float_pair if f32 else _pair)(rng, (bsz, h, w))
    if f32:
        a[0, seg, 300] = np.nan
        a[1, seg - 1, 127] = np.inf
        b[2, 3, 128] = -np.inf
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    dr = 1.0 if f32 else 255.0
    kw = dict(_twin_kw(dr), tile_h=tile[0], tile_w=tile[1])
    assert ssim_cuda.stream_applies("map", 5, tile[1], relaxed=True)
    pp, mp = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, relaxed=True, **kw)
    for mode in ("score", "map"):
        before = ssim_cuda.STREAM_LAUNCHES
        pk, mk = ssim_cuda._launch(at, bt, mode=mode, relaxed=True, segment=seg, **kw)
        torch.cuda.synchronize()
        assert ssim_cuda.STREAM_LAUNCHES == before + 1
        _hold_relaxed(pk, mk, pp, mp, h * w)
    if f32:
        assert mk[0, seg, 300].isnan() and mk[1, seg - 1, 127].isnan()
        assert mk[2, 3, 128].isnan()


#: Relaxed components and pooled streams at pinned segments: (f32, shape,
#: tile, segment rows), NaN pixels (image, y, x): H one past a segment and
#: 2S + 1, odd H and W, H = 3, a ragged last strip, NaN in one image of two.
_RELAXED_COMP_STREAM_CASES = {
    "u8 odd H and W, seg+1": (False, (2, 65, 601), (32, 64), 64, ()),
    "u8 2seg+1, 32x128 tiles": (False, (1, 129, 640), (32, 128), 64, ()),
    "f32 NaN in image 1 of 2, 32x32 tiles": (True, (2, 69, 777), (32, 32), 32,
                                            ((1, 40, 300), (1, 31, 127))),
    "f32 H = 3": (True, (2, 3, 530), (32, 64), 128, ()),
    "u8 1080p x4, the wrappers' tile, 4 tiles a segment": (
        False, (4, 1080, 1920), (ssim_cuda.TILE_H, ssim_cuda.TILE_W), 4 * ssim_cuda.TILE_H,
        ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_RELAXED_COMP_STREAM_CASES))
def test_relaxed_components_stream_matches_twin_on_card(case):
    """The relaxed components and pooled modes through the row-streaming
    kernel at a pinned segment (one STREAM_LAUNCHES and one
    RELAXED_LAUNCHES each) against ssim_components_plain(relaxed=True) and
    downsample2: per-image mean cs and ssim within 2e-6 (never tighter than
    2 * 2e-5 / sqrt(npix)), NaN in exactly the twin's tiles, the pooled
    mode's partials equal to the components mode's, pooled images bit for
    bit."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, shape, tile, seg, nans = _RELAXED_COMP_STREAM_CASES[case]
    rng = np.random.default_rng(0x90 + len(case))
    a, b = (_float_pair if f32 else _pair)(rng, shape)
    for img, y, x in nans:
        a[img, y, x] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    dr = 1.0 if f32 else 255.0
    kw = dict(_twin_kw(dr), tile_h=tile[0], tile_w=tile[1])
    npix = shape[1] * shape[2]
    before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
    parts = ssim_cuda._launch(at, bt, mode="components", relaxed=True, segment=seg, **kw)
    pparts, pa, pb = ssim_cuda._launch(at, bt, mode="pooled", relaxed=True, segment=seg,
                                       **kw)
    torch.cuda.synchronize()
    assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    want = ssim_cuda.ssim_components_plain(at, bt, relaxed=True, **kw)
    assert torch.equal(parts.isnan(), want.isnan())
    gk, gp = parts.double().sum(-2) / npix, want.double().sum(-2) / npix
    fin = ~gp.isnan()
    tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / npix**0.5)
    assert (gk[fin] - gp[fin]).abs().max().item() <= tol
    assert torch.equal(pparts.isnan(), parts.isnan())
    assert torch.equal(pparts.nan_to_num(), parts.nan_to_num())
    for x, y in ((pa, ssim_cuda.downsample2(at)), (pb, ssim_cuda.downsample2(bt))):
        assert torch.equal(x.isnan(), y.isnan())
        assert torch.equal(x.nan_to_num(), y.nan_to_num())
    if nans:
        assert gk[1].isnan().all() and not gk[0].isnan().any()


#: Relaxed batch stream packs: (shape, (k, segment rows)): widths whose
#: 16-column tiles straddle two images (24, 40, 100) and aligned ones (32,
#: 64, 128, 192), images straddling strips, segments.
_RELAXED_BATCH_STREAM_CASES = [
    ((40, 20, 24), (5, 20)), ((30, 33, 40), (3, 16)), ((9, 40, 100), (1, 40)),
    ((9, 21, 100), (3, 21)), ((64, 32, 32), (4, 32)), ((64, 64, 64), (2, 64)),
    ((8, 128, 128), (1, 32)), ((8, 192, 192), (2, 96)), ((7, 50, 1), (7, 50)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pack", _RELAXED_BATCH_STREAM_CASES)
def test_relaxed_batch_stream_matches_twin_on_card(shape, pack):
    """The relaxed kBatch through the packed stream at a pinned pack (one
    STREAM_LAUNCHES and one RELAXED_LAUNCHES) against
    ssim_parts_batch_plain(relaxed=True): per-image scores within 2e-6
    (never tighter than 2 * 2e-5 / sqrt(H W)), counts exact; in f32 a NaN
    in one image poisons its sum and no other."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0x98 + shape[2])
    bsz, h, w = shape
    for f32 in (False, True):
        a, b = (_float_pair if f32 else _pair)(rng, shape)
        if f32:
            a[1, h // 2, w - 1] = np.nan
        at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        dr = 1.0 if f32 else 255.0
        tile_h, tile_w, ipb, groups = ssim_cuda.batch_geometry(*shape)
        before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
        got = ssim_cuda._launch(at, bt, mode="batch", relaxed=True, pack=pack, tile_h=tile_h,
                                tile_w=tile_w, ipb=ipb, groups=groups, **_twin_kw(dr))
        torch.cuda.synchronize()
        assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        want = ssim_cuda.ssim_parts_batch_plain(at, bt, relaxed=True, **_twin_kw(dr))
        assert torch.equal(got[:, 1], want[:, 1])
        bad = torch.isnan(got[:, 0]).nonzero().flatten().tolist()
        assert bad == ([1] if f32 else []), bad
        gk, gp = got[:, 0].double() / (h * w), want[:, 0].double() / (h * w)
        ok = ~gp.isnan()
        tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / (h * w) ** 0.5)
        assert (gk[ok] - gp[ok]).abs().max().item() <= tol, (f32, shape, pack)


def _like_relaxed_twin(mode, got, want, npix):
    """A relaxed components, pooled or batch launch's outputs (card) against
    the wrapper's on the CPU tensors (the relaxed twin): per-image scores
    within 2e-6 (never tighter than 2 * 2e-5 / sqrt(npix)), NaN in the same
    images, pixel counts exact, pooled images bit for bit."""
    if mode == "pooled":
        for x, y in zip(got[1:], want[1:]):
            assert torch.equal(x.cpu(), y)
        got, want = got[0], want[0]
    if mode == "batch":
        assert torch.equal(got[:, 1].cpu(), want[:, 1])
        gk, gp = got[:, 0].double().cpu(), want[:, 0].double()
    else:
        gk, gp = got.double().sum(-2).cpu(), want.double().sum(-2)
    assert torch.equal(gk.isnan(), gp.isnan())
    ok = ~gp.isnan()
    tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / npix**0.5)
    assert ((gk[ok] - gp[ok]).abs() / npix).max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["components", "pooled", "batch"])
def test_relaxed_stream_leaves_other_modes_on_tile_body_on_card(mode):
    """What keeps the tile body in the relaxed tier: the components and
    pooled modes under STREAM_RELAXED_COMP_MIN_PIX pixels a launch and the
    batch mode on u8 at radius 4 (the measured rule,
    STREAM_BATCH_TILE_RADII), one RELAXED_LAUNCHES each and no
    STREAM_LAUNCHES, as do relaxed score and map with a 256-wide tile; the
    components and pooled launches from STREAM_RELAXED_COMP_MIN_PIX (and
    the batch at radius 5) stream, as do relaxed score and map at radius 1
    (the runtime-radius relaxed stream); at radius 16 the measured rule
    (STREAM_RELAXED_TILE_RADII) keeps them on the tile body. Each launch
    matches the relaxed twin (the wrapper on the CPU tensors)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0x63)
    shape = (64, 40, 48) if mode == "batch" else (2, 130, 700)
    fn = {"components": ssim_cuda.ssim_components_cuda,
          "pooled": ssim_cuda.ssim_components_pooled_cuda,
          "batch": ssim_cuda.ssim_parts_batch_cuda}[mode]
    assert shape[0] * shape[1] * shape[2] < ssim_cuda.STREAM_COMP_MIN_PIX
    assert 2 * 1080 * 1920 < ssim_cuda.STREAM_RELAXED_COMP_MIN_PIX <= 4 * 1100 * 1000

    def launched(shape, streams, **window):
        a, b = _pair(rng, shape)
        before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
        got = fn(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(), relaxed=True,
                 **window)
        torch.cuda.synchronize()
        assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES) == (
            before[0] + streams, before[1] + 1)
        want = fn(torch.from_numpy(a), torch.from_numpy(b), relaxed=True, **window)
        _like_relaxed_twin(mode, got, want, shape[1] * shape[2])

    launched(shape, 0, **(dict(radius=4, sigma=1.2) if mode == "batch" else {}))
    if mode != "batch":
        # Above STREAM_COMP_MIN_PIX, under the relaxed threshold: the tile body.
        launched((2, 1080, 1920), 0)
    launched((64, 40, 48) if mode == "batch" else (4, 1100, 1000), 1)
    a, b = _pair(rng, (1, 130, 700))
    wa, wb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    for window, streams in ((dict(radius=1, sigma=0.8), 1), (dict(radius=16, sigma=3.0), 0),
                            (dict(tile_h=8, tile_w=256), 0)):
        before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
        pk, mk = ssim_cuda.ssim_parts_cuda(wa, wb, with_map=True, relaxed=True, **window)
        torch.cuda.synchronize()
        assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES) == (
            before[0] + streams, before[1] + 1)
        pp, mp = ssim_cuda.ssim_parts_cuda(torch.from_numpy(a), torch.from_numpy(b),
                                           with_map=True, relaxed=True, **window)
        _hold_relaxed(pk.cpu(), mk.cpu(), pp, mp, 130 * 700)


def _relaxed_grad(at, bt, w_s, w_cs, g_map, seg=None, radius=5, sigma=1.5, **halo):
    """K3 relaxed through ssim_grad._launch (the segment pinned where seg is
    given), checking its counts: RELAXED_LAUNCHES + 1 (every relaxed launch
    streams, the relaxed tier's one design); then the
    standard K3 and the relaxed twin on the same card tensors (data range
    1). Returns (kernel, twin, standard)."""
    kw = dict(taps=gaussian_taps(np.float32, radius, sigma), c1=1e-4, c2=9e-4,
              clip_bound=131072.0, **halo)
    counts = lambda: (ssim_grad.LAUNCHES, ssim_grad.VHALO_LAUNCHES,
                      ssim_grad.RELAXED_LAUNCHES)
    before = counts()
    got = ssim_grad._launch(at, bt, w_s, w_cs, g_map, relaxed=True, segment=seg, **kw)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 1)
    std = ssim_grad._launch(at, bt, w_s, w_cs, g_map, **kw)
    want = ssim_grad.ssim_grad_plain(at, bt, w_s, w_cs, g_map, relaxed=True, **kw)
    torch.cuda.synchronize()
    return got, want, std


def _hold_relaxed_grad(got, want, std):
    """Kernel against its relaxed twin: NaN exactly where the twin's is,
    within _RELAXED_GRAD * max|g| elsewhere; different from the standard
    K3 and within 1e-3 * max|g| of it."""
    fin = [~x.isnan() for x in std]
    scale = max(x[f].abs().max().item() for x, f in zip(std, fin) if f.any())
    for k, p, s, f in zip(got, want, std, fin):
        assert torch.equal(k.isnan(), p.isnan())
        assert torch.equal(k.isnan(), s.isnan())
        if f.any():
            assert (k[f] - p[f]).abs().max().item() <= _RELAXED_GRAD * scale
            assert 0 < (k[f] - s[f]).abs().max().item() <= 1e-3 * scale


#: The relaxed stream's geometries (radius 5, NaN tiles 32 x 64): (shape,
#: segment, or None for the wrapper's): ragged strips (W = 4 x 128 + 5)
#: and segments, B > 1, segments of 1, 2 and 16 tiles, H = 2S + 1.
_RELAXED_BWD_CASES = {
    "wrapper's segment": ((2, 150, 600), None),
    "1-tile segments, ragged": ((2, 70, 517), 32),
    "16-tile segments": ((1, 1100, 600), 512),
    "2S+1": ((2, 129, 640), 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_RELAXED_BWD_CASES))
@pytest.mark.parametrize("with_g", [False, True])
def test_relaxed_backward_matches_twin_on_card(with_g, case):
    """The backward kernel's relaxed mode (every band pass split; at
    radius 5 the streaming kernel) against its twin, and within 1e-3 *
    max|g| of the standard kernel, at the stream's geometries: the public
    call at the wrapper's segment, then pinned segments."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, seg = _RELAXED_BWD_CASES[case]
    rng = np.random.default_rng(0x61 + len(case))
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    g_map = torch.from_numpy(rng.normal(0, 1e-5, shape).astype(np.float32)).cuda() \
        if with_g else None
    w_s = torch.full((shape[0],), 1.0 / a[0].size, device="cuda")
    w_cs = torch.full((shape[0],), 0.2 / a[0].size, device="cuda")
    if seg is None:
        before = (ssim_grad.LAUNCHES, ssim_grad.RELAXED_LAUNCHES)
        rk = ssim_grad.ssim_grad_cuda(at, bt, w_s, w_cs, g_map, data_range=1.0,
                                      relaxed=True)
        torch.cuda.synchronize()
        assert (ssim_grad.LAUNCHES, ssim_grad.RELAXED_LAUNCHES) == (before[0],
                                                                    before[1] + 1)
        sk = ssim_grad.ssim_grad_cuda(at, bt, w_s, w_cs, g_map, data_range=1.0)
        rp = ssim_grad.ssim_grad_plain(at, bt, w_s, w_cs, g_map, relaxed=True,
                                       **_twin_kw(1.0))
    else:
        rk, rp, sk = _relaxed_grad(at, bt, w_s, w_cs, g_map, seg)
    assert all(torch.isfinite(x).all() for x in rk)
    _hold_relaxed_grad(rk, rp, sk)


@pytest.mark.cuda
def test_relaxed_backward_nonfinite_on_boundaries_on_card():
    """The relaxed stream with non-finite pixels on a segment's first and
    last rows, 2r rows above a segment's first row, a strip's first and
    last columns and the image's last pixel, in segments of two tiles: NaN
    over exactly the twin's tiles, in their own image only."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    seg = 64
    rng = np.random.default_rng(0x65)
    a = rng.random((3, 2 * seg + 7, 600)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    a[0, seg, 200] = np.nan
    a[0, seg - 10, 40] = np.nan
    a[1, seg - 1, 127] = np.inf
    b[1, 3, 128] = -np.inf
    b[1, -1, -1] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    w_s = torch.full((3,), 1.0 / a[0].size, device="cuda")
    w_cs = torch.full((3,), 0.1 / a[0].size, device="cuda")
    rk, rp, sk = _relaxed_grad(at, bt, w_s, w_cs, None, seg)
    _hold_relaxed_grad(rk, rp, sk)
    assert rk[0][0, seg, 0].isnan() and rk[0][1].isnan().any()
    assert torch.isfinite(rk[0][2]).all() and torch.isfinite(rk[1][2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(1, 0), (0, 0), (0, 1), (1, 1)])
def test_relaxed_backward_halo_operands_on_card(flags):
    """The relaxed stream with halo operands: a band of 137 rows (segments
    of two tiles) of a 300-row image, its 2r rows above and below as a ring
    delivers them; flags top, inside, bottom and both."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0x66 + 2 * flags[0] + flags[1])
    a = rng.random((2, 300, 600)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    lo, hi = 100, 237
    band_a, band_b = at[:, lo:hi].contiguous(), bt[:, lo:hi].contiguous()
    a_top, a_bot = _halo(at, lo, hi, 10, flags)
    b_top, b_bot = _halo(bt, lo, hi, 10, flags)
    w_s = torch.full((2,), 1.0 / band_a[0].numel(), device="cuda")
    w_cs = torch.full((2,), 0.2 / band_a[0].numel(), device="cuda")
    rk, rp, sk = _relaxed_grad(band_a, band_b, w_s, w_cs, None, 64,
                               vhalo=(a_top, a_bot, b_top, b_bot), vmask=flags)
    assert all(torch.isfinite(x).all() for x in rk)
    _hold_relaxed_grad(rk, rp, sk)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [4, 16])
def test_relaxed_backward_other_radii_keep_the_tile_kernel_on_card(radius):
    """At radii other than 5, which once kept the relaxed tile kernel, a
    relaxed launch runs the runtime-radius stream (RELAXED_LAUNCHES rises
    by one, at radius 16 on the 64-column strip) and
    matches its twin."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0x67 + radius)
    a = rng.random((2, 150, 600)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    w_s = torch.full((2,), 1.0 / a[0].size, device="cuda")
    w_cs = torch.full((2,), 0.2 / a[0].size, device="cuda")
    rk, rp, sk = _relaxed_grad(at, bt, w_s, w_cs, None, radius=radius,
                               sigma={4: 1.5, 16: 3.0}[radius])
    assert all(torch.isfinite(x).all() for x in rk)
    _hold_relaxed_grad(rk, rp, sk)


def _pad_input(dtype, shape):
    rng = np.random.default_rng(0x5B)
    if dtype == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if dtype == "u16":
        return rng.integers(0, 65536, shape, dtype=np.uint16)
    x = rng.standard_normal(shape).astype(np.float32 if dtype == "f32" else np.float64)
    x[:, 0, 0] = np.nan
    x[:, -1, -1] = -0.0
    x[:, 0, -1] = np.inf
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "u16", "f32", "f64"])
@pytest.mark.parametrize("shape,hp,wp", [((2, 64, 128), 96, 384),
                                         ((3, 37, 200), 96, 512)])
def test_pad_kernel_matches_twin_on_card(dtype, shape, hp, wp):
    _need_card()
    xt = torch.from_numpy(_pad_input(dtype, shape)).cuda()
    got = pad.pad_align_cuda(xt, hp=hp, wp=wp)
    want = pad.pad_align_plain(xt, hp, wp)
    torch.cuda.synchronize()
    assert got.dtype == xt.dtype and got.shape == (shape[0], hp, wp)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_pad_align_launches_the_kernel():
    _need_card()
    xt = torch.from_numpy(_pad_input("u8", (2, 64, 128))).cuda()
    before = pad.PAD_LAUNCHES
    out = pad.pad_align(xt, 96, 384)
    torch.cuda.synchronize()
    assert pad.PAD_LAUNCHES == before + 1
    assert out.is_cuda and torch.equal(out, pad.pad_align_plain(xt, 96, 384))


_RT_SIGMA = {1: 0.8, 3: 1.2, 16: 3.0}
_RT_MODES = ("score", "map", "rowsum", "rowsum_map", "precise", "precise_map",
             "components", "pooled")


def _rt_stream(at, bt, mode, radius, tile, seg, **halo):
    """The forward kernel in `mode` at a runtime radius (the instantiation
    ssim_fwd_stream_rt.cu serves) at a pinned segment and tile, and its
    twin, on the same card tensors; the launch adds one to STREAM_LAUNCHES.
    Returns (the kernel's outputs, the twin's), as _launch and the twins
    return them."""
    dr = 1.0 if at.dtype == torch.float32 else 255.0
    precise = mode.startswith("precise")
    kw = dict(taps=gaussian_taps(np.float64 if precise else np.float32, radius,
                                 _RT_SIGMA[radius]),
              c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=tile[0], tile_w=tile[1])
    assert radius != ssim_cuda.STREAM_RADIUS
    assert ssim_cuda.stream_applies(mode, radius, tile[1])
    before = ssim_cuda.STREAM_LAUNCHES
    got = ssim_cuda._launch(at, bt, mode=mode, segment=seg, **halo, **kw)
    torch.cuda.synchronize()
    assert ssim_cuda.STREAM_LAUNCHES == before + 1
    if mode.startswith("rowsum"):
        want = ssim_cuda.ssim_rows_plain(at, bt, with_map=mode == "rowsum_map", **halo, **kw)
    elif precise:
        want = ssim_cuda.ssim_parts_precise_plain(at, bt, with_map=mode == "precise_map",
                                                  **kw)
    elif mode == "pooled":
        want = ssim_cuda.ssim_components_pooled_plain(at, bt, **kw)
    elif mode == "components":
        want = ssim_cuda.ssim_components_plain(at, bt, **kw)
    else:
        want = ssim_cuda.ssim_parts_plain(at, bt, with_map=mode == "map", **kw)
    return got, want


def _hold_rt(mode, got, want, shape):
    if mode.startswith("precise"):
        _hold_precise(got, want, shape)
    elif mode in ("components", "pooled"):
        _hold_components(got, want, shape[-2] * shape[-1])
    else:
        _hold_forward(got, want, shape, rows=mode.startswith("rowsum"))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 3, 16])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("case", ["seg+1", "2seg+1", "ragged_w", "w<=2r", "nan", "wide"])
def test_runtime_radius_stream_matches_twins_on_card(case, dtype, radius):
    """The row stream at a runtime radius (1, 3 and 16: the window's 2r + 1
    rows in a ring in shared memory) in all eight of its modes against the
    twins, at a segment of two 32-row tiles: H one past the segment and
    2S + 1, a ragged last strip, W <= 2r, W over the TPU's 16384 lanes (K2's
    widths, the same grid), and NaN and inf on a tile edge, a strip
    boundary and 2r rows above the second segment (f32; u8 has none).
    Maps and pooled images bit for bit, partials within the twin tolerance,
    precise scores within 1e-12 relative."""
    _need_card()
    tile, seg = (32, 64), 64
    bsz, h, w = {"seg+1": (2, seg + 1, 300), "2seg+1": (1, 2 * seg + 1, 260),
                 "ragged_w": (2, seg + 1, 517), "w<=2r": (2, seg + 3, 9),
                 "nan": (2, 2 * seg + 5, 300), "wide": (1, seg + 1, 16500)}[case]
    rng = np.random.default_rng(0xB0 + radius + len(case))
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, (bsz, h, w))
    if case == "nan" and dtype == "f32":
        a[0, 31, 64] = np.nan
        b[1, 40, 127] = np.inf
        a[1, seg - 2 * radius, 128] = np.nan
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    for mode in _RT_MODES:
        got, want = _rt_stream(at, bt, mode, radius, tile, seg)
        _hold_rt(mode, got, want, at.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 3, 16])
@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_runtime_radius_row_modes_with_halo_on_card(radius, flags):
    """The row modes at a runtime radius with halo operands of r rows, each
    flag pair, a band of 97 rows of a 300-row f32 image in segments of two
    tiles, NaN-filled operands under a set flag (never read)."""
    _need_card()
    rng = np.random.default_rng(0xB8 + radius)
    a, b = _float_pair(rng, (2, 300, 517))
    lo, hi = 100, 197
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    top, bot = _halo(at, lo, hi, radius, flags)
    btop, bbot = _halo(bt, lo, hi, radius, flags)
    if flags[0]:
        top = torch.full_like(top, float("nan"))
    if flags[1]:
        bbot = torch.full_like(bbot, float("nan"))
    halo = dict(vhalo=(top, bot, btop, bbot), vmask=flags)
    band_a, band_b = at[:, lo:hi].contiguous(), bt[:, lo:hi].contiguous()
    for mode in ("rowsum", "rowsum_map"):
        got, want = _rt_stream(band_a, band_b, mode, radius, (32, 64), 64, **halo)
        _hold_rt(mode, got, want, band_a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 3, 16])
def test_runtime_radius_public_calls_stream_on_card(radius):
    """compute_ssim with a custom window on the card takes the row stream
    (one STREAM_LAUNCHES a call) in the standard and precise tiers and the
    map, and agrees with the same call on the CPU (the twins) within the
    twin tolerance."""
    _need_card()
    rng = np.random.default_rng(0xBC + radius)
    a, b = _pair(rng, (2, 300, 500))
    win = dict(radius=radius, sigma=_RT_SIGMA[radius])
    for extra in (dict(), dict(precision="f64"), dict(with_map=True)):
        before = ssim_cuda.STREAM_LAUNCHES
        got = ssim_tpu_torch.compute_ssim(a, b, **win, **extra)
        torch.cuda.synchronize()
        assert ssim_cuda.STREAM_LAUNCHES == before + 1, (extra, radius)
        want = ssim_tpu_torch.compute_ssim(a, b, device="cpu", **win, **extra)
        if extra.get("with_map"):
            assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
            got, want = got[0], want[0]
        assert np.abs(np.asarray(got) - np.asarray(want)).max() <= 2e-7


#: The runtime-radius instantiations' static shared memory (ptxas, sm_90a:
#: kPooled's raw ring adds 4 KB, the precise modes stage f64 rows), the
#: runtime's 1 KB a block and an H100 SM's 228 KB; the blocks per SM the
#: registers allow (64 a thread, 128 in the precise modes).
_RT_STATIC = {"pooled": 9488, "precise": 10672, "precise_map": 10672}
_RT_STATIC_F32 = 5360
_SM_SMEM, _BLOCK_RESERVED = 233472, 1024


@pytest.mark.cuda
@pytest.mark.parametrize("mode", _RT_MODES)
def test_runtime_radius_occupancy_is_the_rings_shared_memory(mode):
    """The CUDA runtime's occupancy for the runtime-radius stream
    (ssim_cuda._stream_resident over the SMs) is what its shared memory
    allows on an H100, the ring of 2r + 1 rows of four signals (f64 in the
    precise modes) a thread beside the static arrays, under the
    registers' cap, at every radius but 5, u8 and f32: the model
    tests/test_torch_port_fwd_stream.py's H100_RT_BLOCKS follows."""
    _need_card()
    props = torch.cuda.get_device_properties(0)
    if "H100" not in props.name:
        pytest.skip(f"the model is an H100's ({props.name})")
    precise = mode.startswith("precise")
    cap = 4 if precise else 8
    static = _RT_STATIC.get(mode, _RT_STATIC_F32)
    for radius in range(1, ssim_cuda.MAX_FUSED_RADIUS + 1):
        if radius == ssim_cuda.STREAM_RADIUS:
            continue
        ring = (2 * radius + 1) * ssim_cuda.STRIP_W * 4 * (8 if precise else 4)
        want = min(cap, _SM_SMEM // (static + _BLOCK_RESERVED + ring))
        for is_float in (False, True):
            got = ssim_cuda._stream_resident(0, mode, is_float, False, radius)
            assert got == want * props.multi_processor_count, (mode, radius, is_float, got)


_RT_RELAXED_SIGMA = {1: 0.8, 4: 1.5, 8: 2.5, 9: 2.5, 12: 3.0, 13: 3.0, 16: 3.0}


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 8, 9, 16])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_relaxed_runtime_radius_stream_matches_twins_on_card(dtype, radius):
    """The relaxed tier's row stream at a runtime radius
    (ssim_fwd_stream_rt_relaxed.cu: two band k-steps at radii 1 and 8,
    three at 9 and 16) in its four modes at a pinned segment, one
    STREAM_LAUNCHES and one RELAXED_LAUNCHES a launch, against the relaxed
    twins: a ragged last strip, H one past the segment, and in f32 NaN and
    inf on a tile edge and a strip boundary of image 0 (image 1 finite).
    Partials within 2e-6, maps within 2e-5, pooled images bit for bit."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0xC0 + radius)
    a, b = (_pair if dtype == "u8" else _float_pair)(rng, (2, 65, 640))
    if dtype == "f32":
        a[0, 31, 64] = np.nan
        b[0, 40, 127] = np.inf
    dr = 1.0 if dtype == "f32" else 255.0
    kw = dict(taps=gaussian_taps(np.float32, radius, _RT_RELAXED_SIGMA[radius]),
              c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=32, tile_w=64)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    for mode in ("score", "map", "components", "pooled"):
        before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
        got = ssim_cuda._launch(at, bt, mode=mode, relaxed=True, segment=64, **kw)
        torch.cuda.synchronize()
        assert (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES) == (
            before[0] + 1, before[1] + 1), mode
        ac, bc = torch.from_numpy(a), torch.from_numpy(b)
        if mode in ("score", "map"):
            pp, mp = ssim_cuda.ssim_parts_plain(ac, bc, with_map=True, relaxed=True, **kw)
            _hold_relaxed(got[0].cpu(), None if mode == "score" else got[1].cpu(), pp,
                          None if mode == "score" else mp, 65 * 640)
        elif mode == "components":
            _like_relaxed_twin(mode, got, ssim_cuda.ssim_components_plain(
                ac, bc, relaxed=True, **kw), 65 * 640)
        else:
            want = ssim_cuda.ssim_components_pooled_plain(ac, bc, relaxed=True, **kw)
            _like_relaxed_twin("components", got[0], want[0], 65 * 640)
            for x, y in zip(got[1:], want[1:]):  # bit for bit, NaN at the same pixels
                x = x.cpu()
                assert torch.equal(x.isnan(), y.isnan())
                assert torch.equal(x.nan_to_num(), y.nan_to_num())


#: The relaxed runtime-radius forward's static shared memory (ptxas, sm_90a;
#: by band k-steps, 2 or 3: the band's fragments; kPooled's raw ring adds 4
#: KB) and the blocks per SM its registers allow (72 a thread, 80 in the
#: components modes: kStreamBlocksOf).
_RT_RELAXED_STATIC = {("score", 2): 2224, ("score", 3): 3248, ("components", 2): 2256,
                      ("components", 3): 3280, ("pooled", 2): 6352, ("pooled", 3): 7376}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["score", "components", "pooled"])
def test_relaxed_runtime_radius_occupancy_is_its_shared_memory(mode):
    """The CUDA runtime's occupancy for the relaxed runtime-radius forward
    (u8; f32's static arrays are 64 bytes larger) at every radius but 5 is
    what its shared memory allows on an H100: the staged rows, the heavy
    blurs of 4 rows and the ring of 2r + 1 float4 rows a thread
    (stream_rt_relaxed_smem_bytes) beside the static arrays, under the
    registers' cap."""
    _need_card()
    props = torch.cuda.get_device_properties(0)
    if "H100" not in props.name:
        pytest.skip(f"the model is an H100's ({props.name})")
    cap = 7 if mode == "score" else 6
    for radius in range(1, ssim_cuda.MAX_FUSED_RADIUS + 1):
        if radius == ssim_cuda.STREAM_RADIUS:
            continue
        ksteps = 2 if radius <= 8 else 3
        dyn = 8 * 4 * 160 + 4 * 2 * 4 * 128 + (2 * radius + 1) * 128 * 16
        static = _RT_RELAXED_STATIC[(mode, ksteps)]
        want = min(cap, _SM_SMEM // (static + _BLOCK_RESERVED + dyn))
        got = ssim_cuda._stream_resident(0, mode, False, True, radius)
        assert got == want * props.multi_processor_count, (mode, radius, got)


@pytest.mark.cuda
def test_relaxed_backward_occupancy_is_its_shared_memory():
    """The CUDA runtime's occupancy for the relaxed backward stream at every
    radius and its strip (ssim_grad.relaxed_strip_w), with and without
    g_map, is what its shared memory allows on an H100
    (ssim_grad.relaxed_smem_bytes, 16 bytes of static arrays), under the
    registers' cap of 2 blocks (96 registers a thread at 128 columns, up to
    160 at 64)."""
    _need_card()
    props = torch.cuda.get_device_properties(0)
    if "H100" not in props.name:
        pytest.skip(f"the model is an H100's ({props.name})")
    for radius in range(1, ssim_cuda.MAX_FUSED_RADIUS + 1):
        sw = ssim_grad.relaxed_strip_w(radius)
        smem = ssim_grad.relaxed_smem_bytes(radius, sw)
        want = min(2, _SM_SMEM // (16 + _BLOCK_RESERVED + smem))
        for gmap in (False, True):
            got = ssim_grad._resident(0, radius, gmap, True, sw)
            assert got == want * props.multi_processor_count, (radius, sw, gmap, got)


#: The standard K3 at a radius other than 5: the blocks the two-pass
#: stream's registers allow an SM (5: pass A's 82-91 registers, 4 warps a
#: block, and pass B's 72, 5 warps; it has no static shared memory, its
#: taps and fold mass are read from the kernel's parameters); the one-pass
#: stream's at STD_WINDOW_RADII (160 threads, up to 96 registers: 59-61 at
#: radius 1, 75-95 at 2-4; 16 bytes of static shared memory).
_STD_RT_CAP = 5
_STD_WINDOW_CAP = {1: 6, 2: 4, 3: 4, 4: 4}


@pytest.mark.cuda
def test_standard_runtime_radius_occupancy_is_its_shared_memory():
    """The CUDA runtime's occupancy for the standard K3 at every radius but
    5, with and without g_map, in the design the launch routes there: the
    two-pass stream's (the fewer of its two passes') is what its
    shared-memory model (ssim_grad.std_smem_bytes) allows on an H100
    beside the static arrays, under the registers' cap, and at least 2
    blocks (10 warps) at every radius; the one-pass stream's at
    STD_WINDOW_RADII likewise (ssim_grad.std_smem_bytes(r, False))."""
    _need_card()
    props = torch.cuda.get_device_properties(0)
    if "H100" not in props.name:
        pytest.skip(f"the model is an H100's ({props.name})")
    for radius in range(1, ssim_cuda.MAX_FUSED_RADIUS + 1):
        if radius == ssim_cuda.STREAM_RADIUS:
            continue
        two = ssim_grad.std_two_pass(radius)
        if two:
            want = min(_STD_RT_CAP, ssim_grad.std_blocks_per_sm(radius))
        else:
            (dyn,) = ssim_grad.std_smem_bytes(radius, False)
            want = min(_STD_WINDOW_CAP[radius], _SM_SMEM // (16 + _BLOCK_RESERVED + dyn))
        assert want >= 2
        for gmap in (False, True):
            got = ssim_grad._resident(0, radius, gmap)
            assert got == want * props.multi_processor_count, (radius, two, gmap, got)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 3, 8, 12])
def test_standard_two_pass_pinned_matches_twin_on_card(radius):
    """The two-pass stream pinned (also at radii 1 and 3, where the one-pass
    stream is routed) and at its routed radii 8 and 12: a ragged last strip
    and segment, H one past two segments, g_map, a NaN on a strip boundary
    and an inf in image 1; NaN over exactly the twin's tiles, within 1e-6 x
    max(1, max|g|), one TWO_PASS_LAUNCHES a launch."""
    _need_card()
    rng = np.random.default_rng(0x65 + radius)
    seg = ssim_grad.default_tile(radius)[0]
    a = rng.random((2, 2 * seg + 1, 300)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    a[0, seg, 128] = np.nan
    b[1, 3, 299] = np.inf
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    g = torch.from_numpy(rng.normal(0, 1, a.shape).astype(np.float32)).cuda()
    w_s = torch.tensor([0.7, -0.3], device="cuda")
    w_cs = torch.tensor([0.1, 0.25], device="cuda")
    kw = dict(taps=gaussian_taps(np.float32, radius, 0.5 + radius / 4), c1=1e-4, c2=9e-4,
              clip_bound=131072.0)
    for g_map in (None, g):
        before = ssim_grad.TWO_PASS_LAUNCHES
        da, db = ssim_grad._launch(at, bt, w_s, w_cs, g_map, segment=seg, two_pass=True, **kw)
        torch.cuda.synchronize()
        assert ssim_grad.TWO_PASS_LAUNCHES == before + 1
        pa, pb = ssim_grad.ssim_grad_plain(at, bt, w_s, w_cs, g_map, **kw)
        assert da.isnan().any() and not da.isnan().all()
        _hold_backward(da, db, pa, pb)
