"""The fused CUDA kernels (forward in its standard, precise, components,
pooled-components, batch and row modes, with and without halo operands,
and backward, with and without them; both in their relaxed modes) and the
pad kernel against their plain twins, on the card, and the launches of the
training, MS-SSIM, small-image batch and pad paths.

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,precise", [("u8", False), ("u8", True),
                                           ("f32", False), ("f32", True)])
def test_batch_modes_match_twin_on_card(dtype, precise):
    """The batch modes (kBatch, kBatchPrecise) against their twin and the
    tile modes: one partial pair per image, scores within 2e-7 (precise
    1e-12 relative), the count exact; whole images to a block (64x32x40)
    and one image's tiles split over blocks (3x300x64)."""
    _need_card()
    rng = np.random.default_rng(0x5B)
    for shape in ((64, 32, 40), (3, 300, 64)):
        if dtype == "u8":
            a, b = _pair(rng, shape)
            data_range = 255.0
        else:
            a = rng.random(shape, dtype=np.float32)
            b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
            a[1, 20, 30] = np.nan
            data_range = 1.0
        at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        counter = "BATCH_PRECISE_LAUNCHES" if precise else "BATCH_LAUNCHES"
        before = getattr(ssim_cuda, counter)
        pk = ssim_cuda.ssim_parts_batch_cuda(at, bt, data_range=data_range,
                                             precise=precise, allow_float=dtype == "f32")
        torch.cuda.synchronize()
        assert getattr(ssim_cuda, counter) == before + 1
        assert pk.shape == (shape[0], 2) and pk.is_cuda
        assert pk.dtype == (torch.float64 if precise else torch.float32)
        npix = shape[1] * shape[2]
        assert bool((pk[:, 1] == npix).all())
        pp = ssim_cuda.ssim_parts_batch_plain(at, bt, precise,
                                              **_twin_kw(data_range, precise))
        tk, _ = ssim_cuda.ssim_parts_cuda(at, bt, data_range=data_range, precise=precise,
                                          allow_float=dtype == "f32")
        gk = pk.double().sum(-1).cpu().numpy() / npix
        for want in (pp, tk):
            gw = want.double().sum(-1).cpu().numpy() / npix
            assert np.array_equal(np.isnan(gk), np.isnan(gw))
            err = np.nanmax(np.abs(gk - gw) / (np.abs(gw) if precise else 1.0), initial=0.0)
            assert err <= (1e-12 if precise else 2e-7)
        if dtype == "f32":
            assert np.isnan(gk[1]) and np.isfinite(np.delete(gk, 1)).all()


@pytest.mark.cuda
def test_small_batches_launch_the_batch_modes():
    _need_card()
    rng = np.random.default_rng(0x5C)
    a, b = _pair(rng, (64, 32, 40))
    counts = lambda: np.array([ssim_cuda.LAUNCHES, ssim_cuda.PRECISE_LAUNCHES,
                               ssim_cuda.BATCH_LAUNCHES, ssim_cuda.BATCH_PRECISE_LAUNCHES,
                               ssim_grad.LAUNCHES])
    before = counts()
    got = ssim_tpu_torch.compute_ssim(a, b)
    got64 = ssim_tpu_torch.compute_ssim(a, b, precision="f64")
    assert (counts() - before).tolist() == [0, 0, 1, 1, 0]
    want = ssim_tpu_torch.compute_ssim(a, b, device="cpu")
    assert np.abs(got - want).max() <= 2e-7 and np.abs(got64 - want).max() <= 2e-7
    x = torch.from_numpy(a.astype(np.float32) / 255).cuda().requires_grad_()
    y = torch.from_numpy(b.astype(np.float32) / 255).cuda()
    before = counts()
    ssim_tpu_torch.ssim_loss(x, y).backward()
    torch.cuda.synchronize()
    assert (counts() - before).tolist() == [0, 0, 1, 0, 1]
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


@pytest.mark.cuda
@pytest.mark.parametrize("with_g", [False, True])
def test_relaxed_backward_matches_twin_on_card(with_g):
    """The backward kernel's relaxed mode (every band pass split) against
    its twin, and within 1e-3 * max|g| of the standard kernel."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0x61)
    shape = (2, 150, 600)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    at, bt = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    g_map = torch.from_numpy(rng.normal(0, 1e-5, shape).astype(np.float32)).cuda() \
        if with_g else None
    w_s = torch.full((2,), 1.0 / a[0].size, device="cuda")
    w_cs = torch.full((2,), 0.2 / a[0].size, device="cuda")
    before = (ssim_grad.LAUNCHES, ssim_grad.RELAXED_LAUNCHES)
    rk = ssim_grad.ssim_grad_cuda(at, bt, w_s, w_cs, g_map, data_range=1.0, relaxed=True)
    torch.cuda.synchronize()
    assert (ssim_grad.LAUNCHES, ssim_grad.RELAXED_LAUNCHES) == (before[0], before[1] + 1)
    sk = ssim_grad.ssim_grad_cuda(at, bt, w_s, w_cs, g_map, data_range=1.0)
    rp = ssim_grad.ssim_grad_plain(at, bt, w_s, w_cs, g_map, relaxed=True, **_twin_kw(1.0))
    scale = max(x.abs().max().item() for x in sk)
    for k, p, s in zip(rk, rp, sk):
        assert torch.isfinite(k).all()
        assert (k - p).abs().max().item() <= _RELAXED_GRAD * scale
        assert 0 < (k - s).abs().max().item() <= 1e-3 * scale


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
