"""The port's training slice against the JAX package, on the same NumPy
inputs: the fused backward kernel's wrapper (ssim_tpu_torch.ops.ssim_grad)
and the differentiable tensor functions ssim / ssim_and_map / ssim_loss.

On the CPU the wrapper runs the kernel's plain twin and the Pallas kernel
runs in interpret mode, as tests/test_grad.py runs it. The kernel itself
only runs on a card: tests/test_torch_port_cuda.py holds it against the
twin there.

Tolerances are the JAX package's own kernel-against-autodiff ones
(tests/test_grad.py): 2e-5 for the backward kernel, times max(1, max|g|)
for a custom window or data range (gradients grow as the window narrows);
2e-6 for the gradient of the loss and the score, 2e-5 with a map
cotangent; 2e-7 for forward scores (torch_port_util.JAX_GLOBAL); central
finite differences of the f64 oracle within rel 2e-3, abs 1e-5.

At radius 1 the window holds 9 pixels and the f32 cancellation in sigma
grows (torch_port_util's note): against an f64 autograd gradient the
Pallas kernel in interpret mode was up to 3.4e-5 * max|g| off, the twin
1.4e-5 * max|g| (33x47 pairs, sigma 0.8), so twin against Pallas is held
to 5e-5 * max|g| there, the factor torch_port_util.JAX_PIXEL_RADIUS1
gives the forward, and the twin against autograd to 2e-5 * max|g|. Over
25 fresh draws of that case the Pallas kernel was up to 8.1e-5 * max|g|
off (2 draws past 5e-5), the twin up to 4.1e-5 (ROADMAP F6), so the file
draws from its own generator (`rng` below), not from conftest's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import JAX_GLOBAL, JAX_PIXEL, float_pair

import ssim_tpu
import ssim_tpu_torch
from ssim_tpu.ops.ssim_grad import grad_pallas_supported, ssim_grad_pallas
from ssim_tpu_torch import reference
from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
from ssim_tpu_torch.ops.ssim_grad import grad_cuda_supported, ssim_grad_cuda
from ssim_tpu_torch.ops.ssim_torch import _pad_edge, blur_separable, ssim_parts_torch
from ssim_tpu_torch.windows import gaussian_taps

KERNEL_ATOL = 2e-5
KERNEL_ATOL_RADIUS1 = 5e-5
LOSS_ATOL = 2e-6


@pytest.fixture(scope="module")
def rng():
    """The file's own generator, seeded as tests/conftest.py's `rng`: its
    draws are those of the file run alone, whichever files ran before it
    on an xdist worker and drew from that shared one (ROADMAP F6)."""
    return np.random.default_rng(0x55)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twin runs hundreds of small elementwise passes; with one
    intra-op thread per test worker they do not contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _port_grad(a, b, ws, wcs, g=None, **kw):
    da, db = ssim_grad_cuda(_t(a), _t(b), _t(np.asarray(ws, np.float32)),
                            _t(np.asarray(wcs, np.float32)), _t(g), **kw)
    return da.numpy(), db.numpy()


def _close(got, want, atol):
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert err <= atol, (err, atol)


# One Pallas interpret-mode call per case (7 in all): modes w_s, w_cs,
# g_map and per-image weights at radius 5; radius 1, 8 and 16 with custom
# sigma (and k1/k2), one of them at data_range 255.
KERNEL_CASES = [
    ("w_s", (48, 64), 1.0, 0.0, False, {}),
    ("w_cs", (33, 47), 0.7, 0.25, False, {}),
    ("g_map", (40, 517), 0.37, 0.0, True, {}),
    ("per_image", (2, 48, 64), [0.7, -0.3], [0.1, 0.25], True, {}),
    ("radius1", (33, 47), 1.0, 0.0, False,
     dict(radius=1, sigma=0.8, k1=0.02, k2=0.05)),
    ("radius8_u8_range", (48, 64), 1.0, 0.25, True,
     dict(radius=8, sigma=2.5, data_range=255.0)),
    ("radius16", (48, 64), 1.0, 0.0, False, dict(radius=16, sigma=4.0)),
]


@pytest.mark.parametrize("name,shape,ws,wcs,with_g,kw", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_twin_matches_pallas(rng, name, shape, ws, wcs, with_g, kw):
    kw = dict(kw)
    data_range = kw.setdefault("data_range", 1.0)
    a, b = float_pair(rng, shape, data_range)
    g = rng.normal(0, 1, shape).astype(np.float32) if with_g else None
    before = ssim_grad.LAUNCHES
    got = _port_grad(a, b, ws, wcs, g, **kw)
    assert ssim_grad.LAUNCHES == before  # CPU tensors take the twin
    want = ssim_grad_pallas(a, b, np.asarray(ws, np.float32), wcs,
                            None if g is None else jnp.asarray(g),
                            interpret=True, **kw)
    want = [np.asarray(x) for x in want]
    assert got[0].shape == got[1].shape == shape
    assert got[0].dtype == np.float32
    custom = kw.keys() != {"data_range"} or data_range != 1.0
    scale = max(1.0, float(np.abs(want[0]).max())) if custom else 1.0
    atol = KERNEL_ATOL_RADIUS1 if kw.get("radius") == 1 else KERNEL_ATOL
    _close(got, want, atol * scale)


def _autograd_loss(a, b, ws, wcs, g, radius=5, sigma=1.5, data_range=1.0,
                   k1=0.01, k2=0.03):
    """sum (w_s + g) * SSIM + w_cs * sum cs per image, through autograd of
    the port's plain path (a formulation independent of the twin)."""
    at = _t(a).requires_grad_()
    bt = _t(b).requires_grad_()
    _, m = ssim_parts_torch(at, bt, with_map=True, radius=radius, sigma=sigma,
                            data_range=data_range, k1=k1, k2=k2)
    taps = gaussian_taps(np.float32, radius, sigma)
    ap, bp = _pad_edge(at, radius), _pad_edge(bt, radius)
    mu_a, mu_b = blur_separable(ap, taps, radius), blur_separable(bp, taps, radius)
    var = (blur_separable(ap * ap, taps, radius) - mu_a * mu_a
           + blur_separable(bp * bp, taps, radius) - mu_b * mu_b)
    cov = blur_separable(ap * bp, taps, radius) - mu_a * mu_b
    c2 = (k2 * data_range) ** 2
    cs = (2.0 * cov + c2) / (var + c2)
    lead = (slice(None),) + (None,) * 2 if m.dim() == 3 else ()
    ws_t = torch.as_tensor(np.asarray(ws, np.float32))[lead]
    wcs_t = torch.as_tensor(np.asarray(wcs, np.float32))[lead]
    coeff = ws_t if g is None else ws_t + _t(g)
    loss = (coeff * m).sum() + (wcs_t * cs).sum()
    return [x.numpy() for x in torch.autograd.grad(loss, (at, bt))]


@pytest.mark.parametrize(
    "shape,ws,wcs,with_g,kw",
    [
        ((48, 64), 1.0, 0.0, False, {}),
        ((33, 47), 0.7, 0.25, True, {}),
        ((2, 40, 517), [0.7, -0.3], [0.1, 0.25], True, {}),
        ((7, 9), 1.0, 0.3, True, {}),
        ((33, 47), 1.0, 0.0, False, dict(radius=16, sigma=4.0)),
        ((33, 47), 1.0, 0.25, False, dict(radius=1, sigma=0.8, k1=0.02, k2=0.05)),
    ],
)
def test_twin_matches_autograd(rng, shape, ws, wcs, with_g, kw):
    a, b = float_pair(rng, shape)
    g = rng.normal(0, 1, shape).astype(np.float32) if with_g else None
    got = _port_grad(a, b, ws, wcs, g, data_range=1.0, **kw)
    want = _autograd_loss(a, b, ws, wcs, g, **kw)
    scale = max(1.0, float(np.abs(want[0]).max())) if kw else 1.0
    _close(got, want, KERNEL_ATOL * scale)


def test_twin_finite_difference_spotcheck(rng):
    """Central differences of the port's f64 oracle at edge and corner
    pixels, where the clamp fold of the adjoint lands."""
    h, w = 24, 32
    a, b = float_pair(rng, (h, w))
    da, _ = _port_grad(a, b, 1.0, 0.0, data_range=1.0)
    eps = 1e-4
    for y, x in [(0, 0), (0, 31), (23, 0), (23, 31), (12, 16), (5, 30)]:
        ap = a.astype(np.float64)
        am = ap.copy()
        ap[y, x] += eps
        am[y, x] -= eps
        sp, _ = reference.compute_ssim(ap, b.astype(np.float64), data_range=1.0)
        sm, _ = reference.compute_ssim(am, b.astype(np.float64), data_range=1.0)
        fd = (sp - sm) / (2 * eps) * (h * w)  # the oracle returns the mean
        assert da[y, x] == pytest.approx(fd, rel=2e-3, abs=1e-5)


def _jax_grads(fn, a, b):
    return [np.asarray(x) for x in jax.grad(fn, argnums=(0, 1))(a, b)]


def _torch_grads(fn, a, b):
    at, bt = _t(a).requires_grad_(), _t(b).requires_grad_()
    out = fn(at, bt)
    return out, [x.numpy() for x in torch.autograd.grad(out, (at, bt))]


def test_ssim_loss_grad_matches_jax(rng):
    a, b = float_pair(rng, (2, 37, 53))
    loss, got = _torch_grads(ssim_tpu_torch.ssim_loss, a, b)
    want = _jax_grads(lambda x, y: ssim_tpu.ssim_loss(x, y, impl="xla"), a, b)
    _close(got, want, LOSS_ATOL)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(ssim_tpu.ssim_loss(a, b, impl="xla"))) <= JAX_GLOBAL


def test_ssim_grad_matches_jax(rng):
    """Per-image score cotangents on a u8-range batch."""
    a, b = float_pair(rng, (2, 40, 56), 255.0)
    wts = np.array([0.3, -0.7], np.float32)
    score, got = _torch_grads(
        lambda x, y: (ssim_tpu_torch.ssim(x, y) * _t(wts)).sum(), a, b)
    want = _jax_grads(
        lambda x, y: jnp.sum(ssim_tpu.ssim(x, y, impl="xla") * wts), a, b)
    _close(got, want, LOSS_ATOL)
    s = ssim_tpu_torch.ssim(_t(a), _t(b))
    assert s.shape == (2,) and s.dtype == torch.float32
    assert np.abs(s.numpy() - np.asarray(ssim_tpu.ssim(a, b, impl="xla"))).max() <= JAX_GLOBAL


def test_ssim_and_map_grad_matches_jax(rng):
    a, b = float_pair(rng, (39, 57))

    def port(x, y):
        score, m = ssim_tpu_torch.ssim_and_map(x, y, data_range=1.0)
        return score + (m * m).sum()

    def jx(x, y):
        score, m = ssim_tpu.ssim_and_map(x, y, data_range=1.0, impl="xla")
        return score + jnp.sum(m * m)

    _, got = _torch_grads(port, a, b)
    _close(got, _jax_grads(jx, a, b), KERNEL_ATOL)
    s, m = ssim_tpu_torch.ssim_and_map(_t(a), _t(b), data_range=1.0)
    sj, mj = ssim_tpu.ssim_and_map(a, b, data_range=1.0, impl="xla")
    assert abs(s.item() - float(sj)) <= JAX_GLOBAL
    assert np.abs(m.detach().numpy() - np.asarray(mj)).max() <= JAX_PIXEL


def test_device_finalize_is_the_f64_mean(rng):
    a, b = float_pair(rng, (3, 45, 61))
    s = ssim_tpu_torch.ssim(_t(a), _t(b), data_range=1.0)
    want = ssim_tpu_torch.compute_ssim(a, b, data_range=1.0, device="cpu")
    np.testing.assert_array_equal(s.numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize(
    "dtype,shape,kernel",
    [
        (torch.float32, (2, 30, 41), True),
        (torch.float64, (2, 30, 41), False),
        (torch.float32, (30, 4), False),  # w <= radius: no fused backward
    ],
)
def test_backward_routing(rng, monkeypatch, dtype, shape, kernel):
    """f32 pairs the kernel takes go through ssim_grad_cuda; f64 and images
    no wider than the radius through autograd of the plain path. Either
    way the gradient is that of impl="torch" (held against JAX above)."""
    calls = []
    real = ssim_grad.ssim_grad_cuda

    def spy(*args, **kwargs):
        calls.append(kwargs.get("data_range"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ssim_grad, "ssim_grad_cuda", spy)
    a, b = float_pair(rng, shape)
    x = _t(a).to(dtype).requires_grad_()
    ssim_tpu_torch.ssim_loss(x, _t(b).to(dtype)).backward()
    assert calls == ([1.0] if kernel else [])
    assert x.grad.dtype == dtype
    y = _t(a).requires_grad_()
    ssim_tpu_torch.ssim_loss(y, _t(b), impl="torch").backward()
    assert np.abs(x.grad.numpy() - y.grad.numpy()).max() <= LOSS_ATOL


def test_plain_impl_and_uint8(rng):
    """impl="torch" differentiates the plain path; uint8 takes the forward
    kernel and carries no gradient."""
    a, b = float_pair(rng, (33, 47))
    x = _t(a).requires_grad_()
    ssim_tpu_torch.ssim_loss(x, _t(b), impl="torch").backward()
    want = jax.grad(lambda t: ssim_tpu.ssim_loss(t, b, impl="xla"))(a)
    assert np.abs(x.grad.numpy() - np.asarray(want)).max() <= LOSS_ATOL
    au, bu = (np.round(v * 255).astype(np.uint8) for v in (a, b))
    s = ssim_tpu_torch.ssim(_t(au), _t(bu))
    assert not s.requires_grad
    assert abs(s.item() - ssim_tpu_torch.compute_ssim(au, bu, device="cpu")) <= JAX_GLOBAL


@pytest.mark.parametrize("bad_value", [np.nan, np.inf])
def test_nonfinite_pixel_poisons_only_its_image(rng, bad_value):
    """The tiles within 2r of a non-finite pixel get NaN gradients (every
    gradient that depends on it); image 1 equals image 1 alone."""
    a, b = float_pair(rng, (2, 96, 200))
    a[0, 40, 100] = bad_value
    da, db = _port_grad(a, b, 1.0, 0.25, data_range=1.0)
    # Rows 30-50 and columns 90-110 lie within 2r = 10 of the pixel: the
    # 32x64 tiles at rows 0-63, columns 64-127.
    for g in (da, db):
        assert np.isnan(g[0, :64, 64:128]).all()
        assert np.isfinite(g[0, :, :64]).all() and np.isfinite(g[0, :, 128:]).all()
        assert np.isfinite(g[0, 64:]).all() and np.isfinite(g[1]).all()
    alone = _port_grad(a[1], b[1], 1.0, 0.25, data_range=1.0)
    np.testing.assert_array_equal(da[1], alone[0])
    np.testing.assert_array_equal(db[1], alone[1])


@pytest.mark.parametrize("h,w,radius", [(64, 8000, 5), (64, 4, 5), (64, 5, 5),
                                        (1, 6, 5), (64, 256, 16), (64, 256, 17)])
def test_supported_shapes_match_jax(h, w, radius):
    assert grad_cuda_supported(h, w, radius) == grad_pallas_supported(h, w, radius)


def test_argument_guards():
    f32 = torch.zeros((8, 64), dtype=torch.float32)
    cases = [
        ((f32.double(), f32.double(), 1.0, 0.0), {}),
        ((f32.to(torch.uint8), f32.to(torch.uint8), 1.0, 0.0), {}),
        ((f32, torch.zeros((8, 63)), 1.0, 0.0), {}),
        ((f32, f32, 1.0, 0.0, torch.zeros((8, 63))), {}),
        ((f32, f32, 1.0, 0.0, f32.double()), {}),
        ((f32, f32, 1.0, 0.0), dict(radius=17)),
        ((f32[:, :4], f32[:, :4], 1.0, 0.0), {}),
        ((f32, f32, torch.ones(3), 0.0), {}),
        ((f32, f32, 1.0, 0.0), dict(data_range=1.0, k1=1e-9, k2=1e-9)),
        ((torch.zeros((16, 64))[::2], f32, 1.0, 0.0), {}),
    ]
    for args, kw in cases:
        with pytest.raises(ValueError):
            ssim_grad_cuda(*args, **kw)


@pytest.mark.parametrize("radius", [1, 5, 15, 16])
def test_default_tile_fits_shared_memory(radius):
    """The NaN tile per radius, 32x64 up to radius 15 and 16x64 at radius
    16, and the relaxed stream's block at that radius and its strip fits a
    block's shared memory (radius 5: the ~108 KB of its two blocks an SM)."""
    tile_h, tile_w = ssim_grad.default_tile(radius)
    assert (tile_h, tile_w) == ((16, 64) if radius == 16 else (32, 64))
    smem = ssim_grad.relaxed_smem_bytes(radius, ssim_grad.relaxed_strip_w(radius))
    assert smem <= ssim_cuda._MAX_DYNAMIC_SMEM
    if radius == 5:
        assert smem == 110080


@pytest.mark.parametrize("radius", [1, 5, 16])
def test_stream_blocks_hold_whole_nan_tiles(radius):
    """The standard kernel's blocks (a strip of STRIP_W columns down a
    segment of rows, the segment stream_segment's choice for the shape on a
    card that holds 132 or 528 blocks at once) cover every image pixel
    exactly once, and every default_tile(radius) NaN tile lies in one block,
    so a block alone decides its tiles' NaN."""
    tile_h, tile_w = ssim_grad.default_tile(radius)
    assert ssim_grad.STRIP_W == 2 * tile_w  # the kernel's 2-column tile mask
    shapes = [(1, 1, radius + 1), (2, 7, 9 + radius), (4, 67, 120), (3, 257, 300),
              (2, 1080, 1920), (256, 64, 64), (1, 4097, 200), (1, 33, 8000)]
    for resident in (132, 528):
        for bsz, h, w in shapes:
            seg = ssim_grad.stream_segment(bsz, h, w, radius, resident)
            assert seg % tile_h == 0
            assert tile_h <= seg <= ssim_grad.MAX_SEG_TILES * tile_h
            blocks = ssim_grad.stream_blocks(h, w, seg)
            assert len(blocks) == -(-h // seg) * -(-w // ssim_grad.STRIP_W)
            owner = np.full((h, w), -1, np.int32)
            cover = np.zeros((h, w), np.int32)
            for i, (y0, y1, x0, x1) in enumerate(blocks):
                assert y1 - y0 <= seg and x1 - x0 <= ssim_grad.STRIP_W
                owner[y0:y1, x0:x1] = i
                cover[y0:y1, x0:x1] += 1
            assert (cover == 1).all(), (bsz, h, w, seg)
            tiles = owner[::tile_h, ::tile_w]
            for ty in range(0, h, tile_h):
                for tx in range(0, w, tile_w):
                    assert (owner[ty:ty + tile_h, tx:tx + tile_w]
                            == tiles[ty // tile_h, tx // tile_w]).all()


@pytest.mark.parametrize("radius", [1, 5, 16])
def test_stream_segment_fills_the_card(radius):
    """Where the shortest segment (one NaN tile) gives no more blocks than
    the card holds at once, stream_segment takes it; no segment reaches a
    whole tile past the image's last row."""
    tile_h, _ = ssim_grad.default_tile(radius)
    for resident in (132, 396, 528):
        for bsz, h, w in [(1, 1, radius + 1), (4, 135, 240), (4, 270, 480),
                          (4, 540, 960), (4, 1080, 1920), (4, 2160, 3840),
                          (1, 8640, 15360), (256, 64, 64)]:
            seg = ssim_grad.stream_segment(bsz, h, w, radius, resident)
            assert seg < h + tile_h
            if bsz * -(-h // tile_h) * -(-w // ssim_grad.STRIP_W) <= resident:
                assert seg == tile_h, (bsz, h, w, resident, seg)
