"""The port's MS-SSIM slice against the JAX package, on the same NumPy
inputs: the forward kernel's components and pooled-components wrappers
(ssim_tpu_torch.ops.ssim_cuda), and ms_ssim / compute_ms_ssim
(ssim_tpu_torch.models), forward and gradient.

On the CPU the wrappers run the kernel's plain twins and the Pallas
kernels run in interpret mode. The kernel itself only runs on a card:
tests/test_torch_port_cuda.py holds it against the twins there.

The pyramid is held against `ms_ssim(impl="xla")` and the NumPy MS-SSIM of
tests/test_msssim.py, never against the JAX Pallas pyramid: its float
pool returns NaN on ragged tiles (ROADMAP Queue 3, F1).

Tolerances: the twins' per-image [mean cs, mean ssim] against the Pallas
kernel, torch_port_util's port-against-counterpart tier (2e-7, never
tighter than 2e-5 / sqrt(npix)); the pyramid against XLA 2e-5 and against
NumPy 5e-5, and its gradient against jax.grad of the XLA pyramid 1e-7 (the
tiers of tests/test_msssim.py:112, :119 and :159). Pooled images: u8 bit
for bit; f32 bit for bit against the Pallas pool where that is finite,
within 1 ulp of the correctly rounded mean, and within 2 ulps of XLA's
reduce_window (`_downsample2`), which adds the four values in another
order: the Pallas f32 pool is 2 ulps from it too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import random_pair
from test_msssim import _numpy_msssim
from torch_port_util import JAX_GLOBAL, JAX_PIXEL, float_pair, global_tol

import ssim_tpu_torch
from ssim_tpu.errors import InvalidArgumentError as JaxInvalidArgumentError
from ssim_tpu.models.msssim import (
    MS_SSIM_WEIGHTS as JAX_WEIGHTS, _downsample2 as jax_downsample2,
    ms_ssim as jax_ms_ssim,
)
from ssim_tpu.ops.ssim_pallas import (
    ssim_components_pallas, ssim_components_pooled_pallas,
)
from ssim_tpu_torch.errors import InvalidArgumentError, UnsupportedError
from ssim_tpu_torch.models import msssim
from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
from ssim_tpu_torch.ops.ssim_cuda import (
    ssim_components_cuda, ssim_components_pooled_cuda,
)

XLA_ATOL = 2e-5
NUMPY_ATOL = 5e-5
GRAD_ATOL = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins run hundreds of small elementwise passes; with one
    intra-op thread per test worker they do not contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _batch(rng, batch, h, w):
    pairs = [random_pair(rng, h, w) for _ in range(batch)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _means(parts, npix):
    """Per-image [mean cs, mean ssim] from (..., K, 2) partials."""
    return np.asarray(parts, np.float64).sum(axis=-2) / npix


def _ulps(x, y):
    return int(np.abs(x.view(np.int32).astype(np.int64) - y.view(np.int32)).max())


COMPONENT_CASES = [
    ("u8_ragged_batch", (3, 70, 96), np.uint8, {}),
    ("f32_ragged", (41, 200), np.float32, dict(data_range=1.0)),
    ("u8_custom_window", (2, 48, 80), np.uint8, dict(sigma=2.0, k1=0.02, k2=0.05)),
    ("u8_chunked", (24, 4500), np.uint8, dict(max_tile_w=4096)),
]


@pytest.mark.parametrize("name,shape,dtype,kw", COMPONENT_CASES,
                         ids=[c[0] for c in COMPONENT_CASES])
def test_components_twin_matches_pallas(rng, name, shape, dtype, kw):
    """ssim_components_cuda's twin against ssim_components_pallas in
    interpret mode; u8_chunked pins the JAX fast path to 4096 lanes, which
    sends width 4500 to _chunked_overlap_call (K2 components)."""
    kw = dict(kw)
    jax_only = {"max_tile_w": kw.pop("max_tile_w")} if "max_tile_w" in kw else {}
    if dtype == np.uint8:
        a, b = random_pair(rng, *shape) if len(shape) == 2 else _batch(rng, *shape)
    else:
        a, b = float_pair(rng, shape)
    before = (ssim_cuda.COMPONENTS_LAUNCHES, ssim_cuda.POOLED_LAUNCHES)
    got = ssim_components_cuda(_t(a), _t(b), **kw).numpy()
    assert (ssim_cuda.COMPONENTS_LAUNCHES, ssim_cuda.POOLED_LAUNCHES) == before
    want = np.asarray(ssim_components_pallas(a, b, interpret=True, **kw, **jax_only))
    npix = shape[-1] * shape[-2]
    assert got.dtype == np.float32 and got.shape[-1] == 2
    assert got.shape[:-2] == shape[:-2]
    err = np.abs(_means(got, npix) - _means(want, npix)).max()
    assert err <= global_tol(JAX_GLOBAL, JAX_PIXEL, npix), err


@pytest.mark.parametrize("h,w,batch", [(64, 128, None), (63, 127, None),
                                       (70, 96, 3), (41, 200, None)])
def test_pooled_u8_bit_identical(rng, h, w, batch):
    """u8 pooled images equal _downsample2 and the Pallas pooled outputs
    bit for bit (the shapes of tests/test_msssim.py), and the pooled mode's
    partials equal the components mode's."""
    if batch is None:
        a, b = random_pair(rng, h, w)
    else:
        a, b = _batch(rng, batch, h, w)
    parts, pa, pb = ssim_components_pooled_cuda(_t(a), _t(b))
    assert pa.shape == a.shape[:-2] + (h // 2, w // 2) and pa.dtype == torch.float32
    assert torch.equal(parts, ssim_components_cuda(_t(a), _t(b)))
    _, ja, jb = ssim_components_pooled_pallas(a, b, interpret=True)
    for got, x, want in ((pa, a, ja), (pb, b, jb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_downsample2(jnp.asarray(x, jnp.float32))))


@pytest.mark.parametrize("shape,pallas_finite", [((64, 128), True),
                                                 ((41, 200), False)])
def test_pooled_f32(rng, shape, pallas_finite):
    """The f32 pool: bit for bit the Pallas pool where that is finite; at
    41x200 (ragged tiles) the Pallas pool is NaN (F1) and the port's is
    finite. Within 1 ulp of the correctly rounded 2x2 mean and 2 ulps of
    XLA's reduce_window."""
    a, b = float_pair(rng, shape)
    parts, pa, pb = ssim_components_pooled_cuda(_t(a), _t(b), data_range=1.0)
    _, ja, _ = ssim_components_pooled_pallas(a, b, data_range=1.0, interpret=True)
    ja = np.asarray(ja)
    assert bool(np.isfinite(ja).all()) == pallas_finite
    got = pa.numpy()
    assert np.isfinite(got).all() and np.isfinite(pb.numpy()).all()
    if pallas_finite:
        np.testing.assert_array_equal(got, ja)
    h2, w2 = shape[0] // 2, shape[1] // 2
    x = a[: 2 * h2, : 2 * w2].astype(np.float64)
    exact = ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) / 4)
    assert _ulps(got, exact.astype(np.float32)) <= 1
    assert _ulps(got, np.asarray(jax_downsample2(jnp.asarray(a)))) <= 2
    assert np.isfinite(parts.numpy()).all()


def test_pooled_nan_reaches_only_its_pixel(rng):
    a, b = float_pair(rng, (2, 40, 70))
    a[0, 13, 21] = np.nan
    parts, pa, _ = ssim_components_pooled_cuda(_t(a), _t(b), data_range=1.0)
    nan = np.argwhere(np.isnan(pa.numpy())).tolist()
    assert nan == [[0, 6, 10]]
    assert np.isnan(parts[0].numpy()).any() and np.isfinite(parts[1].numpy()).all()


PYRAMID_CASES = [
    ("u8_192x256", (192, 256), np.uint8, {}),
    ("u8_180x200", (180, 200), np.uint8, {}),
    ("u8_batch2", (2, 176, 192), np.uint8, {}),
    ("f32_unit_range", (192, 208), np.float32, dict(data_range=1.0)),
    ("u8_3_weights", (64, 64), np.uint8, dict(weights=JAX_WEIGHTS[:3])),
]


def _pyramid_inputs(rng, shape, dtype):
    if len(shape) == 3:
        a, b = _batch(rng, *shape)
    else:
        a, b = random_pair(rng, *shape)
    if dtype == np.float32:
        a, b = a.astype(np.float32) / 255.0, b.astype(np.float32) / 255.0
    return a, b


@pytest.mark.parametrize("name,shape,dtype,kw", PYRAMID_CASES,
                         ids=[c[0] for c in PYRAMID_CASES])
def test_pyramid_matches_xla_and_numpy(rng, name, shape, dtype, kw):
    a, b = _pyramid_inputs(rng, shape, dtype)
    got = ssim_tpu_torch.compute_ms_ssim(a, b, device="cpu", **kw)
    want = np.asarray(jax_ms_ssim(a, b, impl="xla", **kw))
    assert np.shape(got) == want.shape
    assert np.abs(np.asarray(got) - want).max() <= XLA_ATOL
    plain = ssim_tpu_torch.compute_ms_ssim(a, b, device="cpu", impl="torch", **kw)
    assert np.abs(np.asarray(plain) - want).max() <= XLA_ATOL
    np_kw = {k: v for k, v in kw.items() if k in ("data_range", "weights")}
    refs = [a, b] if len(shape) == 2 else [a[0], b[0]]
    got0 = got if len(shape) == 2 else got[0]
    assert abs(got0 - _numpy_msssim(*refs, **np_kw)) <= NUMPY_ATOL


def test_pyramid_custom_window_matches_xla(rng):
    a, b = random_pair(rng, 176, 192)
    kw = dict(sigma=2.0, k1=0.02, k2=0.05)
    want = float(jax_ms_ssim(a, b, impl="xla", **kw))
    for impl in ("auto", "torch"):
        got = ssim_tpu_torch.compute_ms_ssim(a, b, impl=impl, device="cpu", **kw)
        assert abs(got - want) <= XLA_ATOL
    assert abs(ssim_tpu_torch.compute_ms_ssim(a, b, device="cpu") - want) > 1e-4


def _jax_grad(a, b, wts=None):
    def loss(x):
        s = jax_ms_ssim(x, b, data_range=1.0, impl="xla")
        return 1.0 - s if wts is None else jnp.sum(s * wts)
    return np.asarray(jax.grad(loss)(a))


@pytest.mark.parametrize("batch", [None, 2])
def test_gradient_matches_jax(rng, batch):
    """jax.grad of the XLA pyramid against torch.autograd through the
    components twin and the K3 twin at every scale; the batch of 2 gives
    its images unequal weights, so each image's w_s and w_cs differ."""
    if batch is None:
        a, b = random_pair(rng, 176, 192)
    else:
        a, b = _batch(rng, batch, 176, 192)
    af, bf = a.astype(np.float32) / 255.0, b.astype(np.float32) / 255.0
    wts = None if batch is None else np.array([0.7, -1.3], np.float32)
    x = _t(af).requires_grad_()
    s = ssim_tpu_torch.ms_ssim(x, _t(bf), data_range=1.0)
    loss = 1.0 - s if wts is None else (s * _t(wts)).sum()
    (got,) = torch.autograd.grad(loss, x)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(got.numpy() - _jax_grad(af, bf, wts)).max() <= GRAD_ATOL


def _spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        log.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def _spy_all(monkeypatch):
    log = []
    for name in ("ssim_components_cuda", "ssim_components_pooled_cuda",
                 "ssim_parts_cuda"):
        _spy(monkeypatch, ssim_cuda, name, log)
    _spy(monkeypatch, ssim_grad, "ssim_grad_cuda", log)
    return log


def test_routing_u8_pooled_then_components(rng, monkeypatch):
    log = _spy_all(monkeypatch)
    a, b = random_pair(rng, 176, 192)
    ssim_tpu_torch.compute_ms_ssim(a, b, device="cpu")
    assert log == ["ssim_components_pooled_cuda"] * 4 + ["ssim_components_cuda"]


def test_routing_f32_components_and_backward(rng, monkeypatch):
    log = _spy_all(monkeypatch)
    a, b = float_pair(rng, (176, 192))
    x = _t(a).requires_grad_()
    s = ssim_tpu_torch.ms_ssim(x, _t(b), data_range=1.0)
    assert log == ["ssim_components_cuda"] * 5
    (1.0 - s).backward()
    assert log[5:] == ["ssim_grad_cuda"] * 5
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("kind", ["bf16", "mixed", "impl_torch"])
def test_routing_plain_pyramid(rng, monkeypatch, kind):
    """bf16, mixed dtypes and impl="torch" take the plain pyramid, as the
    JAX package sends them to its XLA pyramid."""
    log = _spy_all(monkeypatch)
    a, b = random_pair(rng, 176, 192)
    ta, tb = _t(a), _t(b)
    kw = {}
    if kind == "bf16":
        ta, tb = ta.to(torch.bfloat16), tb.to(torch.bfloat16)
    elif kind == "mixed":
        tb = tb.to(torch.float32)
    else:
        kw = dict(impl="torch")
    got = ssim_tpu_torch.ms_ssim(ta, tb, **kw)
    assert log == []
    assert got.dtype == torch.float32 and got.dim() == 0
    want = float(jax_ms_ssim(a, b.astype(np.float32) if kind == "mixed" else b,
                             impl="xla"))
    assert abs(got.item() - want) <= XLA_ATOL


def test_validation_errors_match_jax():
    small = np.zeros((64, 64), np.uint8)
    with pytest.raises(ValueError, match="too small for 5 scales"):
        jax_ms_ssim(small, small)
    with pytest.raises(ValueError, match="too small for 5 scales"):
        ssim_tpu_torch.ms_ssim(small, small, device="cpu")
    a = np.zeros((176, 192), np.uint8)
    with pytest.raises(JaxInvalidArgumentError):
        jax_ms_ssim(a, a[:, :190])
    with pytest.raises(InvalidArgumentError):
        ssim_tpu_torch.ms_ssim(a, a[:, :190], device="cpu")
    with pytest.raises(JaxInvalidArgumentError):
        jax_ms_ssim(a, a, accuracy="fast")
    with pytest.raises(InvalidArgumentError):
        ssim_tpu_torch.ms_ssim(a, a, accuracy="fast", device="cpu")
    relaxed = ssim_tpu_torch.compute_ms_ssim(a, a, accuracy="relaxed", device="cpu")
    assert relaxed == ssim_tpu_torch.compute_ms_ssim(a, a, device="cpu")


def test_nan_in_image_0_leaves_image_1(rng):
    a, b = float_pair(rng, (2, 176, 192))
    a[0, 50, 60] = np.nan
    got = ssim_tpu_torch.compute_ms_ssim(a, b, data_range=1.0, device="cpu")
    alone = ssim_tpu_torch.compute_ms_ssim(a[1], b[1], data_range=1.0, device="cpu")
    assert np.isnan(got[0]) and got[1] == np.float32(alone)


def test_numpy_input_needs_a_device_without_gpu(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = random_pair(rng, 176, 192)
    with pytest.raises(UnsupportedError):
        ssim_tpu_torch.compute_ms_ssim(a, b)
    s = ssim_tpu_torch.ms_ssim(a, b, device="cpu")
    assert s.device.type == "cpu"
    assert s.item() == ssim_tpu_torch.ms_ssim(_t(a), _t(b)).item()


def test_weights_equal_jax():
    assert ssim_tpu_torch.MS_SSIM_WEIGHTS == JAX_WEIGHTS
    assert msssim.MS_SSIM_WEIGHTS is ssim_tpu_torch.MS_SSIM_WEIGHTS


def test_components_argument_guards():
    u8 = torch.zeros((8, 8), dtype=torch.uint8)
    for args, kw in [
        ((u8, u8.to(torch.float32)), {}),
        ((u8.to(torch.int16), u8.to(torch.int16)), {}),
        ((u8, u8), dict(radius=17)),
        ((u8, torch.zeros((8, 9), dtype=torch.uint8)), {}),
        ((torch.zeros((16, 8), dtype=torch.uint8)[::2], u8), {}),
    ]:
        for fn in (ssim_components_cuda, ssim_components_pooled_cuda):
            with pytest.raises(ValueError):
                fn(*args, **kw)
    one_row = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ssim_components_pooled_cuda(one_row, one_row)
    assert ssim_components_cuda(one_row, one_row).shape == (1, 2)
