"""The relaxed accuracy tier (accuracy="relaxed") of ssim_tpu_torch against
the JAX package and the f64 oracle, on the same NumPy inputs.

On the CPU every wrapper runs its kernel's plain twin, whose heavy blurs
are `band_bf16x3_plain`: band products with both operands split into bf16
parts, x1 h1 + (x1 h2 + x2 h1) in f32, as the JAX relaxed tier's MXU dots.
The kernels themselves run only on a card (tests/test_torch_port_cuda.py).

Tolerances:

- the split blur against JAX's `_make_hpass_mxu(exact=False)`: 1e-6 of
  max|out| (both add the same three exact bf16 products in f32, in other
  orders; measured 1.8e-7);
- the tier against the f64 oracle: 1e-4 global and 5e-3 per interior map
  pixel, the JAX tests' envelope (tests/test_pallas.py:361-373,
  tests/test_api.py:541-562, tests/test_bpacked.py:136-150); against
  JAX's relaxed `compute_ssim`, 1e-4, as test_accuracy_relaxed_api holds
  it against the standard tier;
- the relaxed gradient within 1e-3 x max|g| of the standard one
  (tests/test_grad.py:335-379); JAX's own relaxed backward is not the
  yardstick here, as its interpret mode evaluates the bf16 dots loosely;
- MS-SSIM within 1e-4 of JAX's plain pyramid (tests/test_msssim.py:194-220).

Inputs come from a generator seeded in each test.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_pair
from torch_port_util import float_pair

import ssim_tpu_torch
from ssim_tpu import compute_ssim as jax_compute_ssim
from ssim_tpu import reference
from ssim_tpu.api import ssim_loss as jax_ssim_loss
from ssim_tpu.models.msssim import ms_ssim as jax_ms_ssim
from ssim_tpu.ops import ssim_pallas as jax_pallas
from ssim_tpu_torch.errors import InvalidArgumentError
from ssim_tpu_torch.ops import _build, routing, ssim_cuda, ssim_grad
from ssim_tpu_torch.windows import gaussian_taps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins run many small passes; one intra-op thread per worker."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("w,radius,sigma", [(640, 5, 1.5), (1000, 5, 1.5),
                                            (640, 16, 3.0), (1000, 3, 1.0)])
def test_split_blur_matches_jax(w, radius, sigma):
    """band_bf16x3_plain against the JAX relaxed lane mode's blur (plain
    jnp on CPU XLA, no Pallas) on (a+b)^2 of independent u8 images, the
    same clamped band; 1000 leaves a ragged 128-lane chunk."""
    rng = np.random.default_rng(0x8A + w + radius)
    a = rng.integers(0, 256, (24, w)).astype(np.float32)
    b = rng.integers(0, 256, (24, w)).astype(np.float32)
    x = np.pad((a + b) ** 2, ((0, 0), (radius, radius)), mode="edge")
    taps = gaussian_taps(np.float32, radius, sigma)
    band = np.pad(x, ((0, 0), (0, -(-w // 128) * 128 - w)))
    want = np.asarray(jax_pallas._make_hpass_mxu(w, radius, exact=False)(
        jnp.asarray(band), jnp.asarray(jax_pallas.hpass_tap_matrix(taps))))
    got = ssim_cuda.band_bf16x3_plain(
        torch.from_numpy(x), [float(t) for t in taps], w).numpy()
    assert got.shape == want.shape == (24, w)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    # The tier acted: the split is not the exact f32 blur.
    exact = ssim_cuda.sym_blur(torch.from_numpy(x), [float(t) for t in taps], -1, w)
    assert not np.array_equal(got, exact.numpy())


def test_split_blur_along_rows_is_the_transpose():
    """dim=-2 (the backward's vertical passes) equals the column pass on
    the transposed plane."""
    rng = np.random.default_rng(0x8B)
    x = torch.from_numpy(rng.random((3, 90, 20)).astype(np.float32))
    t = [float(v) for v in gaussian_taps(np.float32, 5, 1.5)]
    got = ssim_cuda.band_bf16x3_plain(x, t, 80, dim=-2)
    want = ssim_cuda.band_bf16x3_plain(x.transpose(-1, -2), t, 80).transpose(-1, -2)
    assert torch.equal(got, want)


def _u8(rng, shape):
    if len(shape) == 2:
        return random_pair(rng, *shape)
    pairs = [random_pair(rng, *shape[1:]) for _ in range(shape[0])]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.mark.parametrize("kind,shape", [("u8", (37, 617)), ("u8", (2, 47, 613)),
                                        ("f32", (37, 617))])
def test_compute_ssim_relaxed_against_oracle(kind, shape):
    """The JAX envelope against the f64 oracle, and the tier acted: the
    map is not the standard tier's."""
    rng = np.random.default_rng(0x8C)
    if kind == "u8":
        a, b, data_range = *_u8(rng, shape), 255.0
    else:
        a, b = float_pair(rng, shape)
        data_range = 1.0
    g, m = ssim_tpu_torch.compute_ssim(a, b, with_map=True, device="cpu",
                                       accuracy="relaxed", data_range=data_range)
    g0, m0 = ssim_tpu_torch.compute_ssim(a, b, with_map=True, device="cpu",
                                         data_range=data_range)
    want, want_map = reference.compute_ssim(a, b, with_map=True,
                                            data_range=data_range)
    assert np.abs(np.asarray(g) - np.asarray(want)).max() < 1e-4
    inner = (Ellipsis, slice(5, -5), slice(5, -5))
    assert np.abs(m[inner] - want_map[inner]).max() < 5e-3
    assert not np.array_equal(m, m0)


def test_compute_ssim_relaxed_matches_jax():
    """JAX's relaxed compute_ssim (the Pallas kernel in interpret mode) at
    the shape of its own test_accuracy_relaxed_api."""
    rng = np.random.default_rng(0x8D)
    a = rng.integers(0, 256, (37, 617), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-9, 9, a.shape), 0,
                255).astype(np.uint8)
    want = jax_compute_ssim(a, b, accuracy="relaxed")
    got = ssim_tpu_torch.compute_ssim(a, b, device="cpu", accuracy="relaxed")
    assert got == pytest.approx(want, abs=1e-4)


def test_relaxed_below_mxu_min_w_is_standard():
    """Below MXU_MIN_W the relaxed tier is a strict no-op: the score, the
    map and the gradient equal the standard tier's bit for bit."""
    rng = np.random.default_rng(0x8E)
    a, b = random_pair(rng, 33, 320)
    assert a.shape[-1] < ssim_cuda.MXU_MIN_W
    g0, m0 = ssim_tpu_torch.compute_ssim(a, b, with_map=True, device="cpu")
    g1, m1 = ssim_tpu_torch.compute_ssim(a, b, with_map=True, device="cpu",
                                         accuracy="relaxed")
    assert g0 == g1
    np.testing.assert_array_equal(m0, m1)

    fa, fb = float_pair(rng, (40, 200))
    grads = []
    for accuracy in ("standard", "relaxed"):
        x = torch.from_numpy(fa).requires_grad_()
        ssim_tpu_torch.ssim_loss(x, torch.from_numpy(fb), device="cpu",
                                 accuracy=accuracy).backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


def test_relaxed_applies_gate():
    assert not ssim_cuda.relaxed_applies(False, 4096)
    assert not ssim_cuda.relaxed_applies(True, ssim_cuda.MXU_MIN_W - 1)
    assert ssim_cuda.relaxed_applies(True, ssim_cuda.MXU_MIN_W)
    assert ssim_cuda.relaxed_applies(True, 64, batch=True)


def test_batch_route_relaxed():
    """Independent random images, the tier's adversarial content
    (tests/test_bpacked.py:136-150), on the batch route: each image within
    1e-4 of the oracle, and the tier acted."""
    rng = np.random.default_rng(0x8F)
    a = rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
    b = rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    parts, _ = routing.ssim_parts_auto(at, bt, relaxed=True)
    assert parts.shape == (3, 2)  # the batch route's per-image pairs
    std, _ = routing.ssim_parts_auto(at, bt)
    assert not torch.equal(parts, std)
    got = ssim_tpu_torch.compute_ssim(a, b, device="cpu", accuracy="relaxed")
    for i in range(3):
        want, _ = reference.compute_ssim(a[i], b[i])
        assert abs(float(got[i]) - want) < 1e-4
    # The batch mode is relaxed at every width, where the tile grid's gate
    # (W >= MXU_MIN_W) is not: its twin runs the tile twin's relaxed pixels.
    tile, _ = ssim_cuda.ssim_parts_plain(
        at, bt, with_map=False, relaxed=True, taps=gaussian_taps(np.float32, 5, 1.5),
        c1=(0.01 * 255) ** 2, c2=(0.03 * 255) ** 2, clip_bound=131072.0)
    np.testing.assert_allclose(parts[:, 0].double().numpy() + 64 * 64,
                               tile.double().sum(-1).numpy(), rtol=0, atol=1e-3)


def test_relaxed_conflicts_raise():
    rng = np.random.default_rng(0x90)
    a, b = random_pair(rng, 20, 600)
    with pytest.raises(InvalidArgumentError):
        ssim_tpu_torch.compute_ssim(a, b, device="cpu", accuracy="relaxed",
                                    precision="f64")
    with pytest.raises(InvalidArgumentError):
        ssim_tpu_torch.compute_ssim(a, b, device="cpu", accuracy="loose")
    with pytest.raises(InvalidArgumentError):
        ssim_tpu_torch.ssim(torch.from_numpy(a), torch.from_numpy(b),
                            accuracy="fast")
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="relaxed"):
        ssim_cuda.ssim_parts_cuda(at, bt, relaxed=True, precise=True)
    with pytest.raises(ValueError, match="relaxed"):
        ssim_cuda.ssim_parts_batch_cuda(at[None], bt[None], relaxed=True,
                                        precise=True)
    with pytest.raises(ValueError, match="relaxed"):
        ssim_cuda.ssim_parts_cuda(at, bt, relaxed=True, rowsum=True)


def _grad(a, b, accuracy):
    x = torch.from_numpy(a).requires_grad_()
    ssim_tpu_torch.ssim_loss(x, torch.from_numpy(b), device="cpu",
                             accuracy=accuracy).backward()
    return x.grad.numpy()


def test_ssim_loss_relaxed_gradient():
    """The relaxed gradient (every band pass of the backward twin split)
    against JAX's standard-tier gradient and the port's standard one."""
    rng = np.random.default_rng(0x91)
    a, b = float_pair(rng, (64, 640))
    g1 = _grad(a, b, "relaxed")
    g0 = _grad(a, b, "standard")
    gj = np.asarray(jax.grad(lambda x: jax_ssim_loss(
        x, jnp.asarray(b), data_range=1.0, impl="xla"))(jnp.asarray(a)))
    scale = np.abs(gj).max()
    assert np.abs(g1 - gj).max() <= 1e-3 * scale
    assert np.abs(g1 - g0).max() <= 1e-3 * scale
    assert not np.array_equal(g1, g0)


@pytest.mark.parametrize("radius,sigma", [(3, 1.2), (9, 2.5)])
def test_compute_ssim_relaxed_custom_window_against_jax_and_oracle(radius, sigma):
    """compute_ssim(accuracy="relaxed") with a custom window (radius 3: two
    horizontal k-steps of the band, 9: three), u8 at W >= MXU_MIN_W, against
    the f64 oracle (1e-4 global, 5e-3 per interior map pixel) and JAX's
    compute_ssim with impl="xla" at the same window (1e-4); the map is not
    the standard tier's."""
    rng = np.random.default_rng(0x94 + radius)
    a, b = _u8(rng, (2, 45, 600))
    win = dict(radius=radius, sigma=sigma)
    g, m = ssim_tpu_torch.compute_ssim(a, b, with_map=True, device="cpu",
                                       accuracy="relaxed", **win)
    g0, m0 = ssim_tpu_torch.compute_ssim(a, b, with_map=True, device="cpu", **win)
    want, want_map = reference.compute_ssim(a, b, with_map=True, **win)
    jx = np.asarray(jax_compute_ssim(a, b, impl="xla", **win))
    assert np.abs(np.asarray(g) - np.asarray(want)).max() < 1e-4
    assert np.abs(np.asarray(g) - jx).max() < 1e-4
    inner = (Ellipsis, slice(radius, -radius), slice(radius, -radius))
    assert np.abs(m[inner] - want_map[inner]).max() < 5e-3
    assert not np.array_equal(m, m0)


@pytest.mark.parametrize("radius,sigma", [(3, 1.2), (9, 2.5)])
def test_ssim_loss_relaxed_gradient_custom_window(radius, sigma):
    """The relaxed gradient with a custom window (radii 3 and 9: one and two
    vertical k-steps, two and three horizontal ones of the backward's band
    passes) at W >= MXU_MIN_W against JAX's gradient with impl="xla" at the
    same window and the port's standard one, within 1e-3 x max|g|, and not
    the standard one."""
    rng = np.random.default_rng(0x95 + radius)
    a, b = float_pair(rng, (48, 560))
    grads = []
    for accuracy in ("relaxed", "standard"):
        x = torch.from_numpy(a).requires_grad_()
        ssim_tpu_torch.ssim_loss(x, torch.from_numpy(b), device="cpu", accuracy=accuracy,
                                 radius=radius, sigma=sigma).backward()
        grads.append(x.grad.numpy())
    g1, g0 = grads
    gj = np.asarray(jax.grad(lambda x: jax_ssim_loss(
        x, jnp.asarray(b), data_range=1.0, impl="xla", radius=radius,
        sigma=sigma))(jnp.asarray(a)))
    scale = np.abs(gj).max()
    assert np.abs(g1 - gj).max() <= 1e-3 * scale
    assert np.abs(g1 - g0).max() <= 1e-3 * scale
    assert not np.array_equal(g1, g0)


def test_backward_relaxed_with_halo_operands():
    """The relaxed flag is orthogonal to the halo mode: a band with its
    operands, relaxed, stays within 1e-3 x max|g| of the standard band and
    differs from it."""
    rng = np.random.default_rng(0x92)
    a, b = (torch.from_numpy(x[None]) for x in float_pair(rng, (40, 600)))
    r = 5
    band = (slice(None), slice(2 * r, 40 - 2 * r))
    vhalo = tuple(x[:, s].contiguous() for x in (a, b)
                  for s in (slice(0, 2 * r), slice(40 - 2 * r, 40)))
    vhalo = (vhalo[0], vhalo[1], vhalo[2], vhalo[3])
    kw = dict(vhalo=vhalo, vmask=(0, 0), data_range=1.0)
    g0 = ssim_grad.ssim_grad_cuda(a[band].contiguous(), b[band].contiguous(),
                                  1.0, 0.2, **kw)
    g1 = ssim_grad.ssim_grad_cuda(a[band].contiguous(), b[band].contiguous(),
                                  1.0, 0.2, relaxed=True, **kw)
    for x0, x1 in zip(g0, g1):
        scale = float(x0.abs().max())
        assert float((x1 - x0).abs().max()) <= 1e-3 * scale
        assert not torch.equal(x0, x1)


def test_ms_ssim_relaxed():
    """MS-SSIM with the relaxed tier (scale 1 is 704 wide, the others
    standard) against JAX's plain pyramid; its f32 gradient is finite and
    within 1e-3 x max|g| of the standard one; the relaxed components act."""
    rng = np.random.default_rng(0x93)
    a = rng.integers(0, 256, (192, 704), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-12, 12, a.shape), 0,
                255).astype(np.uint8)
    want = float(jax_ms_ssim(a, b, impl="xla"))
    got = float(ssim_tpu_torch.ms_ssim(a, b, device="cpu", accuracy="relaxed"))
    assert got == pytest.approx(want, abs=1e-4)

    af = torch.from_numpy(a.astype(np.float32) / 255.0)
    bf = torch.from_numpy(b.astype(np.float32) / 255.0)
    grads = []
    for accuracy in ("standard", "relaxed"):
        x = af.clone().requires_grad_()
        ssim_tpu_torch.ms_ssim(x, bf, data_range=1.0,
                               accuracy=accuracy).backward()
        grads.append(x.grad)
    assert bool(torch.isfinite(grads[1]).all())
    scale = float(grads[0].abs().max())
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-3 * scale
    assert not torch.equal(grads[0], grads[1])

    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    p0 = ssim_cuda.ssim_components_pooled_cuda(at, bt)
    p1 = ssim_cuda.ssim_components_pooled_cuda(at, bt, relaxed=True)
    assert not torch.equal(p0[0], p1[0])
    assert torch.equal(p0[1], p1[1]) and torch.equal(p0[2], p1[2])


def test_build_compiles_units_and_hashes_headers(tmp_path, monkeypatch):
    """_build compiles each .cu file alone and hashes the .cuh headers
    too, so an edited header changes the library's name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    names = [os.path.basename(p) for p in _build.sources()]
    assert "band_mma.cuh" in names
    assert {"ssim_fwd.cu", "ssim_bwd.cu"} <= set(names)
    units = [os.path.basename(p) for p in _build.translation_units()]
    assert units == sorted(n for n in names if n.endswith(".cu"))
    before = _build.library_path()
    with open(csrc / "band_mma.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before
