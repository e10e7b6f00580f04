"""The precise tier (precision="f64") of ssim_tpu_torch against the f64
oracle and the JAX package, on the same NumPy inputs.

On the CPU `ssim_parts_cuda(precise=True)` runs the kernel's plain twin
(`ssim_parts_precise_plain`) and the Pallas kernel runs in interpret mode.
The kernel itself only runs on a card: tests/test_torch_port_cuda.py holds
it against the twin there.

Tolerances: against the f64 oracle, 5e-9 global and 5e-7 per pixel
(torch_port_util, the JAX package's regression bounds). Against
`ssim_parts_pallas(precise=True)`: scores within 1e-9, maps within 2 f32
ulps. The two packages' f32 blurs round differently (band matrices
against symmetric tap pairs), so their fp64 and df32 formulas start from
inputs that differ in the last bits: on random inputs at these shapes
nearly every pixel is within 1 ulp and a rare one at 2. u16 and float inputs square inexactly in f32 before the
formula: 2e-7 global, the bound of tests/test_precision.py:75-86. The
oracle routes call the same oracle: 1e-12.

Inputs come from a generator seeded in each test, so each test sees the
same values whatever ran before it on its worker.
"""

import numpy as np
import pytest
import torch

from conftest import random_pair
from torch_port_util import PRECISE_GLOBAL, PRECISE_PIXEL, float_pair

import ssim_tpu_torch
from ssim_tpu.ops import ssim_pallas as jax_pallas
from ssim_tpu_torch import engine, reference
from ssim_tpu_torch.config import Config, get_config, set_config
from ssim_tpu_torch.errors import UnsupportedError
from ssim_tpu_torch.ops import pool, ssim_cuda
from ssim_tpu_torch.ops.routing import ssim_parts_auto
from ssim_tpu_torch.ops.ssim_cuda import ssim_parts_cuda, tile_grid

_ORACLE = reference.compute_ssim  # the no_oracle fixture replaces it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twin runs many small elementwise passes; with one intra-op
    thread per test worker they do not contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pairs(seed, shape):
    """A seeded correlated u8 pair of shape (H, W) or (B, H, W)."""
    rng = np.random.default_rng(seed)
    if len(shape) == 2:
        return random_pair(rng, *shape)
    pairs = [random_pair(rng, *shape[1:]) for _ in range(shape[0])]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _twin(a, b, **kw):
    p, m = ssim_parts_cuda(torch.from_numpy(a), torch.from_numpy(b),
                           with_map=True, precise=True, **kw)
    return p.numpy(), m.numpy()


def _scores(partials, npix):
    return np.asarray(partials, np.float64).sum(axis=-1) / npix


@pytest.fixture
def precise_twin_calls(monkeypatch):
    """Counts the calls of the precise twin, the kernel route on the CPU."""
    calls = []
    real = ssim_cuda.ssim_parts_precise_plain

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ssim_cuda, "ssim_parts_precise_plain", spy)
    return calls


@pytest.fixture
def no_oracle(monkeypatch):
    """Makes the f64 oracle raise: a call that passes did not use it."""

    def refuse(*args, **kw):
        raise AssertionError("the f64 oracle was called")

    monkeypatch.setattr(reference, "compute_ssim", refuse)


@pytest.mark.parametrize("shape", [(67, 150), (2, 40, 56)])
def test_twin_matches_oracle(shape):
    a, b = _pairs(1, shape)
    p, m = _twin(a, b)
    nty, ntx = tile_grid(shape[-2], shape[-1])
    assert p.dtype == np.float64 and p.shape == shape[:-2] + (nty * ntx,)
    assert m.dtype == np.float32 and m.shape == shape
    want, want_map = reference.compute_ssim(a, b, with_map=True)
    npix = shape[-1] * shape[-2]
    assert np.abs(_scores(p, npix) - want).max() <= PRECISE_GLOBAL
    assert np.abs(m.astype(np.float64) - want_map).max() <= PRECISE_PIXEL


@pytest.mark.parametrize("shape,kw", [((67, 150), {}),
                                      ((40, 247), dict(max_tile_w=128))])
def test_twin_matches_pallas_precise(shape, kw):
    """The fast path, and the smallest width at which the JAX package
    takes _chunked_overlap_call (K2 precise) once max_tile_w is pinned to
    one 128-lane block."""
    if kw:
        r = 5
        assert (jax_pallas._round_up(shape[1] + 2 * r, 128)
                > kw["max_tile_w"] + jax_pallas.COL_OVERLAP)
        assert (jax_pallas._round_up(shape[1] - 1 + 2 * r, 128)
                <= kw["max_tile_w"] + jax_pallas.COL_OVERLAP)
    a, b = _pairs(2, shape)
    pt, mt = _twin(a, b)
    pj, mj = jax_pallas.ssim_parts_pallas(a, b, with_map=True, precise=True,
                                          interpret=True, **kw)
    pj, mj = np.asarray(pj), np.asarray(mj)
    assert abs(_scores(pt, a.size) - _scores(pj, a.size)) <= 1e-9
    ulp = np.spacing(np.maximum(np.abs(mt), np.abs(mj)))
    assert (np.abs(mt - mj) <= 2 * ulp).all()


def test_precise_beats_f32():
    """The fp64 formula, not a relabel of the standard tier: per pixel
    under a fifth of the standard mode's error (tests/test_precision.py:
    48-62)."""
    a, b = _pairs(3, (128, 200))
    want, want_map = reference.compute_ssim(a, b, with_map=True)
    p64, m64 = _twin(a, b)
    p32, m32 = ssim_parts_cuda(torch.from_numpy(a), torch.from_numpy(b),
                               with_map=True)
    err64 = abs(_scores(p64, a.size) - want)
    err32 = abs(_scores(p32.numpy(), a.size) - want)
    pix64 = np.abs(m64.astype(np.float64) - want_map).max()
    pix32 = np.abs(m32.numpy().astype(np.float64) - want_map).max()
    assert pix64 < pix32 / 5
    assert err64 < max(err32, 1e-9)


@pytest.mark.parametrize("bad_value", [np.nan, np.inf])
def test_nonfinite_pixel_poisons_only_its_image(bad_value):
    a, b = float_pair(np.random.default_rng(4), (2, 40, 150))
    a[0, 13, 100] = bad_value
    p, m = _twin(a, b, data_range=1.0, allow_float=True)
    s = _scores(p, a[0].size)
    assert np.isnan(s[0]) and np.isfinite(s[1])
    ty, tx = 13 // ssim_cuda.TILE_H, 100 // ssim_cuda.TILE_W
    assert np.argwhere(np.isnan(p)).tolist() == [[0, ty * tile_grid(40, 150)[1] + tx]]
    assert np.isnan(m[0, 13, 100]) and not np.isnan(m[1]).any()
    single, _ = _twin(a[1], b[1], data_range=1.0, allow_float=True)
    assert abs(_scores(single, a[0].size) - s[1]) <= 1e-14
    want = reference.compute_ssim(a[1].astype(np.float64), b[1].astype(np.float64),
                                  data_range=1.0)[0]
    assert abs(s[1] - want) <= 2e-7


@pytest.mark.parametrize("tile", [(8, 32), (17, 64)])
def test_partials_are_tile_sums(tile):
    """Each f64 partial is sum(ssim - 1) + n_valid of its own tile, ragged
    tiles included, and the map does not depend on the tile."""
    a, b = _pairs(5, (2, 45, 77))
    p0, m0 = _twin(a, b)
    p1, m1 = _twin(a, b, tile_h=tile[0], tile_w=tile[1])
    assert np.array_equal(m0, m1)
    nty, ntx = tile_grid(45, 77, *tile)
    assert p1.shape == (2, nty * ntx) and p1.dtype == np.float64
    assert np.abs(_scores(p1, 45 * 77) - _scores(p0, 45 * 77)).max() <= 1e-13
    for i in range(nty):
        for j in range(ntx):
            blk = m1[:, i * tile[0]:(i + 1) * tile[0], j * tile[1]:(j + 1) * tile[1]]
            want = (blk.astype(np.float64) - 1.0).sum(axis=(1, 2)) + blk[0].size
            # The map is the f32 rounding of the values the partials sum.
            assert np.abs(p1[:, i * ntx + j] - want).max() <= 6e-8 * blk[0].size
    p2, m2 = ssim_parts_cuda(torch.from_numpy(a), torch.from_numpy(b),
                             precise=True, tile_h=tile[0], tile_w=tile[1])
    assert m2 is None and np.array_equal(p2.numpy(), p1)


def test_cpu_twin_counts_no_launch():
    a, b = _pairs(6, (20, 30))
    before = (ssim_cuda.LAUNCHES, ssim_cuda.PRECISE_LAUNCHES)
    _twin(a, b)
    assert (ssim_cuda.LAUNCHES, ssim_cuda.PRECISE_LAUNCHES) == before


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float16", "bfloat16",
                                   "float32"])
def test_engine_kernel_route(dtype, no_oracle, precise_twin_calls):
    """The dtypes that embed exactly in f32 take the kernel's precise mode
    (its twin here), never the oracle."""
    rng = np.random.default_rng(7)
    if dtype == "uint8":
        a, b = random_pair(rng, 48, 64)
        data_range, tol = 255.0, PRECISE_GLOBAL
    elif dtype == "uint16":
        a = rng.integers(0, 60000, (48, 64)).astype(np.uint16)
        b = rng.integers(0, 60000, (48, 64)).astype(np.uint16)
        data_range, tol = 65535.0, 2e-7
    else:
        if dtype == "bfloat16":
            dtype = pytest.importorskip("ml_dtypes").bfloat16
        a, b = float_pair(rng, (48, 64))
        a, b = a.astype(dtype), b.astype(dtype)
        data_range, tol = 1.0, 2e-7
    wide = lambda x: np.asarray(x, np.float64)
    want, _ = _ORACLE(wide(a), wide(b), data_range=data_range)
    got, _ = engine.compute(a, b, precision="f64", data_range=data_range,
                            device="cpu")
    assert precise_twin_calls == [(1, 48, 64)]
    assert isinstance(got, np.float64)
    assert abs(float(got) - want) <= tol


@pytest.mark.parametrize("case", ["float64", "mixed", "radius17", "torch",
                                  "reference"])
def test_engine_oracle_routes(case, precise_twin_calls):
    """Only f64 inputs, mixed dtypes, radius > 16 and the impls torch and
    reference take the oracle, as in ssim_tpu/engine.py:277-292."""
    a, b = random_pair(np.random.default_rng(8), 40, 56)
    kw = dict(data_range=255.0)
    if case == "float64":
        a, b = a.astype(np.float64), b.astype(np.float64)
    elif case == "mixed":
        b = b.astype(np.float32)
    elif case == "radius17":
        kw.update(radius=17, sigma=3.0)
    elif case in ("torch", "reference"):
        kw.update(impl=case)
    window = {k: v for k, v in kw.items() if k != "impl"}
    want, want_map = reference.compute_ssim(
        np.asarray(a, np.float64), np.asarray(b, np.float64), with_map=True,
        **window)
    got, got_map = engine.compute(torch.from_numpy(a), torch.from_numpy(b),
                                  precision="f64", with_map=True, **kw)
    assert precise_twin_calls == []
    assert abs(float(got) - want) <= 1e-12
    assert np.abs(got_map.astype(np.float64) - want_map).max() <= 1e-6


def test_engine_downsample_pools_on_device(monkeypatch, no_oracle,
                                           precise_twin_calls):
    """downsample=2 with f64 pools on the compute device (2x2 means of u8
    are exact in f32) and then runs the precise mode."""
    a, b = _pairs(9, (90, 130))
    want, _ = _ORACLE(engine.box_decimate(a, 2), engine.box_decimate(b, 2))
    pooled = []
    real = pool.box_decimate_device

    def spy(x, k):
        pooled.append((x.device.type, k))
        return real(x, k)

    monkeypatch.setattr(pool, "box_decimate_device", spy)
    got, _ = engine.compute(a, b, precision="f64", downsample=2, device="cpu")
    assert pooled == [("cpu", 2), ("cpu", 2)]
    assert precise_twin_calls == [(1, 45, 65)]
    assert abs(float(got) - want) <= PRECISE_GLOBAL


def test_config_precision_reaches_kernel(precise_twin_calls):
    """SSIM_TPU_TORCH_PRECISION=f64 (Config.precision) is the default of
    every eager entry point, compute_ssim_map included."""
    a, b = _pairs(10, (40, 56))
    want, want_map = reference.compute_ssim(a, b, with_map=True)
    old = get_config()
    set_config(Config(precision="f64"))
    try:
        got, got_map = ssim_tpu_torch.compute_ssim_map(a, b, device="cpu")
    finally:
        set_config(old)
    assert precise_twin_calls == [(1, 40, 56)]
    assert abs(got - want) <= PRECISE_GLOBAL
    assert np.abs(got_map.astype(np.float64) - want_map).max() <= PRECISE_PIXEL


def test_numpy_input_without_gpu_raises(monkeypatch):
    """The precise tier computes on the card like the standard one: NumPy
    input with no device raises without a GPU, and no oracle stands in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = _pairs(11, (16, 16))
    with pytest.raises(UnsupportedError):
        ssim_tpu_torch.compute_ssim(a, b, precision="f64")


def test_routing_refuses_what_the_kernel_cannot_serve():
    """ssim_parts_auto(precise=True) never runs the f32 plain path: radius
    > 16, f64 inputs and mixed dtypes raise (the engine sends those to the
    oracle). The precise tier has no components mode."""
    u8 = torch.zeros((8, 8), dtype=torch.uint8)
    for a, b, kw in [(u8, u8, dict(radius=17)),
                     (u8.double(), u8.double(), {}),
                     (u8, u8.float(), {})]:
        with pytest.raises(ValueError):
            ssim_parts_auto(a, b, precise=True, **kw)
    for fn in (ssim_cuda.ssim_components_cuda, ssim_cuda.ssim_components_pooled_cuda):
        with pytest.raises(TypeError):
            fn(u8, u8, precise=True)
