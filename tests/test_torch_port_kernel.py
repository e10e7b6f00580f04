"""The fused CUDA kernel's wrapper (ssim_tpu_torch.ops.ssim_cuda) against
the JAX package's Pallas kernel, on the same NumPy inputs.

On the CPU the wrapper runs the kernel's plain twin and the Pallas kernel
runs in interpret mode, as tests/test_pallas.py runs it. The kernel
itself only runs on a card: tests/test_torch_port_cuda.py holds it
against the twin there. Tolerances: tests/torch_port_util.py.
"""

import numpy as np
import pytest
import torch

from conftest import random_pair
from torch_port_util import (
    JAX_GLOBAL, ORACLE_GLOBAL, ORACLE_PIXEL, assert_close, float_pair,
    jax_pixel,
)

from ssim_tpu import reference
from ssim_tpu.ops.routing import ssim_parts_auto as jax_parts_auto
from ssim_tpu.ops.ssim_pallas import ssim_parts_pallas
from ssim_tpu_torch.ops import ssim_cuda
from ssim_tpu_torch.ops.routing import ssim_parts_auto
from ssim_tpu_torch.ops.ssim_cuda import ssim_parts_cuda, tile_grid


def _scores(partials, npix):
    return np.asarray(partials, np.float64).sum(axis=-1) / npix


def _port(a, b, **kw):
    p, m = ssim_parts_cuda(torch.from_numpy(a), torch.from_numpy(b), **kw)
    return p.numpy(), (None if m is None else m.numpy())


def _pallas(a, b, **kw):
    p, m = ssim_parts_pallas(a, b, interpret=True, **kw)
    return np.asarray(p), (None if m is None else np.asarray(m))


def _stack_pairs(rng, batch, h, w):
    pairs = [random_pair(rng, h, w) for _ in range(batch)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.mark.parametrize(
    "shape", [(1, 57, 83), (2, 255, 63), (2, 257, 65), (2, 3, 4), (1, 1, 1)]
)
def test_twin_matches_pallas(rng, shape):
    a, b = _stack_pairs(rng, *shape)
    npix = shape[1] * shape[2]
    pt, mt = _port(a, b, with_map=True)
    pj, mj = _pallas(a, b, with_map=True)
    nty, ntx = tile_grid(shape[1], shape[2])
    assert pt.shape == (shape[0], nty * ntx) and pt.dtype == np.float32
    assert mt.shape == shape and mt.dtype == np.float32
    assert_close(_scores(pt, npix), _scores(pj, npix), npix, mt, mj)
    want, want_map = reference.compute_ssim(a, b, with_map=True)
    assert_close(_scores(pt, npix), want, npix, mt, want_map,
                 base=ORACLE_GLOBAL, pixel=ORACLE_PIXEL)


def test_twin_matches_pallas_chunked_path(rng):
    """A width the JAX package serves with _chunked_overlap_call once its
    fast-path gate is pinned to 4096 lanes (as tests/test_pallas.py
    does); the port's one tile grid covers it."""
    a, b = random_pair(rng, 24, 4500)
    pt, mt = _port(a, b, with_map=True)
    pj, mj = _pallas(a, b, with_map=True, max_tile_w=4096)
    assert_close(_scores(pt, a.size), _scores(pj, a.size), a.size, mt, mj)


def test_twin_float_matches_pallas(rng):
    a, b = float_pair(rng, (2, 67, 150))
    pt, mt = _port(a, b, with_map=True, data_range=1.0, allow_float=True)
    pj, mj = _pallas(a, b, with_map=True, data_range=1.0, allow_float=True)
    assert_close(_scores(pt, 67 * 150), _scores(pj, 67 * 150), 67 * 150, mt, mj)


@pytest.mark.parametrize(
    "window",
    [
        dict(radius=1, sigma=0.8, k1=0.02, k2=0.05),
        dict(radius=16, sigma=3.0, k1=0.015, k2=0.04),
    ],
)
def test_twin_custom_window_matches_pallas(rng, window):
    a, b = _stack_pairs(rng, 2, 70, 90)
    pt, mt = _port(a, b, with_map=True, **window)
    pj, mj = _pallas(a, b, with_map=True, **window)
    assert_close(_scores(pt, 70 * 90), _scores(pj, 70 * 90), 70 * 90, mt, mj,
                 base=JAX_GLOBAL, pixel=jax_pixel(window["radius"]))


@pytest.mark.parametrize("bad_value", [np.nan, np.inf])
def test_nonfinite_pixel_poisons_only_its_image(rng, bad_value):
    a, b = float_pair(rng, (2, 40, 150))
    a[0, 13, 100] = bad_value
    pt, mt = _port(a, b, with_map=True, data_range=1.0, allow_float=True)
    pj, _ = _pallas(a, b, data_range=1.0, allow_float=True)
    st, sj = _scores(pt, a[0].size), _scores(pj, a[0].size)
    assert np.isnan(st[0]) and np.isnan(sj[0])
    assert_close(st[1], sj[1], a[0].size)
    # Only the tile that holds the pixel is poisoned, in image 0 only.
    ty, tx = 13 // ssim_cuda.TILE_H, 100 // ssim_cuda.TILE_W
    nan_tiles = np.argwhere(np.isnan(pt))
    assert nan_tiles.tolist() == [[0, ty * tile_grid(40, 150)[1] + tx]]
    assert np.isnan(mt[0, 13, 100]) and not np.isnan(mt[1]).any()
    single, _ = _port(a[1], b[1], data_range=1.0, allow_float=True)
    assert_close(_scores(single, a[0].size), st[1], a[0].size)


@pytest.mark.parametrize("tile", [(8, 32), (17, 64), (1, 32), (48, 128)])
def test_tile_shapes_agree(rng, tile):
    """Ragged tiles at every edge: per-pixel values do not depend on the
    tile, and each partial is sum(ssim - 1) + n_valid of its own tile."""
    a, b = _stack_pairs(rng, 2, 45, 77)
    p0, m0 = _port(a, b, with_map=True)
    p1, m1 = _port(a, b, with_map=True, tile_h=tile[0], tile_w=tile[1])
    assert np.array_equal(m0, m1)
    nty, ntx = tile_grid(45, 77, *tile)
    assert p1.shape == (2, nty * ntx)
    assert_close(_scores(p1, 45 * 77), _scores(p0, 45 * 77), 45 * 77)
    for i in range(nty):
        for j in range(ntx):
            blk = m1[:, i * tile[0]:(i + 1) * tile[0], j * tile[1]:(j + 1) * tile[1]]
            want = (blk.astype(np.float64) - 1.0).sum(axis=(1, 2)) + blk[0].size
            np.testing.assert_allclose(p1[:, i * ntx + j], want, rtol=0, atol=1e-2)


def test_small_image_batch_matches_jax_route(rng):
    """Batches of small images: both routers take their batch routes (the
    JAX package packs lanes, the port runs the kernel's per-image batch
    mode); both give one score per image."""
    a, b = _stack_pairs(rng, 24, 9, 12)
    pt, _ = ssim_parts_auto(torch.from_numpy(a), torch.from_numpy(b))
    pj, _ = jax_parts_auto(a, b, interpret=True)
    assert_close(_scores(pt.numpy(), 108), _scores(pj, 108), 108)


def test_cpu_twin_counts_no_launch(rng):
    a, b = random_pair(rng, 20, 30)
    before = ssim_cuda.LAUNCHES
    _port(a, b)
    assert ssim_cuda.LAUNCHES == before


def test_argument_guards():
    u8 = torch.zeros((8, 8), dtype=torch.uint8)
    f32 = torch.zeros((8, 8), dtype=torch.float32)
    cases = [
        dict(radius=0), dict(radius=17), dict(data_range=1e-7),
        dict(data_range=1.0, k1=1e-9, k2=1e-9), dict(tile_w=48), dict(tile_h=0),
        dict(tile_h=256, tile_w=256),
    ]
    for kw in cases:
        with pytest.raises(ValueError):
            ssim_parts_cuda(u8, u8, **kw)
    with pytest.raises(ValueError):
        ssim_parts_cuda(f32, f32)  # float needs allow_float
    with pytest.raises(ValueError):
        ssim_parts_cuda(u8.to(torch.int16), u8.to(torch.int16), allow_float=True)
    with pytest.raises(ValueError):
        ssim_parts_cuda(u8, torch.zeros((8, 9), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ssim_parts_cuda(torch.zeros((16, 8), dtype=torch.uint8)[::2], u8)
    with pytest.raises(ValueError):
        ssim_parts_cuda(torch.zeros((2, 0, 8), dtype=torch.uint8),
                        torch.zeros((2, 0, 8), dtype=torch.uint8))
