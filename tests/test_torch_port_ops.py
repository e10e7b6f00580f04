"""The port's plain PyTorch path (ssim_tpu_torch.ops.ssim_torch) against
its JAX counterpart ssim_tpu.ops.ssim_xla and the f64 oracle, on the same
NumPy inputs. Tolerances: tests/torch_port_util.py."""

import numpy as np
import pytest
import torch

from conftest import random_pair
from torch_port_util import (
    JAX_GLOBAL, ORACLE_GLOBAL, ORACLE_PIXEL, assert_close, float_pair,
    jax_pixel,
)

from ssim_tpu import reference
from ssim_tpu.ops.pool import box_decimate_device as jax_box_decimate
from ssim_tpu.ops.ssim_xla import ssim_parts_xla
from ssim_tpu_torch.ops.pool import box_decimate_device
from ssim_tpu_torch.ops.ssim_torch import _pad_edge, ssim_parts_torch


def _finalize(row_sums, npix):
    return np.asarray(row_sums, np.float64).sum(axis=-1) / npix


@pytest.mark.parametrize("shape", [(57, 83), (255, 63), (257, 65), (3, 4)])
@pytest.mark.parametrize("radius", [1, 5, 16])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_ssim_parts_torch_matches_xla(rng, shape, radius, dtype):
    if dtype == "u8":
        a, b = random_pair(rng, *shape)
        dr = 255.0
    else:
        a, b = float_pair(rng, shape)
        dr = 1.0
    npix = a.size
    rows_t, map_t = ssim_parts_torch(
        torch.from_numpy(a), torch.from_numpy(b), with_map=True,
        radius=radius, data_range=dr,
    )
    rows_j, map_j = ssim_parts_xla(a, b, with_map=True, radius=radius,
                                   data_range=dr)
    assert rows_t.dtype == torch.float32 and rows_t.shape == (shape[0],)
    assert map_t.dtype == torch.float32
    assert_close(_finalize(rows_t, npix), _finalize(rows_j, npix), npix,
                 map_t.numpy(), np.asarray(map_j),
                 base=JAX_GLOBAL, pixel=jax_pixel(radius))
    want, want_map = reference.compute_ssim(a, b, with_map=True,
                                            radius=radius, data_range=dr)
    assert_close(_finalize(rows_t, npix), want, npix, map_t.numpy(),
                 want_map, base=ORACLE_GLOBAL, pixel=ORACLE_PIXEL)


def test_ssim_parts_torch_batched_custom_window(rng):
    pairs = [random_pair(rng, 40, 51) for _ in range(3)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    kw = dict(radius=4, sigma=2.0, k1=0.02, k2=0.05)
    rows_t, _ = ssim_parts_torch(torch.from_numpy(a), torch.from_numpy(b), **kw)
    rows_j, _ = ssim_parts_xla(a, b, **kw)
    assert rows_t.shape == (3, 40)
    assert_close(_finalize(rows_t, 40 * 51), _finalize(rows_j, 40 * 51), 40 * 51)


@pytest.mark.parametrize("shape", [(1, 1), (2, 7), (9, 3)])
def test_pad_edge_matches_numpy(rng, shape):
    x = rng.random(shape).astype(np.float32)
    got = _pad_edge(torch.from_numpy(x), 5).numpy()
    assert np.array_equal(got, np.pad(x, 5, mode="edge"))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_box_decimate_matches_jax(rng, k, dtype):
    x = (rng.random((2, 37, 50)) * 255).astype(dtype)
    got = box_decimate_device(torch.from_numpy(x), k).numpy()
    want = np.asarray(jax_box_decimate(x, k))
    assert got.dtype == np.float32 and got.shape == want.shape
    # u8 window sums are exact; f32 ones add in another order than
    # reduce_window, a few ulp apart.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
