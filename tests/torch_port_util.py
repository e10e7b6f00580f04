"""Tolerances and comparisons shared by the port's tests
(tests/test_torch_port_*.py), which hold ssim_tpu_torch against ssim_tpu
on the CPU with the same NumPy inputs fed to both packages.

Tolerances:

- Port against the f64 oracle: 2e-6 global and 1e-3 per pixel, the f32
  tier of ssim_tpu/testing/frozen.py:28-29.
- Port against its JAX counterpart: 2e-7 global and 1e-5 per pixel. The
  two run the same f32 algebra with other roundings (four blurred
  signals against five, another order of the blur passes, FMA).

At radius 1 the window holds 9 pixels, so local variances are small next
to the means and the f32 cancellation in sigma grows: each package alone
is up to ~1.2e-5 per pixel from the f64 oracle there (measured on the
inputs of test_torch_port_ops: ssim_xla 8.9e-6, ssim_torch 1.2e-5, from
2.1e-6 at radius 5), so the two can differ by twice that. Port against
JAX at radius 1 is held to 5e-5 per pixel (`jax_pixel`).

A global score is a mean of per-pixel values, so on tiny images it is no
more accurate than a pixel: the global tolerance is never tighter than
twice the per-pixel one over sqrt(npix), the rule of
tests/test_pallas.py::_check.

The precise tier (precision="f64") against the f64 oracle: 5e-9 global
and 5e-7 per pixel, the JAX package's regression bounds
(tests/test_precision.py:27-28), both inside the reference double
build's tier of 5e-7 / 1e-5.
"""

import numpy as np

from ssim_tpu.testing import frozen

ORACLE_GLOBAL = frozen.GLOBAL_TOLERANCE_F32
ORACLE_PIXEL = frozen.PIXEL_TOLERANCE_F32
JAX_GLOBAL = 2e-7
JAX_PIXEL = 1e-5
JAX_PIXEL_RADIUS1 = 5e-5
PRECISE_GLOBAL = 5e-9
PRECISE_PIXEL = 5e-7


def jax_pixel(radius: int) -> float:
    return JAX_PIXEL_RADIUS1 if radius == 1 else JAX_PIXEL


def global_tol(base: float, pixel: float, npix: int) -> float:
    return max(base, 2.0 * pixel / npix**0.5)


def assert_close(got, want, npix, got_map=None, want_map=None, *,
                 base=JAX_GLOBAL, pixel=JAX_PIXEL):
    """Scores (scalars or (B,) arrays) and optional maps within the
    stated tolerances; NaN must sit where the reference has NaN."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    tol = global_tol(base, pixel, npix)
    err = np.nanmax(np.abs(got - want), initial=0.0)
    assert err <= tol, (err, tol, got, want)
    if want_map is not None:
        got_map = np.asarray(got_map)
        want_map = np.asarray(want_map)
        assert got_map.shape == want_map.shape, (got_map.shape, want_map.shape)
        perr = np.abs(got_map.astype(np.float64) - want_map).max()
        assert perr <= pixel, (perr, pixel)


def float_pair(rng, shape, data_range=1.0):
    """A correlated float32 pair in [0, data_range]."""
    a = (rng.random(shape) * data_range).astype(np.float32)
    noise = rng.normal(0, 0.05 * data_range, shape).astype(np.float32)
    b = np.clip(a + noise, 0, data_range).astype(np.float32)
    return a, b
