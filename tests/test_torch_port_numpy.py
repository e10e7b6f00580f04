"""The port's NumPy-only layer equals the JAX package's, and the port
imports without JAX.

ssim_tpu_torch copies the modules of ssim_tpu that need no JAX (errors,
version, windows, reference, params); these tests prove each copy
behaves as its original on the same inputs, bit for bit.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import random_pair

import ssim_tpu
import ssim_tpu_torch
from ssim_tpu import errors as jerrors
from ssim_tpu import params as jparams
from ssim_tpu import reference as jreference
from ssim_tpu import windows as jwindows
from ssim_tpu_torch import errors as terrors
from ssim_tpu_torch import params as tparams
from ssim_tpu_torch import reference as treference
from ssim_tpu_torch import windows as twindows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ssim_tpu_torch")


@pytest.mark.parametrize("sigma", [0.5, 1.5, 3.0])
@pytest.mark.parametrize("radius", range(1, 17))
def test_taps_bitwise_equal(radius, sigma):
    for dtype in (np.float32, np.float64):
        got = twindows.gaussian_taps(dtype, radius, sigma)
        want = jwindows.gaussian_taps(dtype, radius, sigma)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


def test_window_constants_equal():
    for name in ("RADIUS", "SIGMA", "K1", "K2", "L", "C1", "C2"):
        assert getattr(twindows, name) == getattr(jwindows, name), name
    assert np.array_equal(twindows.frozen_kernel_2d(), jwindows.frozen_kernel_2d())
    assert np.array_equal(twindows.gaussian_kernel_2d(), jwindows.gaussian_kernel_2d())


@pytest.mark.parametrize(
    "shape,kw",
    [
        ((57, 83), {}),
        ((2, 30, 41), {}),
        ((3, 4), {"radius": 3, "sigma": 2.0, "k1": 0.02, "k2": 0.05}),
    ],
)
def test_oracle_array_equal(rng, shape, kw):
    a, b = random_pair(rng, int(np.prod(shape[:-1])), shape[-1])
    a, b = a.reshape(shape), b.reshape(shape)
    g_t, m_t = treference.compute_ssim(a, b, with_map=True, **kw)
    g_j, m_j = jreference.compute_ssim(a, b, with_map=True, **kw)
    assert np.array_equal(m_t, m_j)
    assert np.array_equal(np.asarray(g_t), np.asarray(g_j))


def test_errors_and_errnos_equal():
    names = ("SsimError", "InvalidArgumentError", "OutOfMemoryError",
             "DispatchError", "UnsupportedError")
    for name in names:
        t, j = getattr(terrors, name), getattr(jerrors, name)
        assert t.errno == j.errno, name
        assert [c.__name__ for c in t.__mro__] == [c.__name__ for c in j.__mro__]


def test_version_equal():
    assert ssim_tpu_torch.get_version() == ssim_tpu.get_version()
    assert ssim_tpu_torch.__version__ == ssim_tpu.__version__


def test_params_copy_equal(rng):
    buf = rng.integers(0, 256, 7 * 9 * 3, dtype=np.uint8)
    kw = dict(width=9, height=7, step=3, stride=-27, offset=6 * 27 + 1)
    vt = tparams.ImageView.from_strided(buf, **kw)
    vj = jparams.ImageView.from_strided(buf, **kw)
    assert np.array_equal(vt.data, vj.data)
    smap = rng.random((7, 9)).astype(np.float32)
    out_t = np.zeros(7 * 9 * 2, np.float32)
    out_j = np.zeros(7 * 9 * 2, np.float32)
    tparams.write_strided_map(out_t, smap, 2, 18)
    jparams.write_strided_map(out_j, smap, 2, 18)
    assert np.array_equal(out_t, out_j)
    with pytest.raises(terrors.InvalidArgumentError):
        tparams.Params(vt, tparams.ImageView.from_gray(smap[:3]))


def test_import_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import ssim_tpu_torch\n"
        "assert not any(m == 'ssim_tpu' or m.startswith('ssim_tpu.') "
        "for m in sys.modules), 'ssim_tpu was imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_ssim_tpu_imports():
    files = [
        os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
        if f.endswith(".py")
    ]
    assert len(files) >= 14
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "ssim_tpu"), (path, mod)
