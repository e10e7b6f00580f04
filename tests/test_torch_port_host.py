"""The port's native host backend (`ssim_tpu_torch.ops.host`, its own copy
of the C++ source in `ssim_tpu_torch/csrc/host/`) against the JAX
package's (`ssim_tpu.ops.host`): tests/test_host.py's cases but the
thread-scaling timing. Both libraries are built by g++ from the same
code with the same flags on this CPU, so scores and maps must be equal
bit for bit; against the f64 oracle the f32 tier's tolerances
(ssim_tpu/testing/frozen.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import random_pair

import ssim_tpu
from ssim_tpu import reference
from ssim_tpu.testing import frozen

import ssim_tpu_torch
from ssim_tpu_torch import Implementation, available_impls, select_impl
from ssim_tpu_torch.errors import InvalidArgumentError, UnsupportedError
from ssim_tpu_torch.ops import _build
from ssim_tpu_torch.ops import host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_host():
    """The JAX package's host backend, built as tests/test_host.py builds it."""
    from ssim_tpu.ops import host as host_mod

    if not host_mod.is_available():
        try:
            subprocess.run(
                ["make", "-C", "native"], cwd=host_mod._lib_path().rsplit("/", 2)[0],
                check=True, capture_output=True, timeout=120,
            )
        except Exception as e:
            pytest.skip(f"cannot build the JAX package's native backend: {e}")
        host_mod._TRIED = False  # re-probe
        if not host_mod.is_available():
            pytest.skip("the JAX package's native backend is unavailable after build")
    return host_mod


def _code(path):
    """A C++ source's lines with the // comments taken out."""
    with open(path) as f:
        return [line.split("//")[0].rstrip() for line in f]


def test_source_is_the_native_source_and_builds_into_the_package():
    """The port keeps a copy of native/ssim_host.cpp, the same code line
    for line (one comment names the reference's source without a
    machine's path), and builds it into ssim_tpu_torch/_build/, keyed by
    the source's hash."""
    native = os.path.join(REPO, "native", "ssim_host.cpp")
    assert _code(_build.HOST_SOURCE) == _code(native)
    with open(_build.HOST_SOURCE) as f, open(native) as g:
        differ = [a for a, b in zip(f, g) if a != b]
    assert len(differ) == 1 and differ[0].startswith("// the reference's src/ssim.cpp")
    assert host.is_available(), host.unavailable_reason()
    path = _build.host_library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(REPO, "ssim_tpu_torch", "_build")
    assert _build.HOST_FLAGS == ("-O3", "-march=native", "-fopenmp", "-fPIC",
                                 "-std=c++17", "-shared")


def test_library_key_covers_compiler_and_cpu(monkeypatch):
    """The built library's name hashes the compiler's version and the
    target -march=native selects, so a build directory carried to another
    CPU or compiler is rebuilt there, not loaded."""
    target = _build._host_target()
    assert b"-march=" in target and b"[enabled]" in target
    here = _build.host_library_path()
    monkeypatch.setattr(_build, "_host_target",
                        lambda: target.replace(b"[enabled]", b"[disabled]", 1))
    assert _build.host_library_path() != here
    monkeypatch.setattr(_build, "_host_target", lambda: b"")
    assert _build.host_library_path() != here


@pytest.mark.parametrize("shape", [(1, 1), (9, 13), (63, 255), (128, 200)])
def test_host_vs_oracle(rng, jax_host, shape):
    a, b = random_pair(rng, *shape)
    want, want_map = reference.compute_ssim(a, b, with_map=True)
    got, got_map = host.compute(a, b, with_map=True)
    npix = shape[0] * shape[1]
    tol = max(frozen.GLOBAL_TOLERANCE_F32, 2e-3 / npix**0.5)
    assert type(got) is np.float64 and got_map.dtype == np.float32
    assert abs(float(got) - want) < tol
    assert np.abs(got_map - want_map).max() < frozen.PIXEL_TOLERANCE_F32
    jgot, jmap = jax_host.compute(a, b, with_map=True)
    assert got == jgot
    np.testing.assert_array_equal(got_map, jmap)


def test_host_einstein_frozen(images_dir):
    from ssim_tpu_torch.utils import load_image

    ref = load_image(os.path.join(images_dir, "einstein.png"))
    for name, want in frozen.EINSTEIN_SUITE.items():
        img = load_image(os.path.join(images_dir, name))
        got, _ = host.compute(img, ref)
        assert abs(float(got) - want) < frozen.GLOBAL_TOLERANCE_F32, (name, got)


@pytest.mark.parametrize("with_map", [False, True])
def test_host_via_engine(rng, jax_host, with_map):
    """impl="host" needs no device: the JAX engine's result bit for bit,
    within 2e-6 of the oracle."""
    a, b = random_pair(rng, 64, 96)
    got = ssim_tpu_torch.compute_ssim(a, b, impl="host", with_map=with_map)
    jgot = ssim_tpu.compute_ssim(a, b, impl="host", with_map=with_map)
    want, _ = reference.compute_ssim(a, b)
    if with_map:
        (got, m), (jgot, jm) = got, jgot
        np.testing.assert_array_equal(m, jm)
    assert type(got) is float and got == jgot
    assert got == pytest.approx(want, abs=2e-6)


def test_host_batched(rng, jax_host):
    a1, b1 = random_pair(rng, 32, 48)
    a2, b2 = random_pair(rng, 32, 48)
    a, b = np.stack([a1, a2]), np.stack([b1, b2])
    scores, maps = host.compute(a, b, with_map=True)
    assert scores.shape == (2,) and scores.dtype == np.float64
    assert maps.shape == (2, 32, 48) and maps.dtype == np.float32
    s1, _ = host.compute(a1, b1)
    assert scores[0] == s1
    js, jm = jax_host.compute(a, b, with_map=True)
    np.testing.assert_array_equal(scores, js)
    np.testing.assert_array_equal(maps, jm)
    got = ssim_tpu_torch.compute_ssim(a, b, impl="host")
    np.testing.assert_array_equal(got, ssim_tpu.compute_ssim(a, b, impl="host"))


def test_host_takes_tensors(rng):
    import torch

    a, b = random_pair(rng, 20, 30)
    got, m = host.compute(torch.from_numpy(a), torch.from_numpy(b), with_map=True)
    want, wm = host.compute(a, b, with_map=True)
    assert got == want
    np.testing.assert_array_equal(m, wm)


def test_host_rejects_non_u8(rng):
    """float / u16 inputs raise, not silently truncate or wrap to u8; so do
    a downsample (pooled images are float) and a custom window, through the
    API, as in the JAX engine."""
    a, b = random_pair(rng, 32, 40)
    for bad in (np.float32, np.uint16):
        with pytest.raises(InvalidArgumentError):
            host.compute(a.astype(bad), b.astype(bad))
        with pytest.raises(InvalidArgumentError):
            ssim_tpu_torch.compute_ssim(a.astype(bad), b.astype(bad), impl="host")
    with pytest.raises(InvalidArgumentError, match="downsample"):
        ssim_tpu_torch.compute_ssim(a, b, impl="host", downsample=2)
    for kw in (dict(radius=3), dict(sigma=2.0), dict(k1=0.02), dict(k2=0.05)):
        with pytest.raises(InvalidArgumentError, match="custom radius"):
            ssim_tpu_torch.compute_ssim(a, b, impl="host", **kw)
        with pytest.raises(ssim_tpu.InvalidArgumentError):
            ssim_tpu.compute_ssim(a, b, impl="host", **kw)
    # downsample=1 and "auto" on a small image pool nothing, as in the JAX engine.
    assert ssim_tpu_torch.compute_ssim(a, b, impl="host", downsample="auto") == \
        ssim_tpu_torch.compute_ssim(a, b, impl="host")


def test_host_f64_takes_the_oracle(rng):
    """precision="f64" with impl="host" takes the f64 oracle, as the JAX
    engine routes it."""
    a, b = random_pair(rng, 30, 41)
    got = ssim_tpu_torch.compute_ssim(a, b, impl="host", precision="f64")
    want, _ = reference.compute_ssim(a, b)
    assert got == pytest.approx(want, abs=1e-12)


def test_select_impl_host_when_it_builds():
    assert select_impl("host") == Implementation.HOST
    assert Implementation.HOST in available_impls()
    assert set(available_impls()) == {Implementation.REFERENCE, Implementation.TORCH,
                                      Implementation.CUDA, Implementation.HOST}


def test_failed_build_raises_unsupported(rng, monkeypatch, tmp_path):
    """Where g++ cannot build the library, host reports unavailable, and
    an explicit impl="host" raises UnsupportedError carrying the compiler's
    message; no other implementation runs in its place."""
    monkeypatch.setattr(_build, "HOST_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(host, "_LIB", None)
    monkeypatch.setattr(host, "_ERROR", None)
    assert not host.is_available()
    assert "no-such-g++" in host.unavailable_reason()
    assert Implementation.HOST not in available_impls()
    a, b = random_pair(rng, 16, 16)
    with pytest.raises(UnsupportedError, match="no-such-g"):
        host.compute(a, b)
    with pytest.raises(UnsupportedError, match="no-such-g"):
        select_impl("host")
    with pytest.raises(UnsupportedError) as e:
        ssim_tpu_torch.compute_ssim(a, b, impl="host")
    assert "no-such-g" in str(e.value)

    # A compiler that runs and fails: its message is carried.
    fake = tmp_path / "failing-cxx"
    fake.write_text("#!/bin/sh\necho 'fatal: cannot compile here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "HOST_CXX", str(fake))
    monkeypatch.setattr(host, "_ERROR", None)
    with pytest.raises(UnsupportedError, match="cannot compile here"):
        ssim_tpu_torch.compute_ssim(a, b, impl="host")
    assert not os.path.exists(_build.host_library_path())


def test_host_multithread_bands_match_oracle():
    """The per-thread row bands with halo recompute run only with >= 2
    OpenMP threads: force 4 in a subprocess and check ragged bands against
    the oracle."""
    code = r"""
import numpy as np
from ssim_tpu_torch.ops import host
from ssim_tpu_torch import reference
assert host.is_available()
rng = np.random.default_rng(404)
for h, w in [(130, 96), (7, 64), (64, 257)]:
    a = rng.integers(0, 256, (h, w), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.normal(0, 12, a.shape).astype(np.int16), 0, 255).astype(np.uint8)
    got, gmap = host.compute(a, b, with_map=True)
    want, wmap = reference.compute_ssim(a, b, with_map=True)
    assert abs(float(got) - want) < 2e-6, (h, w, got, want)
    assert np.abs(gmap - wmap).max() < 1e-3, (h, w)
print("OK")
"""
    env = dict(os.environ, OMP_NUM_THREADS="4")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
