"""The port's slice as a whole: ssim_tpu_torch's eager API against
ssim_tpu's with impl="xla", on the same NumPy inputs. On the CPU the
port's default route is the fused kernel's plain twin. Tolerances:
tests/torch_port_util.py."""

import errno

import numpy as np
import pytest
import torch

from conftest import random_pair
from torch_port_util import (
    ORACLE_GLOBAL, ORACLE_PIXEL, assert_close, float_pair,
)

import ssim_tpu
import ssim_tpu_torch
from ssim_tpu_torch import ImageView, Params, engine
from ssim_tpu_torch.errors import InvalidArgumentError, UnsupportedError


def _both(fn_name, *args, **kw):
    got = getattr(ssim_tpu_torch, fn_name)(*args, **kw)
    want = getattr(ssim_tpu, fn_name)(*args, impl="xla", **kw)
    return got, want


@pytest.mark.parametrize("batch", [None, 3])
def test_compute_ssim_matches_jax(rng, batch):
    shape = (61, 95)
    pairs = [random_pair(rng, *shape) for _ in range(batch or 1)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    if batch is None:
        a, b = a[0], b[0]
    got, want = _both("compute_ssim", a, b)
    if batch is None:
        assert type(got) is float and type(want) is float
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        assert got.shape == want.shape == (batch,)
    assert_close(got, want, a.shape[-1] * a.shape[-2])


def test_compute_ssim_map_matches_jax(rng):
    a, b = random_pair(rng, 70, 129)
    (g, m), (gj, mj) = _both("compute_ssim_map", a, b)
    assert type(g) is float and m.dtype == np.float32 == mj.dtype
    assert isinstance(m, np.ndarray) and m.shape == (70, 129)
    assert_close(g, gj, a.size, m, mj)
    want, want_map = ssim_tpu_torch.reference.compute_ssim(a, b, with_map=True)
    assert_close(g, want, a.size, m, want_map, base=ORACLE_GLOBAL,
                 pixel=ORACLE_PIXEL)


def test_compute_ssim_with_map_batched(rng):
    a, b = random_pair(rng, 2 * 40, 50)
    a, b = a.reshape(2, 40, 50), b.reshape(2, 40, 50)
    (g, m), (gj, mj) = _both("compute_ssim", a, b, with_map=True)
    assert m.shape == (2, 40, 50) and m.dtype == np.float32
    assert_close(g, gj, 2000, m, mj)


def test_compute_ssim_legacy_matches_jax(rng):
    a, b = random_pair(rng, 33, 47)
    got, want = _both("compute_ssim_legacy", a, b)
    assert type(got) is float
    assert_close(got, want, a.size)
    bad = ssim_tpu_torch.compute_ssim_legacy(a, b[:-1])
    assert bad == ssim_tpu.compute_ssim_legacy(a, b[:-1]) == -float(errno.EINVAL)
    assert ssim_tpu_torch.compute_ssim_legacy(a, b, impl="host") == -float(errno.ENOSYS)


@pytest.mark.parametrize(
    "args,kw",
    [
        ("mismatch", {}),
        ("empty", {}),
        ("empty_batch", {}),
        ("rank", {}),
        ("complex", {}),
        ("bool", {}),
        ("ok", {"radius": 0}),
        ("ok", {"radius": 2.5}),
        ("ok", {"sigma": -1.0}),
        ("ok", {"k1": float("nan")}),
        ("ok", {"k2": True}),
        ("ok", {"k1": 1e-12, "k2": 1e-12}),
        ("ok", {"precision": "f16"}),
        ("ok", {"accuracy": "fast"}),
        ("ok", {"accuracy": "relaxed", "precision": "f64"}),
        ("ok", {"downsample": 0}),
        ("ok", {"downsample": 9}),
    ],
)
def test_invalid_arguments_raise_einval_like_jax(args, kw):
    a = np.zeros((8, 8), np.uint8)
    pairs = {
        "mismatch": (a, np.zeros((8, 9), np.uint8)),
        "empty": (np.zeros((0, 8), np.uint8),) * 2,
        "empty_batch": (np.zeros((0, 8, 8), np.uint8),) * 2,
        "rank": (np.zeros((2, 2, 8, 8), np.uint8),) * 2,
        "complex": (a.astype(np.complex64),) * 2,
        "bool": (a.astype(bool),) * 2,
        "ok": (a, a),
    }
    x, y = pairs[args]
    with pytest.raises(InvalidArgumentError) as got:
        ssim_tpu_torch.compute_ssim(x, y, **kw)
    with pytest.raises(ssim_tpu.InvalidArgumentError) as want:
        ssim_tpu.compute_ssim(x, y, impl="xla", **kw)
    assert got.value.errno == want.value.errno == errno.EINVAL


def test_unknown_and_unported_impls_raise_enosys(rng):
    a, b = random_pair(rng, 12, 12)
    for impl in ("xla", "pallas", "host", "avx512"):
        with pytest.raises(UnsupportedError) as e:
            ssim_tpu_torch.compute_ssim(a, b, impl=impl)
        assert e.value.errno == errno.ENOSYS


def test_uint16_full_range(rng):
    a = rng.integers(0, 65536, (48, 64), dtype=np.uint16)
    b = np.clip(a.astype(np.int32) + rng.normal(0, 2000, a.shape).astype(np.int32),
                0, 65535).astype(np.uint16)
    got, want = _both("compute_ssim", a, b, data_range=65535.0)
    assert_close(got, want, a.size)


def test_float32_unit_range(rng):
    a, b = float_pair(rng, (2, 50, 70))
    got, want = _both("compute_ssim", a, b, data_range=1.0)
    assert_close(got, want, 50 * 70)


@pytest.mark.parametrize("dtype", [np.float64, np.float16, "bfloat16"])
def test_other_float_dtypes(rng, dtype):
    if dtype == "bfloat16":
        ml_dtypes = pytest.importorskip("ml_dtypes")
        dtype = ml_dtypes.bfloat16
    a, b = float_pair(rng, (40, 56))
    a, b = a.astype(dtype), b.astype(dtype)
    got, want = _both("compute_ssim", a, b, data_range=1.0)
    assert_close(got, want, a.size)


def test_downsample(rng):
    a, b = random_pair(rng, 90, 130)
    for ds in (2, "auto"):
        got, want = _both("compute_ssim", a, b, downsample=ds)
        assert_close(got, want, (90 // 2) * (130 // 2))


def test_params_input_and_map_buffer(rng):
    a, b = random_pair(rng, 30, 44)
    buf_t = np.zeros(30 * 44 * 2, np.float32)
    buf_j = np.zeros(30 * 44 * 2, np.float32)
    pt = Params(ImageView.from_gray(a), ImageView.from_gray(b), with_map=True,
                map_buffer=buf_t, map_step=2)
    pj = ssim_tpu.Params(ssim_tpu.ImageView.from_gray(a),
                         ssim_tpu.ImageView.from_gray(b), with_map=True,
                         implementation="xla", map_buffer=buf_j, map_step=2)
    (g, m), (gj, mj) = ssim_tpu_torch.compute_ssim(pt), ssim_tpu.compute_ssim(pj)
    assert_close(g, gj, a.size, m, mj)
    assert np.abs(buf_t - buf_j).max() <= 1e-5


@pytest.mark.parametrize("impl", ["cuda", "torch", "reference", "auto"])
def test_every_impl_agrees_with_oracle(rng, impl):
    a, b = random_pair(rng, 37, 53)
    g, m = ssim_tpu_torch.compute_ssim(a, b, with_map=True, impl=impl)
    want, want_map = ssim_tpu_torch.reference.compute_ssim(a, b, with_map=True)
    assert_close(g, want, a.size, m, want_map, base=ORACLE_GLOBAL,
                 pixel=ORACLE_PIXEL)


def test_precision_f64_and_relaxed_interim_routes(rng):
    a, b = random_pair(rng, 37, 53)
    want, _ = ssim_tpu_torch.reference.compute_ssim(a, b)
    assert ssim_tpu_torch.compute_ssim(a, b, precision="f64") == want
    std = ssim_tpu_torch.compute_ssim(a, b)
    assert ssim_tpu_torch.compute_ssim(a, b, accuracy="relaxed") == std


def test_large_radius_takes_torch_path(rng):
    a, b = random_pair(rng, 50, 60)
    got, want = _both("compute_ssim", a, b, radius=20)
    assert_close(got, want, a.size)


def test_tensor_inputs_match_numpy(rng):
    a, b = random_pair(rng, 40, 56)
    want = ssim_tpu_torch.compute_ssim(a, b)
    got = ssim_tpu_torch.compute_ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert got == want
    got_bf = ssim_tpu_torch.compute_ssim(
        torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).float())
    assert_close(got_bf, want, a.size)


def test_device_resolution():
    a = np.zeros((4, 4), np.uint8)
    t = torch.zeros((4, 4), dtype=torch.uint8)
    assert engine.resolve_device(None, t, t) == t.device
    assert engine.resolve_device("cpu", a, a) == torch.device("cpu")
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert engine.resolve_device(None, a, a).type == want


def test_explicit_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    a = np.zeros((4, 4), np.uint8)
    with pytest.raises(UnsupportedError):
        ssim_tpu_torch.compute_ssim(a, a, device="cuda")
