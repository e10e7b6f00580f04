"""The small-image batch route of ssim_tpu_torch against the JAX package's,
on the same NumPy inputs.

The JAX package sends a (B, h, w) batch of small images to its lane-packed
path, `ssim_parts_pallas_bpacked` (K1e), which returns one partial pair per
image; `tools/probe_bpack.py::bpack_parts` (K5) computes the same per-image
sums. The port's router takes the same batches (the same gate) to the
forward kernel's batch modes, `ssim_parts_batch_cuda`. On the CPU the
wrapper runs the modes' plain twin and the Pallas kernels run in interpret
mode; tests/test_torch_port_cuda.py holds the kernel against the twin on a
card.

Tolerances: per-image scores within max(2e-6, 3e-3 / sqrt(h*w)) of the
JAX packed path and of the f64 oracle, the bounds of tests/test_bpacked.py
(its blurs run as matrix products, ours as tap pairs); the precise tier
within 5e-9 of the oracle (torch_port_util), looser by the pixel count
only below 64 pixels; the routes of one package against each other
within 2e-7 (the same pixels, other orders of the sums).
"""

import ast
import errno
import os

import numpy as np
import pytest
import torch

from conftest import random_pair
from torch_port_util import PRECISE_GLOBAL, PRECISE_PIXEL, float_pair, global_tol

import ssim_tpu_torch
from ssim_tpu import reference
from ssim_tpu.ops import ssim_pallas as jax_pallas
from ssim_tpu.ops.routing import ssim_parts_auto as jax_parts_auto
from ssim_tpu_torch import engine
from ssim_tpu_torch.config import Config, get_config, set_config
from ssim_tpu_torch.errors import InvalidArgumentError
from ssim_tpu_torch.ops import routing, ssim_cuda
from ssim_tpu_torch.ops.routing import ssim_parts_auto
from ssim_tpu_torch.ops.ssim_cuda import ssim_parts_batch_cuda
from ssim_tpu_torch.ops.ssim_torch import ssim_parts_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twin runs many small elementwise passes; with one intra-op
    thread per test worker they do not contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _batch(seed, batch, h, w):
    """A seeded correlated u8 batch pair."""
    rng = np.random.default_rng(seed)
    pairs = [random_pair(rng, h, w) for _ in range(batch)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _port(a, b, **kw):
    return ssim_parts_batch_cuda(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()


def _scores(parts, npix):
    return np.asarray(parts, np.float64).sum(axis=-1) / npix


def _packed_tol(npix):
    return max(2e-6, 3e-3 / npix**0.5)


def _oracle(a, b, **kw):
    return np.array([reference.compute_ssim(x, y, **kw)[0] for x, y in zip(a, b)])


def _check_pairs(parts, batch, h, w, dtype=np.float32):
    assert parts.shape == (batch, 2) and parts.dtype == dtype
    np.testing.assert_array_equal(parts[:, 1], np.full(batch, h * w, dtype))


@pytest.fixture
def spies(monkeypatch):
    """Counts the calls of the port's batch wrapper and tile wrapper (as
    the router reaches them) and of the JAX package's packed path."""
    calls = {"port_batch": 0, "port_tile": 0, "jax_packed": 0}

    def spy(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(routing, "ssim_parts_batch_cuda",
                        spy("port_batch", routing.ssim_parts_batch_cuda))
    monkeypatch.setattr(routing, "ssim_parts_cuda",
                        spy("port_tile", routing.ssim_parts_cuda))
    monkeypatch.setattr(jax_pallas, "ssim_parts_pallas_bpacked",
                        spy("jax_packed", jax_pallas.ssim_parts_pallas_bpacked))
    return calls


@pytest.fixture
def restore_config():
    old = get_config()
    yield
    set_config(old)


@pytest.mark.parametrize("itemsize", [1, 4])
def test_gate_copies_equal_jax(itemsize):
    for w in range(1, 301):
        for batch in (1, 2, 3, 4, 5, 7, 8, 16, 31, 64, 100, 512, 1024, 4096, 8192):
            assert ssim_cuda.bpack_count(w, batch, itemsize) == jax_pallas.bpack_count(
                w, batch, itemsize), (w, batch)
            assert ssim_cuda.pack_preferred(w, batch, itemsize) == jax_pallas.pack_preferred(
                w, batch, itemsize=itemsize), (w, batch)


@pytest.mark.parametrize(
    "batch,shape",
    [(4, (64, 64)), (3, (33, 47)), (2, (30, 200)), (5, (11, 11)), (3, (50, 1))],
)
def test_twin_matches_bpacked(batch, shape):
    """The JAX package's packed-path test shapes (tests/test_bpacked.py)."""
    h, w = shape
    a, b = _batch(0x60, batch, h, w)
    parts = _port(a, b)
    _check_pairs(parts, batch, h, w)
    got = _scores(parts, h * w)
    want = _scores(jax_pallas.ssim_parts_pallas_bpacked(a, b, interpret=True), h * w)
    tol = _packed_tol(h * w)
    assert np.abs(got - want).max() < tol
    assert np.abs(got - _oracle(a, b)).max() < tol


def test_remainder_batch_matches_bpacked():
    """B not a multiple of the JAX pack count (p = 2 at w = 2048): the port
    has no padding slots, and every image keeps its score."""
    h, w, batch = 16, 2048, 5
    assert ssim_cuda.bpack_count(w, batch) == 2
    a, b = _batch(0x61, batch, h, w)
    parts = _port(a, b)
    _check_pairs(parts, batch, h, w)
    want = _scores(jax_pallas.ssim_parts_pallas_bpacked(a, b, interpret=True), h * w)
    assert np.abs(_scores(parts, h * w) - want).max() < 2e-6
    assert np.abs(_scores(parts, h * w) - _oracle(a, b)).max() < 2e-6


@pytest.mark.parametrize("precise", [False, True])
def test_identical_pairs_sum_to_zero(precise):
    a, _ = _batch(0x62, 5, 32, 32)
    parts = _port(a, a.copy(), precise=precise)
    np.testing.assert_array_equal(parts[:, 0], np.zeros(5))
    np.testing.assert_array_equal(engine.finalize_mean(parts, 32 * 32), np.ones(5))


@pytest.mark.parametrize("radius,sigma,k1,k2,relaxed", [
    (1, 0.8, 0.02, 0.05, False), (3, 0.9, 0.02, 0.05, False), (8, 2.5, 0.01, 0.03, False),
    (16, 3.0, 0.015, 0.04, False), (9, 2.5, 0.01, 0.03, True)])
def test_custom_window_matches_bpacked(radius, sigma, k1, k2, relaxed):
    """A custom window on the batch route (the packed row stream at every
    radius; relaxed: its heavy blurs as band products) against the JAX
    packed path in the same tier: per-image scores within 2e-6; against
    the f64 oracle within 2e-6 (relaxed: 1e-4, the tier's envelope)."""
    h, w, batch = 40, 96, 3
    a, b = _batch(0x63 + radius, batch, h, w)
    window = dict(radius=radius, sigma=sigma, k1=k1, k2=k2)
    got = _scores(_port(a, b, relaxed=relaxed, **window), h * w)
    want = _scores(jax_pallas.ssim_parts_pallas_bpacked(a, b, interpret=True,
                                                        relaxed=relaxed, **window), h * w)
    assert np.abs(got - want).max() < 2e-6
    assert np.abs(got - _oracle(a, b, **window)).max() < (1e-4 if relaxed else 2e-6)


@pytest.mark.parametrize("precise", [False, True])
def test_nonfinite_pixel_reaches_only_its_image(precise):
    batch, h, w = 4, 48, 64
    a, b = float_pair(np.random.default_rng(0x64), (batch, h, w))
    a[2, 10, 20] = np.nan
    a[0, 47, 63] = np.inf
    parts = _port(a, b, data_range=1.0, allow_float=True, precise=precise)
    _check_pairs(parts, batch, h, w, np.float64 if precise else np.float32)
    got = _scores(parts, h * w)
    assert np.isnan(got[[0, 2]]).all() and np.isfinite(got[[1, 3]]).all()
    for i in (1, 3):
        alone = _port(a[i:i + 1], b[i:i + 1], data_range=1.0, allow_float=True,
                      precise=precise)
        assert _scores(alone, h * w)[0] == got[i]
    want = _scores(jax_pallas.ssim_parts_pallas_bpacked(
        a, b, data_range=1.0, interpret=True, allow_float=True), h * w)
    assert np.isnan(want[[0, 2]]).all()
    assert np.abs(got[[1, 3]] - want[[1, 3]]).max() < 2e-6


@pytest.mark.parametrize("shape", [(3, 64, 64), (3, 37, 100), (5, 7, 5)])
def test_precise_matches_oracle(shape):
    batch, h, w = shape
    a, b = _batch(0x65, batch, h, w)
    parts = _port(a, b, precise=True)
    _check_pairs(parts, batch, h, w, np.float64)
    npix = h * w
    # A score is a mean of pixels: below 64 pixels it is no more accurate
    # than one (the rule of tests/test_pallas.py::_check).
    tol = global_tol(PRECISE_GLOBAL, PRECISE_PIXEL, npix) if npix < 64 else PRECISE_GLOBAL
    assert np.abs(_scores(parts, npix) - _oracle(a, b)).max() <= tol
    std = _scores(_port(a, b), npix)
    assert np.abs(_scores(parts, npix) - std).max() < 2e-7


def _load_k5():
    """tools/probe_bpack.py's kernel (K5) without running the probe: the
    module runs its probes at import, so only its imports and the two
    functions of the kernel are executed."""
    path = os.path.join(ROOT, "tools", "probe_bpack.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom))
            or (isinstance(n, ast.FunctionDef)
                and n.name in ("hpass_clamped_matrix", "bpack_parts"))]
    namespace = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), namespace)
    return namespace["bpack_parts"]


def test_twin_matches_k5_bpack_parts():
    """K5's (B,) sum(ssim - 1) + h*w is the batch mode's parts[:, 0] +
    parts[:, 1] (radius 5, sigma 1.5, data_range 255)."""
    h, w = 40, 48
    a, b = _batch(0x66, 4, h, w)
    k5 = np.asarray(_load_k5()(a, b, 2, 32, interpret=True), np.float64)
    parts = _port(a, b)
    assert np.abs(_scores(parts, h * w) - k5 / (h * w)).max() < 2e-6


@pytest.mark.parametrize("kind", ["u8", "f32", "u8 precise"])
def test_auto_route_matches_jax(spies, kind):
    """A batch both routers send to their batch routes: one partial pair
    per image from each, the same scores."""
    precise = kind.endswith("precise")
    if kind == "f32":
        a, b = float_pair(np.random.default_rng(0x67), (6, 33, 47))
        data_range = 1.0
    else:
        a, b = _batch(0x67, 8, 40, 64)
        data_range = 255.0
    npix = a.shape[1] * a.shape[2]
    pt, mt = ssim_parts_auto(torch.from_numpy(a), torch.from_numpy(b),
                             data_range=data_range, precise=precise)
    pj, mj = jax_parts_auto(a, b, data_range=data_range, precise=precise,
                            interpret=True)
    assert mt is None and mj is None
    assert tuple(pt.shape) == (a.shape[0], 2)
    assert pt.dtype == (torch.float64 if precise else torch.float32)
    assert spies == {"port_batch": 1, "port_tile": 0, "jax_packed": 1}
    got, want = _scores(pt.numpy(), npix), _scores(pj, npix)
    assert np.abs(got - want).max() < _packed_tol(npix)
    if precise:
        assert np.abs(got - _oracle(a, b)).max() <= PRECISE_GLOBAL


@pytest.mark.parametrize("case", ["map", "single image", "w 193", "tile pin"])
def test_tile_path_cases_match_jax(spies, case):
    """What the JAX gate keeps off its packed path stays on the tile grid
    in both packages."""
    shape = {"single image": (1, 20, 30), "w 193": (2, 10, 193)}.get(case, (4, 20, 30))
    a, b = _batch(0x68, *shape)
    with_map = case == "map"
    pins = case == "tile pin"
    pt, mt = ssim_parts_auto(torch.from_numpy(a), torch.from_numpy(b),
                             with_map=with_map, **(dict(tile_h=32, tile_w=64) if pins else {}))
    pj, mj = jax_parts_auto(a, b, with_map=with_map, interpret=True,
                            **(dict(max_tile_h=32) if pins else {}))
    assert spies == {"port_batch": 0, "port_tile": 1, "jax_packed": 0}
    npix = shape[1] * shape[2]
    got, want = _scores(pt.numpy(), npix), _scores(pj, npix)
    assert np.abs(got - want).max() <= global_tol(2e-7, 1e-5, npix)
    assert (mt is None) == (mj is None) == (not with_map)


def test_gate_refuses_2_24_pixels():
    """The count rides as an exact f32: h*w < 2^24, held by the gate alone
    (the twin would take gigabytes at that size)."""
    gate = dict(with_map=False, data_range=255.0, tile_kwargs={})
    assert routing.batch_routable((2, (1 << 24) // 128 - 1, 128), itemsize=1, **gate)
    assert not routing.batch_routable((2, (1 << 24) // 128, 128), itemsize=1, **gate)
    assert not routing.batch_routable((2, 64, 64), itemsize=1,
                                      **dict(gate, data_range=1e-7))
    assert not routing.batch_routable((64, 64), itemsize=1, **gate)


def test_engine_compute_takes_the_batch_route(spies):
    a, b = float_pair(np.random.default_rng(0x69), (8, 40, 64))
    got, m = engine.compute(a, b, data_range=1.0, device="cpu")
    assert m is None and got.shape == (8,)
    assert spies == {"port_batch": 1, "port_tile": 0, "jax_packed": 0}
    tile, _ = engine.compute(a, b, data_range=1.0, device="cpu", with_map=True)
    assert np.abs(got - tile).max() <= 2e-7
    assert np.abs(got - _oracle(a, b, data_range=1.0)).max() <= 2e-6


def test_ssim_loss_on_a_routed_batch(spies):
    """ssim_loss's forward takes the batch route and its gradient the
    backward kernel's twin: value and gradient against autograd of the
    plain path."""
    a, b = float_pair(np.random.default_rng(0x6A), (8, 40, 64))
    x = torch.from_numpy(a).requires_grad_()
    loss = ssim_tpu_torch.ssim_loss(x, torch.from_numpy(b))
    loss.backward()
    assert spies["port_batch"] == 1
    xt = torch.from_numpy(a).requires_grad_()
    parts, _ = ssim_parts_torch(xt, torch.from_numpy(b), data_range=1.0)
    want = 1.0 - (parts.double().sum(-1) / (40 * 64)).mean()
    want.backward()
    assert abs(loss.item() - want.item()) <= 2e-6
    scale = max(1.0, xt.grad.abs().max().item())
    assert (x.grad - xt.grad).abs().max().item() <= 2e-5 * scale


def test_out_of_range_tile_settings_compute(monkeypatch, restore_config):
    """Settings the JAX engine accepts compute in the port too: clamped
    into the kernel's range, the same score as with no setting."""
    a, b = random_pair(np.random.default_rng(0x6B), 70, 300)
    want = ssim_tpu_torch.compute_ssim(a, b, device="cpu")
    monkeypatch.setenv("SSIM_TPU_TORCH_TILE_H", "1000")
    monkeypatch.setenv("SSIM_TPU_TORCH_TILE_W", "100")
    set_config(Config.from_env())
    got = ssim_tpu_torch.compute_ssim(a, b, device="cpu")
    assert abs(float(got) - float(want)) <= 2e-7
    legacy = ssim_tpu_torch.compute_ssim_legacy(a, b, device="cpu")
    assert abs(legacy - float(want)) <= 2e-7


@pytest.mark.parametrize("setting", [dict(max_tile_h=0), dict(max_tile_w=-3)])
def test_tile_setting_below_one_is_invalid(restore_config, setting):
    a, b = random_pair(np.random.default_rng(0x6C), 20, 30)
    set_config(Config(**setting))
    with pytest.raises(InvalidArgumentError):
        engine.compute(a, b, device="cpu")
    assert ssim_tpu_torch.compute_ssim_legacy(a, b, device="cpu") == -float(errno.EINVAL)


def test_tile_setting_keeps_a_batch_on_the_tile_grid(spies, restore_config):
    a, b = _batch(0x6D, 8, 40, 64)
    want, _ = engine.compute(a, b, device="cpu")
    set_config(Config(max_tile_w=64))
    got, _ = engine.compute(a, b, device="cpu")
    assert spies == {"port_batch": 1, "port_tile": 1, "jax_packed": 0}
    assert np.abs(got - want).max() <= 2e-7


@pytest.mark.parametrize(
    "setting,radius,want",
    [((1000, 100), 5, (128, 64)), ((1, 1), 5, (32, 32)), ((None, 256), 5, (32, 128)),
     ((256, 256), 16, (32, 128)), ((None, None), 16, (32, 64)), ((70, 33), 1, (64, 32))],
)
def test_fit_tile(setting, radius, want):
    got = ssim_cuda.fit_tile(*setting, radius)
    assert got == want
    ssim_cuda._check_tile(*got, radius)


@pytest.mark.parametrize(
    "shape",
    [(8192, 32, 32), (4096, 64, 64), (1024, 128, 128), (512, 192, 192),
     (2, 8192, 64), (5, 11, 11), (3, 50, 1), (5, 16, 2048), (1, 1, 1)],
)
def test_batch_geometry(shape):
    """Every tile of every image is walked once, and the tile fits in
    shared memory at every radius the kernel takes."""
    batch, h, w = shape
    tile_h, tile_w, ipb, groups = ssim_cuda.batch_geometry(*shape)
    assert tile_w in (8, 16, 32, 64) and (tile_w >= w or tile_w == 64)
    assert 1 <= tile_h <= h and ipb >= 1 and groups >= 1 and min(ipb, groups) == 1
    assert ssim_cuda.smem_bytes(tile_h, tile_w, 16) <= ssim_cuda._MAX_DYNAMIC_SMEM
    assert (ssim_cuda.smem_bytes(tile_h, tile_w, 16, precise=True)
            <= ssim_cuda._MAX_DYNAMIC_SMEM)
    nty, ntx = ssim_cuda.tile_grid(h, w, tile_h, tile_w)
    tiles = nty * ntx
    # The kernel's runs: tiles [g * tiles // groups, (g + 1) * tiles // groups).
    runs = [(g + 1) * tiles // groups - g * tiles // groups for g in range(groups)]
    assert sum(runs) == tiles and min(runs) >= 1
    assert max(runs) <= ssim_cuda._BATCH_MAX_RUN or groups == 1
    assert -(-batch // ipb) * ipb >= batch


def test_wrapper_guards():
    u8 = torch.zeros((2, 8, 8), dtype=torch.uint8)
    for kw in (dict(radius=0), dict(radius=17), dict(data_range=1e-7),
               dict(data_range=1.0, k1=1e-9, k2=1e-9)):
        with pytest.raises(ValueError):
            ssim_parts_batch_cuda(u8, u8, **kw)
    with pytest.raises(ValueError):
        ssim_parts_batch_cuda(u8[0], u8[0])  # not a batch
    big = torch.zeros((1, 4096, 4096), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ssim_parts_batch_cuda(big, big)  # h*w = 2^24
    with pytest.raises(ValueError):
        ssim_parts_batch_cuda(u8.float(), u8.float())  # float needs allow_float
    meta = torch.empty((2, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        ssim_parts_batch_cuda(meta, meta)


def test_cpu_twin_counts_no_launch():
    a, b = _batch(0x6E, 3, 12, 12)
    before = (ssim_cuda.BATCH_LAUNCHES, ssim_cuda.BATCH_PRECISE_LAUNCHES)
    _port(a, b)
    _port(a, b, precise=True)
    assert (ssim_cuda.BATCH_LAUNCHES, ssim_cuda.BATCH_PRECISE_LAUNCHES) == before
