"""The port's batch data parallelism (ssim_tpu_torch.parallel.batch)
against the JAX package's (ssim_tpu.parallel.batch), on the same NumPy
inputs.

One module-scoped spawn of 4 gloo ranks, each a subprocess (JAX's threads
rule out fork), the process group set up with a `file://` store in a
temporary directory. Every rank runs every case through
`ssim_batch_sharded` and `mean_ssim_sharded` on a `cpu` DeviceMesh (the
kernels' plain twins, by the tensors' device) and writes its results as
.npy files: u8 and f32 batches of small images (the batch route) and of
wider ones (the tile grid), with and without the map, impl="torch", the
custom windows of tests/test_distributed.py:361-380, DTensor inputs from
`multihost.distribute_batch`, and the argument errors. Every rank's
result must equal rank 0's (the maps' local blocks are each rank's own).
In this process the JAX functions run on the conftest's CPU devices with
impl="xla", and per-image `compute_ssim(impl="xla")` beside them.

Tolerances: per-image scores and maps at torch_port_util's port-against-
JAX tier (2e-7 global, never tighter than twice the per-pixel bound over
sqrt(npix); 1e-5 per pixel); means as in tests/test_torch_port_spatial.py
(1e-7 on the plain route, 1e-6 on the kernel route).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import JAX_PIXEL, assert_close

from ssim_tpu import compute_ssim as jax_compute_ssim
from ssim_tpu import engine as jax_engine
from ssim_tpu.parallel import (
    make_mesh as jax_make_mesh,
    mean_ssim_sharded as jax_mean_sharded,
    ssim_batch_sharded as jax_batch_sharded,
)
from ssim_tpu_torch.ops.routing import ssim_parts_auto

WORLD = 4
MEAN_PLAIN = 1e-7
MEAN_KERNEL = 1e-6

_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        world_size=world, rank=rank)
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from ssim_tpu_torch.errors import UnsupportedError
from ssim_tpu_torch.ops import ssim_cuda
from ssim_tpu_torch.parallel import (
    make_mesh, mean_ssim_sharded, multihost, ssim_batch_sharded)

inp = dict(np.load(os.path.join(out, "inputs.npz")))

def save(name, x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    np.save(os.path.join(out, f"{name}.{rank}.npy"), np.asarray(x))

def raises(fn, exc, match):
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False

mesh = make_mesh((world,), ("data",), device_type="cpu")
for key in ("u8_small", "u8_wide", "f32_small", "f32_wide"):
    a, b = inp[f"{key}_a"], inp[f"{key}_b"]
    dr = 1.0 if key.startswith("f32") else 255.0
    parts, none = ssim_batch_sharded(a, b, mesh, data_range=dr)
    assert none is None
    save(f"{key}_parts", parts)
    save(f"{key}_mean", mean_ssim_sharded(a, b, mesh, data_range=dr))
    parts, smap = ssim_batch_sharded(torch.from_numpy(a), torch.from_numpy(b), mesh,
                                     with_map=True, data_range=dr)
    assert isinstance(smap, DTensor) and tuple(smap.shape) == a.shape, smap.shape
    save(f"{key}_map_parts", parts)
    save(f"local_{key}_map", smap.to_local())
    save(f"{key}_map_full", smap.full_tensor())

a, b = inp["u8_small_a"], inp["u8_small_b"]
parts, smap = ssim_batch_sharded(a, b, mesh, with_map=True, impl="torch")
save("torch_parts", parts); save("torch_map", smap.full_tensor())
save("torch_mean", mean_ssim_sharded(a, b, mesh, impl="torch"))
for name, win in (("custom", dict(sigma=2.0, k1=0.02, k2=0.05)), ("r3", dict(radius=3)),
                  ("r17", dict(radius=17, sigma=3.0))):
    save(f"{name}_mean", mean_ssim_sharded(a, b, mesh, **win))
    save(f"{name}_parts", ssim_batch_sharded(a, b, mesh, **win)[0])

# DTensor input: each rank holds only its own images.
bd = a.shape[0] // world
da = multihost.distribute_batch(a[rank * bd:(rank + 1) * bd], mesh)
db = multihost.distribute_batch(torch.from_numpy(b[rank * bd:(rank + 1) * bd]), mesh)
assert tuple(da.shape) == a.shape, da.shape
save("dtensor_mean", mean_ssim_sharded(da, db, mesh))
parts, smap = ssim_batch_sharded(da, db, mesh, with_map=True)
save("dtensor_parts", parts); save("dtensor_map", smap.full_tensor())
save("cpu_launches", np.array([ssim_cuda.LAUNCHES, ssim_cuda.BATCH_LAUNCHES,
                               ssim_cuda.STREAM_LAUNCHES]))

odd_a, odd_b = inp["odd_a"], inp["odd_b"]
rep = DTensor.from_local(torch.from_numpy(a), mesh, [Replicate()], run_check=False)
part = DTensor.from_local(torch.from_numpy(a), mesh, [Partial()], run_check=False)
other = DTensor.from_local(torch.from_numpy(a[:bd]),
                           make_mesh((world,), ("images",), device_type="cpu"), [Shard(0)],
                           run_check=False)
save("errors", np.array([
    raises(lambda: mean_ssim_sharded(odd_a, odd_b, mesh), ValueError, "must divide"),
    raises(lambda: ssim_batch_sharded(odd_a, odd_b, mesh), ValueError, "must divide"),
    raises(lambda: ssim_batch_sharded(a[0], b[0], mesh), ValueError, "(B, H, W)"),
    raises(lambda: ssim_batch_sharded(a, b[:, :-1], mesh), ValueError, "(B, H, W)"),
    raises(lambda: mean_ssim_sharded(rep, rep, mesh), ValueError, "split on dim 0"),
    raises(lambda: mean_ssim_sharded(part, part, mesh), ValueError, "Shard or Replicate"),
    raises(lambda: mean_ssim_sharded(other, other, mesh), ValueError, "another mesh"),
    raises(lambda: mean_ssim_sharded(a, b, mesh, axis="rows"), ValueError, "no axis"),
    raises(lambda: mean_ssim_sharded(a, b, mesh, sigma=-1.0), ValueError, "sigma"),
    raises(lambda: mean_ssim_sharded(a, b, mesh, impl="reference"), UnsupportedError,
           "'torch'"),
]))
# Every rank's collectives done and its results on disk; exit at once,
# skipping the gloo teardown at interpreter exit, which aborted once.
dist.barrier()
sys.stdout.flush(); sys.stderr.flush()
os._exit(0)
"""


def _u8_batch(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.normal(0, 12, shape).astype(np.int32)
    return a, np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def _f32_batch(rng, shape):
    a = rng.random(shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.06, shape), 0, 1).astype(np.float32)


# (key, shape, route of each rank's block): 2 images of 48x64 and 32x32
# a rank pack on the batch route; 200 and 210 columns are past PACK_MAX_W.
CASES = {
    "u8_small": ((8, 48, 64), _u8_batch),
    "u8_wide": ((8, 40, 200), _u8_batch),
    "f32_small": ((8, 32, 32), _f32_batch),
    "f32_wide": ((4, 36, 210), _f32_batch),
}


def _inputs():
    rng = np.random.default_rng(0xBA7C)
    x = {}
    for key, (shape, make) in CASES.items():
        x[f"{key}_a"], x[f"{key}_b"] = make(rng, shape)
    x["odd_a"], x["odd_b"] = _u8_batch(rng, (6, 24, 32))
    return x


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4 gloo ranks; returns (inputs, load(name) -> rank 0's result,
    local(name) -> every rank's), having checked that every rank's
    results (but the maps' local blocks) equal rank 0's."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("gloo_batch")
    inputs = _inputs()
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(out), str(rank), str(WORLD)],
                         cwd=repo, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for rank in range(WORLD)
    ]
    failures = []
    for rank, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"gloo rank {rank} timed out")
        if p.returncode != 0:
            failures.append(f"rank {rank} (rc {p.returncode}): {err[-3000:]}")
    assert not failures, "\n".join(failures)
    names = sorted({f.name.rsplit(".", 2)[0] for f in out.glob("*.0.npy")})
    assert names, "no results from the gloo ranks"
    for name in names:
        if name.startswith("local_"):
            continue
        r0 = np.load(out / f"{name}.0.npy")
        for rank in range(1, WORLD):
            np.testing.assert_array_equal(np.load(out / f"{name}.{rank}.npy"), r0,
                                          err_msg=f"{name}: rank {rank} != rank 0")

    def load(name):
        return np.load(out / f"{name}.0.npy")

    def local(name):
        return [np.load(out / f"{name}.{rank}.npy") for rank in range(WORLD)]

    return inputs, load, local


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh((WORLD,), ("data",))


def _per_image(a, b, **kw):
    return np.array([jax_compute_ssim(a[i], b[i], impl="xla", **kw)
                     for i in range(a.shape[0])])


@pytest.mark.parametrize("key", list(CASES))
def test_batch_sharded_matches_jax(ranks, jax_mesh, key):
    """Per-image scores (the port's partials finalized: (B, 2) on the batch
    route, per-tile on the tile grid, JAX's per-row) and the gathered map
    against JAX's ssim_batch_sharded and per-image compute_ssim."""
    inputs, load, _ = ranks
    a, b = inputs[f"{key}_a"], inputs[f"{key}_b"]
    dr = 1.0 if key.startswith("f32") else 255.0
    npix = a.shape[1] * a.shape[2]
    j_parts, j_map = jax_batch_sharded(a, b, jax_mesh, with_map=True, impl="xla",
                                       data_range=dr)
    want = jax_engine.finalize_mean(np.asarray(j_parts), npix)
    for name in (f"{key}_parts", f"{key}_map_parts"):
        got = load(name)
        assert got.shape[0] == a.shape[0] and got.dtype == np.float32
        assert_close(jax_engine.finalize_mean(got, npix), want, npix)
    assert_close(jax_engine.finalize_mean(load(f"{key}_parts"), npix),
                 _per_image(a, b, data_range=dr), npix)
    full = load(f"{key}_map_full")
    assert full.shape == a.shape
    assert np.abs(full - np.asarray(j_map)).max() <= JAX_PIXEL


def test_blocks_take_the_single_device_route(ranks):
    """Each rank's block of the partials is, bit for bit, the single-device
    route's on that block (ops/routing.ssim_parts_auto, here its twins):
    (B, 2) [sum(ssim - 1), H*W] per image on the batch route, per-tile sums
    on the tile grid, and the tile grid with the map. No kernel launch is
    counted on CPU tensors."""
    inputs, load, _ = ranks
    for key in CASES:
        a, b = inputs[f"{key}_a"], inputs[f"{key}_b"]
        dr = 1.0 if key.startswith("f32") else 255.0
        bd = a.shape[0] // WORLD
        for name, with_map in ((f"{key}_parts", False), (f"{key}_map_parts", True)):
            want = [ssim_parts_auto(torch.from_numpy(a[r * bd:(r + 1) * bd]),
                                    torch.from_numpy(b[r * bd:(r + 1) * bd]),
                                    with_map=with_map, data_range=dr)[0].numpy()
                    for r in range(WORLD)]
            np.testing.assert_array_equal(load(name), np.concatenate(want), err_msg=name)
    for key in ("u8_small", "f32_small"):
        h, w = inputs[f"{key}_a"].shape[1:]
        parts = load(f"{key}_parts")
        assert parts.shape[1] == 2
        np.testing.assert_array_equal(parts[:, 1], np.float32(h * w))
    np.testing.assert_array_equal(load("cpu_launches"), [0, 0, 0])


@pytest.mark.parametrize("key", list(CASES))
def test_map_stays_sharded(ranks, key):
    """The map is a DTensor split on dim 0: each rank's local block is its
    own images' map, and the blocks in rank order are the global map."""
    inputs, load, local = ranks
    a = inputs[f"{key}_a"]
    blocks = local(f"local_{key}_map")
    bd = a.shape[0] // WORLD
    assert all(x.shape == (bd,) + a.shape[1:] for x in blocks)
    np.testing.assert_array_equal(np.concatenate(blocks), load(f"{key}_map_full"))


@pytest.mark.parametrize("key", list(CASES))
def test_mean_sharded_matches_jax(ranks, jax_mesh, key):
    """The all-reduced mean against JAX's mean_ssim_sharded (psum) and the
    mean of per-image compute_ssim; a 0-d f32 on every rank."""
    inputs, load, _ = ranks
    a, b = inputs[f"{key}_a"], inputs[f"{key}_b"]
    dr = 1.0 if key.startswith("f32") else 255.0
    got = load(f"{key}_mean")
    assert got.shape == () and got.dtype == np.float32
    want = float(jax_mean_sharded(a, b, jax_mesh, impl="xla", data_range=dr))
    assert abs(float(got) - want) <= MEAN_KERNEL
    assert abs(float(got) - np.mean(_per_image(a, b, data_range=dr))) <= MEAN_KERNEL


def test_plain_route_matches_jax(ranks, jax_mesh):
    """impl="torch" (ssim_parts_torch per rank): per-row partials, the map
    and the mean against JAX's XLA route."""
    inputs, load, _ = ranks
    a, b = inputs["u8_small_a"], inputs["u8_small_b"]
    j_parts, j_map = jax_batch_sharded(a, b, jax_mesh, with_map=True, impl="xla")
    parts = load("torch_parts")
    assert parts.shape == np.asarray(j_parts).shape
    assert np.abs(parts.astype(np.float64) - np.asarray(j_parts)).max() \
        <= JAX_PIXEL * a.shape[2]
    assert np.abs(load("torch_map") - np.asarray(j_map)).max() <= JAX_PIXEL
    want = np.mean(_per_image(a, b))
    assert abs(float(load("torch_mean")) - want) <= MEAN_PLAIN


@pytest.mark.parametrize("name,win,tol", [
    ("custom", dict(sigma=2.0, k1=0.02, k2=0.05), MEAN_KERNEL),
    ("r3", dict(radius=3), MEAN_KERNEL),
    ("r17", dict(radius=17, sigma=3.0), MEAN_PLAIN),
])
def test_custom_window(ranks, jax_mesh, name, win, tol):
    """The custom-window extension through the batch layer
    (tests/test_distributed.py:361-380): sigma/k1/k2 and radius 3 on the
    kernels' routes, radius 17 on the plain path."""
    inputs, load, _ = ranks
    a, b = inputs["u8_small_a"], inputs["u8_small_b"]
    want = _per_image(a, b, **win)
    npix = a.shape[1] * a.shape[2]
    assert abs(float(load(f"{name}_mean")) - np.mean(want)) <= tol
    assert abs(float(load(f"{name}_mean"))
               - float(jax_mean_sharded(a, b, jax_mesh, impl="xla", **win))) <= MEAN_KERNEL
    assert_close(jax_engine.finalize_mean(load(f"{name}_parts"), npix), want, npix)


def test_dtensor_input(ranks):
    """distribute_batch of each rank's own images: the same partials, map
    and mean as the whole batch on every rank, bit for bit."""
    _, load, _ = ranks
    np.testing.assert_array_equal(load("dtensor_parts"), load("u8_small_map_parts"))
    np.testing.assert_array_equal(load("dtensor_map"), load("u8_small_map_full"))
    assert float(load("dtensor_mean")) == float(load("u8_small_mean"))


def test_batch_argument_errors(ranks):
    """B not divisible by the axis, non-(B, H, W) or mismatched pairs, a
    DTensor not split on dim 0, a partial-sum DTensor, one on another mesh,
    an unknown axis, a bad window and an impl the layer does not run all
    raise."""
    _, load, _ = ranks
    assert load("errors").all(), load("errors")


def test_parallel_exports_every_jax_name():
    """ssim_tpu_torch.parallel exports every name of ssim_tpu.parallel."""
    import ssim_tpu.parallel
    import ssim_tpu_torch.parallel

    assert set(ssim_tpu.parallel.__all__) <= set(ssim_tpu_torch.parallel.__all__)
    for name in ssim_tpu.parallel.__all__:
        assert hasattr(ssim_tpu_torch.parallel, name), name
