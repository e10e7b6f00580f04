"""The port's multi-process layer (ssim_tpu_torch.parallel.multihost)
against the JAX package, case by case with tests/test_multihost.py.

Two processes join one gloo group through
`multihost.initialize("localhost:<port>", 2, pid, device="cpu")` (a free
port picked here, as tests/test_multihost.py does), one rank each, and run
every case; each writes its results as .npy files and this process holds
them against the JAX functions on the same NumPy inputs:

- the mean over `distribute_batch` halves (each process holds its own 4
  images, seeds 1000 + pid), on the kernel route and the plain one;
- the "every process must own part of the mesh" and "need n ranks" errors;
- `ssim_spatial_sharded` of one (96, 64) image from process-local rows (a
  DTensor split on the rows, as JAX's `make_array_from_process_local_data`
  with `P("space", None)`), on the kernel route and the plain one;
- `ssim_grad_spatial_sharded` of a (160, 64) pair from process-local rows,
  within 3e-5 x max|g| of jax.grad of the unsharded XLA formulation.

Beside them, the port's own cases for DTensor inputs to the spatial
functions: rows that are the band (no gather) and rows thinner than the
radius (gathered first) give the whole-tensor call's outputs bit for bit,
and `mean_ssim_spatial`'s gradient reaches a DTensor as one whose local
block is that rank's rows of the whole-tensor gradient.

Tolerances: means as in tests/test_torch_port_spatial.py (1e-7 plain,
1e-6 kernel route and f32 pairs), gradients 3e-5 x max|g|
(tests/test_multihost.py).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssim_tpu import compute_ssim as jax_compute_ssim
from ssim_tpu.ops.ssim_xla import ssim_parts_xla

MEAN_PLAIN = 1e-7
MEAN_KERNEL = 1e-6
GRAD_REL = 3e-5

_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
out, port, pid = sys.argv[1], sys.argv[2], int(sys.argv[3])
from torch.distributed.tensor import DTensor, Shard
from ssim_tpu_torch.parallel import (
    mean_ssim_sharded, mean_ssim_spatial, multihost, ssim_batch_sharded,
    ssim_grad_spatial_sharded, ssim_spatial_sharded)

multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid, device="cpu")
multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid, device="cpu")
assert dist.get_world_size() == 2 and dist.get_rank() == pid

def save(name, x):
    if isinstance(x, DTensor):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    np.save(os.path.join(out, f"{name}.{pid}.npy"), np.asarray(x))

def message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""

def rows_of(x, mesh, axis, dim=0):
    # This process's rows of a whole array, as a DTensor split on `dim`.
    n = x.shape[dim] // 2
    local = torch.from_numpy(np.ascontiguousarray(x.take(range(pid * n, (pid + 1) * n), dim)))
    return DTensor.from_local(local, mesh, [Shard(dim)], run_check=False)

mesh = multihost.global_mesh((2,), ("data",))
save("errors", np.array([
    "every process must own part of the mesh" in message(
        lambda: multihost.global_mesh((1,), ("data",))),
    "need 4 ranks" in message(lambda: multihost.global_mesh((4,), ("data",))),
]))

# Each process holds only ITS half of the batch.
rng = np.random.default_rng(1000 + pid)
a_local = rng.integers(0, 256, (4, 48, 64), dtype=np.uint8)
noise = rng.normal(0, 12, a_local.shape)
b_local = np.clip(a_local.astype(np.int32) + noise.astype(np.int32), 0, 255).astype(np.uint8)
a = multihost.distribute_batch(a_local, mesh)
b = multihost.distribute_batch(b_local, mesh)
assert tuple(a.shape) == (8, 48, 64), a.shape
for impl in ("auto", "torch"):
    save(f"batch_mean_{impl}", mean_ssim_sharded(a, b, mesh, impl=impl))
save("batch_parts", ssim_batch_sharded(a, b, mesh)[0])

space = multihost.global_mesh((2,), ("space",))
rng = np.random.default_rng(77)
a_full = rng.integers(0, 256, (96, 64), dtype=np.uint8)
noise = rng.normal(0, 12, a_full.shape)
b_full = np.clip(a_full.astype(np.int32) + noise.astype(np.int32), 0, 255).astype(np.uint8)
ad, bd = rows_of(a_full, space, "space"), rows_of(b_full, space, "space")
assert tuple(ad.shape) == (96, 64)
for impl in ("auto", "torch"):
    rows, smap = ssim_spatial_sharded(ad, bd, space, impl=impl, with_map=True)
    whole_rows, whole_map = ssim_spatial_sharded(a_full, b_full, space, impl=impl,
                                                 with_map=True)
    save(f"spatial_rows_{impl}", rows); save(f"spatial_map_{impl}", smap)
    save(f"spatial_same_{impl}", np.array([torch.equal(rows, whole_rows),
                                           torch.equal(smap, whole_map)]))
# Bands of 4 rows, thinner than the radius: the DTensor is gathered first.
thin = rows_of(a_full[:8], space, "space"), rows_of(b_full[:8], space, "space")
rows, _ = ssim_spatial_sharded(*thin, space)
save("thin_same", np.array([torch.equal(
    rows, ssim_spatial_sharded(a_full[:8], b_full[:8], space)[0])]))

h, w = 160, 64
rng = np.random.default_rng(78)
ga = rng.random((h, w)).astype(np.float32)
gb = np.clip(ga + rng.normal(0, 0.06, ga.shape), 0, 1).astype(np.float32)
da, db = ssim_grad_spatial_sharded(rows_of(ga, space, "space"), rows_of(gb, space, "space"),
                                   space, w_s=1.0 / (h * w), data_range=1.0)
save("grad_da", da); save("grad_db", db)
whole = ssim_grad_spatial_sharded(ga, gb, space, w_s=1.0 / (h * w), data_range=1.0)
save("grad_same", np.array([torch.equal(da, whole[0]), torch.equal(db, whole[1])]))

# mean_ssim_spatial on DTensor rows: the kernel route (bands of 80 rows),
# the plain route (bands of 8 rows, under 2r), a batch split on its rows.
for name, (x, y, dim) in {"mean_kernel": (ga, gb, 0), "mean_plain": (ga[:16], gb[:16], 0),
                          "mean_batch": (ga.reshape(2, 80, 64), gb.reshape(2, 80, 64), 1)}.items():
    xd = rows_of(x, space, "space", dim).requires_grad_()
    val = mean_ssim_spatial(xd, rows_of(y, space, "space", dim), space, data_range=1.0)
    (1.0 - val).backward()
    assert isinstance(xd.grad, DTensor) and xd.grad.placements == (Shard(dim),)
    xw = torch.from_numpy(x).requires_grad_()
    val_w = mean_ssim_spatial(xw, y, space, data_range=1.0)
    (1.0 - val_w).backward()
    save(f"{name}_val", val); save(f"{name}_val_whole", val_w)
    save(f"local_{name}_grad", xd.grad); save(f"{name}_grad_whole", xw.grad)
dist.barrier()
sys.stdout.flush(); sys.stderr.flush()
os._exit(0)
"""


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Run the two processes; returns load(name) -> process 0's result and
    local(name) -> both processes', having checked that both wrote the same
    results (but their local gradient blocks)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path_factory.mktemp("multihost")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ps = [subprocess.Popen([sys.executable, "-c", _WORKER, str(out), str(port), str(pid)],
                           cwd=repo, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
          for pid in (0, 1)]
    failures = []
    for pid, p in enumerate(ps):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in ps:
                q.kill()
            pytest.fail("multi-process run timed out")
        if p.returncode != 0:
            failures.append(f"process {pid} (rc {p.returncode}): {err[-3000:]}")
    assert not failures, "\n".join(failures)
    names = sorted({f.name.rsplit(".", 2)[0] for f in out.glob("*.0.npy")})
    assert names, "no results from the processes"
    for name in names:
        if not name.startswith("local_"):
            np.testing.assert_array_equal(np.load(out / f"{name}.1.npy"),
                                          np.load(out / f"{name}.0.npy"), err_msg=name)

    def load(name):
        return np.load(out / f"{name}.0.npy")

    def local(name):
        return [np.load(out / f"{name}.{pid}.npy") for pid in (0, 1)]

    return load, local


def _union_batch():
    a, b = [], []
    for pid in (0, 1):
        rng = np.random.default_rng(1000 + pid)
        a_local = rng.integers(0, 256, (4, 48, 64), dtype=np.uint8)
        noise = rng.normal(0, 12, a_local.shape)
        a.append(a_local)
        b.append(np.clip(a_local.astype(np.int32) + noise.astype(np.int32), 0, 255)
                 .astype(np.uint8))
    return np.concatenate(a), np.concatenate(b)


def _spatial_image():
    rng = np.random.default_rng(77)
    a = rng.integers(0, 256, (96, 64), dtype=np.uint8)
    noise = rng.normal(0, 12, a.shape)
    return a, np.clip(a.astype(np.int32) + noise.astype(np.int32), 0, 255).astype(np.uint8)


def _grad_pair():
    rng = np.random.default_rng(78)
    a = rng.random((160, 64)).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.06, a.shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("impl,tol", [("auto", MEAN_KERNEL), ("torch", MEAN_PLAIN)])
def test_two_process_mean_ssim(procs, impl, tol):
    """mean_ssim_sharded over distribute_batch halves (no process holds the
    global batch) against single-process JAX compute_ssim over the union
    batch (tests/test_multihost.py:99-132)."""
    load, _ = procs
    a, b = _union_batch()
    want = np.mean([jax_compute_ssim(a[i], b[i], impl="xla") for i in range(8)])
    got = load(f"batch_mean_{impl}")
    assert got.shape == () and got.dtype == np.float32
    assert abs(float(got) - want) <= tol


def test_two_process_batch_partials(procs):
    """ssim_batch_sharded on the distributed batch: the gathered per-image
    scores against JAX compute_ssim (2e-7 global tier, twice the 1e-5 pixel
    bound over sqrt(npix) at 48x64)."""
    from ssim_tpu import engine as jax_engine
    from torch_port_util import assert_close

    load, _ = procs
    a, b = _union_batch()
    want = np.array([jax_compute_ssim(a[i], b[i], impl="xla") for i in range(8)])
    assert_close(jax_engine.finalize_mean(load("batch_parts"), 48 * 64), want, 48 * 64)


def test_global_mesh_errors(procs):
    """A mesh that leaves a process out raises the targeted "every process"
    error (tests/test_multihost.py:39-44), one larger than the world "need
    n ranks"."""
    load, _ = procs
    assert load("errors").all(), load("errors")


@pytest.mark.parametrize("impl,tol", [("auto", MEAN_KERNEL), ("torch", MEAN_PLAIN)])
def test_two_process_spatial_sharded(procs, impl, tol):
    """Row-sharded SSIM of one image from process-local rows: the ring's
    halo exchange crosses the process boundary (tests/test_multihost.py:
    141-200); equal to the whole-tensor call bit for bit, and against JAX
    compute_ssim and its XLA map."""
    load, _ = procs
    a, b = _spatial_image()
    assert load(f"spatial_same_{impl}").all()
    jax_impl = "xla" if impl == "torch" else "pallas"
    want, want_map = jax_compute_ssim(a, b, impl=jax_impl, with_map=True)
    got = float(np.asarray(load(f"spatial_rows_{impl}"), np.float64).sum() / a.size)
    assert abs(got - want) <= tol
    assert np.abs(load(f"spatial_map_{impl}") - np.asarray(want_map)).max() <= 1e-5


def test_dtensor_rows_thinner_than_the_radius(procs):
    """Bands of 4 rows (radius 5): the DTensor is gathered and the
    whole-tensor path runs, with the same rows."""
    load, _ = procs
    assert load("thin_same").all()


def test_two_process_spatial_grad(procs):
    """The sharded backward kernel's halo mode (its twin here) on
    process-local rows: the whole gradients equal the whole-tensor call's,
    and are within 3e-5 x max|g| of jax.grad of the unsharded XLA
    formulation (tests/test_multihost.py:203-261)."""
    load, _ = procs
    assert load("grad_same").all()
    a, b = _grad_pair()
    ws = 1.0 / a.size
    ga, gb = jax.grad(lambda x, y: ws * jnp.sum(ssim_parts_xla(x, y, data_range=1.0)[0]),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    scale = float(jnp.abs(ga).max())
    err = max(float(np.abs(load("grad_da") - np.asarray(ga)).max()),
              float(np.abs(load("grad_db") - np.asarray(gb)).max()))
    assert err <= GRAD_REL * scale, (err, scale)


@pytest.mark.parametrize("name,rows,dim", [("mean_kernel", 160, 0), ("mean_plain", 16, 0),
                                          ("mean_batch", 80, 1)])
def test_mean_ssim_spatial_dtensor_gradient(procs, name, rows, dim):
    """mean_ssim_spatial on DTensor rows: the value of the whole-tensor
    call, and a gradient that reaches the DTensor as one, its local block
    that process's rows of the whole-tensor gradient (bit for bit); the
    value against the JAX XLA formulation."""
    load, local = procs
    assert float(load(f"{name}_val")) == float(load(f"{name}_val_whole"))
    whole = load(f"{name}_grad_whole")
    np.testing.assert_array_equal(np.concatenate(local(f"local_{name}_grad"), axis=dim),
                                  whole)
    a, b = _grad_pair()
    x, y = (a.reshape(2, 80, 64), b.reshape(2, 80, 64)) if dim else (a[:rows], b[:rows])
    want = float(jnp.sum(ssim_parts_xla(jnp.asarray(x), jnp.asarray(y),
                                        data_range=1.0)[0]) / x.size)
    assert abs(float(load(f"{name}_val")) - want) <= MEAN_KERNEL
