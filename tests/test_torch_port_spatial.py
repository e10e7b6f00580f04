"""The port's spatial sharding (ssim_tpu_torch.parallel) against the JAX
package's (ssim_tpu.parallel), on the same NumPy inputs.

Op level, in this process: the forward kernel's row modes with halo
operands (`ssim_rows_cuda(vhalo, vmask)` with and without the map, and
`ssim_parts_cuda(rowsum=True | with_map=True, vhalo, vmask)` over it)
and the backward kernel's halo mode (`ssim_grad_cuda(vhalo, vmask)`) run
their plain twins on CPU tensors and are held against `ssim_parts_pallas`
and `ssim_grad_pallas` in interpret mode, at the geometries of
tests/test_grad_vhalo.py: interior and ragged bands, either and both
image edges, a batch, radius 3 and 16, w_cs, and raw garbage operands at
flagged edges (the port also takes NaN-filled ones there, which it never
reads).

Distributed: one module-scoped spawn of 4 gloo ranks, and one of 8, each
rank a subprocess (JAX's threads rule out fork), the process group set up
with a `file://` store in a temporary directory (no network). Every rank
runs every case of its spawn through `ssim_spatial_sharded`,
`mean_ssim_spatial` and `ssim_grad_spatial_sharded` on a `cpu`
DeviceMesh and writes its results as .npy files. The JAX side runs here on
the 8-device CPU mesh from conftest. Every rank's result must equal rank
0's; rank 0's is held against JAX.

Tolerances, those of tests/test_distributed.py:
- maps: 5e-6 per pixel on the plain route (impl="torch" against the
  unsharded XLA formulation, :71, :118), 1e-5 on the kernel route
  (against the JAX spatial layer's impl="pallas", :153);
- means: 1e-7 (plain), 1e-6 (kernel route, and means of f32 pairs);
- row sums, a sum of W pixels each: W times the map tolerance;
- gradients: 3e-5 * max|g| (:203, :302, :344);
- op level: row sums and maps at torch_port_util's port-against-JAX tier
  (1e-5 per pixel, W of them per row), gradients 2e-5 * max|g|, the
  bound of tests/test_grad_vhalo.py (5e-5 at radius 1 is not needed:
  the radii here are 3, 5, 8 and 16).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from torch_port_util import JAX_PIXEL

from ssim_tpu import compute_ssim as jax_compute_ssim
from ssim_tpu.ops.ssim_grad import ssim_grad_pallas
from ssim_tpu.ops.ssim_pallas import ssim_parts_pallas
from ssim_tpu.ops.ssim_xla import ssim_parts_xla
from ssim_tpu.parallel import (
    make_mesh as jax_make_mesh,
    mean_ssim_spatial as jax_mean_ssim_spatial,
    ssim_grad_spatial_sharded as jax_grad_spatial,
    ssim_spatial_sharded as jax_spatial,
)
from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
from ssim_tpu_torch.ops.ssim_cuda import ssim_parts_cuda, ssim_rows_cuda
from ssim_tpu_torch.ops.ssim_grad import ssim_grad_cuda

MAP_PLAIN = 5e-6
MAP_KERNEL = 1e-5
MEAN_PLAIN = 1e-7
MEAN_KERNEL = 1e-6
GRAD_REL = 3e-5
OP_GRAD_REL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins run many small elementwise passes; one intra-op thread
    per test worker keeps them from contending for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _u8_pair(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.normal(0, 12, shape).astype(np.int32)
    return a, np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def _f32_pair(rng, shape):
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.06, shape), 0, 1).astype(np.float32)
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _operands(rng, x_a, x_b, rows, is_top, is_bot, dtype, nan_at_edges):
    """(JAX operands, port operands): true-looking neighbour rows, random
    garbage at a flagged edge for JAX, and for the port the same garbage or,
    with nan_at_edges, NaN there (it must not be read)."""
    lead = x_a.shape[:-2]
    w = x_a.shape[-1]

    def rand():
        if dtype == np.uint8:
            return rng.integers(0, 256, lead + (rows, w), dtype=np.uint8)
        return rng.random(lead + (rows, w)).astype(np.float32)

    jax_ops = [rand() for _ in range(4)]  # a_top, a_bot, b_top, b_bot
    port_ops = [x.copy() for x in jax_ops]
    if nan_at_edges:
        flagged = [is_top, is_bot, is_top, is_bot]
        for i, f in enumerate(flagged):
            if f:
                port_ops[i] = np.full_like(port_ops[i], np.nan)
    return tuple(jax_ops), tuple(_t(x) for x in port_ops)


# Op-level forward cases: (name, shape, dtype, (is_top, is_bot), window).
# 32-row tiles: 45 rows is a ragged band, 37 rows leaves a last tile of 5
# rows (at radius 8: thinner than r, so the previous tile's halo reads the
# bottom operand too), 3 rows a band thinner than the radius.
FWD_CASES = [
    ("interior", (40, 130), np.uint8, (0, 0), {}),
    ("ragged", (45, 100), np.uint8, (0, 0), {}),
    ("top", (40, 100), np.uint8, (1, 0), {}),
    ("bottom", (40, 100), np.uint8, (0, 1), {}),
    ("both", (40, 100), np.uint8, (1, 1), {}),
    ("thin_last_tile_r8", (37, 90), np.uint8, (0, 0), dict(radius=8, sigma=2.5)),
    ("thin_band", (3, 70), np.uint8, (1, 1), {}),
    ("batched", (2, 24, 96), np.uint8, (1, 0), {}),
    ("radius3", (32, 90), np.uint8, (0, 0), dict(radius=3, sigma=1.0, k1=0.02, k2=0.05)),
    ("radius16", (40, 70), np.uint8, (1, 0), dict(radius=16, sigma=4.0)),
    ("f32_nan_operands", (40, 100), np.float32, (1, 1), dict(data_range=1.0)),
    ("f32_interior", (2, 36, 80), np.float32, (0, 0), dict(data_range=1.0)),
]


@pytest.mark.parametrize("name,shape,dtype,flags,kw", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
@pytest.mark.parametrize("mode", ["rowsum", "map"])
def test_halo_forward_twin_matches_pallas(rng, name, shape, dtype, flags, kw, mode):
    """Row sums and maps of a band with halo operands: the twin against
    the Pallas kernel in interpret mode."""
    r = kw.get("radius", 5)
    a, b = _u8_pair(rng, shape) if dtype == np.uint8 else _f32_pair(rng, shape)
    jax_ops, port_ops = _operands(rng, a, b, r, *flags, dtype,
                                  nan_at_edges=dtype == np.float32)
    fl = tuple(float(f) for f in flags)
    mkw = dict(rowsum=True) if mode == "rowsum" else dict(with_map=True)
    allow = dict(allow_float=dtype == np.float32)
    before = (ssim_cuda.ROWSUM_LAUNCHES, ssim_cuda.ROWSUM_MAP_LAUNCHES)
    rows, smap = ssim_rows_cuda(_t(a), _t(b), with_map=mode == "map",
                                vhalo=port_ops, vmask=flags, **allow, **kw)
    parts, pmap = ssim_parts_cuda(_t(a), _t(b), vhalo=port_ops, vmask=flags,
                                  **mkw, **allow, **kw)
    assert (ssim_cuda.ROWSUM_LAUNCHES,
            ssim_cuda.ROWSUM_MAP_LAUNCHES) == before  # CPU tensors take the twin
    j_rows, j_map = ssim_parts_pallas(a, b, interpret=True, vhalo=jax_ops,
                                      vmask=fl, **mkw, **allow, **kw)
    w = shape[-1]
    assert rows.shape == shape[:-1] and rows.dtype == torch.float32
    if mode == "rowsum":
        # ssim_parts_cuda(rowsum=True) is ssim_rows_cuda's score.
        assert smap is None and pmap is None and torch.equal(parts, rows)
        err = np.abs(rows.numpy().astype(np.float64) - np.asarray(j_rows)).max()
        assert err <= JAX_PIXEL * w, (err, JAX_PIXEL * w)
    else:
        # ssim_parts_cuda(with_map=True, vhalo) gives the map alone.
        assert parts is None and torch.equal(pmap, smap)
        j_map = np.asarray(j_map)
        assert smap.shape == j_map.shape
        assert np.abs(smap.numpy() - j_map).max() <= JAX_PIXEL
        # The row sums of the same launch equal the JAX map's rows.
        err = np.abs(rows.numpy() - j_map.astype(np.float64).sum(-1)).max()
        assert err <= JAX_PIXEL * w, (err, JAX_PIXEL * w)


def test_halo_forward_unsharded_equivalence(rng):
    """Bands of one image with their neighbours' rows as operands and the
    flags a mesh would set give the unsharded image's rows and map, and
    the band's own tiles carry a NaN in a neighbour's rows no further than
    the unsharded grid does (the NaN pixel's rows are NaN, rows finite in
    both agree)."""
    a, b = _f32_pair(rng, (100, 70))
    a[37, 20] = np.nan
    kw = dict(data_range=1.0, allow_float=True)
    whole_rows, _ = ssim_rows_cuda(_t(a), _t(b), **kw)
    _, whole_map = ssim_parts_cuda(_t(a), _t(b), with_map=True, **kw)
    r, bands = 5, [(0, 34), (34, 61), (61, 100)]  # ragged, uneven bands
    rows, maps = [], []
    for i, (lo, hi) in enumerate(bands):
        top = lambda x: _t(x[max(lo - r, 0):lo] if lo else x[-r:])  # raw ring
        bot = lambda x: _t(x[hi:hi + r] if hi < 100 else x[:r])
        vh = (top(a), bot(a), top(b), bot(b))
        flags = (i == 0, i == len(bands) - 1)
        got_rows, got_map = ssim_rows_cuda(_t(a[lo:hi]), _t(b[lo:hi]), with_map=True,
                                           vhalo=vh, vmask=flags, **kw)
        rows.append(got_rows.numpy())
        maps.append(got_map.numpy())
    rows, smap = np.concatenate(rows), np.concatenate(maps)
    want_rows, want_map = whole_rows.numpy(), whole_map.numpy()
    assert np.isnan(rows[37]) and np.isnan(want_rows[37])
    both = np.isfinite(rows) & np.isfinite(want_rows)
    assert both.sum() >= 100 - 64  # at most two 32-row tiles differ
    assert np.abs(rows[both] - want_rows[both]).max() <= JAX_PIXEL * 70
    fin = np.isfinite(smap) & np.isfinite(want_map)
    assert np.abs(smap[fin] - want_map[fin]).max() <= JAX_PIXEL


# Op-level backward cases: (name, shape, (is_top, is_bot), w_cs, window);
# the JAX test file's geometries at smaller widths.
BWD_CASES = [
    ("interior", (40, 96), (0, 0), 0.0, {}),
    ("ragged", (45, 100), (0, 0), 0.0, {}),
    ("top", (40, 96), (1, 0), 0.0, {}),
    ("bottom_ragged", (70, 131), (0, 1), 0.0, {}),
    ("both", (40, 96), (1, 1), 0.0, {}),
    ("batched", (2, 24, 96), (1, 0), 0.0, {}),
    ("radius3", (32, 100), (0, 0), 0.0, dict(radius=3, sigma=1.0)),
    ("radius8_bottom", (40, 120), (0, 1), 0.0, dict(radius=8, sigma=2.5)),
    ("radius16_top", (40, 70), (1, 0), 0.0, dict(radius=16, sigma=4.0)),
    ("w_cs", (40, 96), (1, 0), 0.7, {}),
]


@pytest.mark.parametrize("name,shape,flags,w_cs,kw", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_halo_backward_twin_matches_pallas(rng, name, shape, flags, w_cs, kw):
    """Gradients of a band with 2r-row halo operands: the twin against the
    Pallas kernel in interpret mode; NaN-filled operands at flagged edges
    for the port, random garbage for JAX."""
    r = kw.get("radius", 5)
    a, b = _f32_pair(rng, shape)
    jax_ops, port_ops = _operands(rng, a, b, 2 * r, *flags, np.float32,
                                  nan_at_edges=True)
    before = (ssim_grad.LAUNCHES, ssim_grad.VHALO_LAUNCHES)
    da, db = ssim_grad_cuda(_t(a), _t(b), 1.3, w_cs, vhalo=port_ops, vmask=flags,
                            data_range=1.0, **kw)
    assert (ssim_grad.LAUNCHES, ssim_grad.VHALO_LAUNCHES) == before
    want = ssim_grad_pallas(a, b, 1.3, w_cs, interpret=True, vhalo=jax_ops,
                            vmask=tuple(float(f) for f in flags), data_range=1.0,
                            **kw)
    want = [np.asarray(x) for x in want]
    scale = float(np.abs(want[0]).max())
    for got, ref in zip((da, db), want):
        assert got.shape == ref.shape
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= OP_GRAD_REL * scale, (err, scale)


def test_halo_argument_guards(rng):
    """The JAX package's checks (ssim_pallas.py:1811-1850,
    ssim_grad.py:773-809)."""
    a, b = _u8_pair(rng, (40, 64))
    ta, tb = _t(a), _t(b)
    ops = tuple(torch.zeros(5, 64, dtype=torch.uint8) for _ in range(4))
    with pytest.raises(ValueError, match="rowsum"):
        ssim_parts_cuda(ta, tb, rowsum=True, with_map=True)
    with pytest.raises(ValueError, match="vmask requires vhalo"):
        ssim_parts_cuda(ta, tb, rowsum=True, vmask=(1, 0))
    with pytest.raises(ValueError, match="rowsum/map"):
        ssim_parts_cuda(ta, tb, vhalo=ops)
    with pytest.raises(ValueError, match="vhalo must be"):
        ssim_parts_cuda(ta, tb, rowsum=True, vhalo=ops[:3])
    with pytest.raises(ValueError, match="vhalo must be"):
        ssim_parts_cuda(ta, tb, rowsum=True, vhalo=tuple(x[:4] for x in ops))
    with pytest.raises(ValueError, match="vmask requires vhalo"):
        ssim_rows_cuda(ta, tb, with_map=True, vmask=(1, 0))
    with pytest.raises(ValueError, match="vhalo must be"):
        ssim_rows_cuda(ta, tb, vhalo=ops[:3])
    fa = ta.float()
    gops = tuple(torch.zeros(10, 64) for _ in range(4))
    with pytest.raises(ValueError, match="g_map"):
        ssim_grad_cuda(fa, fa, 1.0, 0.0, torch.zeros_like(fa), vhalo=gops, vmask=(0, 0))
    with pytest.raises(ValueError, match="requires vmask"):
        ssim_grad_cuda(fa, fa, 1.0, 0.0, vhalo=gops)
    with pytest.raises(ValueError, match="2\\*radius"):
        ssim_grad_cuda(fa[:9], fa[:9], 1.0, 0.0, vhalo=gops, vmask=(0, 0))
    with pytest.raises(ValueError, match="vhalo must be"):
        ssim_grad_cuda(fa, fa, 1.0, 0.0, vhalo=tuple(x[:5] for x in gops), vmask=(0, 0))


# --- distributed: gloo ranks in subprocesses --------------------------------

_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        world_size=world, rank=rank)
from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
from ssim_tpu_torch.parallel import (
    make_mesh, mean_ssim_spatial, ssim_grad_spatial_sharded, ssim_spatial_sharded)
from ssim_tpu_torch.parallel import mesh as mesh_mod

inp = dict(np.load(os.path.join(out, "inputs.npz")))
T = lambda k: torch.from_numpy(inp[k])

def save(name, x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    np.save(os.path.join(out, f"{name}.{rank}.npy"), np.asarray(x))

def raises(fn, match):
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False

space = make_mesh((world,), ("space",), device_type="cpu")
if world == 4:
    for h in (200, 53, 102, 201):
        rows, smap = ssim_spatial_sharded(T(f"u8_{h}_a"), T(f"u8_{h}_b"), space,
                                          with_map=True)
        save(f"u8_{h}_rows", rows); save(f"u8_{h}_map", smap)
    rows, _ = ssim_spatial_sharded(T("u8_200_a"), T("u8_200_b"), space)
    save("u8_200_score_rows", rows)
    rows, smap = ssim_spatial_sharded(T("f32_a"), T("f32_b"), space, with_map=True,
                                      data_range=1.0)
    save("f32_rows", rows); save("f32_map", smap)
    rows, smap = ssim_spatial_sharded(T("u8_102_a"), T("u8_102_b"), space,
                                      with_map=True, impl="torch")
    save("torch_rows", rows); save("torch_map", smap)
    win = dict(radius=3, sigma=2.0, k1=0.02, k2=0.05)
    rows, _ = ssim_spatial_sharded(T("u8_96_a"), T("u8_96_b"), space, **win)
    save("custom_rows", rows)
    rows, _ = ssim_spatial_sharded(T("u8_96_a"), T("u8_96_b"), space, radius=17,
                                   sigma=3.0)
    save("r17_rows", rows)
    # No twin launch counts as a kernel launch on CPU tensors.
    save("cpu_launches", np.array([ssim_cuda.ROWSUM_LAUNCHES, ssim_cuda.ROWSUM_MAP_LAUNCHES,
                                   ssim_grad.VHALO_LAUNCHES]))

    ga = T("g_a")
    da, db = ssim_grad_spatial_sharded(ga, T("g_b"), space, w_s=1.0 / ga.numel(),
                                       data_range=1.0)
    save("grad_da", da); save("grad_db", db)
    x = ga.clone().requires_grad_()
    y = T("g_b").clone().requires_grad_()
    val = mean_ssim_spatial(x, y, space, data_range=1.0)
    val.backward()
    save("mean_val", val); save("mean_ga", x.grad); save("mean_gb", y.grad)
    x = T("g117_a").clone().requires_grad_()
    val = mean_ssim_spatial(x, T("g117_b"), space, data_range=1.0)
    (1.0 - val).backward()
    save("fallback_val", val); save("fallback_ga", x.grad)
    x = T("b_a").clone().requires_grad_()
    val = mean_ssim_spatial(x, T("b_b"), space, data_range=1.0)
    (1.0 - val).backward()
    save("batch1d_val", val); save("batch1d_ga", x.grad)
    x = T("b_a").clone().requires_grad_()
    val = mean_ssim_spatial(x, T("b_b"), space, data_range=1.0, impl="torch")
    (1.0 - val).backward()
    save("batch1d_torch_val", val); save("batch1d_torch_ga", x.grad)

    mesh2 = make_mesh((2, 2), ("data", "space"), device_type="cpu")
    x = T("b_a").clone().requires_grad_()
    val = mean_ssim_spatial(x, T("b_b"), mesh2, axis="space", batch_axis="data",
                            data_range=1.0)
    (1.0 - val).backward()
    save("mesh22_val", val); save("mesh22_ga", x.grad)
    v8 = mean_ssim_spatial(T("b_u8_a"), T("b_u8_b"), mesh2, axis="space",
                           batch_axis="data")
    save("mesh22_u8_val", v8)

    ok = T("g_a")[:80, :64].contiguous()
    u8 = (ok * 255).to(torch.uint8)
    save("errors", np.array([
        raises(lambda: ssim_grad_spatial_sharded(ok[:79], ok[:79], space), "divide"),
        raises(lambda: ssim_grad_spatial_sharded(ok[:36], ok[:36], space), "divide"),
        raises(lambda: ssim_grad_spatial_sharded(u8, u8, space), "float32"),
        raises(lambda: ssim_grad_spatial_sharded(ok[None, None], ok[None, None], space), "pair"),
        raises(lambda: ssim_grad_spatial_sharded(ok, ok, space, batch_axis="space"), "batch_axis"),
        raises(lambda: ssim_grad_spatial_sharded(ok[None], ok[None], space,
                                                 w_s=np.ones((1,), np.float32)), "scalar"),
        raises(lambda: mean_ssim_spatial(ok[None, :78], ok[None, :78], space), "divisible"),
        raises(lambda: mean_ssim_spatial(ok[None, :32], ok[None, :32], space), "differentiable"),
        raises(lambda: mean_ssim_spatial(ok, ok, space, batch_axis="data"), "batch_axis"),
        raises(lambda: ssim_spatial_sharded(ok, ok, space, axis="rows"), "no axis"),
        raises(lambda: make_mesh((world + 1,), ("space",), device_type="cpu"), "ranks"),
    ]))
else:
    rows, _ = ssim_spatial_sharded(T("u8_64_a"), T("u8_64_b"), space)
    save("small_rows", rows)
    rows, _ = ssim_spatial_sharded(T("u8_12_a"), T("u8_12_b"), space)
    save("tiny_rows", rows)
    for h in (160, 80):
        a = T(f"g{h}_a")
        da, db = ssim_grad_spatial_sharded(a, T(f"g{h}_b"), space, w_s=1.0 / a.numel(),
                                           data_range=1.0)
        save(f"grad{h}_da", da); save(f"grad{h}_db", db)
# Every rank's sends delivered and its results on disk; then exit at once.
# Nothing waits on this rank past the barrier, and skipping the process
# group's teardown at interpreter exit avoids a rare gloo abort there
# ("terminate called without an active exception", rc -6).
dist.barrier()
sys.stdout.flush(); sys.stderr.flush()
os._exit(0)
"""


def _inputs(world):
    rng = np.random.default_rng(0x5A + world)
    x = {}
    if world == 4:
        for h in (200, 53, 102, 201):
            x[f"u8_{h}_a"], x[f"u8_{h}_b"] = _u8_pair(rng, (h, 96 if h == 200 else 64))
        x["u8_96_a"], x["u8_96_b"] = _u8_pair(rng, (96, 80))
        x["f32_a"], x["f32_b"] = _f32_pair(rng, (96, 160))
        x["g_a"], x["g_b"] = _f32_pair(rng, (120, 96))
        x["g117_a"], x["g117_b"] = _f32_pair(rng, (117, 96))
        x["b_a"], x["b_b"] = _f32_pair(rng, (4, 80, 64))
        x["b_u8_a"] = (x["b_a"] * 255).astype(np.uint8)
        x["b_u8_b"] = (x["b_b"] * 255).astype(np.uint8)
    else:
        x["u8_64_a"], x["u8_64_b"] = _u8_pair(rng, (64, 64))
        x["u8_12_a"], x["u8_12_b"] = _u8_pair(rng, (12, 64))
        for h in (160, 80):
            x[f"g{h}_a"], x[f"g{h}_b"] = _f32_pair(rng, (h, 96))
    return x


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run both spawns (4 and 8 gloo ranks) at once; returns
    {world: (inputs, load(name) -> rank 0's result)}, having checked that
    every rank's results equal rank 0's."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    runs = {}
    for world in (4, 8):
        out = tmp_path_factory.mktemp(f"gloo{world}")
        inputs = _inputs(world)
        np.savez(out / "inputs.npz", **inputs)
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(out), str(rank), str(world)],
                cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            for rank in range(world)
        ]
        runs[world] = (out, inputs, procs)
    failures = []
    for world, (_, _, procs) in runs.items():
        for rank, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for q in (q for _, _, ps in runs.values() for q in ps):
                    q.kill()
                pytest.fail(f"gloo rank {rank} of {world} timed out")
            if p.returncode != 0:
                failures.append(f"rank {rank} of {world} (rc {p.returncode}): {err[-3000:]}")
    assert not failures, "\n".join(failures)
    result = {}
    for world, (out, inputs, _) in runs.items():
        names = sorted({f.name.rsplit(".", 2)[0] for f in out.glob("*.0.npy")})
        assert names, f"no results from the {world}-rank run"
        for name in names:
            r0 = np.load(out / f"{name}.0.npy")
            for rank in range(1, world):
                np.testing.assert_array_equal(np.load(out / f"{name}.{rank}.npy"), r0,
                                              err_msg=f"{name}: rank {rank} != rank 0")
        result[world] = (inputs, lambda name, out=out: np.load(out / f"{name}.0.npy"))
    return result


def _mean(rows, npix):
    return float(np.asarray(rows, np.float64).sum() / npix)


def _check_rows_map(rows, smap, j_rows, j_map, w, pixel):
    assert rows.shape == np.asarray(j_rows).shape
    assert np.abs(rows.astype(np.float64) - np.asarray(j_rows)).max() <= pixel * w
    if j_map is not None:
        assert smap.shape == np.asarray(j_map).shape
        assert np.abs(smap - np.asarray(j_map)).max() <= pixel


@pytest.mark.parametrize("h", [200, 53, 102, 201])
def test_spatial_kernel_route_matches_jax(ranks, h):
    """4 ranks, u8 pairs of any height (53, 102, 201 padded, 200 not): the
    row mode with halo operands on every band (its twin here) against the
    JAX spatial layer's Pallas route."""
    inputs, load = ranks[4]
    a, b = inputs[f"u8_{h}_a"], inputs[f"u8_{h}_b"]
    mesh = jax_make_mesh((4,), ("space",))
    j_rows, j_map = jax_spatial(a, b, mesh, with_map=True, impl="pallas")
    rows, smap = load(f"u8_{h}_rows"), load(f"u8_{h}_map")
    _check_rows_map(rows, smap, j_rows, j_map, a.shape[1], MAP_KERNEL)
    npix = a.size
    assert abs(_mean(rows, npix) - _mean(j_rows, npix)) <= MEAN_KERNEL
    if h == 200:
        score_rows = load("u8_200_score_rows")
        _check_rows_map(score_rows, None, j_rows, None, a.shape[1], MAP_KERNEL)
        assert abs(_mean(score_rows, npix) - jax_compute_ssim(a, b, impl="xla")) <= MEAN_KERNEL


def test_spatial_float_pair_and_custom_window(ranks):
    """An f32 pair on the kernel route, and radius 3 with custom
    sigma/k1/k2; no kernel launch is counted on CPU tensors."""
    inputs, load = ranks[4]
    mesh = jax_make_mesh((4,), ("space",))
    a, b = inputs["f32_a"], inputs["f32_b"]
    j_rows, j_map = jax_spatial(a, b, mesh, with_map=True, impl="pallas", data_range=1.0)
    _check_rows_map(load("f32_rows"), load("f32_map"), j_rows, j_map, a.shape[1],
                    MAP_KERNEL)
    a, b = inputs["u8_96_a"], inputs["u8_96_b"]
    win = dict(radius=3, sigma=2.0, k1=0.02, k2=0.05)
    j_rows, _ = jax_spatial(a, b, mesh, impl="pallas", **win)
    _check_rows_map(load("custom_rows"), None, j_rows, None, a.shape[1], MAP_KERNEL)
    np.testing.assert_array_equal(load("cpu_launches"), [0, 0, 0])


def test_spatial_plain_route_matches_jax(ranks):
    """impl="torch" (the plain route, edge replicas built on the host)
    against the unsharded JAX XLA formulation, as test_distributed.py
    holds JAX's own XLA spatial route (JAX's sharded XLA route compiles
    for ~23 s per shape here); radius 17 (past the kernel) takes the plain
    route too."""
    inputs, load = ranks[4]
    a, b = inputs["u8_102_a"], inputs["u8_102_b"]
    j_rows, j_map = ssim_parts_xla(jnp.asarray(a), jnp.asarray(b), with_map=True)
    _check_rows_map(load("torch_rows"), load("torch_map"), j_rows, j_map, a.shape[1],
                    MAP_PLAIN)
    want = jax_compute_ssim(a, b, impl="xla")
    assert abs(_mean(load("torch_rows"), a.size) - want) <= MEAN_PLAIN
    a, b = inputs["u8_96_a"], inputs["u8_96_b"]
    want = jax_compute_ssim(a, b, impl="xla", radius=17, sigma=3.0)
    assert abs(_mean(load("r17_rows"), a.size) - want) <= MEAN_PLAIN


def test_spatial_eight_ranks(ranks):
    """8 ranks: bands of exactly 8 rows (64 high), and 12 rows over 8
    ranks (padded to bands of the radius)."""
    inputs, load = ranks[8]
    mesh = jax_make_mesh((8,), ("space",))
    for key, name in (("u8_64", "small_rows"), ("u8_12", "tiny_rows")):
        a, b = inputs[f"{key}_a"], inputs[f"{key}_b"]
        j_rows, _ = jax_spatial(a, b, mesh, impl="pallas")
        _check_rows_map(load(name), None, j_rows, None, a.shape[1], MAP_KERNEL)
        assert abs(_mean(load(name), a.size) - jax_compute_ssim(a, b, impl="xla")) \
            <= MEAN_KERNEL


def _close_grad(got, want):
    scale = float(np.abs(np.asarray(want)).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= GRAD_REL * scale, (err, scale)


@pytest.mark.parametrize("world,h", [(4, 120), (8, 160), (8, 80)])
def test_grad_spatial_matches_jax(ranks, world, h):
    """The backward kernel's halo mode over 4 and 8 ranks (at (8, 80) the
    bands are 2r = 10 rows, the least allowed) against the JAX sharded
    backward."""
    inputs, load = ranks[world]
    key, name = ("g", "grad") if world == 4 else (f"g{h}", f"grad{h}")
    a, b = inputs[f"{key}_a"], inputs[f"{key}_b"]
    mesh = jax_make_mesh((world,), ("space",))
    j_da, j_db = jax_grad_spatial(a, b, mesh, w_s=1.0 / a.size, data_range=1.0)
    _close_grad(load(f"{name}_da"), j_da)
    _close_grad(load(f"{name}_db"), j_db)


def test_mean_ssim_spatial_kernel_route(ranks):
    """mean_ssim_spatial on one f32 pair: the row mode's mean (against the
    JAX layer's Pallas rows) and its gradient through the sharded backward
    (against JAX's, which is jax.grad of JAX's mean_ssim_spatial by its
    custom VJP)."""
    inputs, load = ranks[4]
    a, b = inputs["g_a"], inputs["g_b"]
    mesh = jax_make_mesh((4,), ("space",))
    j_rows, _ = jax_spatial(a, b, mesh, impl="pallas", data_range=1.0)
    assert abs(float(load("mean_val")) - _mean(j_rows, a.size)) <= MEAN_KERNEL
    j_da, j_db = jax_grad_spatial(a, b, mesh, w_s=1.0 / a.size, data_range=1.0)
    _close_grad(load("mean_ga"), j_da)
    _close_grad(load("mean_gb"), j_db)


def test_mean_ssim_spatial_fallback_and_plain_batch(ranks):
    """Geometries the sharded backward cannot take (117 rows over 4) and
    impl="torch" on a batch: autograd through the plain route (the ring
    exchange's adjoint, the all-reduce and the band gather) against
    jax.grad of the unsharded XLA formulation."""
    inputs, load = ranks[4]
    for key, name in (("g117", "fallback"), ("b", "batch1d_torch"), ("b", "batch1d")):
        a, b = inputs[f"{key}_a"], inputs[f"{key}_b"]
        loss = lambda x: 1.0 - jnp.sum(ssim_parts_xla(x, jnp.asarray(b), data_range=1.0)[0]) / a.size
        want = float(1.0 - loss(jnp.asarray(a)))
        assert abs(float(load(f"{name}_val")) - want) <= MEAN_KERNEL, name
        _close_grad(load(f"{name}_ga"), jax.grad(loss)(jnp.asarray(a)))


def test_mean_ssim_spatial_data_by_space_mesh(ranks):
    """A (4, 80, 64) f32 batch on a (2, 2) data x space mesh: the value
    against JAX's mean_ssim_spatial on the same mesh shape, the gradient
    against JAX's sharded backward there; the u8 batch's forward too."""
    inputs, load = ranks[4]
    a, b = inputs["b_a"], inputs["b_b"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "space"))
    want = float(jax_mean_ssim_spatial(a, b, mesh, axis="space", batch_axis="data",
                                       data_range=1.0))
    assert abs(float(load("mesh22_val")) - want) <= MEAN_KERNEL
    j_da, _ = jax_grad_spatial(a, b, mesh, axis="space", batch_axis="data",
                               w_s=-1.0 / a.size, data_range=1.0)
    _close_grad(load("mesh22_ga"), j_da)
    u8a, u8b = inputs["b_u8_a"], inputs["b_u8_b"]
    want8 = float(np.mean(jax_compute_ssim(u8a, u8b, impl="xla")))
    assert abs(float(load("mesh22_u8_val")) - want8) <= MEAN_KERNEL


def test_spatial_argument_errors(ranks):
    """The JAX layer's geometry, dtype and shape errors
    (tests/test_distributed.py:232-253), and the port's mesh checks."""
    _, load = ranks[4]
    assert load("errors").all(), load("errors")


def test_make_mesh_needs_a_process_group():
    """make_mesh never creates a process group behind the caller's back."""
    import torch.distributed as dist

    from ssim_tpu_torch.parallel import default_mesh, make_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1,), ("space",), device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        default_mesh("space", device_type="cpu")


def test_parallel_imports_without_jax():
    """ssim_tpu_torch.parallel (batch.py and multihost.py with it), the
    entry points and the examples import with JAX blocked and pull in no
    module of ssim_tpu."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import ssim_tpu_torch.parallel\n"
        "import ssim_tpu_torch.parallel.batch, ssim_tpu_torch.parallel.multihost\n"
        "import ssim_tpu_torch.entry\n"
        "import ssim_tpu_torch.examples.sample, ssim_tpu_torch.examples.training\n"
        "import ssim_tpu_torch.examples.distributed\n"
        "assert not any(m == 'ssim_tpu' or m.startswith('ssim_tpu.') "
        "for m in sys.modules), 'ssim_tpu was imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
