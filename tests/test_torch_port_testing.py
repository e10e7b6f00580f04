"""The port's testing layer (ssim_tpu_torch.testing: frozen, devicebench,
report) against the JAX package's (ssim_tpu.testing), on the CPU.

- frozen: every constant equal to JAX's, value for value; the same
  image-directory variable and default.
- devicebench: `make_runner(impl)(a, b, 3)` on device="cpu" against the
  JAX `make_runner` on the same NumPy inputs. Both add into an f32
  accumulator, so the loop's sum is held to the f32 tier's global bound
  per pixel and iteration: 2e-6 x pixels x iters (ORACLE_GLOBAL of
  torch_port_util; each iteration adds one SSIM sum over the pixels).
  Tighter bounds where the sum is not over pixels: `grad` sums
  da[..., 0, 0] + db[..., 0, 0], held to the port's gradient tier, 2e-5 x
  max|g| per element (tests/test_torch_port_grad.py); `msssim` sums one
  MS-SSIM per image, held to 2e-5 per value (MS-SSIM against the plain
  pyramid, tests/test_torch_port_msssim.py). `msssim` is held against a
  loop of JAX `ms_ssim(impl="xla")`: the JAX runner reaches the Pallas
  pyramid, which returns NaN on the CPU (ROADMAP Queue 3, F1). `spatial`
  runs on a one-rank gloo group in a subprocess, against JAX's runner on
  the 8-device CPU mesh of conftest.
- device_throughput: finite and positive on the CPU; "unstable
  measurement" when every delta is noise (a patched clock); cuda without
  a GPU raises UnsupportedError.
- report: a synthetic suite under the suite's file names (PIL, a seed):
  the same pairs as JAX's `_suite_pairs`; JAX's table layout; every
  implementation within the f32 tier of the oracle (2e-6 global, 1e-3 per
  pixel); --quick reads only the Einstein pairs; no images returns 1; a
  failing device measurement propagates.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import ORACLE_GLOBAL, ORACLE_PIXEL

from ssim_tpu.models.msssim import ms_ssim as jax_ms_ssim
from ssim_tpu.testing import devicebench as jax_devicebench
from ssim_tpu.testing import frozen as jax_frozen
from ssim_tpu.testing import report as jax_report
import ssim_tpu.testing as jax_testing

import ssim_tpu_torch.testing as port_testing
from ssim_tpu_torch.errors import UnsupportedError
from ssim_tpu_torch.ops.ssim_grad import ssim_grad_cuda
from ssim_tpu_torch.testing import devicebench, frozen, report

ITERS = 3
GRAD_REL = 2e-5
MSSSIM_TOL = 2e-5

FROZEN_NAMES = ["ORACLE_TOLERANCE", "DECODER_TOLERANCE", "GLOBAL_TOLERANCE_F32",
                "PIXEL_TOLERANCE_F32", "GLOBAL_TOLERANCE_F64", "PIXEL_TOLERANCE_F64",
                "EINSTEIN_SUITE", "BBB360", "BBB1080", "BBB255", "BBB257"]


@pytest.mark.parametrize("name", FROZEN_NAMES)
def test_frozen_constant_equals_jax(name):
    got, want = getattr(frozen, name), getattr(jax_frozen, name)
    assert type(got) is type(want)
    assert got == want


def test_frozen_names_and_exports_match_jax():
    upper = lambda m: sorted(n for n in dir(m) if n.isupper() and not n.startswith("_"))
    assert upper(frozen) == upper(jax_frozen)
    assert port_testing.__all__ == jax_testing.__all__
    for name in port_testing.__all__:
        got, want = getattr(port_testing, name), getattr(jax_testing, name)
        assert (got() == want()) if callable(want) else (got == want), name


def test_images_dir_reads_the_jax_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("SSIM_TPU_IMAGES_DIR", raising=False)
    assert frozen.images_dir() == jax_frozen.images_dir()
    monkeypatch.setenv("SSIM_TPU_IMAGES_DIR", str(tmp_path))
    assert frozen.images_dir() == jax_frozen.images_dir() == str(tmp_path)
    assert not frozen.have_images()
    (tmp_path / "einstein.png").write_bytes(b"")
    assert frozen.have_images() and jax_frozen.have_images()


def test_testing_imports_without_jax():
    """The testing modules import with JAX blocked and load nothing of
    ssim_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import ssim_tpu_torch.testing.frozen, ssim_tpu_torch.testing.devicebench\n"
        "import ssim_tpu_torch.testing.report\n"
        "assert not any(m == 'ssim_tpu' or m.startswith('ssim_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def _u8_pair(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.normal(0, 8, shape).astype(np.int16)
    return a, np.clip(a.astype(np.int16) + noise, 0, 255).astype(np.uint8)


# (port impl, JAX impl, with_map, options, shape). precise runs JAX's
# Pallas kernel in interpret mode, so its shape is tiny; relaxed needs
# W >= 512 to take the relaxed blurs (the JAX XLA path computes the
# standard tier, so it is held to the relaxed tier's 1e-4 per pixel).
RUNNER_CASES = [
    ("torch", "xla", False, {}, (2, 40, 48)),
    ("torch", "xla", True, {}, (2, 40, 48)),
    ("cuda", "xla", False, {}, (2, 40, 48)),
    ("cuda", "xla", True, {}, (2, 40, 48)),
    ("cuda", "pallas", False, dict(precise=True), (1, 24, 40)),
    ("cuda", "xla", False, dict(relaxed=True), (1, 16, 520)),
    ("auto", "auto", False, {}, (16, 64, 64)),
]


@pytest.mark.parametrize("impl,jax_impl,with_map,opts,shape", RUNNER_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_runner_matches_jax(impl, jax_impl, with_map, opts, shape):
    a, b = _u8_pair(np.random.default_rng(sum(shape)), shape)
    got = devicebench.make_runner(impl, with_map, device="cpu", **opts)(a, b, ITERS)
    jax_opts = {} if jax_impl == "xla" else opts
    want = float(jax_devicebench.make_runner(jax_impl, with_map, **jax_opts)(a, b, ITERS))
    per_px = 1e-4 if opts.get("relaxed") else ORACLE_GLOBAL
    assert abs(got - want) <= per_px * a.size * ITERS, (got, want)


def test_runner_graph_flag_and_eager_on_cpu():
    """On the CPU the loop runs eagerly: no graph, and eager() is the
    same loop as run()."""
    a, b = _u8_pair(np.random.default_rng(1), (2, 24, 32))
    run = devicebench.make_runner("cuda", True, device="cpu")
    assert not run.graph
    assert run(a, b, ITERS) == run.eager(a, b, ITERS)


def test_runner_changes_one_pixel_per_iteration():
    """Each iteration adds 1 to a[0, 0, 0] in the input's dtype (u8 wraps
    mod 256) before its call: the sum over iters equals a loop over the
    changed inputs, and the caller's arrays are untouched."""
    a, b = _u8_pair(np.random.default_rng(2), (1, 20, 24))
    a[0, 0, 0] = 254
    a0 = a.copy()
    run = devicebench.make_runner("torch", False, device="cpu")
    got = run(a, b, 3)
    np.testing.assert_array_equal(a, a0)
    from ssim_tpu_torch.ops.ssim_torch import ssim_parts_torch

    want = np.float32(0.0)
    x = torch.from_numpy(a.copy())
    for _ in range(3):
        x[0, 0, 0] += 1
        want = np.float32(want + ssim_parts_torch(x, torch.from_numpy(b))[0].sum().item())
    assert x[0, 0, 0].item() == 1  # 254 -> 255 -> 0 -> 1
    assert abs(got - float(want)) <= ORACLE_GLOBAL * a.size * 3


def test_grad_runner_matches_jax():
    a, b = _u8_pair(np.random.default_rng(3), (2, 40, 48))
    a, b = a.astype(np.float32), b.astype(np.float32)
    got = devicebench.make_runner("grad", False, device="cpu")(a, b, ITERS)
    want = float(jax_devicebench.make_runner("grad", False)(a, b, ITERS))
    da, db = ssim_grad_cuda(torch.from_numpy(a), torch.from_numpy(b), 1.0, 0.0,
                            data_range=255.0)
    scale = max(da.abs().max().item(), db.abs().max().item())
    # 2 B elements summed per iteration, each within GRAD_REL x max|g|.
    assert abs(got - want) <= GRAD_REL * scale * 2 * a.shape[0] * ITERS, (got, want)


def test_msssim_runner_matches_jax_xla_loop():
    a, b = _u8_pair(np.random.default_rng(4), (2, 176, 184))
    got = devicebench.make_runner("msssim", False, device="cpu")(a, b, ITERS)
    x, want = a.copy(), 0.0
    for _ in range(ITERS):
        x[0, 0, 0] += 1
        want += float(np.asarray(jax_ms_ssim(x, b, data_range=255.0, impl="xla"),
                                 np.float32).sum())
    assert abs(got - want) <= MSSSIM_TOL * a.shape[0] * ITERS, (got, want)


_SPATIAL_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
out = sys.argv[1]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "store"),
                        world_size=1, rank=0)
from ssim_tpu_torch.testing import devicebench

inp = np.load(os.path.join(out, "inputs.npz"))
run = devicebench.make_runner("spatial", False, device="cpu")
np.save(os.path.join(out, "spatial.npy"), np.array(run(inp["a"], inp["b"], int(sys.argv[2]))))
dist.barrier()
sys.stdout.flush(); sys.stderr.flush()
os._exit(0)
"""


def test_spatial_runner_matches_jax(tmp_path):
    """The port's runner on a one-rank gloo group (a subprocess, a file://
    store) against JAX's spatial runner on the 8-device CPU mesh."""
    a, b = _u8_pair(np.random.default_rng(5), (2, 48, 40))
    np.savez(tmp_path / "inputs.npz", a=a, b=b)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", _SPATIAL_WORKER, str(tmp_path), str(ITERS)],
                       cwd=repo, env=dict(os.environ, OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = float(np.load(tmp_path / "spatial.npy"))
    want = float(jax_devicebench.make_runner("spatial", False)(a, b, ITERS))
    # Each iteration adds one mean: the f32 tier's global bound per mean.
    assert abs(got - want) <= ORACLE_GLOBAL * ITERS, (got, want)


def test_spatial_runner_without_a_group_raises():
    with pytest.raises(UnsupportedError, match="multihost.initialize"):
        devicebench.make_runner("spatial", False, device="cpu")


def test_unknown_impl_raises():
    """The port's names only: the JAX names are not aliases."""
    for name in ("pallas", "xla", "reference"):
        with pytest.raises(UnsupportedError, match="unknown devicebench impl"):
            devicebench.make_runner(name, False, device="cpu")


def test_device_throughput_on_cpu_is_finite_and_positive():
    v = devicebench.device_throughput("cuda", batch=2, h=40, w=48, iters=16, reps=1,
                                      device="cpu")
    assert np.isfinite(v) and v > 0


def test_device_throughput_unstable_measurement_raises(monkeypatch):
    """A clock that advances by the same step at every reading makes every
    loop length take the same time: every delta is noise."""
    ticks = iter(range(10**6))
    monkeypatch.setattr(devicebench.time, "perf_counter", lambda: float(next(ticks)))
    with pytest.raises(RuntimeError, match="unstable measurement"):
        devicebench.device_throughput("torch", batch=1, h=16, w=16, iters=8, reps=2,
                                      device="cpu")


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(UnsupportedError):
        devicebench.make_runner("cuda", False)
    with pytest.raises(UnsupportedError):
        devicebench.device_throughput("cuda", batch=1, h=16, w=16, iters=8)


# --- report ------------------------------------------------------------------

EINSTEIN = ["einstein.png", "meanshift.png", "contrast.png", "impulse.png", "blur.png",
            "jpg.png"]


def _write_suite(root, quick=False, hw=(40, 56)):
    """The suite's files: six gray Einstein PNGs, the RGB bbb360 PNG and
    its JPEGs at q 0, 50, 100 (quick: the Einstein PNGs alone), from a
    seed."""
    from PIL import Image

    rng = np.random.default_rng(0x5EED)
    h, w = hw
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    Image.fromarray(ref).save(root / "einstein.png")
    for i, name in enumerate(EINSTEIN[1:]):
        noise = rng.normal(0, 4 + 4 * i, (h, w))
        img = np.clip(ref + noise, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / name)
    if quick:
        return
    png = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(png).save(root / "big_buck_bunny_360_07806.png")
    for q in (0, 50, 100):
        Image.fromarray(png).save(root / f"big_buck_bunny_360_07806_{q:02d}.jpg",
                                  quality=max(q, 1))


def test_suite_pairs_match_jax(tmp_path):
    _write_suite(tmp_path)
    for quick in (False, True):
        got = list(report._suite_pairs(str(tmp_path), quick))
        want = list(jax_report._suite_pairs(str(tmp_path), quick))
        assert [n for n, _, _ in got] == [n for n, _, _ in want]
        assert len(got) == (5 if quick else 14)
        for (_, ga, gb), (_, wa, wb) in zip(got, want):
            np.testing.assert_array_equal(ga, wa)
            np.testing.assert_array_equal(gb, wb)


def _rows(text, title, names):
    """{impl: [numbers]} of the table under `title`."""
    lines = text.splitlines()
    start = lines.index(title)
    rows = {}
    for line in lines[start + 2:]:
        cells = [c.strip() for c in line.split("|")]
        if len(cells) < 2 or cells[0] not in names:
            break
        rows[cells[0]] = [float(c) for c in cells[1:]]
    return rows


def test_report_layout_and_accuracy(tmp_path, monkeypatch):
    from ssim_tpu_torch.dispatch import Implementation, available_impls

    _write_suite(tmp_path)
    monkeypatch.setenv("SSIM_TPU_IMAGES_DIR", str(tmp_path))
    calls = []

    def fake_throughput(impl, with_map=False, **kw):
        calls.append((impl, with_map, kw))
        return 123.0

    monkeypatch.setattr(devicebench, "device_throughput", fake_throughput)
    out = io.StringIO()
    assert report.run_report(quick=False, out=out, device="cpu") == 0
    text = out.getvalue()
    lines = text.splitlines()
    assert lines[0] == "backend: cpu" and lines[1] == ""
    assert lines[2] == "Accuracy vs float64 oracle"
    assert lines[3] == (f"{'impl':>10} | {'avg global':>12} | {'max global':>12} | "
                        f"{'avg pixel':>12} | {'max pixel':>12}")
    assert (f"{'impl':>10} | {'eager nomap':>11} | {'eager map':>11} | "
            f"{'device nomap':>12} | {'device map':>12}") in lines
    names = [i.value for i in available_impls() if i != Implementation.REFERENCE]
    assert {"torch", "cuda"} <= set(names)
    acc = _rows(text, "Accuracy vs float64 oracle", names)
    thr = _rows(text, "Throughput (Mpix/s)", names)
    assert list(acc) == names and list(thr) == names
    for name in names:
        avg_g, max_g, avg_p, max_p = acc[name]
        assert avg_g <= max_g <= ORACLE_GLOBAL and avg_p <= max_p <= ORACLE_PIXEL, acc
        assert all(np.isfinite(v) and v > 0 for v in thr[name][:2])
    # Off the card the plain path is measured, twice (± map), at JAX's size.
    assert [(c[0], c[1]) for c in calls] == [("torch", False), ("torch", True)]
    assert all(c[2] == dict(batch=2, h=1080, w=1920, iters=64, reps=2,
                            device=torch.device("cpu")) for c in calls)
    assert thr["torch"][2:] == [123.0, 123.0]
    assert all(np.isnan(v) for v in thr["cuda"][2:])


def test_report_quick_reads_only_einstein(tmp_path, monkeypatch):
    _write_suite(tmp_path, quick=True)  # no bbb files: --quick must not read them
    monkeypatch.setenv("SSIM_TPU_IMAGES_DIR", str(tmp_path))
    monkeypatch.setattr(devicebench, "device_throughput",
                        lambda *a, **k: pytest.fail("--quick measured a device column"))
    out = io.StringIO()
    assert report.run_report(quick=True, out=out, device="cpu") == 0
    thr = _rows(out.getvalue(), "Throughput (Mpix/s)", ["torch", "cuda", "host"])
    assert all(np.isnan(v) for row in thr.values() for v in row[2:])


def test_report_without_images_returns_1(tmp_path, monkeypatch):
    monkeypatch.setenv("SSIM_TPU_IMAGES_DIR", str(tmp_path))
    out = io.StringIO()
    assert report.run_report(out=out, device="cpu") == 1
    assert out.getvalue() == "test images unavailable; set SSIM_TPU_IMAGES_DIR\n"
    assert report.main(["--quick"]) == 1


def test_report_device_failure_propagates(tmp_path, monkeypatch):
    """The JAX report prints nan for a failed device measurement; the
    port's lets it propagate."""
    _write_suite(tmp_path, hw=(24, 32))
    monkeypatch.setenv("SSIM_TPU_IMAGES_DIR", str(tmp_path))

    def broken(*args, **kw):
        raise RuntimeError("unstable measurement: every delta was noise-dominated")

    monkeypatch.setattr(devicebench, "device_throughput", broken)
    with pytest.raises(RuntimeError, match="unstable measurement"):
        report.run_report(quick=False, out=io.StringIO(), device="cpu")
