"""The port's entry points (ssim_tpu_torch.entry) and examples
(ssim_tpu_torch.examples) against the JAX package's `__graft_entry__.py`
and `compute_ssim`, on the CPU.

- `entry(device="cpu")`: the forward kernel's plain twin on the JAX
  entry's arrays, against the JAX entry's fn (2e-7 global, the port-
  against-JAX tier of torch_port_util);
- `dryrun_multichip(4, device="cpu")`: 4 gloo rank processes on a (2, 2)
  data x space mesh pass the dry run's own checks (the kernel eval within
  0.05 of 1 - loss, delta moved, the sharded gradient within 3e-5 x
  max|g| of autograd of the unsharded plain path), and the loss is 1 -
  the mean of JAX `compute_ssim(impl="xla")` on the dry run's arrays (1e-6,
  the f32 pairs' mean tolerance of tests/test_torch_port_spatial.py);
- a cuda request raises here, without a GPU: `entry`, `dryrun_multichip`,
  `multihost.initialize` and each example;
- the three examples on the CPU: `sample` on two PPM files against JAX
  `compute_ssim` per channel (to the printed digits), `training` for a few
  steps (the loss falls), `distributed` on 2 gloo ranks through torchrun's
  environment variables, against JAX `compute_ssim`.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import JAX_GLOBAL, JAX_PIXEL, global_tol

from ssim_tpu import compute_ssim as jax_compute_ssim
from ssim_tpu_torch import UnsupportedError
from ssim_tpu_torch import entry as port_entry
from ssim_tpu_torch.examples import distributed as ex_distributed
from ssim_tpu_torch.examples import sample as ex_sample
from ssim_tpu_torch.examples import training as ex_training
from ssim_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN_KERNEL = 1e-6


def test_entry_matches_graft_entry():
    """entry(device="cpu")'s per-image scores on the JAX entry's arrays
    against the JAX entry's fn (ssim_parts_xla on the CPU)."""
    import __graft_entry__

    fn, (a, b) = port_entry.entry(device="cpu")
    j_fn, (ja, jb) = __graft_entry__.entry()
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    got = fn(a, b)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == (2,) and got.device.type == "cpu"
    want = np.asarray(j_fn(ja, jb), np.float64)
    tol = global_tol(JAX_GLOBAL, JAX_PIXEL, a.shape[1] * a.shape[2])
    assert np.abs(got.numpy().astype(np.float64) - want).max() <= tol


def test_dryrun_multichip_four_gloo_ranks(monkeypatch):
    """The distributed training step on a (2, 2) mesh of 4 gloo rank
    processes: its own checks pass, and its loss is JAX's on the same
    arrays."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = port_entry.dryrun_multichip(4, device="cpu")
    assert res["mesh"] == [2, 2]
    assert res["grad_relerr"] <= 3e-5
    assert abs(res["eval_ssim"] - (1.0 - res["loss"])) < port_entry.EVAL_TOL
    assert res["delta_max"] > 0.0
    x = port_entry.dryrun_inputs(2, 2)
    want = 1.0 - np.mean(jax_compute_ssim(x["a"], x["b"], impl="xla", data_range=1.0))
    assert abs(res["loss"] - want) <= MEAN_KERNEL, (res["loss"], want)


def test_cuda_requests_raise_without_a_gpu(tmp_path):
    """Nothing moves to the CPU when cuda is asked for and there is no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda requests run")
    with pytest.raises(UnsupportedError):
        port_entry.entry()
    with pytest.raises(UnsupportedError, match="GPUs"):
        port_entry.dryrun_multichip(2)
    with pytest.raises(UnsupportedError, match="GPU"):
        multihost.initialize("localhost:1", 1, 0)
    with pytest.raises(UnsupportedError):
        ex_training.main(["--steps", "1"])
    with pytest.raises(UnsupportedError):
        ex_distributed.main([])
    a, b = _ppm_pair(tmp_path, 8, 8)
    with pytest.raises(UnsupportedError):
        ex_sample.main([a, b])


def _write_ppm(path, img):
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img).tobytes())


def _ppm_pair(tmp_path, h, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    noise = rng.normal(0, 12, a.shape).astype(np.int32)
    b = np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    pa, pb = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    _write_ppm(pa, a)
    _write_ppm(pb, b)
    return pa, pb


def test_sample_example(tmp_path, capsys):
    """Per-channel SSIM of two PPM files, each printed score JAX
    compute_ssim of its channel to the printed digits (half a unit of the
    6th decimal, plus the global tier)."""
    pa, pb = _ppm_pair(tmp_path, 40, 56)
    assert ex_sample.main([pa, pb, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    from ssim_tpu.utils import load_image

    a, b = load_image(pa), load_image(pb)
    assert len(lines) == 3
    for c, line in enumerate(lines):
        m = re.fullmatch(rf"Channel {c}: SSIM = (-?\d+\.\d{{6}})", line)
        assert m, line
        want = jax_compute_ssim(a[..., c], b[..., c])
        assert abs(float(m.group(1)) - want) <= 5e-7 + global_tol(JAX_GLOBAL, JAX_PIXEL,
                                                                  40 * 56)


def test_sample_example_shape_mismatch(tmp_path, capsys):
    pa, _ = _ppm_pair(tmp_path, 16, 16)
    rng = np.random.default_rng(1)
    pc = str(tmp_path / "c.ppm")
    _write_ppm(pc, rng.integers(0, 256, (16, 20, 3), dtype=np.uint8))
    assert ex_sample.main([pa, pc, "--device", "cpu"]) == 1
    assert "identical dimensions" in capsys.readouterr().err


def test_training_example_loss_falls(capsys):
    """Adam on ssim_loss for a few steps on the CPU: every loss finite and
    the last below the first."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses = ex_training.main(["--steps", "4", "--device", "cpu"])
    finally:
        torch.set_num_threads(old)
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "final  1-SSIM" in capsys.readouterr().out


def test_distributed_example_two_gloo_ranks():
    """The torchrun example on 2 gloo ranks (torchrun's environment set by
    hand): the sharded per-image scores, the all-reduced mean and the
    row-sharded image's score against JAX compute_ssim on its arrays."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ssim_tpu_torch.examples.distributed", "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the distributed example timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    assert outs[1].strip() == "", outs[1]
    text = outs[0]
    assert "2 ranks (gloo)" in text
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (2, 256, 384), dtype=np.uint8)
    b = np.clip(a + rng.normal(0, 10, a.shape).astype(np.int16), 0, 255).astype(np.uint8)
    big_a = rng.integers(0, 256, (2 * 128, 1024), dtype=np.uint8)
    big_b = np.clip(big_a + rng.normal(0, 6, big_a.shape).astype(np.int16), 0,
                    255).astype(np.uint8)
    scores = jax_compute_ssim(a, b, impl="xla")
    per_image = re.search(r"per-image SSIM \(sharded\): \[([^\]]*)\]", text).group(1)
    np.testing.assert_allclose([float(v) for v in per_image.split()], scores, atol=5e-5)
    mean = float(re.search(r"mean via all-reduce: (\S+)", text).group(1))
    assert abs(mean - np.mean(scores)) <= MEAN_KERNEL
    huge = float(re.search(r"huge-image SSIM: (\S+)", text).group(1))
    assert abs(huge - jax_compute_ssim(big_a, big_b, impl="xla")) <= MEAN_KERNEL


def test_initialize_argument_errors():
    """initialize takes its three arguments together or none of them, and
    a device it knows; it checks them before it looks for a group."""
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("localhost:1", device="cpu")
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="device"):
        multihost.initialize(device="mps")
