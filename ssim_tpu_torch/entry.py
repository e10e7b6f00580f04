"""Entry points of the port: the counterpart of the repo's
`__graft_entry__.py`.

- entry(device="cuda"): (fn, (a, b)), a forward step on the flagship path:
  per-image SSIM of a u8 (2, 360, 640) pair through the forward kernel.
- dryrun_multichip(n, device="cuda"): one distributed training step on a
  (data, space) mesh of n ranks, one process each: the SSIM perceptual
  loss of batch-sharded, row-sharded images (halo rows over the ring) and
  its gradient, an SGD update, the kernel route's eval of the updated
  images across the same mesh, and the sharded gradient (the forward
  kernel's row mode and the backward kernel's halo mode) held against
  autograd of the unsharded plain path. Called outside a process group it
  starts n rank processes itself (gloo for "cpu"; nccl and one GPU each
  for "cuda", which needs n GPUs and never moves to the CPU).

`train_step`, `grad_check` and `dryrun_step` take the mesh and tensors of
any size, so the step also runs at full width (chip_smoke.py phase 13).

    python -m ssim_tpu_torch.entry [--device cpu]

runs entry() and dryrun_multichip on every GPU here (4 ranks on the CPU).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from .engine import resolve_device
from .errors import UnsupportedError

# The dry run's checks (__graft_entry__.py:203-211, :238): the kernel eval
# of the u8-quantized images against 1 - loss of the same images in f32,
# and the sharded gradient against unsharded autograd, relative to max|g|.
EVAL_TOL = 0.05
GRAD_REL_TOL = 3e-5
LR = 0.1
RANKS_TIMEOUT_S = 900

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device="cuda"):
    """Return (fn, (a, b)): fn(a, b) is the per-image SSIM, f32 (B,), of
    a u8 pair through the forward kernel on `device` (its plain version
    on the CPU, only when device="cpu" is asked for)."""
    from .ops.routing import ssim_parts_auto

    dev = resolve_device(device)

    def fn(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        partials, _ = ssim_parts_auto(a.to(dev), b.to(dev))
        n = a.shape[-1] * a.shape[-2]
        return (partials.to(torch.float64).sum(-1) / n).to(torch.float32)

    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (2, 360, 640), dtype=np.uint8)
    b = rng.integers(0, 256, (2, 360, 640), dtype=np.uint8)
    return fn, (a, b)


def dryrun_inputs(dp: int, sp: int) -> Dict[str, np.ndarray]:
    """The dry run's arrays for a (dp, sp) mesh, from default_rng(1) as in
    __graft_entry__.py: f32 a, b (2dp, 8sp, 32) in [0, 1], the trainable
    delta (zeros), and the gradient check's correlated pair (dp, 20sp, 64)."""
    batch, h, w = 2 * dp, 8 * sp, 32
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (batch, h, w)).astype(np.float32) / 255.0
    b = rng.integers(0, 256, (batch, h, w)).astype(np.float32) / 255.0
    bb, hh, ww = dp, 20 * sp, 64
    big_a = rng.random((bb, hh, ww)).astype(np.float32)
    big_b = np.clip(big_a + rng.normal(0, 0.05, big_a.shape), 0, 1).astype(np.float32)
    return dict(a=a, b=b, delta=np.zeros_like(a), big_a=big_a, big_b=big_b)


def train_step(mesh, a, b, delta):
    """One SGD step of the perceptual loss 1 - mean SSIM(clamp(a + delta),
    b) on the mesh's ("data", "space") axes through the plain route
    (autograd through the halo exchange's adjoint and the all-reduce), then
    the eval: mean SSIM of the u8-quantized updated pair through the
    kernel route (the forward kernel's row mode with halo operands).
    Returns (new delta, loss, eval SSIM), the same on every rank."""
    from .parallel import mean_ssim_spatial

    x = delta.detach().clone().requires_grad_()
    enhanced = (a + x).clamp(0.0, 1.0)
    loss = 1.0 - mean_ssim_spatial(enhanced, b, mesh, axis="space", batch_axis="data",
                                   data_range=1.0, impl="torch")
    (g,) = torch.autograd.grad(loss, x)
    with torch.no_grad():
        new_delta = delta - LR * g
        e8 = ((a + new_delta).clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        b8 = (b * 255.0 + 0.5).to(torch.uint8)
        eval_ssim = mean_ssim_spatial(e8, b8, mesh, axis="space", batch_axis="data")
    return new_delta, loss.detach(), eval_ssim


def grad_check(mesh, a, b):
    """The gradient of 1 - mean_ssim_spatial(a, b) through the kernels
    (impl="auto": the forward kernel's row mode, the backward kernel's halo
    mode) against autograd of the unsharded plain path on the whole
    tensors. Returns (max |difference|, max |g|)."""
    from .ops.ssim_torch import ssim_parts_torch
    from .parallel import mean_ssim_spatial

    x = a.detach().clone().requires_grad_()
    loss = 1.0 - mean_ssim_spatial(x, b, mesh, axis="space", batch_axis="data",
                                   data_range=1.0, impl="auto")
    (g_sh,) = torch.autograd.grad(loss, x)
    y = a.detach().clone().requires_grad_()
    rows, _ = ssim_parts_torch(y, b, data_range=1.0)
    ref = 1.0 - (rows.to(torch.float64).sum() / y.numel()).to(torch.float32)
    (g_ref,) = torch.autograd.grad(ref, y)
    return float((g_sh - g_ref).abs().max()), float(g_ref.abs().max())


def dryrun_step(mesh, a, b, delta, big_a, big_b) -> Dict[str, float]:
    """train_step on (a, b, delta) and grad_check on (big_a, big_b): the
    dry run's numbers, before its checks."""
    new_delta, loss, eval_ssim = train_step(mesh, a, b, delta)
    err, scale = grad_check(mesh, big_a, big_b)
    return dict(loss=float(loss), eval_ssim=float(eval_ssim),
                delta_max=float(new_delta.abs().max()), grad_err=err,
                grad_scale=scale, grad_relerr=err / max(scale, 1e-12))


def check_dryrun(res: Dict[str, float]) -> None:
    """The dry run's checks; raises RuntimeError on a failed one."""
    problems = []
    if not np.isfinite(res["loss"]):
        problems.append(f"non-finite loss {res['loss']}")
    if not abs(res["eval_ssim"] - (1.0 - res["loss"])) < EVAL_TOL:
        problems.append(f"kernel eval {res['eval_ssim']} inconsistent with the "
                        f"plain loss {res['loss']}")
    if not res["delta_max"] > 0.0:
        problems.append("the SGD update did not move delta")
    if not res["grad_relerr"] <= GRAD_REL_TOL:
        problems.append(f"sharded gradient {res['grad_err']:.3g} from autograd "
                        f"(max|g| {res['grad_scale']:.3g}; bound {GRAD_REL_TOL} x max|g|)")
    if problems:
        raise RuntimeError("dryrun_multichip: " + "; ".join(problems))


def _dryrun_in_group(n_devices: int, device: str) -> Dict[str, float]:
    from .parallel import make_mesh
    from .parallel.mesh import mesh_device

    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of {world} ranks")
    dp = max(1, n_devices // 2)
    sp = n_devices // dp
    mesh = make_mesh((dp, sp), ("data", "space"), device_type=device)
    dev = mesh_device(mesh)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dryrun_inputs(dp, sp).items()}
    res = dryrun_step(mesh, t["a"], t["b"], t["delta"], t["big_a"], t["big_b"])
    check_dryrun(res)
    res["mesh"] = [dp, sp]
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok: mesh=({dp}x{sp}), loss={res['loss']:.6f}, "
              f"kernel_eval_ssim={res['eval_ssim']:.6f}, "
              f"spatial_grad_relerr={res['grad_relerr']:.2e}", flush=True)
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(n_devices: int, device: str) -> Dict[str, float]:
    """Run the dry run in n rank processes (subprocesses: a parent with
    threads must not fork) on a tcp:// store at 127.0.0.1; returns rank 0's
    result. A rank that fails stops the others."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_PARENT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory(prefix="ssim_dryrun_") as tmp:
        logs, procs = [], []
        for rank in range(n_devices):
            out = open(os.path.join(tmp, f"{rank}.out"), "w+")
            err = open(os.path.join(tmp, f"{rank}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ssim_tpu_torch.entry", "--rank", str(rank),
                 "--world", str(n_devices), "--port", str(port), "--device", device],
                cwd=_PKG_PARENT, env=env, stdout=out, stderr=err))
        try:
            deadline = time.monotonic() + RANKS_TIMEOUT_S
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"dryrun_multichip: the {n_devices} ranks "
                                       f"did not finish in {RANKS_TIMEOUT_S} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            texts = []
            for out, err in logs:
                out.seek(0)
                err.seek(0)
                texts.append((out.read(), err.read()))
                out.close()
                err.close()
    failed = [f"rank {r} (rc {p.returncode}): {texts[r][1][-3000:]}"
              for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("dryrun_multichip failed:\n" + "\n".join(failed))
    res = None
    for line in texts[0][0].splitlines():
        if line.startswith("DRYRUN "):
            res = json.loads(line[len("DRYRUN "):])
        else:
            print(line, flush=True)
    if res is None:
        raise RuntimeError("dryrun_multichip: rank 0 printed no result")
    return res


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[str, float]:
    """One distributed training step over an n-rank (data, space) mesh,
    (dp, sp) = (max(1, n // 2), n // dp); raises on a failed check.
    Inside a process group of n ranks it runs there; outside one it starts
    n rank processes. Returns the step's numbers (loss, eval_ssim,
    delta_max, grad_err, grad_scale, grad_relerr, mesh)."""
    device = torch.device(device).type
    if device not in ("cuda", "cpu"):
        raise ValueError(f'device must be "cuda" or "cpu", got {device!r}')
    if dist.is_initialized():
        return _dryrun_in_group(n_devices, device)
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise UnsupportedError(
                f"dryrun_multichip({n_devices}) on cuda needs {n_devices} GPUs, "
                f"this machine has {have}")
    return _spawn_ranks(n_devices, device)


def _rank_main(rank: int, world: int, port: int, device: str) -> None:
    from .parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=device)
    res = _dryrun_in_group(world, device)
    if rank == 0:
        print("DRYRUN " + json.dumps(res), flush=True)
    # Every rank's collectives done; then exit at once, skipping the
    # process group's teardown at interpreter exit (a gloo rank aborted
    # there once, "terminate called without an active exception").
    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.port, args.device)
    fn, (a, b) = entry(args.device)
    print("entry:", fn(a, b).cpu().numpy(), flush=True)
    n = max(1, torch.cuda.device_count()) if args.device == "cuda" else 4
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
