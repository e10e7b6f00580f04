"""Runs the forward and backward kernels under NVIDIA's compute-sanitizer.

    python -m ssim_tpu_torch.tools.sanitize
    python -m ssim_tpu_torch.tools.sanitize --launches   # the launches alone

Builds the kernel library first, then runs this module's launches under
racecheck, synccheck and initcheck in turn (`compute-sanitizer --tool
<tool> --error-exitcode 9`, the binary beside the nvcc that builds the
kernels) and prints one JSON line: per tool its exit code (9: the tool
reported an error), whether the tool supports the card (it refuses some
before the first CUDA call, and then checks nothing), seconds, its
summary line and the lines that name an error. Where the binary is
absent it says so in that line and exits 2.

The launches (`--launches`): the streaming kMap and kScore on u8
(1, 255, 63) at the segment the picker takes and pinned at every segment
from 32 to 256 rows (the comparison of chip_smoke.py phase 3 that failed
once, ROADMAP Queue 3 P6), one launch of the packed batch stream (u8
64 x 64 x 64) and one of the backward stream (f32 (1, 300, 500), g_map).
Inputs are made on the host from a fixed seed and copied to the card;
each result is held against its plain twin on the CPU (the forward 2e-7
global and 1e-5 per pixel, the backward 1e-6 x max|g|), so the only
kernels the tools see are the port's and the copies.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (1, 255, 63)
TOOLS = ("racecheck", "synccheck", "initcheck")
TOOL_TIMEOUT_S = 300


def _pair(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.normal(0, 12, shape).astype(np.int32)
    return a, np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def launches():
    """Every launch above, each against its twin; returns the worst
    errors and raises on a mismatch."""
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad

    rng = np.random.default_rng(0x5A17)
    worst = {}

    def note(name, err, tol):
        worst[name] = max(worst.get(name, 0.0), err)
        if not err <= tol:
            raise RuntimeError(f"{name}: {err} from the twin (tolerance {tol})")

    a, b = _pair(rng, SHAPE)
    ca, cb = torch.from_numpy(a), torch.from_numpy(b)
    ga, gb = ca.cuda(), cb.cuda()
    kw = ssim_cuda._tile_kw(ca, cb, False, None, None, data_range=255.0, radius=5,
                            sigma=1.5, k1=0.01, k2=0.03)
    want_p, want_m = ssim_cuda.ssim_parts_plain(ca, cb, with_map=True, **kw)
    th = ssim_cuda.TILE_H
    top = min(ssim_cuda.MAX_SEG_TILES, -(-SHAPE[1] // th)) * th
    for seg in [None] + list(range(th, top + 1, th)):
        for mode in ("map", "score"):
            parts, smap = ssim_cuda._launch(ga, gb, mode=mode, segment=seg, **kw)
            torch.cuda.synchronize()
            g = abs(parts.double().sum().item() - want_p.double().sum().item()) / a.size
            note(f"k{mode.capitalize()} global", g, 2e-7)
            if smap is not None:
                note("kMap pixel", (smap.cpu() - want_m).abs().max().item(), 1e-5)

    a, b = _pair(rng, (64, 64, 64))
    ca, cb = torch.from_numpy(a), torch.from_numpy(b)
    got = ssim_cuda.ssim_parts_batch_cuda(ca.cuda(), cb.cuda())
    want = ssim_cuda.ssim_parts_batch_cuda(ca, cb)
    torch.cuda.synchronize()
    note("kBatch global", ((got.cpu().double() - want.double())[:, 0].abs().max().item()
                           / (64 * 64)), 2e-7)

    a = rng.random((1, 300, 500)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    g_map = rng.normal(0, 1e-3, a.shape).astype(np.float32)
    ca, cb, cg = (torch.from_numpy(x) for x in (a, b, g_map))
    da, db = ssim_grad.ssim_grad_cuda(ca.cuda(), cb.cuda(), 0.5, 0.25, cg.cuda(),
                                      data_range=1.0)
    wa, wb = ssim_grad.ssim_grad_cuda(ca, cb, 0.5, 0.25, cg, data_range=1.0)
    torch.cuda.synchronize()
    scale = max(1.0, wa.abs().max().item(), wb.abs().max().item())
    note("K3 stream", max((da.cpu() - wa).abs().max().item(),
                          (db.cpu() - wb).abs().max().item()) / scale, 1e-6)
    return worst


def find_sanitizer():
    """compute-sanitizer beside the toolkit's nvcc, or None."""
    from ssim_tpu_torch.ops import _build

    bin_dir = os.path.dirname(_build.find_nvcc())
    for path in (os.path.join(bin_dir, "compute-sanitizer"),
                 os.path.join(os.path.dirname(bin_dir), "compute-sanitizer",
                              "compute-sanitizer")):
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def run_tools():
    from ssim_tpu_torch.ops import _build

    _build.build()
    sanitizer = find_sanitizer()
    if sanitizer is None:
        return {"sanitizer": None, "error": "no compute-sanitizer beside nvcc"}, 2
    res, rc = {"sanitizer": sanitizer}, 0
    for tool in TOOLS:
        t0 = time.perf_counter()
        cmd = [sanitizer, "--tool", tool, "--error-exitcode", "9",
               sys.executable, "-m", "ssim_tpu_torch.tools.sanitize", "--launches"]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
            code, text = p.returncode, p.stdout + p.stderr
        except subprocess.TimeoutExpired as e:
            # Captured output comes back as bytes here, whatever `text` says.
            code, text = "timeout", (e.stdout or b"").decode(errors="replace")
        lines = text.splitlines()
        res[tool] = {
            "rc": code,
            # The tool refuses some cards ("Device not supported") before the
            # first CUDA call; it then checks nothing.
            "device_supported": not any("Device not supported" in ln for ln in lines),
            "seconds": round(time.perf_counter() - t0, 1),
            "summary": [ln for ln in lines if "ERROR SUMMARY" in ln or "RACECHECK" in ln
                        or "SUMMARY" in ln][-3:],
            "hazards": [ln for ln in lines if "Error" in ln or "Hazard" in ln
                        or "hazard" in ln or "Uninitialized" in ln][:20],
            "tail": lines[-8:],
        }
        rc = rc or (code != 0)
    return res, int(bool(rc))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--launches", action="store_true",
                    help="make the launches in this process (what each tool runs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no GPU"}))
        return 2
    if args.launches:
        print(json.dumps({"launches": launches()}))
        return 0
    res, rc = run_tools()
    print(json.dumps({"sanitize": res}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
