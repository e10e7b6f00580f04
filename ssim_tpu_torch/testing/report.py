"""Accuracy + performance report harness.

Counterpart of `ssim_tpu/testing/report.py`, the rebuild of the reference
test binary's built-in reporting (tests/rmgr-ssim-tests.cpp:163-222):
after running the image suite through every available implementation,
print README-style tables of avg/max global and per-pixel error (vs the
f64 oracle) and Mpix/s throughput per implementation x {map, nomap}.

Run: python -m ssim_tpu_torch.testing.report [--quick]

Every implementation but the oracle runs through `engine.compute` on
`device`: `torch`, `cuda` and, where its library builds, `host` (which
computes on the CPU whatever the device). The device columns come from
`devicebench.device_throughput` at (2, 1080, 1920): `cuda` on a CUDA
device, `torch` off it, neither with --quick (the JAX rule: the fused
kernel measured where it is compiled, the plain path elsewhere). One
deliberate change from the JAX report: a failed device measurement is
not printed as nan but propagates, so the report exits nonzero.
"""

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np


def _suite_pairs(images_dir: str, quick: bool):
    """(name, a, b) single-channel test pairs from the reference image
    suite (tests/rmgr-ssim-tests.cpp:341-403)."""
    from ..utils import load_image

    ref = load_image(os.path.join(images_dir, "einstein.png"))
    for name in ["meanshift.png", "contrast.png", "impulse.png", "blur.png", "jpg.png"]:
        yield name, load_image(os.path.join(images_dir, name)), ref
    if quick:
        return
    png = load_image(os.path.join(images_dir, "big_buck_bunny_360_07806.png"))
    for q in (0, 50, 100):
        jpg = load_image(
            os.path.join(images_dir, f"big_buck_bunny_360_07806_{q:02d}.jpg")
        )
        for c in range(3):
            yield f"bbb360_q{q}_c{c}", jpg[:, :, c], png[:, :, c]


def _backend_line(device) -> str:
    """The device the report ran on: `cuda (<name>, <power limit>)` as
    nvidia-smi prints them, or `cpu`."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    index = torch.cuda.current_device() if dev.index is None else dev.index
    limit = out.stdout.strip().splitlines()[index].split(",")[-1].strip()
    return f"cuda ({torch.cuda.get_device_name(index)}, {limit})"


def run_report(quick: bool = False, out=sys.stdout, *, device="cuda"):
    from .. import engine, reference
    from ..dispatch import Implementation, available_impls
    from . import frozen

    images_dir = frozen.images_dir()
    if not frozen.have_images():
        out.write("test images unavailable; set SSIM_TPU_IMAGES_DIR\n")
        return 1

    device = engine.resolve_device(device)
    impls = [i for i in available_impls() if i != Implementation.REFERENCE]
    gerr = defaultdict(list)
    perr = defaultdict(list)
    ticks = defaultdict(float)
    pixels = defaultdict(int)

    pairs = list(_suite_pairs(images_dir, quick))
    oracle = {}
    for name, a, b in pairs:
        oracle[name] = reference.compute_ssim(a, b, with_map=True)

    for impl in impls:
        for with_map in (False, True):
            key = (impl, with_map)
            for name, a, b in pairs:
                want, want_map = oracle[name]
                t0 = time.perf_counter()
                got, got_map = engine.compute(a, b, with_map=with_map,
                                              impl=impl.value, device=device)
                t1 = time.perf_counter()
                ticks[key] += t1 - t0
                pixels[key] += a.size
                gerr[impl].append(abs(float(got) - want))
                if with_map:
                    perr[impl].append(np.abs(got_map - want_map).max())

    out.write(f"backend: {_backend_line(device)}\n\n")
    out.write("Accuracy vs float64 oracle\n")
    out.write(f"{'impl':>10} | {'avg global':>12} | {'max global':>12} | "
              f"{'avg pixel':>12} | {'max pixel':>12}\n")
    for impl in impls:
        g = np.array(gerr[impl])
        p = np.array(perr[impl]) if perr[impl] else np.array([np.nan])
        out.write(
            f"{impl.value:>10} | {g.mean():12.3e} | {g.max():12.3e} | "
            f"{p.mean():12.3e} | {p.max():12.3e}\n"
        )
    out.write("\nThroughput (Mpix/s)\n")
    out.write(f"{'impl':>10} | {'eager nomap':>11} | {'eager map':>11} | "
              f"{'device nomap':>12} | {'device map':>12}\n")
    on_card = device.type == "cuda"
    for impl in impls:
        no_map = pixels[(impl, False)] / ticks[(impl, False)] / 1e6
        w_map = pixels[(impl, True)] / ticks[(impl, True)] / 1e6
        # Steady-state device numbers by devicebench's method; the eager
        # columns include per-call host transfers (the reference's harness
        # semantics, tests/rmgr-ssim-tests.cpp:107-152). The kernel is
        # measured on the card and the plain path off it.
        dev = [float("nan")] * 2
        measurable = (impl == Implementation.CUDA and on_card) or (
            impl == Implementation.TORCH and not on_card
        )
        if measurable and not quick:
            from .devicebench import device_throughput

            for j, wm in enumerate((False, True)):
                dev[j] = device_throughput(
                    impl.value, with_map=wm, batch=2, h=1080, w=1920,
                    iters=64, reps=2, device=device,
                )
        out.write(
            f"{impl.value:>10} | {no_map:11.1f} | {w_map:11.1f} | "
            f"{dev[0]:12.1f} | {dev[1]:12.1f}\n"
        )
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="einstein suite only")
    args = ap.parse_args(argv)
    return run_report(quick=args.quick)


if __name__ == "__main__":
    sys.exit(main())
