#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: CUDA must be available; prints the name and power limit;
2. build: compiles ssim_tpu_torch/csrc/*.cu with nvcc for sm_90a from
   this checkout and prints the build time and the ptxas report;
3. kernel against its plain PyTorch twin on the card, score and map, at
   tiny, ragged, 1080p, over-16384-wide, float-with-NaN, radius 1/16 and
   small-image-batch shapes, and against the f64 oracle on the small ones;
4. the main path: `compute_ssim` and `compute_ssim_map` on uint8 batches
   at 1080p x4, 4K x4 and 16K UHD x1, which must go through the kernel
   (its launch counter must rise) and give finite scores and maps that
   agree with the twin; then times the kernel and the twin with CUDA
   events and the whole call with the host clock.

Prints the kernel record as one JSON line, the card's name and power
limit, and last `{"ok": true, "device": {...}}`. Inputs are random,
made on the device from a fixed seed. Imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

# Tolerances. Kernel against twin: 2e-7 global, never tighter than twice
# the per-pixel bound over sqrt(npix); 1e-5 per pixel (5e-5 at radius 1).
# The kernel is built with --fmad=false and does the twin's operations in
# the twin's order, so its pixels are expected to match exactly. Against
# the f64 oracle: 2e-6 global (never tighter than 2e-3 / sqrt(npix), the
# rule of tests/test_pallas.py) and 1e-3 per pixel.
TWIN_GLOBAL, TWIN_PIXEL, TWIN_PIXEL_R1 = 2e-7, 1e-5, 5e-5
ORACLE_GLOBAL, ORACLE_PIXEL = 2e-6, 1e-3
SEED = 0x55


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def pair(gen, shape, dtype=torch.uint8, data_range=255.0):
    """A correlated random pair on the card."""
    if dtype == torch.uint8:
        a = torch.randint(0, 256, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
        noise = (torch.randn(shape, generator=gen, device="cuda") * 12).to(torch.int32)
        b = (a + noise).clamp_(0, 255)
        return a.to(torch.uint8), b.to(torch.uint8)
    a = torch.rand(shape, generator=gen, device="cuda") * data_range
    b = (a + torch.randn(shape, generator=gen, device="cuda") * 0.05 * data_range)
    return a, b.clamp_(0, data_range)


def scores(partials, npix):
    return partials.double().sum(-1).cpu().numpy() / npix


def twin(a, b, with_map, data_range=255.0, radius=5, sigma=1.5, k1=0.01, k2=0.03):
    from ssim_tpu_torch.ops import ssim_cuda

    return ssim_cuda.ssim_parts_plain(
        a, b, with_map=with_map,
        taps=ssim_cuda.gaussian_taps(np.float32, radius, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range),
    )


def compare_kernel_to_twin(name, a, b, *, oracle=False, **kw):
    """Kernel and twin on the same card tensors; returns max abs error."""
    from ssim_tpu_torch import reference
    from ssim_tpu_torch.ops.ssim_cuda import ssim_parts_cuda

    npix = a.shape[-1] * a.shape[-2]
    pk, mk = ssim_parts_cuda(a, b, with_map=True,
                             allow_float=a.dtype == torch.float32, **kw)
    torch.cuda.synchronize()
    win = {k: v for k, v in kw.items() if k != "allow_float"}
    pp, mp = twin(a, b, True, **win)
    gk, gp = scores(pk, npix), scores(pp, npix)
    check(np.array_equal(np.isnan(gk), np.isnan(gp)), f"{name}: NaN scores differ")
    check(torch.equal(mk.isnan(), mp.isnan()), f"{name}: NaN map pixels differ")
    g_err = float(np.nanmax(np.abs(gk - gp), initial=0.0))
    finite = ~mp.isnan()
    p_err = float((mk[finite] - mp[finite]).abs().max()) if finite.any() else 0.0
    pixel_tol = TWIN_PIXEL_R1 if kw.get("radius", 5) == 1 else TWIN_PIXEL
    g_tol = max(TWIN_GLOBAL, 2 * pixel_tol / npix**0.5)
    check(g_err <= g_tol and p_err <= pixel_tol,
          f"{name}: kernel vs twin global {g_err:.3g} (tol {g_tol:.3g}), "
          f"pixel {p_err:.3g} (tol {pixel_tol:.3g})")
    line = f"  {name}: kernel vs twin global {g_err:.3g} pixel {p_err:.3g}"
    if oracle:
        wo, mo = reference.compute_ssim(
            a.cpu().numpy(), b.cpu().numpy(), with_map=True, **win)
        o_g = float(np.abs(gk - np.asarray(wo)).max())
        o_p = float(np.abs(mk.cpu().numpy().astype(np.float64) - mo).max())
        o_tol = max(ORACLE_GLOBAL, 2e-3 / npix**0.5)
        check(o_g <= o_tol and o_p <= ORACLE_PIXEL,
              f"{name}: kernel vs oracle global {o_g:.3g} (tol {o_tol:.3g}), "
              f"pixel {o_p:.3g}")
        line += f"; vs f64 oracle global {o_g:.3g} pixel {o_p:.3g}"
    print(line, flush=True)
    return max(g_err, p_err), gk


def phase_kernel(gen):
    print("phase 3: kernel against its plain twin on the card", flush=True)
    err = 0.0
    for shape in [(1, 255, 63), (1, 257, 65), (2, 1, 1), (2, 7, 5)]:
        a, b = pair(gen, shape)
        e, _ = compare_kernel_to_twin(f"u8 {shape}", a, b, oracle=True)
        err = max(err, e)
    for shape in [(4, 1080, 1920), (1, 1024, 20480)]:
        a, b = pair(gen, shape)
        e, _ = compare_kernel_to_twin(f"u8 {shape}", a, b)
        err = max(err, e)
    # f32, data_range 1, one NaN in image 0 of 2.
    a, b = pair(gen, (2, 300, 500), torch.float32, 1.0)
    a[0, 123, 321] = float("nan")
    e, g = compare_kernel_to_twin("f32 NaN in image 0 of 2", a, b, data_range=1.0)
    check(np.isnan(g[0]) and np.isfinite(g[1]), f"NaN isolation: scores {g}")
    a_ok = a[1:].contiguous()
    e1, g1 = compare_kernel_to_twin("f32 image 1 alone", a_ok, b[1:].contiguous(),
                                    oracle=True, data_range=1.0)
    check(abs(g1[0] - g[1]) <= TWIN_GLOBAL, f"image 1 alone {g1[0]} vs in batch {g[1]}")
    err = max(err, e, e1)
    for win in (dict(radius=1, sigma=0.8, k1=0.02, k2=0.05),
                dict(radius=16, sigma=3.0, k1=0.015, k2=0.04)):
        a, b = pair(gen, (2, 300, 500))
        e, _ = compare_kernel_to_twin(f"u8 (2, 300, 500) {win}", a, b,
                                      oracle=True, **win)
        err = max(err, e)
    a, b = pair(gen, (4096, 1, 64))
    e, _ = compare_kernel_to_twin("u8 (4096, 1, 64) batch", a, b, oracle=True)
    return max(err, e)


def cuda_ms(fn, reps):
    """Median device time of fn() in ms over reps launches (CUDA events,
    after two warm-up calls)."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


MAIN_CONFIGS = [("1080p_b4", (4, 1080, 1920)), ("4k_b4", (4, 2160, 3840)),
                ("16k_b1", (1, 8640, 15360))]


def phase_main(gen, label):
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import routing, ssim_cuda

    print("phase 4: main path (compute_ssim / compute_ssim_map)", flush=True)
    inputs = {name: pair(gen, shape) for name, shape in MAIN_CONFIGS}
    torch.cuda.synchronize()

    ssim_cuda.LAUNCHES = 0
    results = {}
    for name, shape in MAIN_CONFIGS:
        a, b = inputs[name]
        s = ssim_tpu_torch.compute_ssim(a, b)
        s_map, m = ssim_tpu_torch.compute_ssim_map(a, b)
        results[name] = (s, s_map, m)
    launches = ssim_cuda.LAUNCHES
    check(launches == 2 * len(MAIN_CONFIGS),
          f"main path launched the kernel {launches} times, expected "
          f"{2 * len(MAIN_CONFIGS)}")

    records = {}
    for name, shape in MAIN_CONFIGS:
        a, b = inputs[name]
        s, s_map, m = results[name]
        npix = shape[1] * shape[2]
        s = np.atleast_1d(np.asarray(s, np.float64))
        check(s.shape == (shape[0],) and np.isfinite(s).all(), f"{name}: scores {s}")
        check(np.abs(s - np.atleast_1d(s_map)).max() <= TWIN_GLOBAL,
              f"{name}: score with the map differs")
        check(m.shape == (shape[0],) + shape[1:] and m.dtype == np.float32
              and np.isfinite(m).all() and np.abs(m).max() <= 1.0 + 1e-6,
              f"{name}: map {m.shape} {m.dtype}")
        partials, _ = routing.ssim_parts_auto(a, b)
        check(partials.is_cuda, f"{name}: partials on {partials.device}")
        pp, _ = twin(a, b, False)
        g_err = float(np.abs(scores(pp, npix) - s).max())
        check(g_err <= TWIN_GLOBAL, f"{name}: compute_ssim vs twin {g_err:.3g}")
        del pp

        mpix = shape[0] * npix / 1e6
        kernel = lambda: ssim_cuda.ssim_parts_cuda(a, b)
        kernel_map = lambda: ssim_cuda.ssim_parts_cuda(a, b, with_map=True)
        plain = lambda: twin(a, b, False)
        t_plain_a = cuda_ms(plain, 5)
        t_k = cuda_ms(kernel, 20)
        t_km = cuda_ms(kernel_map, 20)
        t_plain_b = cuda_ms(plain, 5)
        t_plain = min(t_plain_a, t_plain_b)
        e2e = host_ms(lambda: ssim_tpu_torch.compute_ssim(a, b), 10)
        e2e_map = host_ms(lambda: ssim_tpu_torch.compute_ssim_map(a, b), 5)
        rec = dict(
            shape=list(shape), kernel_ms=t_k, kernel_map_ms=t_km,
            plain_ms=t_plain, plain_ms_runs=[t_plain_a, t_plain_b],
            kernel_mpix_s=mpix / t_k * 1e3, kernel_map_mpix_s=mpix / t_km * 1e3,
            plain_mpix_s=mpix / t_plain * 1e3,
            compute_ssim_ms=e2e, compute_ssim_mpix_s=mpix / e2e * 1e3,
            compute_ssim_map_ms=e2e_map,
            compute_ssim_map_mpix_s=mpix / e2e_map * 1e3,
            score_twin_err=g_err,
        )
        records[name] = rec
        print(f"  {name} {shape}: kernel {t_k:.4f} ms ({rec['kernel_mpix_s']:.1f} "
              f"Mpix/s), kernel+map {t_km:.4f} ms ({rec['kernel_map_mpix_s']:.1f} "
              f"Mpix/s), plain twin {t_plain:.4f} ms ({rec['plain_mpix_s']:.1f} "
              f"Mpix/s); compute_ssim {e2e:.3f} ms ({rec['compute_ssim_mpix_s']:.1f} "
              f"Mpix/s), compute_ssim_map {e2e_map:.3f} ms "
              f"({rec['compute_ssim_map_mpix_s']:.1f} Mpix/s) | {label}", flush=True)
        del inputs[name]
        torch.cuda.empty_cache()
    return launches, records


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    # Outside a checkout of the repo this import fails before any output.
    from ssim_tpu_torch.ops import _build

    label = gpu_label()
    print(f"phase 1: card {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"phase 2: built {os.path.relpath(lib_path, HERE)} in {build_s:.1f} s",
          flush=True)
    with open(lib_path + ".log") as f:
        for line in f.read().splitlines():
            if "ssim_fwd" in line or "registers" in line or "spill" in line:
                print("  " + line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    max_err = phase_kernel(gen)
    launches, records = phase_main(gen, label)
    check("jax" not in sys.modules, "JAX was imported")

    ref = records["4k_b4"]
    print(json.dumps({"kernels": [{
        "name": "ssim_fwd",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710, ssim_tpu/ops/ssim_pallas.py:1364",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "shape": ref["shape"],
    }]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
