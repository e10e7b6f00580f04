#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: CUDA must be available; prints the name and power limit;
2. build: compiles ssim_tpu_torch/csrc/*.cu with nvcc for sm_90a from
   this checkout (one nvcc per source, in parallel) and prints the build
   time and the ptxas report;
3. forward kernel against its plain PyTorch twin on the card, score and
   map, at tiny, ragged, 1080p, over-16384-wide, float-with-NaN, radius
   1/16 and small-image-batch shapes, and against the f64 oracle on the
   small ones;
4. the main path: one `compute_ssim` on NumPy input with no `device`
   (it must run on the card), then `compute_ssim` and `compute_ssim_map`
   on uint8 batches at 1080p x4, 4K x4 and 16K UHD x1, which must go
   through the kernel (its launch counter must rise) and give finite
   scores and maps that agree with the twin; then times the kernel and
   the twin with CUDA events and the whole call with the host clock;
5. training: the backward kernel against its plain twin with score,
   g_map and w_cs cotangents and per-image weights at tiny, ragged,
   1080p x4, 20480-wide, radius 1/16 and float-with-NaN shapes, and
   against autograd of the plain path at 1080p x4; five Adam steps on
   `ssim_loss` at 1080p x4 (the loss must fall, each kernel must launch
   exactly five times) and one `ssim_and_map` step with a map cotangent
   at 4K (it must launch the backward kernel with g_map); then times the
   backward kernel and its twin with CUDA events and a whole training
   step with the host clock, and traces five steps with torch.profiler
   for the device's busy time per step;
6. MS-SSIM: the forward kernel's components and pooled-components modes
   against their plain twins (pooled images bit for bit, and for uint8
   equal to an exact 2x2 mean computed on the host; per-image [sum cs,
   sum ssim] within the twin tolerance) at tiny and ragged, 1080p x4,
   1x1024x20480, float-with-NaN (the NaN reaches only its own image and
   pooled pixel) and custom sigma/k1/k2 shapes; one `compute_ms_ssim` on
   NumPy uint8 (4, 1080, 1920) with no `device` (exactly 4 pooled and 1
   components launch, no standard-mode launch, scores within 2e-5 of
   `impl="torch"`), with every scale of its pyramid held against the
   twins at its own shape; the gradient of 1 - `ms_ssim` at (4, 1080,
   1920) f32 against autograd of `impl="torch"` (2e-5 of max|g|); five
   Adam steps on 1 - `ms_ssim` there (the loss must fall; exactly 25
   components and 25 backward launches), and the components mode against
   its twin on the trained pair; then times each mode and its twin at the
   pyramid's shapes with CUDA events, the whole `compute_ms_ssim` call
   and a training step with the host clock, traces five steps, and times
   `torch.nn.functional.pad(mode="replicate")`, the library call of the
   unported pad kernel (K4), with the bounds of K4 and K5;
7. the precise tier (`precision="f64"`): the forward kernel's precise
   modes, with and without the map, against their plain twin (maps bit
   for bit, per-image fp64 scores within 1e-12 relative) at tiny and
   ragged, 1080p x4, 1x1024x20480, float-with-NaN, radius 1/16 with
   custom sigma/k1/k2 and uint16 shapes, and against the f64 oracle on
   the small ones; one `compute_ssim(precision="f64")` on NumPy uint8
   (4, 1080, 1920) with no `device` (exactly one precise launch, no
   other launch, no call of the oracle), then `compute_ssim` at the three
   main-path shapes and `compute_ssim_map` under the f64 default; then
   times the precise modes, the standard mode beside them and the twin
   with CUDA events at those shapes and at 1x1024x20480,
   `compute_ssim(precision="f64")` with the host clock, and once the
   oracle route it replaced at (1, 1080, 1920).

Prints the kernel records as one JSON line (with each kernel's roofline
bound), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Inputs are random, made on the device
from a fixed seed. Imports no JAX.
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
# Backward kernel against its twin: 1e-6 * max(1, max|g|) (both round
# alike, so they are expected to agree exactly); against autograd of the
# plain path, an independent formulation: 2e-5 * max(1, max|g|), the
# bound of tests/test_torch_port_grad.py.
GRAD_TWIN, GRAD_AUTOGRAD = 1e-6, 2e-5
# The precise tier. Kernel against twin: maps bit for bit, per-image fp64
# scores within 1e-12 relative (only the order of the tile sums differs).
# Against the f64 oracle: 5e-9 global and 5e-7 per pixel, the JAX
# package's regression bounds (tests/test_precision.py:27-28); with a
# custom window the reference double build's tier, 5e-7 and 1e-5 (the f32
# blurs cancel more at radius 1: 3.4e-6 per pixel on the CPU twin).
PRECISE_REL = 1e-12
PRECISE_GLOBAL, PRECISE_PIXEL = 5e-9, 5e-7
DOUBLE_GLOBAL, DOUBLE_PIXEL = 5e-7, 1e-5
SEED = 0x55

# Roofline bound: the least time the card could take for the same work,
# the larger of the bytes over 3.35 TB/s and the f32 operations over
# 67 TFLOP/s (NVIDIA H100 SXM data sheet, at 700 W). Bytes: each input
# read once, each output written once. Operations per output pixel that
# the function needs at radius r (multiplies, adds, divisions; compares
# and selects not counted; the product signals (a+b)^2 and (a-b)^2 formed
# once per pixel, not once per tap pair as the kernels recompute them;
# halo recompute not counted):
# - forward (csrc/ssim_fwd.cu): the four signals 4, then horizontal pass
#   12r + 8 (per tap pair and signal an add, a multiply and an
#   accumulate; the centre tap 2 per signal), vertical pass 12r + 8,
#   SSIM formula and tile sum 23: 24r + 43;
# - backward (csrc/ssim_bwd.cu): forward blurs 24r + 20, 66 for the
#   weight maps (one more with g_map), vertical and horizontal adjoints
#   12r + 8 each, 14 for da/db: 48r + 116;
# - MS-SSIM components (the forward's kComponents mode): the forward's
#   24r + 43 less the standard formula's two products num and den, which
#   the function does not need, plus the second division, the l * cs
#   product and the second tile sum (2): 24r + 45; two f32 partials per
#   tile;
# - pooled components (kPooled): 24r + 45, plus 2 operations per input
#   pixel for the pool (3 adds and a multiply per 2x2 block of each of
#   the two images) and 2 bytes written per input pixel (two f32 images
#   of a quarter of the pixels): 24r + 47;
# - K4, the unported pad kernel (ssim_tpu/ops/pad.py): bytes only, one
#   read of (B, H, W) and one write of (B, hp, wp);
# - K5, the unported small-image probe (tools/probe_bpack.py): the
#   forward's 24r + 43 per pixel, u8 inputs, one f32 partial per image;
# - precise (the forward's kPrecise mode): the f32 blurs, 24r + 20 at the
#   f32 rate, plus in fp64 the four widenings of the blurred signals and
#   the formula and tile sum (23, as counted for the forward): 27 at
#   34 TFLOP/s (FP64 outside the tensor cores, H100 SXM data sheet), the
#   two times added; one f64 partial (8 bytes) per tile, and with the map
#   4 bytes per pixel.
HBM_BYTES_PER_S, F32_OPS_PER_S, F64_OPS_PER_S = 3.35e12, 67e12, 34e12


def bound_ms(nbytes, ops):
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_bound(shape, itemsize, radius=5):
    bsz, h, w = shape
    npix = bsz * h * w
    tiles = bsz * -(-h // 32) * -(-w // 64)
    return bound_ms(2 * itemsize * npix + 4 * tiles, (24 * radius + 43) * npix)


def bwd_bound(shape, with_g, radius=5):
    bsz, h, w = shape
    npix = bsz * h * w
    return bound_ms((16 + 4 * with_g) * npix + 8 * bsz,
                    (48 * radius + 116 + with_g) * npix)


def precise_bound(shape, itemsize, with_map=False, radius=5):
    bsz, h, w = shape
    npix = bsz * h * w
    tiles = bsz * -(-h // 32) * -(-w // 64)
    t_bytes = (2 * itemsize * npix + 8 * tiles + 4 * npix * with_map) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = ((24 * radius + 20) * npix / F32_OPS_PER_S
             + 27 * npix / F64_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def comp_bound(shape, itemsize, pooled, radius=5):
    bsz, h, w = shape
    npix = bsz * h * w
    tiles = bsz * -(-h // 32) * -(-w // 64)
    pooled_px = bsz * (h // 2) * (w // 2) if pooled else 0
    return bound_ms(2 * itemsize * npix + 8 * tiles + 8 * pooled_px,
                    (24 * radius + 45) * npix + 8 * pooled_px)


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
    """Device time of one fn() call in ms: CUDA events around reps
    back-to-back calls, so the host's launch work overlaps the device's
    (events around a single call would also count the device idling while
    the host launches); the median of three such runs, after two warm-up
    calls."""
    fn()
    fn()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return statistics.median(runs)


def host_times(fn, reps):
    """Host-clock times of fn() in ms, each ending in a synchronize
    (after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def host_ms(fn, reps):
    return statistics.median(host_times(fn, reps))


def device_trace(fn, reps):
    """One torch.profiler trace of reps calls of fn(). Returns the device's
    busy ms per call (the union of its kernel and copy intervals), the
    traced window's host-clock ms per call, the device operations per
    call, and the ms per call of each operation name, largest first; the
    busy time is None when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3 / reps
    spans, by_name = [], {}
    for e in prof.events():
        # Ranges that annotate the device timeline (Optimizer.step) span
        # kernels listed on their own, and the gaps between them.
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / reps
    if not spans:
        return None, window, 0, []
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return busy_us / 1e3 / reps, window, len(spans) / reps, top


def kernel_trace_ms(fn, reps, name):
    """Device ms per fn() call of the kernels whose name holds `name`, from
    one torch.profiler trace of reps calls: the kernel alone. Where a
    launch is shorter than the wrapper's host work, events around
    back-to-back calls (cuda_ms) measure the host instead. None when the
    trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(us) / 1e3 / reps if us else None


MAIN_CONFIGS = [("1080p_b4", (4, 1080, 1920)), ("4k_b4", (4, 2160, 3840)),
                ("16k_b1", (1, 8640, 15360))]


def phase_main(gen, label):
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import routing, ssim_cuda

    print("phase 4: main path (compute_ssim / compute_ssim_map)", flush=True)
    inputs = {name: pair(gen, shape) for name, shape in MAIN_CONFIGS}
    torch.cuda.synchronize()

    # NumPy input with no device runs on the card.
    a_np, b_np = (x.cpu().numpy() for x in inputs["1080p_b4"])
    ssim_cuda.LAUNCHES = 0
    s_np = ssim_tpu_torch.compute_ssim(a_np, b_np)
    check(ssim_cuda.LAUNCHES == 1,
          f"NumPy compute_ssim launched the kernel {ssim_cuda.LAUNCHES} times")
    check(s_np.shape == (4,) and np.isfinite(s_np).all(), f"NumPy scores {s_np}")
    print(f"  NumPy input, no device: 1 launch, scores {s_np}", flush=True)

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
        bnd, by = fwd_bound(shape, 1)
        rec = dict(
            shape=list(shape), kernel_ms=t_k, kernel_map_ms=t_km,
            bound_ms=bnd, bound_by=by,
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
              f"({rec['compute_ssim_map_mpix_s']:.1f} Mpix/s); bound {bnd:.4f} ms "
              f"({by}) | {label}", flush=True)
        del inputs[name]
        torch.cuda.empty_cache()
    return launches, records


def grad_twin(a, b, w_s, w_cs, g_map, data_range=1.0, radius=5, sigma=1.5,
              k1=0.01, k2=0.03):
    from ssim_tpu_torch.ops import ssim_grad

    return ssim_grad.ssim_grad_plain(
        a, b, w_s, w_cs, g_map,
        taps=ssim_grad.gaussian_taps(np.float32, radius, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range),
    )


def compare_grad_to_twin(name, a, b, w_s, w_cs, g_map, **kw):
    """Backward kernel and twin on the same card tensors; returns the max
    abs error and the kernel's (da, db)."""
    from ssim_tpu_torch.ops.ssim_grad import ssim_grad_cuda

    kw.setdefault("data_range", 1.0)
    da, db = ssim_grad_cuda(a, b, w_s, w_cs, g_map, **kw)
    torch.cuda.synchronize()
    pa, pb = grad_twin(a, b, w_s, w_cs, g_map, **kw)
    err, scale = 0.0, 1.0
    for k, p in ((da, pa), (db, pb)):
        check(torch.equal(k.isnan(), p.isnan()), f"{name}: NaN gradients differ")
        fin = ~p.isnan()
        if fin.any():
            err = max(err, float((k[fin] - p[fin]).abs().max()))
            scale = max(scale, float(p[fin].abs().max()))
    check(err <= GRAD_TWIN * scale,
          f"{name}: backward kernel vs twin {err:.3g} (tol {GRAD_TWIN * scale:.3g})")
    print(f"  {name}: backward kernel vs twin {err:.3g} (max|g| {scale:.3g})",
          flush=True)
    del pa, pb
    return err, da, db


def phase_train(gen, label):
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
    from ssim_tpu_torch.ops.ssim_torch import ssim_parts_torch

    print("phase 5: training (ssim_loss / ssim_and_map, backward kernel)",
          flush=True)

    def weights(bsz):
        w_s = torch.rand(bsz, generator=gen, device="cuda") + 0.5
        w_cs = torch.rand(bsz, generator=gen, device="cuda") * 0.3
        return w_s, w_cs

    # (a) The backward kernel against its twin: score (per-image w_s), w_cs
    # and g_map cotangents.
    max_err = 0.0
    cases = [((1, 255, 63), {}), ((1, 257, 65), {}), ((2, 7, 9), {}),
             ((4, 1080, 1920), {}), ((1, 1024, 20480), {}),
             ((2, 300, 500), dict(radius=1, sigma=0.8, k1=0.02, k2=0.05)),
             ((2, 300, 500), dict(radius=16, sigma=3.0, k1=0.015, k2=0.04))]
    for shape, win in cases:
        a, b = pair(gen, shape, torch.float32, 1.0)
        w_s, w_cs = weights(shape[0])
        g = torch.randn(shape, generator=gen, device="cuda")
        for g_map in (None, g):
            tag = f"f32 {shape} {win}" + (" g_map" if g_map is not None else "")
            e, _, _ = compare_grad_to_twin(tag, a, b, w_s, w_cs, g_map, **win)
            max_err = max(max_err, e)
    # f32, one NaN in image 0 of 2: NaN at the pixel, image 1 finite and
    # equal to image 1 alone.
    a, b = pair(gen, (2, 300, 500), torch.float32, 1.0)
    a[0, 123, 321] = float("nan")
    w_s, w_cs = weights(2)
    e, da, db = compare_grad_to_twin("f32 NaN in image 0 of 2", a, b, w_s, w_cs, None)
    d1, e1 = ssim_grad.ssim_grad_cuda(a[1:].contiguous(), b[1:].contiguous(),
                                      w_s[1:], w_cs[1:], data_range=1.0)
    check(bool(da[0, 123, 321].isnan()) and bool(db[0, 123, 321].isnan())
          and bool(torch.isfinite(da[1]).all()) and bool(torch.isfinite(db[1]).all()),
          "NaN isolation: gradients")
    check(torch.equal(da[1], d1[0]) and torch.equal(db[1], e1[0]),
          "NaN isolation: image 1 differs from image 1 alone")
    print("  NaN isolated to image 0; image 1 equals image 1 alone", flush=True)
    max_err = max(max_err, e)
    # Against autograd of the plain path, an independent formulation.
    shape = (4, 1080, 1920)
    a, b = pair(gen, shape, torch.float32, 1.0)
    w_s, _ = weights(4)
    g = torch.randn(shape, generator=gen, device="cuda")
    at, bt = a.clone().requires_grad_(), b.clone().requires_grad_()
    _, m = ssim_parts_torch(at, bt, with_map=True, data_range=1.0)
    ga, gb = torch.autograd.grad(((w_s[:, None, None] + g) * m).sum(), (at, bt))
    da, db = ssim_grad.ssim_grad_cuda(a, b, w_s, 0.0, g, data_range=1.0)
    err = max(float((da - ga).abs().max()), float((db - gb).abs().max()))
    scale = max(1.0, float(ga.abs().max()))
    check(err <= GRAD_AUTOGRAD * scale,
          f"backward kernel vs autograd {err:.3g} (tol {GRAD_AUTOGRAD * scale:.3g})")
    print(f"  f32 {shape} g_map: backward kernel vs autograd of ssim_parts_torch "
          f"{err:.3g} (max|g| {scale:.3g})", flush=True)
    del at, bt, m, ga, gb, da, db

    # (b) The training path at full width: examples/training.py's Adam
    # denoising on 1 - SSIM, five steps.
    clean = torch.rand(shape, generator=gen, device="cuda")
    noisy = (clean + 0.15 * torch.randn(shape, generator=gen, device="cuda")).clamp_(0, 1)
    x = noisy.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=0.02)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = ssim_tpu_torch.ssim_loss(x, clean)
        loss.backward()
        finite = torch.isfinite(x.grad).all()
        opt.step()
        with torch.no_grad():
            x.clamp_(0.0, 1.0)
        return loss.detach(), finite

    torch.cuda.synchronize()
    ssim_cuda.LAUNCHES = 0
    ssim_grad.LAUNCHES = 0
    results = [step() for _ in range(5)]
    fwd_launches, bwd_launches = ssim_cuda.LAUNCHES, ssim_grad.LAUNCHES
    losses = [float(loss) for loss, _ in results]
    check(fwd_launches == 5 and bwd_launches == 5,
          f"5 training steps launched the forward kernel {fwd_launches} and "
          f"the backward kernel {bwd_launches} times, expected 5 and 5")
    check(all(bool(f) for _, f in results), "non-finite gradients in training")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss did not fall: {losses}")
    print(f"  5 Adam steps on ssim_loss {shape}: 1-SSIM {losses}; launches "
          f"forward {fwd_launches}, backward {bwd_launches}", flush=True)

    # One ssim_and_map step with a map cotangent: K3 with g_map.
    a4, b4 = pair(gen, (1, 2160, 3840), torch.float32, 1.0)
    xm = a4.clone().requires_grad_()
    seen = []
    real = ssim_grad.ssim_grad_cuda

    def spy(*args, **kwargs):
        seen.append(len(args) > 4 and args[4] is not None)
        return real(*args, **kwargs)

    ssim_grad.ssim_grad_cuda = spy
    try:
        before = ssim_grad.LAUNCHES
        score, m = ssim_tpu_torch.ssim_and_map(xm, b4, data_range=1.0)
        (score.sum() + (m * m).sum()).backward()
        torch.cuda.synchronize()
        map_launches = ssim_grad.LAUNCHES - before
    finally:
        ssim_grad.ssim_grad_cuda = real
    check(map_launches == 1 and seen == [True],
          f"ssim_and_map backward: {map_launches} launches, g_map passed {seen}")
    check(bool(torch.isfinite(xm.grad).all()), "ssim_and_map: non-finite gradient")
    print(f"  ssim_and_map (1, 2160, 3840), score + map cotangent: 1 launch with "
          f"g_map, score {score.item():.6f}", flush=True)
    del a4, b4, xm, m

    # (c) Times: the kernel at grad_1080_b4 (bench.py's training config:
    # w_s = 1, w_cs = 0, data_range 255, u8-valued f32) and at 4K x4, each
    # with and without g_map; the twin at the same shapes; a whole step.
    records = {}
    for name, tshape in (("grad_1080_b4", (4, 1080, 1920)),
                         ("grad_4k_b4", (4, 2160, 3840))):
        au, bu = pair(gen, tshape)
        a, b = au.float(), bu.float()
        del au, bu
        g = torch.randn(tshape, generator=gen, device="cuda")
        ones = torch.ones(tshape[0], device="cuda")
        zeros = torch.zeros(tshape[0], device="cuda")
        kern = lambda gm: ssim_grad.ssim_grad_cuda(a, b, ones, zeros, gm,
                                                   data_range=255.0)
        plain = lambda gm: grad_twin(a, b, ones, zeros, gm, data_range=255.0)
        t_plain = cuda_ms(lambda: plain(None), 5)
        t_k = cuda_ms(lambda: kern(None), 20)
        t_kg = cuda_ms(lambda: kern(g), 20)
        t_plain_g = cuda_ms(lambda: plain(g), 5)
        mpix = tshape[0] * tshape[1] * tshape[2] / 1e6
        bnd, by = bwd_bound(tshape, False)
        bnd_g, by_g = bwd_bound(tshape, True)
        records[name] = dict(
            shape=list(tshape), kernel_ms=t_k, kernel_gmap_ms=t_kg,
            plain_ms=t_plain, plain_gmap_ms=t_plain_g, bound_ms=bnd, bound_by=by,
            bound_gmap_ms=bnd_g, bound_gmap_by=by_g,
        )
        print(f"  {name} {tshape}: kernel {t_k:.4f} ms ({mpix / t_k * 1e3:.1f} "
              f"Mpix/s), kernel+g_map {t_kg:.4f} ms ({mpix / t_kg * 1e3:.1f} "
              f"Mpix/s), plain twin {t_plain:.3f} ms ({mpix / t_plain * 1e3:.1f} "
              f"Mpix/s), twin+g_map {t_plain_g:.3f} ms; bound {bnd:.4f} ms "
              f"({by}), {bnd_g:.4f} ms with g_map | {label}", flush=True)
        del a, b, g
        torch.cuda.empty_cache()
    steps = host_times(step, 10)
    t_step = statistics.median(steps)
    # The step's parts on the device: the forward kernel on the f32 pair,
    # and one Adam update (the backward kernel is timed above).
    x_now = x.detach()
    t_fwd = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(
        x_now, clean, allow_float=True, data_range=1.0), 20)
    t_adam = cuda_ms(opt.step, 20)
    mpix = shape[0] * shape[1] * shape[2] / 1e6
    print(f"  training step (ssim_loss forward + backward + Adam) {shape}: "
          f"{t_step:.3f} ms median of 10 ({min(steps):.3f}-{max(steps):.3f}; "
          f"{mpix / t_step * 1e3:.1f} Mpix/s); forward kernel on f32 "
          f"{t_fwd:.4f} ms, Adam update {t_adam:.4f} ms | {label}", flush=True)
    # One profiler trace of five steps: the device's busy time per step.
    busy, window, n_ops, top = device_trace(step, 5)
    if busy is None:
        print("  trace: the profiler recorded no device activity", flush=True)
    else:
        print(f"  trace of 5 steps: device busy {busy:.4f} ms per step, "
              f"{busy / t_step:.1%} of the untraced step, {busy / window:.1%} "
              f"of the traced window ({window:.3f} ms per step); "
              f"{n_ops:.0f} device operations per step", flush=True)
        for name, ms in top[:8]:
            print(f"    {ms:.4f} ms  {name[:90]}", flush=True)
    records["train_step"] = dict(
        shape=list(shape), step_ms=t_step, step_ms_runs=steps,
        fwd_kernel_ms=t_fwd, adam_ms=t_adam, trace_busy_ms=busy,
        trace_window_ms=window, trace_ops_per_step=n_ops,
        trace_top=top[:8])
    return fwd_launches, bwd_launches, max_err, records


def comp_twin(a, b, pooled, data_range=255.0, sigma=1.5, k1=0.01, k2=0.03):
    """The plain twin of the pooled-components mode, (parts, pooled_a,
    pooled_b), or of the components mode, parts."""
    from ssim_tpu_torch.ops import ssim_cuda

    fn = (ssim_cuda.ssim_components_pooled_plain if pooled
          else ssim_cuda.ssim_components_plain)
    return fn(
        a, b, taps=ssim_cuda.gaussian_taps(np.float32, 5, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range),
    )


def same(x, y):
    """Equal bit for bit, NaN where NaN."""
    return torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())


def host_pool(x):
    """The exact 2x2 mean of a (B, H, W) uint8 tensor, computed on the
    host in integers (a sum of four u8 over 4 is exact in f32)."""
    v = x.cpu().numpy().astype(np.int64)
    h2, w2 = v.shape[1] // 2, v.shape[2] // 2
    v = v[:, : 2 * h2, : 2 * w2]
    s = v[:, 0::2, 0::2] + v[:, 1::2, 0::2] + v[:, 0::2, 1::2] + v[:, 1::2, 1::2]
    return torch.from_numpy((s / 4.0).astype(np.float32))


def compare_components(name, a, b, **kw):
    """Both components modes and the twin on the same card tensors. Returns
    the max abs error of the per-image [mean cs, mean ssim], the kernel's
    means, and its pooled images."""
    from ssim_tpu_torch.ops.ssim_cuda import (
        ssim_components_cuda, ssim_components_pooled_cuda,
    )

    ck = ssim_components_cuda(a, b, **kw)
    pk, pak, pbk = ssim_components_pooled_cuda(a, b, **kw)
    torch.cuda.synchronize()
    ct, pat, pbt = comp_twin(a, b, True, **kw)
    check(same(ck, pk), f"{name}: the pooled mode's partials differ from the "
          f"components mode's")
    check(same(pak, pat) and same(pbk, pbt), f"{name}: pooled images differ from the twin's")
    if a.dtype == torch.uint8:
        check(torch.equal(pak.cpu(), host_pool(a)) and torch.equal(pbk.cpu(), host_pool(b)),
              f"{name}: pooled images differ from the exact 2x2 mean")
    npix = a.shape[-1] * a.shape[-2]
    mk = ck.double().sum(-2).cpu().numpy() / npix
    mt = ct.double().sum(-2).cpu().numpy() / npix
    check(np.array_equal(np.isnan(mk), np.isnan(mt)), f"{name}: NaN means differ")
    err = float(np.nanmax(np.abs(mk - mt), initial=0.0))
    tol = max(TWIN_GLOBAL, 2 * TWIN_PIXEL / npix**0.5)
    check(err <= tol, f"{name}: components kernel vs twin {err:.3g} (tol {tol:.3g})")
    print(f"  {name}: [mean cs, mean ssim] kernel vs twin {err:.3g}; pooled images "
          f"equal the twin's bit for bit" + (" and the exact mean" if a.dtype == torch.uint8
                                            else ""), flush=True)
    return err, mk, (pak, pbk)


def launch_counts():
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad

    return dict(standard=ssim_cuda.LAUNCHES, precise=ssim_cuda.PRECISE_LAUNCHES,
                components=ssim_cuda.COMPONENTS_LAUNCHES,
                pooled=ssim_cuda.POOLED_LAUNCHES, backward=ssim_grad.LAUNCHES)


def zero_counts():
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad

    ssim_cuda.LAUNCHES = ssim_cuda.PRECISE_LAUNCHES = 0
    ssim_cuda.COMPONENTS_LAUNCHES = ssim_cuda.POOLED_LAUNCHES = 0
    ssim_grad.LAUNCHES = 0


def phase_msssim(gen, label):
    import ssim_tpu_torch
    from ssim_tpu_torch.ops.ssim_cuda import (
        ssim_components_cuda, ssim_components_pooled_cuda,
    )

    print("phase 6: MS-SSIM (components and pooled-components modes)", flush=True)
    # (a) Both modes against their twins.
    err = 0.0
    for shape in [(1, 255, 63), (1, 257, 65), (2, 7, 9), (1, 1024, 20480)]:
        a, b = pair(gen, shape)
        e, _, _ = compare_components(f"u8 {shape}", a, b)
        err = max(err, e)
    wide = (a, b, 255.0)  # wider than K2's 16384 lanes
    shape = (4, 1080, 1920)
    a, b = pair(gen, shape)
    e, _, (pa, pb) = compare_components(f"u8 {shape} (scale 0)", a, b)
    e1, _, _ = compare_components(f"f32 {tuple(pa.shape)} (scale 1)", pa, pb)
    err = max(err, e, e1)
    del pa, pb
    a, b = pair(gen, (2, 300, 500), torch.float32, 1.0)
    a[0, 123, 321] = float("nan")
    e, m, (pa, _) = compare_components("f32 NaN in image 0 of 2", a, b, data_range=1.0)
    nan_px = torch.nonzero(pa.isnan()).tolist()
    check(np.isnan(m[0]).all() and np.isfinite(m[1]).all() and nan_px == [[0, 61, 160]],
          f"NaN isolation: means {m}, NaN pooled pixels {nan_px}")
    print("  NaN reaches only image 0 and its own pooled pixel", flush=True)
    err = max(err, e)
    a, b = pair(gen, (2, 300, 500))
    e, _, _ = compare_components("u8 (2, 300, 500) sigma 2.0, k1 0.02, k2 0.05", a, b,
                                 sigma=2.0, k1=0.02, k2=0.05)
    err = max(err, e)

    # (b) The inference path: compute_ms_ssim on NumPy uint8, no device.
    a, b = pair(gen, shape)
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    torch.cuda.synchronize()
    zero_counts()
    s_np = ssim_tpu_torch.compute_ms_ssim(a_np, b_np)
    infer = launch_counts()
    check(infer == dict(standard=0, precise=0, components=1, pooled=4, backward=0),
          f"compute_ms_ssim launches {infer}, expected 4 pooled and 1 components")
    s_plain = ssim_tpu_torch.compute_ms_ssim(a_np, b_np, impl="torch")
    d = float(np.abs(s_np - s_plain).max())
    check(s_np.shape == shape[:1] and np.isfinite(s_np).all() and d <= 2e-5,
          f"compute_ms_ssim {s_np} vs impl=torch {s_plain} ({d:.3g})")
    print(f"  compute_ms_ssim NumPy u8 {shape}, no device: launches {infer}; "
          f"scores {s_np}; vs impl=\"torch\" on the card {d:.3g}", flush=True)
    # Each scale of that call's pyramid against the twins at its own shape:
    # the pooled f32 scales 1-3 (scale 1 is held in (a)) and the last.
    scales = [(a, b, 255.0)]
    for _ in range(4):
        _, pa, pb = ssim_components_pooled_cuda(*scales[-1][:2])
        scales.append((pa, pb, 255.0))
    for lvl in (2, 3, 4):
        e, _, _ = compare_components(f"f32 {tuple(scales[lvl][0].shape)} (scale {lvl})",
                                     scales[lvl][0], scales[lvl][1])
        err = max(err, e)

    # (c) Training: five Adam steps on 1 - ms_ssim at full width.
    clean = torch.rand(shape, generator=gen, device="cuda")
    noisy = (clean + 0.15 * torch.randn(shape, generator=gen, device="cuda")).clamp_(0, 1)
    x = noisy.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=0.02)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = 1.0 - ssim_tpu_torch.ms_ssim(x, clean, data_range=1.0).mean()
        loss.backward()
        finite = torch.isfinite(x.grad).all()
        opt.step()
        with torch.no_grad():
            x.clamp_(0.0, 1.0)
        return loss.detach(), finite

    # The first step's gradient against autograd of the plain pyramid on
    # the same tensors. The loss is a mean over pixels, so |g| is far below
    # 1: the tolerance scales with max|g| alone.
    xk = x.detach().clone().requires_grad_()
    (1.0 - ssim_tpu_torch.ms_ssim(xk, clean, data_range=1.0).mean()).backward()
    xt = x.detach().clone().requires_grad_()
    (gt,) = torch.autograd.grad(
        1.0 - ssim_tpu_torch.ms_ssim(xt, clean, data_range=1.0, impl="torch").mean(), xt)
    grad_err = float((xk.grad - gt).abs().max())
    grad_scale = float(gt.abs().max())
    check(bool(torch.isfinite(xk.grad).all()) and grad_err <= GRAD_AUTOGRAD * grad_scale,
          f"MS-SSIM gradient vs autograd of impl=\"torch\" {grad_err:.3g} "
          f"(tol {GRAD_AUTOGRAD * grad_scale:.3g})")
    print(f"  f32 {shape} gradient of 1 - ms_ssim: kernels vs autograd of "
          f"impl=\"torch\" {grad_err:.3g} (max|g| {grad_scale:.3g}, "
          f"{grad_err / grad_scale:.3g} of it)", flush=True)
    del xk, xt, gt

    torch.cuda.synchronize()
    zero_counts()
    results = [step() for _ in range(5)]
    train = launch_counts()
    losses = [float(loss) for loss, _ in results]
    check(train == dict(standard=0, precise=0, components=25, pooled=0, backward=25),
          f"5 MS-SSIM training steps launched {train}, expected 25 components and "
          f"25 backward")
    check(all(bool(f) for _, f in results), "non-finite gradients in MS-SSIM training")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the MS-SSIM loss did not fall: {losses}")
    print(f"  5 Adam steps on 1 - ms_ssim {shape}: losses {losses}; launches {train}",
          flush=True)
    e, _, _ = compare_components(f"f32 {shape} data_range 1 (training scale 0)",
                                 x.detach(), clean, data_range=1.0)
    err = max(err, e)

    # (d) Times at the pyramid's shapes: pooled u8 at scale 0, pooled f32
    # at scale 1, components at the last scale (u8 pyramid) and at scale 0
    # of the training pyramid, and components at width 20480 (the width
    # JAX serves with K2); each mode's twin beside it. Kernel times by
    # CUDA events around back-to-back calls and, from a profiler trace, of
    # the kernel alone (at the last scale the events measure the wrapper's
    # host work, longer than the kernel).
    modes = [
        ("pooled_u8_scale0", True, scales[0]),
        ("pooled_f32_scale1", True, scales[1]),
        ("components_f32_scale4", False, scales[4]),
        ("components_f32_train_scale0", False, (x.detach(), clean, 1.0)),
        ("components_u8_wide", False, wide),
    ]
    times = {}
    for name, pooled, (ta, tb, dr) in modes:
        fn = ssim_components_pooled_cuda if pooled else ssim_components_cuda
        t_k = cuda_ms(lambda: fn(ta, tb, data_range=dr), 20)
        t_dev = kernel_trace_ms(lambda: fn(ta, tb, data_range=dr), 20, "ssim_fwd_kernel")
        t_p = cuda_ms(lambda: comp_twin(ta, tb, pooled, data_range=dr), 5)
        bnd, by = comp_bound(tuple(ta.shape), ta.element_size(), pooled)
        mpix = ta.numel() / 1e6
        times[name] = dict(shape=list(ta.shape), ms=t_k, device_ms=t_dev, plain_ms=t_p,
                           bound_ms=bnd, bound_by=by, mpix_s=mpix / t_k * 1e3)
        dev = "not recorded" if t_dev is None else f"{t_dev:.4f} ms"
        print(f"  {name} {tuple(ta.shape)} {ta.dtype}: kernel {t_k:.4f} ms "
              f"({mpix / t_k * 1e3:.1f} Mpix/s), in the trace {dev}; plain twin "
              f"{t_p:.4f} ms; bound {bnd:.4f} ms ({by}) | {label}", flush=True)
    del scales, wide
    e2e = host_times(lambda: ssim_tpu_torch.compute_ms_ssim(a, b), 10)
    steps = host_times(step, 10)
    mpix = a.numel() / 1e6
    print(f"  compute_ms_ssim u8 {shape} on the card: {statistics.median(e2e):.3f} ms "
          f"median of 10 ({min(e2e):.3f}-{max(e2e):.3f}; "
          f"{mpix / statistics.median(e2e) * 1e3:.1f} Mpix/s) | {label}", flush=True)
    print(f"  MS-SSIM training step (forward + backward + Adam) {shape}: "
          f"{statistics.median(steps):.3f} ms median of 10 ({min(steps):.3f}-"
          f"{max(steps):.3f}) | {label}", flush=True)
    busy, window, n_ops, top = device_trace(step, 5)
    if busy is None:
        print("  trace: the profiler recorded no device activity", flush=True)
    else:
        t_step = statistics.median(steps)
        print(f"  trace of 5 MS-SSIM steps: device busy {busy:.4f} ms per step, "
              f"{busy / t_step:.1%} of the untraced step, {busy / window:.1%} of the "
              f"traced window ({window:.3f} ms per step); {n_ops:.0f} device "
              f"operations per step", flush=True)
        for name, ms in top[:8]:
            print(f"    {ms:.4f} ms  {name[:90]}", flush=True)

    # (e) K4's library call, torch.nn.functional.pad(mode="replicate"), at
    # 4K x4 into pad.py's (8, 128)-aligned layout (f32: the card's
    # replicate pad takes floating types), and the bounds of K4 and K5.
    kb, kh, kw_ = 4, 2160, 3840
    hp, wp = -(-(kh + 8) // 32) * 32, -(-(kw_ + 128 + 5) // 128) * 128
    img = torch.rand((kb, kh, kw_), generator=gen, device="cuda")
    pad = lambda: torch.nn.functional.pad(img, (128, wp - kw_ - 128, 8, hp - kh - 8),
                                          mode="replicate")
    check(tuple(pad().shape) == (kb, hp, wp), "replicate pad shape")
    t_pad = cuda_ms(pad, 20)
    k4_bound = bound_ms(4 * kb * kh * kw_ + 4 * kb * hp * wp, 0)
    k4_u8_bound = bound_ms(kb * kh * kw_ + kb * hp * wp, 0)
    k5 = {}
    for bsz, side in ((1024, 128), (4096, 64)):
        npix = bsz * side * side
        k5[f"{side}x{side}x{bsz}"] = bound_ms(2 * npix + 4 * bsz, (24 * 5 + 43) * npix)
    print(f"  K4 library call F.pad(replicate) f32 ({kb}, {kh}, {kw_}) -> ({kb}, {hp}, "
          f"{wp}): {t_pad:.4f} ms; K4 bound {k4_bound[0]:.4f} ms f32, "
          f"{k4_u8_bound[0]:.4f} ms u8 (bytes); K5 bounds "
          + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in k5.items())
          + f" | {label}", flush=True)
    records = dict(times=times, infer=infer, train=train, losses=losses,
                   grad_err=grad_err, grad_scale=grad_scale,
                   compute_ms_ssim_ms=e2e, train_step_ms=steps, trace_busy_ms=busy,
                   trace_window_ms=window, trace_ops_per_step=n_ops,
                   trace_top=top[:8], k4_library_ms=t_pad, k4_bound=k4_bound,
                   k5_bounds=k5)
    return err, records


def precise_twin(a, b, with_map, data_range=255.0, radius=5, sigma=1.5, k1=0.01,
                 k2=0.03):
    from ssim_tpu_torch.ops import ssim_cuda

    return ssim_cuda.ssim_parts_precise_plain(
        a, b, with_map=with_map,
        taps=ssim_cuda.gaussian_taps(np.float32, radius, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range),
    )


def compare_precise(name, a, b, *, oracle=None, **kw):
    """Both precise modes (through ops.routing.ssim_parts_auto, which casts
    u16 to f32 as the engine's route does) and the twin on the same card
    tensors; with oracle=(global, pixel), also the f64 oracle. Returns the
    largest score or map difference from the twin, the kernel's per-image
    scores and the twin's."""
    from ssim_tpu_torch import reference
    from ssim_tpu_torch.ops.routing import ssim_parts_auto

    npix = a.shape[-1] * a.shape[-2]
    pk, none = ssim_parts_auto(a, b, precise=True, **kw)
    pkm, mk = ssim_parts_auto(a, b, with_map=True, precise=True, **kw)
    torch.cuda.synchronize()
    check(none is None and pk.dtype == pkm.dtype == torch.float64,
          f"{name}: partials {pk.dtype}/{pkm.dtype}")
    af, bf = (a, b) if a.dtype == torch.uint8 else (a.float(), b.float())
    pp, mp = precise_twin(af, bf, True, **kw)
    check(same(mk, mp), f"{name}: the precise map differs from the twin's")
    check(same(pk, pkm), f"{name}: kPrecise and kPreciseMap partials differ")
    gk, gp = scores(pk, npix), scores(pp, npix)
    check(np.array_equal(np.isnan(gk), np.isnan(gp)), f"{name}: NaN scores differ")
    rel = float(np.nanmax(np.abs(gk - gp) / np.abs(gp), initial=0.0))
    err = float(np.nanmax(np.abs(gk - gp), initial=0.0))
    check(rel <= PRECISE_REL, f"{name}: precise kernel vs twin {rel:.3g} relative "
          f"(tol {PRECISE_REL:g})")
    line = (f"  {name}: precise kernel vs twin: maps bit for bit, scores "
            f"{rel:.3g} relative")
    if oracle is not None:
        wo, mo = reference.compute_ssim(
            a.cpu().numpy().astype(np.float64), b.cpu().numpy().astype(np.float64),
            with_map=True, **kw)
        o_g = float(np.abs(gk - np.asarray(wo)).max())
        o_p = float(np.abs(mk.cpu().numpy().astype(np.float64) - mo).max())
        # A score is a mean of pixels: on a tiny image (1x1, 7x5) it is no
        # more accurate than one (the rule of tests/test_pallas.py::_check).
        o_tol = max(oracle[0], 2 * oracle[1] / npix**0.5) if npix < 64 else oracle[0]
        check(o_g <= o_tol and o_p <= oracle[1],
              f"{name}: precise kernel vs oracle global {o_g:.3g} (tol {o_tol:.3g}), "
              f"pixel {o_p:.3g} (tol {oracle[1]:g})")
        line += f"; vs f64 oracle global {o_g:.3g} pixel {o_p:.3g}"
    print(line, flush=True)
    return err, gk, gp


def phase_precise(gen, label):
    import dataclasses

    import ssim_tpu_torch
    from ssim_tpu_torch import config, reference
    from ssim_tpu_torch.ops import ssim_cuda

    print('phase 7: the precise tier (precision="f64", kPrecise / kPreciseMap)',
          flush=True)
    # (a) Both modes against the twin at every shape they are launched at.
    err = 0.0
    for shape in [(1, 255, 63), (1, 257, 65), (2, 1, 1), (2, 7, 5)]:
        a, b = pair(gen, shape)
        e, _, _ = compare_precise(f"u8 {shape}", a, b,
                                  oracle=(PRECISE_GLOBAL, PRECISE_PIXEL))
        err = max(err, e)
    # The main-path shapes are held in (c), where they are timed.
    a, b = pair(gen, (1, 1024, 20480))
    e, _, _ = compare_precise("u8 (1, 1024, 20480)", a, b)
    err = max(err, e)
    del a, b
    a, b = pair(gen, (2, 300, 500), torch.float32, 1.0)
    a[0, 123, 321] = float("nan")
    e, g, _ = compare_precise("f32 NaN in image 0 of 2", a, b, data_range=1.0)
    check(np.isnan(g[0]) and np.isfinite(g[1]), f"NaN isolation: scores {g}")
    e1, g1, _ = compare_precise("f32 image 1 alone", a[1:].contiguous(),
                                b[1:].contiguous(), data_range=1.0,
                                oracle=(PRECISE_GLOBAL, PRECISE_PIXEL))
    check(abs(g1[0] - g[1]) <= PRECISE_REL, f"image 1 alone {g1[0]} vs in batch {g[1]}")
    err = max(err, e, e1)
    for win in (dict(radius=1, sigma=0.8, k1=0.02, k2=0.05),
                dict(radius=16, sigma=3.0, k1=0.015, k2=0.04)):
        a, b = pair(gen, (2, 300, 500))
        e, _, _ = compare_precise(f"u8 (2, 300, 500) {win}", a, b,
                                  oracle=(DOUBLE_GLOBAL, DOUBLE_PIXEL), **win)
        err = max(err, e)
    rng = np.random.default_rng(SEED)
    a16 = rng.integers(0, 65536, (2, 300, 500)).astype(np.uint16)
    b16 = np.clip(a16 + rng.normal(0, 2000, a16.shape), 0, 65535).astype(np.uint16)
    e, _, _ = compare_precise("u16 (2, 300, 500) data_range 65535",
                              torch.from_numpy(a16).cuda(), torch.from_numpy(b16).cuda(),
                              data_range=65535.0, oracle=(PRECISE_GLOBAL, PRECISE_PIXEL))
    err = max(err, e)

    # (b) The main path: compute_ssim(precision="f64") on NumPy u8 with no
    # device must launch kPrecise once and call neither the oracle nor any
    # other mode; then card tensors at the three main-path shapes, and
    # compute_ssim_map under the f64 default (SSIM_TPU_TORCH_PRECISION).
    inputs = {name: pair(gen, shape) for name, shape in MAIN_CONFIGS}
    a_np, b_np = (x.cpu().numpy() for x in inputs["1080p_b4"])
    oracle_calls = []
    real_oracle = reference.compute_ssim

    def counted_oracle(*args, **kw):
        oracle_calls.append(args[0].shape)
        return real_oracle(*args, **kw)

    torch.cuda.synchronize()
    reference.compute_ssim = counted_oracle
    try:
        zero_counts()
        s_np = ssim_tpu_torch.compute_ssim(a_np, b_np, precision="f64")
        first = launch_counts()
        results = {name: ssim_tpu_torch.compute_ssim(*inputs[name], precision="f64")
                   for name, _ in MAIN_CONFIGS}
        old_cfg = config.get_config()
        config.set_config(dataclasses.replace(old_cfg, precision="f64"))
        try:
            s_map, m_map = ssim_tpu_torch.compute_ssim_map(*inputs["1080p_b4"])
        finally:
            config.set_config(old_cfg)
        counts = launch_counts()
    finally:
        reference.compute_ssim = real_oracle
    check(first == dict(standard=0, precise=1, components=0, pooled=0, backward=0),
          f'NumPy compute_ssim(precision="f64") launches {first}, expected 1 precise')
    expected = dict(standard=0, precise=2 + len(MAIN_CONFIGS), components=0, pooled=0,
                    backward=0)
    check(counts == expected, f"precise main path launches {counts}, expected {expected}")
    check(oracle_calls == [], f"the f64 oracle was called: {oracle_calls}")
    launches = counts["precise"]
    a, b = inputs["1080p_b4"]
    pp, mp = precise_twin(a, b, True)
    g_twin = scores(pp, a.shape[-1] * a.shape[-2])
    for got in (s_np, results["1080p_b4"], s_map):
        got = np.asarray(got, np.float64)
        check(got.shape == (4,) and np.isfinite(got).all()
              and np.abs(got - g_twin).max() <= PRECISE_REL * np.abs(g_twin).max(),
              f'compute_ssim(precision="f64") {got} vs the twin {g_twin}')
    check(torch.equal(torch.from_numpy(m_map), mp.cpu()),
          "compute_ssim_map under the f64 default: map differs from the twin's")
    del pp, mp
    print(f'  compute_ssim(precision="f64") NumPy u8 (4, 1080, 1920), no device: '
          f"launches {first}, oracle calls 0, scores {s_np}; then {launches} precise "
          f"launches in all (3 main-path shapes, compute_ssim_map under the f64 "
          f"default), no other mode, no oracle call", flush=True)

    # (c) At each main-path shape: both precise modes and the main path's
    # scores held against the twin; then times of the precise modes, the
    # standard mode beside them (in turns: standard, precise, precise +
    # map, standard), the twin, and compute_ssim(precision="f64") end to end.
    records = {}
    for name, shape in MAIN_CONFIGS:
        a, b = inputs[name]
        e, _, g_twin = compare_precise(f"u8 {shape}", a, b)
        err = max(err, e)
        s = np.atleast_1d(np.asarray(results[name], np.float64))
        check(s.shape == (shape[0],) and np.isfinite(s).all()
              and np.abs(s - g_twin).max() <= PRECISE_REL * np.abs(g_twin).max(),
              f'{name}: compute_ssim(precision="f64") {s} vs the twin {g_twin}')
        mpix = shape[0] * shape[1] * shape[2] / 1e6
        t_std_a = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(a, b), 20)
        t_p = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(a, b, precise=True), 20)
        t_pm = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(a, b, with_map=True,
                                                         precise=True), 20)
        t_std_b = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(a, b), 20)
        t_plain = cuda_ms(lambda: precise_twin(a, b, False), 5)
        e2e = host_times(lambda: ssim_tpu_torch.compute_ssim(a, b, precision="f64"), 10)
        bnd, by = precise_bound(shape, 1)
        bnd_m, _ = precise_bound(shape, 1, with_map=True)
        records[name] = dict(
            shape=list(shape), ms=t_p, map_ms=t_pm, standard_ms=[t_std_a, t_std_b],
            plain_ms=t_plain, bound_ms=bnd, bound_by=by, bound_map_ms=bnd_m,
            compute_ssim_f64_ms=statistics.median(e2e), compute_ssim_f64_runs=e2e,
        )
        print(f"  {name} {shape}: precise {t_p:.4f} ms ({mpix / t_p * 1e3:.1f} Mpix/s), "
              f"precise + map {t_pm:.4f} ms, standard {t_std_a:.4f} / {t_std_b:.4f} ms "
              f"(precise / standard {t_p / min(t_std_a, t_std_b):.3f}); twin "
              f"{t_plain:.3f} ms; compute_ssim(precision=\"f64\") "
              f"{statistics.median(e2e):.3f} ms median of 10 ({min(e2e):.3f}-"
              f"{max(e2e):.3f}); bound {bnd:.4f} ms ({by}), {bnd_m:.4f} ms with the "
              f"map | {label}", flush=True)
        del inputs[name]
        torch.cuda.empty_cache()
    # Wider than the 16384 lanes of K1's fast path: the JAX package's K2.
    shape = (1, 1024, 20480)
    a, b = pair(gen, shape)
    t_p = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(a, b, precise=True), 20)
    t_plain = cuda_ms(lambda: precise_twin(a, b, False), 5)
    bnd, by = precise_bound(shape, 1)
    records["wide"] = dict(shape=list(shape), ms=t_p, plain_ms=t_plain, bound_ms=bnd,
                           bound_by=by)
    print(f"  wide {shape}: precise {t_p:.4f} ms; twin {t_plain:.3f} ms; bound "
          f"{bnd:.4f} ms ({by}) | {label}", flush=True)
    del a, b

    # (d) The route the kernel replaced, the host f64 oracle, once at
    # (1, 1080, 1920), beside the card route on the same NumPy input.
    a1, b1 = (x[:1].copy() for x in (a_np, b_np))
    t0 = time.perf_counter()
    s_oracle = ssim_tpu_torch.compute_ssim(a1, b1, precision="f64", impl="reference")
    t_oracle = (time.perf_counter() - t0) * 1e3
    card = host_times(lambda: ssim_tpu_torch.compute_ssim(a1, b1, precision="f64"), 10)
    s_card = ssim_tpu_torch.compute_ssim(a1, b1, precision="f64")
    d = float(np.abs(np.asarray(s_card) - np.asarray(s_oracle)).max())
    check(d <= PRECISE_GLOBAL, f"(1, 1080, 1920): card route vs oracle {d:.3g}")
    print(f"  (1, 1080, 1920) NumPy u8: the oracle route (host NumPy f64) "
          f"{t_oracle:.1f} ms once; the card route {statistics.median(card):.3f} ms "
          f"median of 10 ({min(card):.3f}-{max(card):.3f}); scores {d:.3g} apart "
          f"| {label}", flush=True)
    records["oracle_1080p_b1_ms"] = t_oracle
    records["card_1080p_b1_ms"] = statistics.median(card)
    records["card_vs_oracle_1080p_b1"] = d
    return launches, err, records


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
            if "ssim_" in line or "registers" in line or "spill" in line:
                print("  " + line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    max_err = phase_kernel(gen)
    launches, records = phase_main(gen, label)
    train_fwd, train_bwd, grad_err, train = phase_train(gen, label)
    comp_err, ms = phase_msssim(gen, label)
    prec_launches, prec_err, prec = phase_precise(gen, label)
    check("jax" not in sys.modules, "JAX was imported")

    ref = records["4k_b4"]
    bwd = train["grad_1080_b4"]
    print(json.dumps({"kernels": [{
        "name": "ssim_fwd",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710, ssim_tpu/ops/ssim_pallas.py:1364",
        "launches": launches,
        "launches_training": train_fwd,
        "max_abs_err": max_err,
        "ms": ref["kernel_ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_ms"],
        "bound_by": ref["bound_by"],
        "library_ms": None,
        "shape": ref["shape"],
    }, {
        "name": "ssim_bwd",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_bwd.cu",
        "replaces": "ssim_tpu/ops/ssim_grad.py:278",
        "launches": train_bwd,
        "max_abs_err": grad_err,
        "ms": bwd["kernel_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,
        "shape": bwd["shape"],
        "ms_gmap": bwd["kernel_gmap_ms"],
        "ms_4k_b4": train["grad_4k_b4"]["kernel_ms"],
        "train_step_ms": train["train_step"]["step_ms"],
        "launches_msssim_training": ms["train"]["backward"],
        "msssim_grad_vs_autograd": ms["grad_err"],
        "msssim_grad_max": ms["grad_scale"],
    }, {
        "name": "ssim_fwd_components",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:1957 (K1 mode c), "
                    "ssim_tpu/ops/ssim_pallas.py:1364 (K2 components)",
        "launches": ms["infer"]["components"],
        "launches_training": ms["train"]["components"],
        "max_abs_err": comp_err,
        **{k: ms["times"]["components_f32_train_scale0"][k]
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "library_ms": None,
        **{f"{k}_last_scale": ms["times"]["components_f32_scale4"][k]
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "shape")},
        "ms_wide": ms["times"]["components_u8_wide"]["ms"],
        "shape_wide": ms["times"]["components_u8_wide"]["shape"],
    }, {
        "name": "ssim_fwd_pooled",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:2066 (K1 mode d)",
        "launches": ms["infer"]["pooled"],
        "max_abs_err": comp_err,
        **{k: ms["times"]["pooled_u8_scale0"][k]
           for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "library_ms": None,
        "ms_f32_scale1": ms["times"]["pooled_f32_scale1"]["ms"],
        "device_ms_f32_scale1": ms["times"]["pooled_f32_scale1"]["device_ms"],
        "compute_ms_ssim_ms": statistics.median(ms["compute_ms_ssim_ms"]),
        "msssim_train_step_ms": statistics.median(ms["train_step_ms"]),
    }, {
        "name": "ssim_fwd_precise",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710 (K1 mode b), "
                    "ssim_tpu/ops/ssim_pallas.py:1364 (K2 precise)",
        "launches": prec_launches,
        "max_abs_err": prec_err,
        **{k: prec["4k_b4"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "library_ms": None,
        "map_ms": prec["4k_b4"]["map_ms"],
        "standard_ms": prec["4k_b4"]["standard_ms"],
        "ms_1080p_b4": prec["1080p_b4"]["ms"],
        "ms_16k_b1": prec["16k_b1"]["ms"],
        "ms_wide": prec["wide"]["ms"],
        "plain_ms_wide": prec["wide"]["plain_ms"],
        "bound_ms_wide": prec["wide"]["bound_ms"],
        "shape_wide": prec["wide"]["shape"],
        "compute_ssim_f64_ms": prec["4k_b4"]["compute_ssim_f64_ms"],
        "oracle_route_ms_1080p_b1": prec["oracle_1080p_b1_ms"],
        "card_route_ms_1080p_b1": prec["card_1080p_b1_ms"],
    }]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
