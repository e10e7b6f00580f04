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
   for the device's busy time per step.

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
#   12r + 8 each, 14 for da/db: 48r + 116.
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


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
    }]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
