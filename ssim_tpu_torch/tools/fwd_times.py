"""Times the forward kernel's modes on the card.

    python -m ssim_tpu_torch.tools.fwd_times [--segments] [--batch] [--relaxed] [--radii]
                                             [--relaxed-radii] [--batch --radii]

Times (CUDA events around 20 back-to-back calls, median of 3) the
streaming kernel's modes kScore, kMap, kRowsum and kRowsumMap (the row
modes with halo operands, both flags set, as on one rank), kPrecise,
kPreciseMap, relaxed kScore and kMap, and the MS-SSIM components and
pooled modes on u8 pairs at 1080p x4, 4K x4, 16K x1 and 1x1024x20480;
the components and pooled modes also on f32 pairs at 1080p x4 and at the
smaller scales of msssim_1080_b4 (4x540x960 to 4x67x120), there also by
a profiler trace (the kernel alone: the events measure the wrapper's host
work at small scales), each beside the tile body (a pinned 16x256 tile,
in turns: tile body, wrapper, wrapper, tile body); the tile body's
modes: kScore and precise at radius 1 and 16 at 1080p x4, and the relaxed
components, pooled and batch modes (whichever design the package runs);
and the batch modes as --batch times them.
Prints the card's name and power limit, then one JSON line {"card": ...,
"package": ..., "ms": {...}}. It calls only the wrappers' public
arguments and ssim_cuda._launch, so it also times another checkout's
kernel when run as a file with that checkout's root on PYTHONPATH:

    PYTHONPATH=/path/to/checkout python ssim_tpu_torch/tools/fwd_times.py

--segments also times kScore, kRowsum, kPrecise, relaxed kScore and the
components and pooled modes at each shape at every segment length the
streaming kernel takes (where they stream), beside the wrapper's own
choice (`ssim_cuda.stream_segment`).

--batch times only the batch modes at phase 8's routed shapes (u8
32x32 x8192, 64x64 x4096, 128x128 x1024, 192x192 x512 and kBatchPrecise
at 64x64 x4096): the batch wrapper (`ssim_parts_batch_cuda`, whichever
design the package runs) in turns with the tile grid (`ssim_parts_cuda`
on the same batch: tile grid, batch, batch, tile grid), and, where the
package's `_launch` takes `tile_body`, the tile body's batch mode beside
them, and the packed stream at other segments than `batch_stream_plan`'s
(`--batch --packs`); run it with another checkout on PYTHONPATH to time
that checkout's.

--relaxed times only the relaxed components, pooled and batch modes: the
components (f32) and pooled (u8 and f32) modes at 1080p x4, the relaxed
MS-SSIM scale 1 (4x540x960) and the one-frame scales that straddle
STREAM_COMP_MIN_PIX (2x540x960, 1x1080x1920, 1x540x960), each through
the row-streaming kernel at the wrapper's segment (pinned, so it streams
at any size), the relaxed tile body (`_launch(tile_body=True)`) and the
standard stream, in turns (tile body, relaxed, standard, standard,
relaxed, tile body; events, and a profiler trace of the kernel alone); a
segment sweep of both at 1080p x4; then the relaxed batch at the routed
shapes (RELAXED_BATCH_SHAPES: the batch route's, and widths whose packed
strips straddle 16-column tiles) in turns with its tile body and the
standard packed stream, and at other packs. Where the package's relaxed
modes do not stream, "relaxed" times what its wrapper launches.

--radii times only the row stream at radii other than 5 (the
runtime-radius instantiation, ssim_fwd_stream_rt.cu) in turns with the
tile body (tile body, stream, stream, tile body) at radii 1, 3, 4, 6, 8
and 16 (RADII): u8 kScore and kMap at 4K x4, kPrecise at 4K x4,
kComponents on f32 at 1080p x4 and kRowsum (both halo flags set, as on
one rank) at 16K x1 (RADIUS_CASES). The stream runs at the segment
stream_segment picks at its occupancy at that radius, pinned, so that it
streams whatever stream_applies says; the tile body is pinned with
_launch(tile_body=True).

--batch --radii times the batch modes' packed stream at every radius
1-16 (ssim_fwd_batch_rt.cu's runtime radius, radius 5's own stream at 5)
in turns with the tile body's batch branch (tile body, stream, stream,
tile body; both pinned: the stream at batch_stream_plan's pack for its
occupancy at that radius, the tile body with _launch(tile_body=True) at
batch_geometry's tiles), the data of ssim_cuda.STREAM_BATCH_TILE_RADII
(BATCH_RULE_CASES: kBatch, kBatchPrecise and the relaxed kBatch on u8
and f32 pairs at each width of BATCH_RULE_SHAPES, among them
BATCH_RADIUS_CASES), each beside its bound (chip_smoke.py's fwd_bound,
precise_bound, relaxed_fwd_bound, imported from the checkout's root: run
it from there); then the rule those times give (batch_tile_rule).

--relaxed-radii times the relaxed tier's row stream at every radius 1-16
(ssim_fwd_stream_rt_relaxed.cu, radius 5's own stream at 5) the same way,
in turns with the relaxed tile body: u8 kScore and kMap at 4K x4,
kComponents on f32 and kPooled on u8 and f32 at 1080p x4
(RELAXED_RULE_CASES), the data of ssim_cuda.STREAM_RELAXED_TILE_RADII.

--loss times only the ssim_loss training step on phase 8's f32 batch
(256, 64, 64), which the batch route serves (forward, backward, Adam, a
clamp, ending in a synchronize): the host clock (median of 20 steps) and
the device's busy time per step in a torch.profiler trace of 10 steps.
"""

import argparse
import inspect
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ssim_tpu_torch.ops import ssim_cuda

SHAPES = (("1080p_b4", (4, 1080, 1920)), ("4k_b4", (4, 2160, 3840)),
          ("16k_b1", (1, 8640, 15360)), ("wide_b1", (1, 1024, 20480)))
#: The batch route's shapes (chip_smoke.BATCH_CONFIGS): name, shape, precise.
BATCH_SHAPES = (("32x32_b8192", (8192, 32, 32), False),
                ("64x64_b4096", (4096, 64, 64), False),
                ("128x128_b1024", (1024, 128, 128), False),
                ("192x192_b512", (512, 192, 192), False),
                ("64x64_b4096_f64", (4096, 64, 64), True))
#: The scales of msssim_1080_b4 below the first (bench.py:59).
MSSSIM_SCALES = ((4, 540, 960), (4, 270, 480), (4, 135, 240), (4, 67, 120))


def card_label():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError:
        out = ""
    return out or torch.cuda.get_device_name(0)


def cuda_ms(fn, reps=20, runs=3):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / reps)
    return statistics.median(out)


def trace_ms(fn, reps=20):
    """Device ms per fn() call of the forward kernel (ssim_fwd_stream_kernel
    or ssim_fwd_kernel) in one torch.profiler trace of reps calls; None
    when the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "ssim_fwd" in e.name]
    return sum(us) / 1e3 / reps if us else None


def u8_pair(gen, shape):
    a = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.int32)
    noise = (torch.randn(shape, generator=gen, device="cuda") * 12).to(torch.int32)
    return a.to(torch.uint8), (a + noise).clamp_(0, 255).to(torch.uint8)


def main_path_modes(a, b):
    """The streaming kernel's modes on one pair: name -> call (relaxed
    kScore and kMap stream where this package's stream_applies says so, else
    they time the tile body)."""
    h = a.shape[-2]
    vh = (a[..., h - 5:, :].contiguous(), a[..., :5, :].contiguous(),
          b[..., h - 5:, :].contiguous(), b[..., :5, :].contiguous())
    rows = dict(vhalo=vh, vmask=(1, 1))
    return {
        "kScore": lambda: ssim_cuda.ssim_parts_cuda(a, b),
        "kMap": lambda: ssim_cuda.ssim_parts_cuda(a, b, with_map=True),
        "kRowsum": lambda: ssim_cuda.ssim_rows_cuda(a, b, **rows),
        "kRowsumMap": lambda: ssim_cuda.ssim_rows_cuda(a, b, with_map=True, **rows),
        "kPrecise": lambda: ssim_cuda.ssim_parts_cuda(a, b, precise=True),
        "kPreciseMap": lambda: ssim_cuda.ssim_parts_cuda(a, b, with_map=True, precise=True),
        "relaxed kScore": lambda: ssim_cuda.ssim_parts_cuda(a, b, relaxed=True),
        "relaxed kMap": lambda: ssim_cuda.ssim_parts_cuda(a, b, with_map=True, relaxed=True),
        "components": lambda: ssim_cuda.ssim_components_cuda(a, b),
        "pooled": lambda: ssim_cuda.ssim_components_pooled_cuda(a, b),
    }


def comp_tile_body(a, b, pooled, data_range):
    """The components (pooled) mode on the tile body, which a pinned 16x256
    tile reaches in every checkout (stream_applies is false at tile_w 256;
    32x256 does not fit a block's shared memory at radius 5): its parts,
    or (parts, pooled_a, pooled_b)."""
    kw = ssim_cuda._components_args(a, b, data_range, 5, 1.5, 0.01, 0.03)
    kw.update(tile_h=16, tile_w=256)
    return ssim_cuda._launch(a, b, mode="pooled" if pooled else "components", **kw)


def comp_modes(a, b, ms, trace=False):
    """The components and pooled modes on one pair (u8, or f32 in [0, 1])
    through the wrappers, in turns with the tile body: ms[name] the
    wrapper's time, ms[name + " tile body"] the 16x256 tile body's (each
    the lower of the two in turns); with trace, also their kernels' trace
    times (name + " trace"), and where the package streams the mode, the
    stream's at a pinned one-tile segment (name + " stream trace": the
    wrapper's choice where the size condition lets it stream). Prints
    each."""
    dr = 1.0 if a.dtype == torch.float32 else 255.0
    kind = "f32" if a.dtype == torch.float32 else "u8"
    shape = "x".join(str(n) for n in a.shape)
    for pooled in (False, True):
        fn = ssim_cuda.ssim_components_pooled_cuda if pooled else ssim_cuda.ssim_components_cuda
        call = lambda: fn(a, b, data_range=dr)
        tile = lambda: comp_tile_body(a, b, pooled, dr)
        name = f"{'pooled' if pooled else 'components'} {kind} {shape}"
        t = [cuda_ms(tile), cuda_ms(call), cuda_ms(call), cuda_ms(tile)]
        ms[name], ms[f"{name} tile body"] = min(t[1:3]), min(t[0], t[3])
        line = (f"  {name}: {t[1]:.4f} / {t[2]:.4f} ms, tile body (16x256) {t[0]:.4f} / "
                f"{t[3]:.4f} ms")
        if trace:
            ms[f"{name} trace"] = trace_ms(call)
            ms[f"{name} tile body trace"] = trace_ms(tile)
            line += (f"; trace {ms[f'{name} trace']} ms, tile body "
                     f"{ms[f'{name} tile body trace']} ms")
            mode = "pooled" if pooled else "components"
            if ssim_cuda.stream_applies(mode, 5, ssim_cuda.TILE_W):
                kw = ssim_cuda._components_args(a, b, dr, 5, 1.5, 0.01, 0.03)
                ms[f"{name} stream trace"] = trace_ms(lambda: ssim_cuda._launch(
                    a, b, mode=mode, segment=ssim_cuda.TILE_H, **kw))
                line += f", stream {ms[f'{name} stream trace']} ms"
        print(line, flush=True)


def tile_body_modes(gen, a, b):
    """The tile body's modes at 1080p x4, and under their earlier names the
    modes that since ran the tile body and now stream (the components and
    pooled modes, the relaxed ones and the relaxed batch at 64x64 x4096):
    name -> call."""
    fa, fb = a.float() / 255.0, b.float() / 255.0
    sa, sb = u8_pair(gen, (4096, 64, 64))
    return {
        "components f32": lambda: ssim_cuda.ssim_components_cuda(fa, fb, data_range=1.0),
        "pooled u8": lambda: ssim_cuda.ssim_components_pooled_cuda(a, b),
        "relaxed components f32": lambda: ssim_cuda.ssim_components_cuda(
            fa, fb, data_range=1.0, relaxed=True),
        "relaxed pooled u8": lambda: ssim_cuda.ssim_components_pooled_cuda(a, b, relaxed=True),
        "kScore r=1": lambda: ssim_cuda.ssim_parts_cuda(a, b, radius=1, sigma=0.8),
        "kScore r=16": lambda: ssim_cuda.ssim_parts_cuda(a, b, radius=16, sigma=3.0),
        "precise r=1": lambda: ssim_cuda.ssim_parts_cuda(a, b, precise=True, radius=1,
                                                         sigma=0.8),
        "precise r=16": lambda: ssim_cuda.ssim_parts_cuda(a, b, precise=True, radius=16,
                                                          sigma=3.0),
        "relaxed batch 64x64_b4096": lambda: ssim_cuda.ssim_parts_batch_cuda(
            sa, sb, relaxed=True),
    }


def batch_times(gen, ms, packs=False):
    """The batch modes at BATCH_SHAPES, in turns with the tile grid (and
    the tile body's batch mode, where this package's _launch can pin it):
    ms["batch <name>"], ms["batch <name> tile grid"], ms["batch <name> tile
    body"], each the lower of the two in turns; with packs, the packed
    stream at one group a block, and at segments of 32 to 96 rows, as
    ms["batch <name> pack (k, seg)"]. Prints each."""
    body = "tile_body" in inspect.signature(ssim_cuda._launch).parameters
    for name, shape, precise in BATCH_SHAPES:
        a, b = u8_pair(gen, shape)
        batch = lambda: ssim_cuda.ssim_parts_batch_cuda(a, b, precise=precise)
        grid = lambda: ssim_cuda.ssim_parts_cuda(a, b, precise=precise)
        t = [cuda_ms(grid), cuda_ms(batch), cuda_ms(batch), cuda_ms(grid)]
        ms[f"batch {name}"], ms[f"batch {name} tile grid"] = min(t[1:3]), min(t[0], t[3])
        line = (f"  batch {name}: {t[1]:.4f} / {t[2]:.4f} ms, tile grid {t[0]:.4f} / "
                f"{t[3]:.4f} ms")
        kw = ssim_cuda._prepare(a, b, data_range=255.0, radius=5, sigma=1.5, k1=0.01,
                                k2=0.03, precise=precise)
        if body:
            th, tw, ipb, groups = ssim_cuda.batch_geometry(*shape)
            tile = lambda: ssim_cuda._launch(
                a, b, mode="batch_precise" if precise else "batch", tile_h=th, tile_w=tw,
                ipb=ipb, groups=groups, tile_body=True, **kw)
            ms[f"batch {name} tile body"] = cuda_ms(tile)
            line += f", tile body {ms[f'batch {name} tile body']:.4f} ms"
        print(line, flush=True)
        if packs:
            mode = "batch_precise" if precise else "batch"
            res = ssim_cuda._stream_resident(a.device.index, mode, False)
            k, seg = ssim_cuda.batch_stream_plan(*shape, res)
            tries = [(k, shape[1])] + [(k, s) for s in (32, 64, 96) if s < shape[1]]
            parts = [f"plan {(k, seg)} ({res} resident)"]
            for pk in tries:
                t = cuda_ms(lambda: ssim_cuda._launch(
                    a, b, mode=mode, tile_h=32, tile_w=64, pack=pk, **kw))
                ms[f"batch {name} pack {pk}"] = t
                parts.append(f"{pk}: {t:.4f}")
            print(f"  batch {name} packs: " + ", ".join(parts) + " ms", flush=True)
        del a, b
        torch.cuda.empty_cache()


def loss_step_times(gen, ms):
    """The ssim_loss Adam step on f32 (256, 64, 64): ms["loss step host"]
    (median of 20 steps on the host clock, each ending in a synchronize)
    and ms["loss step device busy"] (the device's busy time per step in
    one profiler trace of 10 steps, None if the trace holds none)."""
    import time

    import ssim_tpu_torch
    from torch.profiler import ProfilerActivity, profile

    shape = (256, 64, 64)
    clean = torch.rand(shape, generator=gen, device="cuda")
    noisy = (clean + 0.15 * torch.randn(shape, generator=gen, device="cuda")).clamp_(0, 1)
    x = noisy.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=0.02)

    def step():
        opt.zero_grad(set_to_none=True)
        ssim_tpu_torch.ssim_loss(x, clean).backward()
        opt.step()
        with torch.no_grad():
            x.clamp_(0.0, 1.0)
        torch.cuda.synchronize()

    for _ in range(3):
        step()
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
    # The union of the device's kernel and copy intervals (ranges that
    # annotate the device timeline, as Optimizer.step, span gaps).
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    ms["loss step host"] = statistics.median(host)
    ms["loss step device busy"] = busy / 1e3 / 10 if spans else None
    busy = ms["loss step device busy"]
    print(f"  ssim_loss step f32 {shape}: host {ms['loss step host']:.4f} ms (median of "
          f"20), device busy {'not measured' if busy is None else f'{busy:.4f} ms'} per "
          f"step", flush=True)


#: --relaxed: the components and pooled launches the relaxed tier makes at
#: W >= 512 (msssim_1080_b4 scales 0 and 1, one-frame pyramids), around
#: STREAM_COMP_MIN_PIX.
RELAXED_COMP_SHAPES = ((4, 1080, 1920), (3, 1080, 1920), (2, 1080, 1920), (4, 540, 960),
                       (2, 540, 960), (1, 1080, 1920), (1, 540, 960))


#: --relaxed: the relaxed batch at the batch route's shapes (BATCH_SHAPES)
#: and at routed widths that are not multiples of 16, whose packed strips
#: hold 16-column tiles straddling two images (the stream's lines are then
#: the staged row's own tiles, one or two sweeps: 12, 24, 40, 50, 60, 120,
#: 184) or one image a strip (100).
RELAXED_BATCH_SHAPES = tuple((n, s) for n, s, precise in BATCH_SHAPES if not precise) + (
    ("12x12_b16384", (16384, 12, 12)), ("24x24_b8192", (8192, 24, 24)),
    ("40x40_b4096", (4096, 40, 40)), ("50x50_b4096", (4096, 50, 50)),
    ("60x60_b4096", (4096, 60, 60)), ("100x100_b1024", (1024, 100, 100)),
    ("120x120_b1024", (1024, 120, 120)), ("184x184_b512", (512, 184, 184)))


def relaxed_times(gen, ms):
    """The relaxed components, pooled and batch modes (see --relaxed):
    ms["relaxed <mode> <kind> <shape>"] and its " tile body" and
    " standard" beside it, each the lower of two in turns; " trace" where
    traced; ms["relaxed <mode> segments 1080p_b4"] the sweep; the batch
    as ms["relaxed batch <name>"] with " tile body", " standard" and
    " pack (k, seg)"."""
    for shape in RELAXED_COMP_SHAPES:
        npix = shape[0] * shape[1] * shape[2]
        a, b = u8_pair(gen, shape)
        fa, fb = a.float() / 255.0, b.float() / 255.0
        for mode, x, y in (("components", fa, fb), ("pooled", a, b), ("pooled", fa, fb)):
            dr = 1.0 if x.dtype == torch.float32 else 255.0
            kw = ssim_cuda._components_args(x, y, dr, 5, 1.5, 0.01, 0.03)
            streams = ssim_cuda.stream_applies(mode, 5, kw["tile_w"], relaxed=True)
            seg = None
            if streams:
                res = ssim_cuda._stream_resident(x.device.index, mode,
                                                 x.dtype == torch.float32, True)
                seg = ssim_cuda.stream_segment(*shape, kw["tile_h"], 10, res)
            rel = lambda: ssim_cuda._launch(x, y, mode=mode, relaxed=True, segment=seg, **kw)
            body = lambda: ssim_cuda._launch(x, y, mode=mode, relaxed=True, tile_body=True,
                                             **kw)
            std = lambda: ssim_cuda._launch(x, y, mode=mode, **kw)
            t = [cuda_ms(f) for f in (body, rel, std, std, rel, body)]
            kind = "f32" if x.dtype == torch.float32 else "u8"
            name = f"relaxed {mode} {kind} {'x'.join(str(n) for n in shape)}"
            ms[name] = min(t[1], t[4])
            ms[f"{name} tile body"] = min(t[0], t[5])
            ms[f"{name} standard"] = min(t[2], t[3])
            line = (f"  {name}: {t[1]:.4f} / {t[4]:.4f} ms (segment {seg}), tile body "
                    f"{t[0]:.4f} / {t[5]:.4f}, standard {t[2]:.4f} / {t[3]:.4f}")
            if npix <= 1 << 23:
                ms[f"{name} trace"] = trace_ms(rel)
                ms[f"{name} tile body trace"] = trace_ms(body)
                line += (f"; trace {ms[f'{name} trace']}, tile body "
                         f"{ms[f'{name} tile body trace']}")
            print(line, flush=True)
            if shape == (4, 1080, 1920) and streams and kind == ("u8" if mode == "pooled"
                                                                 else "f32"):
                parts = []
                for k in range(1, ssim_cuda.MAX_SEG_TILES + 1):
                    sg = k * kw["tile_h"]
                    tk = cuda_ms(lambda: ssim_cuda._launch(x, y, mode=mode, relaxed=True,
                                                           segment=sg, **kw))
                    ms[f"relaxed {mode} segments 1080p_b4 {sg}"] = tk
                    parts.append(f"{sg}: {tk:.4f}")
                print(f"  segments relaxed {mode} {kind} 1080p_b4 (picker {seg}): "
                      + ", ".join(parts) + " ms", flush=True)
        del a, b, fa, fb
        torch.cuda.empty_cache()
    for name, shape in RELAXED_BATCH_SHAPES:
        a, b = u8_pair(gen, shape)
        kw = ssim_cuda._prepare(a, b, data_range=255.0, radius=5, sigma=1.5, k1=0.01,
                                k2=0.03)
        th, tw, ipb, groups = ssim_cuda.batch_geometry(*shape)
        geo = dict(tile_h=th, tile_w=tw, ipb=ipb, groups=groups)
        rel = lambda: ssim_cuda.ssim_parts_batch_cuda(a, b, relaxed=True)
        body = lambda: ssim_cuda._launch(a, b, mode="batch", relaxed=True, tile_body=True,
                                         **geo, **kw)
        std = lambda: ssim_cuda.ssim_parts_batch_cuda(a, b)
        t = [cuda_ms(f) for f in (body, rel, std, std, rel, body)]
        key = f"relaxed batch {name}"
        ms[key], ms[f"{key} tile body"] = min(t[1], t[4]), min(t[0], t[5])
        ms[f"{key} standard"] = min(t[2], t[3])
        line = (f"  {key}: {t[1]:.4f} / {t[4]:.4f} ms, tile body {t[0]:.4f} / {t[5]:.4f}, "
                f"standard {t[2]:.4f} / {t[3]:.4f}")
        if ssim_cuda.stream_applies("batch", 5, tw, relaxed=True):
            res = ssim_cuda._stream_resident(a.device.index, "batch", False, True)
            k, seg = ssim_cuda.batch_stream_plan(*shape, res)
            parts = []
            for pk in [(k, shape[1])] + [(k, s) for s in (32, 64, 96) if s < shape[1]]:
                tk = cuda_ms(lambda: ssim_cuda._launch(a, b, mode="batch", relaxed=True,
                                                       pack=pk, **geo, **kw))
                ms[f"{key} pack {pk}"] = tk
                parts.append(f"{pk}: {tk:.4f}")
            line += f"; plan {(k, seg)} ({res} resident), packs " + ", ".join(parts)
        print(line, flush=True)
        del a, b
        torch.cuda.empty_cache()


#: --radii: the radii and the launches timed at each (name, mode, shape,
#: f32 input).
RADII = (1, 3, 4, 6, 8, 16)
RADIUS_CASES = (("kScore 4k_b4", "score", (4, 2160, 3840), False),
                ("kMap 4k_b4", "map", (4, 2160, 3840), False),
                ("kPrecise 4k_b4", "precise", (4, 2160, 3840), False),
                ("kComponents f32 1080p_b4", "components", (4, 1080, 1920), True),
                ("kRowsum 16k_b1", "rowsum", (1, 8640, 15360), False))
#: --relaxed-radii: the relaxed launches timed at each radius.
RELAXED_RADIUS_CASES = (("relaxed kScore 4k_b4", "score", (4, 2160, 3840), False),
                        ("relaxed kComponents f32 1080p_b4", "components", (4, 1080, 1920),
                         True),
                        ("relaxed kPooled 1080p_b4", "pooled", (4, 1080, 1920), False))
#: --relaxed-radii, at every radius 1-16: those, kMap and kPooled on f32 (the
#: pyramid's scale 1 of a u8 4K x4 pair).
RELAXED_RULE_CASES = RELAXED_RADIUS_CASES + (
    ("relaxed kMap 4k_b4", "map", (4, 2160, 3840), False),
    ("relaxed kPooled f32 1080p_b4", "pooled", (4, 1080, 1920), True))
#: The window's sigma at each radius 1-16: the tests' and chip_smoke.py's
#: custom windows at 1, 3, 4, 6, 8 and 16, else 0.3 r + 0.3 up to 3.0.
RADIUS_SIGMA = {r: min(3.0, round(0.3 * r + 0.3, 2)) for r in range(1, 17)}
RADIUS_SIGMA.update({1: 0.8, 3: 1.2, 4: 1.5, 6: 2.0, 8: 2.5, 16: 3.0})


def radius_launches(a, b, mode, radius, relaxed=False):
    """(stream, tile body, segment): _launch calls of `mode` at `radius` on
    one pair (u8, or f32 in [0, 1]), the stream at stream_segment's pick
    for its occupancy at that radius (pinned), the tile body pinned; the
    row modes with both halo flags set; relaxed: the relaxed tier's."""
    from ssim_tpu_torch.windows import gaussian_taps

    h = a.shape[-2]
    dr = 1.0 if a.dtype == torch.float32 else 255.0
    precise = mode.startswith("precise")
    kw = dict(taps=gaussian_taps(np.float64 if precise else np.float32, radius,
                                 RADIUS_SIGMA[radius]),
              c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=ssim_cuda.TILE_H, tile_w=ssim_cuda.TILE_W)
    if relaxed:
        kw["relaxed"] = True
    if mode.startswith("rowsum"):
        kw.update(vhalo=(a[..., h - radius:, :].contiguous(), a[..., :radius, :].contiguous(),
                         b[..., h - radius:, :].contiguous(), b[..., :radius, :].contiguous()),
                  vmask=(1, 1))
    res = ssim_cuda._stream_resident(a.device.index, mode, a.dtype == torch.float32, relaxed,
                                     radius)
    seg = ssim_cuda.stream_segment(*a.shape, ssim_cuda.TILE_H, 2 * radius, res)
    return (lambda: ssim_cuda._launch(a, b, mode=mode, segment=seg, **kw),
            lambda: ssim_cuda._launch(a, b, mode=mode, tile_body=True, **kw), seg)


def radius_times(gen, ms, radii=RADII, cases=RADIUS_CASES, reps=10, relaxed=False):
    """The row stream against the tile body at each radius (see --radii;
    relaxed: --relaxed-radii): ms["<name> r<radius>"] the stream's ms and
    " tile body" the tile body's, each the lower of two in turns,
    " segment" the stream's segment. Prints each."""
    for name, mode, shape, f32 in cases:
        a, b = u8_pair(gen, shape)
        if f32:
            a, b = a.float() / 255.0, b.float() / 255.0
        for radius in radii:
            stream, body, seg = radius_launches(a, b, mode, radius, relaxed)
            t = [cuda_ms(f, reps) for f in (body, stream, stream, body)]
            key = f"{name} r{radius}"
            ms[key], ms[f"{key} tile body"] = min(t[1:3]), min(t[0], t[3])
            ms[f"{key} segment"] = seg
            print(f"  {key}: stream {t[1]:.4f} / {t[2]:.4f} ms (segment {seg}), tile body "
                  f"{t[0]:.4f} / {t[3]:.4f} ms", flush=True)
        del a, b
        torch.cuda.empty_cache()


#: --batch --radii: (name, shape, precise, relaxed, f32 input), u8 pairs
#: (f32: the same pairs / 255).
BATCH_RADIUS_CASES = (("kBatch 32x32_b8192", (8192, 32, 32), False, False, False),
                      ("kBatch 64x64_b4096", (4096, 64, 64), False, False, False),
                      ("kBatch 192x192_b512", (512, 192, 192), False, False, False),
                      ("kBatchPrecise 64x64_b4096", (4096, 64, 64), True, False, False),
                      ("relaxed kBatch 64x64_b4096", (4096, 64, 64), False, True, False),
                      ("relaxed kBatch 40x40_b4096", (4096, 40, 40), False, True, False))
#: --batch --radii: the widths of ssim_cuda's batch rule, each at a batch
#: of 4-19 Mpix (B, H, W), from 2 to 5 widths in each of its width classes
#: (ssim_cuda.BATCH_RULE_WIDTHS: the tile body's tile width).
BATCH_RULE_SHAPES = ((131072, 8, 8), (65536, 12, 12), (32768, 16, 16), (8192, 24, 24),
                     (8192, 32, 32), (4096, 40, 40), (4096, 48, 48), (4096, 64, 64),
                     (1024, 96, 96), (1024, 100, 100), (1024, 120, 120), (1024, 128, 128),
                     (512, 160, 160), (512, 192, 192))
#: --batch --radii: (name, shape, precise, relaxed, f32 input), every batch
#: mode on u8 and f32 at each of BATCH_RULE_SHAPES.
BATCH_RULE_CASES = tuple(
    (f"{tag}{' f32' if f32 else ''} {h}x{w}_b{bsz}", (bsz, h, w), precise, relaxed, f32)
    for bsz, h, w in BATCH_RULE_SHAPES
    for tag, precise, relaxed in (("kBatch", False, False), ("kBatchPrecise", True, False),
                                  ("relaxed kBatch", False, True))
    for f32 in (False, True))
assert set(BATCH_RADIUS_CASES) <= set(BATCH_RULE_CASES)


def batch_radius_launches(a, b, radius, precise=False, relaxed=False, pack=None):
    """(stream, tile body, pack): _launch calls of the batch mode at
    `radius` on one pair (u8, or f32 in [0, 1]), the packed stream pinned
    at `pack` (k, segment rows), batch_stream_plan's for its occupancy at
    that radius if None, the tile body pinned at batch_geometry's
    tiles."""
    from ssim_tpu_torch.windows import gaussian_taps

    bsz, h, w = a.shape
    f32 = a.dtype == torch.float32
    dr = 1.0 if f32 else 255.0
    mode = "batch_precise" if precise else "batch"
    th, tw, ipb, groups = ssim_cuda.batch_geometry(bsz, h, w)
    kw = dict(taps=gaussian_taps(np.float64 if precise else np.float32, radius,
                                 RADIUS_SIGMA[radius]),
              c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=th, tile_w=tw, ipb=ipb, groups=groups, relaxed=relaxed)
    if pack is None:
        k = ssim_cuda.batch_pack(bsz, w)
        res = ssim_cuda._stream_resident(a.device.index, mode, f32, relaxed, radius, w, k)
        pack = ssim_cuda.batch_stream_plan(bsz, h, w, res, radius)
    return (lambda: ssim_cuda._launch(a, b, mode=mode, pack=pack, **kw),
            lambda: ssim_cuda._launch(a, b, mode=mode, tile_body=True, **kw), pack)


def batch_radius_times(gen, ms, radii=range(1, ssim_cuda.MAX_FUSED_RADIUS + 1),
                       cases=BATCH_RADIUS_CASES, reps=10):
    """The batch modes' packed stream against the tile body at each radius
    (see --batch --radii): ms["<name> r<radius>"] the stream's ms and
    " tile body" the tile body's, each the lower of two in turns, " pack"
    the stream's (k, segment rows). Prints each."""
    for name, shape, precise, relaxed, f32 in cases:
        a, b = u8_pair(gen, shape)
        if f32:
            a, b = a.float() / 255.0, b.float() / 255.0
        for radius in radii:
            stream, body, pack = batch_radius_launches(a, b, radius, precise, relaxed)
            t = [cuda_ms(f, reps) for f in (body, stream, stream, body)]
            key = f"{name} r{radius}"
            ms[key], ms[f"{key} tile body"] = min(t[1:3]), min(t[0], t[3])
            ms[f"{key} pack"] = list(pack)
            print(f"  {key}: stream {t[1]:.4f} / {t[2]:.4f} ms (pack {pack}), tile body "
                  f"{t[0]:.4f} / {t[3]:.4f} ms", flush=True)
        del a, b
        torch.cuda.empty_cache()


def batch_tile_rule(ms, cases=BATCH_RULE_CASES, radii=range(1, ssim_cuda.MAX_FUSED_RADIUS + 1)):
    """The batch rule that batch_radius_times' ms give: {(mode, relaxed,
    f32 input, width class): radii}, each radius other than STREAM_RADIUS
    at which the stream took at least the tile body's time at some width
    of the class (ssim_cuda.batch_width_class) in that mode, tier and
    input dtype."""
    rule = {}
    for name, (bsz, h, w), precise, relaxed, f32 in cases:
        key = ("batch_precise" if precise else "batch", relaxed, f32,
               ssim_cuda.batch_width_class(w))
        lost = rule.setdefault(key, set())
        lost.update(r for r in radii if r != ssim_cuda.STREAM_RADIUS
                    and ms[f"{name} r{r}"] >= ms[f"{name} r{r} tile body"])
    return {key: tuple(sorted(v)) for key, v in sorted(rule.items()) if v}


def batch_radius_bounds(radii=range(1, ssim_cuda.MAX_FUSED_RADIUS + 1),
                        cases=BATCH_RADIUS_CASES):
    """{"<name> r<radius>": (bound ms, "bytes" or "operations")} for the
    batch radius cases (one partial pair per image out), from
    chip_smoke.batch_rt_bound (fwd_bound, precise_bound, relaxed_fwd_bound)."""
    import chip_smoke

    return {f"{name} r{radius}": chip_smoke.batch_rt_bound(shape, radius, precise, relaxed,
                                                           4 if f32 else 1)
            for name, shape, precise, relaxed, f32 in cases for radius in radii}


def segment_sweep(name, a, b):
    """kScore, kRowsum, kPrecise, relaxed kScore, components and pooled at
    every segment the streaming kernel takes (the last four where they
    stream)."""
    from ssim_tpu_torch.windows import gaussian_taps

    bsz, h, w = a.shape
    kw = dict(c1=(0.01 * 255) ** 2, c2=(0.03 * 255) ** 2, clip_bound=131072.0,
              tile_h=ssim_cuda.TILE_H, tile_w=ssim_cuda.TILE_W)
    vh = (a[..., h - 5:, :].contiguous(), a[..., :5, :].contiguous(),
          b[..., h - 5:, :].contiguous(), b[..., :5, :].contiguous())
    f32_taps = dict(taps=gaussian_taps(np.float32, 5, 1.5))
    runs = [("score", f32_taps), ("rowsum", dict(vhalo=vh, vmask=(1, 1), **f32_taps))]
    if ssim_cuda.stream_applies("precise", 5, ssim_cuda.TILE_W):
        runs.append(("precise", dict(taps=gaussian_taps(np.float64, 5, 1.5))))
    if ssim_cuda.stream_applies("score", 5, ssim_cuda.TILE_W, relaxed=True):
        runs.append(("score", dict(relaxed=True, **f32_taps)))
    for mode in ("components", "pooled"):
        if ssim_cuda.stream_applies(mode, 5, ssim_cuda.TILE_W):
            runs.append((mode, f32_taps))
    for mode, extra in runs:
        relaxed = extra.get("relaxed", False)
        resident = (ssim_cuda._stream_resident(a.device.index, mode, False, True) if relaxed
                    else ssim_cuda._stream_resident(a.device.index, mode, False))
        auto = ssim_cuda.stream_segment(bsz, h, w, ssim_cuda.TILE_H, 10, resident)
        parts = [f"auto {auto} ({resident} resident)"]
        for k in range(1, ssim_cuda.MAX_SEG_TILES + 1):
            seg = k * ssim_cuda.TILE_H
            t = cuda_ms(lambda: ssim_cuda._launch(a, b, mode=mode, segment=seg,
                                                  **extra, **kw))
            parts.append(f"{seg}: {t:.4f}")
            if seg >= h:
                break
        label = f"relaxed {mode}" if relaxed else mode
        print(f"  segments {name} {label}: " + ", ".join(parts) + " ms", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--segments", action="store_true")
    parser.add_argument("--batch", action="store_true")
    parser.add_argument("--packs", action="store_true")
    parser.add_argument("--loss", action="store_true")
    parser.add_argument("--relaxed", action="store_true")
    parser.add_argument("--radii", action="store_true")
    parser.add_argument("--relaxed-radii", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    label = card_label()
    print(label, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    ms = {}
    if args.relaxed:
        torch.backends.cuda.matmul.allow_tf32 = False
        relaxed_times(gen, ms)
        print(json.dumps({"card": label, "package": ssim_cuda.__file__, "ms": ms}))
        return 0
    if args.relaxed_radii:
        torch.backends.cuda.matmul.allow_tf32 = False
        radius_times(gen, ms, radii=range(1, ssim_cuda.MAX_FUSED_RADIUS + 1),
                     cases=RELAXED_RULE_CASES, relaxed=True)
        print(json.dumps({"card": label, "package": ssim_cuda.__file__, "ms": ms}))
        return 0
    if args.batch and args.radii:
        torch.backends.cuda.matmul.allow_tf32 = False
        batch_radius_times(gen, ms, cases=BATCH_RULE_CASES)
        for key, (bnd, by) in batch_radius_bounds(cases=BATCH_RULE_CASES).items():
            ms[f"{key} bound"] = bnd
            print(f"  {key}: stream / tile body {ms[key] / ms[f'{key} tile body']:.3f}, bound "
                  f"{bnd:.4f} ms ({by})", flush=True)
        print("  STREAM_BATCH_TILE_RADII measured:", batch_tile_rule(ms), flush=True)
        print(json.dumps({"card": label, "package": ssim_cuda.__file__, "ms": ms}))
        return 0
    if args.radii:
        radius_times(gen, ms)
        print(json.dumps({"card": label, "package": ssim_cuda.__file__, "ms": ms}))
        return 0
    if args.batch or args.loss:
        if args.batch:
            batch_times(gen, ms, args.packs)
        if args.loss:
            loss_step_times(gen, ms)
        print(json.dumps({"card": label, "package": ssim_cuda.__file__, "ms": ms}))
        return 0
    for name, shape in SHAPES:
        a, b = u8_pair(gen, shape)
        for mode, fn in main_path_modes(a, b).items():
            ms[f"{mode} {name}"] = cuda_ms(fn)
            print(f"  {mode} {name}: {ms[f'{mode} {name}']:.4f} ms", flush=True)
        if name == "1080p_b4":
            for mode, fn in tile_body_modes(gen, a, b).items():
                ms[mode] = cuda_ms(fn)
                print(f"  {mode}: {ms[mode]:.4f} ms", flush=True)
            comp_modes(a, b, ms)
            comp_modes(a.float() / 255.0, b.float() / 255.0, ms)
        if args.segments:
            segment_sweep(name, a, b)
        del a, b
        torch.cuda.empty_cache()
    for shape in MSSSIM_SCALES:
        a, b = u8_pair(gen, shape)
        comp_modes(a.float() / 255.0, b.float() / 255.0, ms, trace=True)
        if args.segments:
            segment_sweep("x".join(str(n) for n in shape), a, b)
    batch_times(gen, ms)
    print(json.dumps({"card": label, "package": ssim_cuda.__file__, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
