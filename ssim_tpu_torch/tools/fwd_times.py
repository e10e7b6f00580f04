"""Times the forward kernel's modes on the card.

    python -m ssim_tpu_torch.tools.fwd_times [--segments]

Times (CUDA events around 20 back-to-back calls, median of 3) the
streaming kernel's modes kScore, kMap, kRowsum and kRowsumMap (the row
modes with halo operands, both flags set, as on one rank), kPrecise,
kPreciseMap and relaxed kScore and kMap on u8 pairs at 1080p x4, 4K x4,
16K x1 and 1x1024x20480, and beside them the tile body's modes:
components and pooled components, relaxed and not, kScore and precise at
radius 1 and 16 at 1080p x4, batch, relaxed batch and batch precise at
64x64 x4096. Prints the card's name and power
limit, then one JSON line {"card": ..., "package": ..., "ms": {...}}. It
calls only the wrappers' public arguments, so it also times another
checkout's kernel when run as a file with that checkout's root on
PYTHONPATH:

    PYTHONPATH=/path/to/checkout python ssim_tpu_torch/tools/fwd_times.py

--segments also times kScore, kRowsum, kPrecise and relaxed kScore at each
shape at every segment length the streaming kernel takes (the last two
where they stream), beside the wrapper's own choice
(`ssim_cuda.stream_segment`).
"""

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ssim_tpu_torch.ops import ssim_cuda

SHAPES = (("1080p_b4", (4, 1080, 1920)), ("4k_b4", (4, 2160, 3840)),
          ("16k_b1", (1, 8640, 15360)), ("wide_b1", (1, 1024, 20480)))


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
    }


def tile_body_modes(gen, a, b):
    """The tile body's modes at 1080p x4 (batch at 64x64 x4096): name ->
    call."""
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
        "batch 64x64_b4096": lambda: ssim_cuda.ssim_parts_batch_cuda(sa, sb),
        "relaxed batch 64x64_b4096": lambda: ssim_cuda.ssim_parts_batch_cuda(
            sa, sb, relaxed=True),
        "batch precise 64x64_b4096": lambda: ssim_cuda.ssim_parts_batch_cuda(
            sa, sb, precise=True),
    }


def segment_sweep(name, a, b):
    """kScore, kRowsum, kPrecise and relaxed kScore at every segment the
    streaming kernel takes (the last two where they stream)."""
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    label = card_label()
    print(label, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    ms = {}
    for name, shape in SHAPES:
        a, b = u8_pair(gen, shape)
        for mode, fn in main_path_modes(a, b).items():
            ms[f"{mode} {name}"] = cuda_ms(fn)
            print(f"  {mode} {name}: {ms[f'{mode} {name}']:.4f} ms", flush=True)
        if name == "1080p_b4":
            for mode, fn in tile_body_modes(gen, a, b).items():
                ms[mode] = cuda_ms(fn)
                print(f"  {mode}: {ms[mode]:.4f} ms", flush=True)
        if args.segments:
            segment_sweep(name, a, b)
        del a, b
        torch.cuda.empty_cache()
    print(json.dumps({"card": label, "package": ssim_cuda.__file__, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
