"""Times the backward kernel on the card, by radius.

    python -m ssim_tpu_torch.tools.bwd_times [--segments] [--radii R,... [--designs]]
                                             [--relaxed [--radii R,...] [--strips]]

Times `ssim_grad_cuda` (CUDA events around 20 back-to-back calls, median
of 3) at (4, 1080, 1920) f32 for radii 4, 5, 6 and 16, with and without a
g_map cotangent, and prints the card's name and power limit, then one JSON
line {"card": ..., "package": ..., "ms": {"r=5": ..., "r=5 g_map": ...}}.
It calls only `ssim_grad_cuda`'s public arguments, so it also times another
checkout's kernel when run as a file with that checkout's root on
PYTHONPATH:

    PYTHONPATH=/path/to/checkout python ssim_tpu_torch/tools/bwd_times.py

--segments also times each radius without g_map at every segment length
the kernel takes up to 512 rows, beside the wrapper's own choice
(`ssim_grad.stream_segment`).

--radii R,... (without --relaxed) times the standard tier at those radii
instead, with and without g_map, each beside its blocks per SM (the CUDA
runtime's occupancy for the design the package routes there: the one-pass
stream at STD_WINDOW_RADII, the two-pass stream at the other radii but
5); --designs also times each standard design built at each radius,
pinned (`_launch(two_pass=)`: "r=8 two-pass", "r=3 one-pass"), with its
blocks per SM.

--relaxed times the relaxed tier instead (`relaxed=True`, every band pass
on the tensor cores) at radii 5 and 4 (RELAXED_RADII; --radii R,... for
others, also without --relaxed), each with and without g_map, through
`ssim_grad_cuda` (whatever design the package runs there: run it with a
parent checkout on PYTHONPATH, in turns with this one, to time that
checkout's). --strips (with --relaxed) also times the relaxed stream at
each strip it takes (128 and 64 columns, where the package builds the
block and it fits), pinned, beside its occupancy: "r=4 relaxed strip 64".
With --segments, the first radius's segments.
"""

import argparse
import inspect
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ssim_tpu_torch.ops import ssim_grad
from ssim_tpu_torch.windows import gaussian_taps

SHAPE = (4, 1080, 1920)
RADII = (4, 5, 6, 16)
RELAXED_RADII = (5, 4)
STRIPS = (128, 64)


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--segments", action="store_true")
    parser.add_argument("--relaxed", action="store_true")
    parser.add_argument("--radii", type=lambda x: tuple(int(v) for v in x.split(",")))
    parser.add_argument("--strips", action="store_true")
    parser.add_argument("--designs", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    label = card_label()
    print(label, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    a = 255 * torch.rand(SHAPE, generator=gen, device="cuda")
    b = (a + 12.0 * torch.randn(SHAPE, generator=gen, device="cuda")).clamp_(0, 255)
    g = torch.randn(SHAPE, generator=gen, device="cuda")
    w_s = torch.full((SHAPE[0],), 1.0 / (SHAPE[1] * SHAPE[2]), device="cuda")
    w_cs = torch.zeros(SHAPE[0], device="cuda")
    ms = {}
    radii, tag = (RELAXED_RADII, " relaxed") if args.relaxed else (RADII, "")
    radii = args.radii or radii
    strips = args.strips and "strip_w" in inspect.signature(ssim_grad._launch).parameters
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for radius in radii:
        kw = dict(taps=gaussian_taps(np.float32, radius, 1.5), c1=(0.01 * 255) ** 2,
                  c2=(0.03 * 255) ** 2, clip_bound=131072.0, relaxed=args.relaxed)
        for name, gmap in ((f"r={radius}{tag}", None), (f"r={radius}{tag} g_map", g)):
            ms[name] = cuda_ms(lambda: ssim_grad.ssim_grad_cuda(
                a, b, w_s, w_cs, gmap, data_range=255.0, radius=radius, sigma=1.5,
                relaxed=args.relaxed))
            extra = ""
            if args.radii and not args.relaxed:
                ms[f"{name} blocks_per_sm"] = blocks = ssim_grad._resident(
                    a.device.index, radius, gmap is not None) // sms
                extra = f" ({blocks} blocks/SM)"
            print(f"  {name}: {ms[name]:.4f} ms{extra}", flush=True)
        if args.designs and not args.relaxed and hasattr(ssim_grad, "std_two_pass"):
            for two in (True, False):
                if radius == 5 or not (two or radius in ssim_grad.STD_WINDOW_RADII):
                    continue
                design = "two-pass" if two else "one-pass"
                for name, gmap in ((f"r={radius} {design}", None),
                                   (f"r={radius} {design} g_map", g)):
                    ms[name] = cuda_ms(lambda: ssim_grad._launch(a, b, w_s, w_cs, gmap,
                                                                 two_pass=two, **kw))
                    ms[f"{name} blocks_per_sm"] = blocks = ssim_grad._resident(
                        a.device.index, radius, gmap is not None, False, ssim_grad.STRIP_W,
                        two) // sms
                    print(f"  {name}: {ms[name]:.4f} ms ({blocks} blocks/SM)", flush=True)
        if strips:
            for sw in STRIPS:
                try:
                    res = ssim_grad._resident(a.device.index, radius, False, True, sw)
                except RuntimeError:
                    print(f"  r={radius}{tag} strip {sw}: not built or does not fit",
                          flush=True)
                    continue
                seg = ssim_grad.stream_segment(*SHAPE, radius, res, sw)
                name = f"r={radius}{tag} strip {sw}"
                ms[name] = cuda_ms(lambda: ssim_grad._launch(a, b, w_s, w_cs, None,
                                                             strip_w=sw, **kw))
                ms[f"{name} resident"] = res
                print(f"  {name}: {ms[name]:.4f} ms ({res} resident, segment {seg})",
                      flush=True)
    if args.segments:
        for radius in (radii[:1] if args.relaxed else radii):
            tile_h = ssim_grad.default_tile(radius)[0]
            kw = dict(taps=gaussian_taps(np.float32, radius, 1.5),
                      c1=(0.01 * 255) ** 2, c2=(0.03 * 255) ** 2, clip_bound=131072.0,
                      relaxed=args.relaxed)
            sw = ssim_grad.relaxed_strip_w(radius) if args.relaxed else ssim_grad.STRIP_W
            resident = ssim_grad._resident(a.device.index, radius, False, args.relaxed, sw)
            parts = [f"auto {ssim_grad.stream_segment(*SHAPE, radius, resident, sw)}"]
            for seg in range(tile_h, min(512, ssim_grad.MAX_SEG_TILES * tile_h) + 1, tile_h):
                t = cuda_ms(lambda: ssim_grad._launch(a, b, w_s, w_cs, None,
                                                      segment=seg, **kw))
                parts.append(f"{seg}: {t:.4f}")
            print(f"  segments r={radius}{tag}: " + ", ".join(parts) + " ms", flush=True)
    print(json.dumps({"card": label, "package": ssim_grad.__file__, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
