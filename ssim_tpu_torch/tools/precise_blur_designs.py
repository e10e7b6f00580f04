"""Per-pixel error of candidate blur designs for the precise tier against
the f64 oracle, on the inputs where the f32 blurs fail: flat windows.

The precise modes (kPrecise, kPreciseMap, kBatchPrecise) blur in fp64 with
the f64 taps, which costs fp64 arithmetic and f64 planes in shared memory.
Each cheaper design is emulated here with the twins' own blur passes
(`ssim_cuda.hpass4` then `ssim_cuda.sym_blur`, in the kernel's order of
operations) and the SSIM formula in f64, and held to the tier's bound of
5e-7 per pixel. Accuracy only: it runs on the CPU and measures no time.

    python -m ssim_tpu_torch.tools.precise_blur_designs
"""

import numpy as np
import torch

from ssim_tpu_torch import reference
from ssim_tpu_torch.ops import ssim_cuda
from ssim_tpu_torch.windows import gaussian_taps

PIXEL_BOUND = 5e-7
C1, C2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
F32, F64 = torch.float32, torch.float64

# name: (horizontal pass dtype, vertical pass dtype, taps dtype of each
# pass, input shift)
DESIGNS = {
    "f32 blurs, f32 taps (the standard modes')": (F32, F32, "f32", None),
    "fp64 blurs, f32 taps": (F64, F64, "f32", None),
    "fp64 blurs, f64 taps (shipped)": (F64, F64, "f64", None),
    "f32 horizontal, fp64 vertical with f64 taps": (F32, F64, "mixed", None),
    "fp64 horizontal with f64 taps, f32 vertical": (F64, F32, "mixed", None),
    "f32 blurs on inputs less 128": (F32, F32, "f32", "128"),
    "f32 blurs on inputs less the first pixel": (F32, F32, "f32", "first"),
}


def ssim_map(a, b, design, radius=5, sigma=1.5):
    """(B, H, W) SSIM of u8 arrays under one design. A shift k is taken
    off each input before the blurs and added back to the means: the
    variances do not depend on it."""
    hdt, vdt, taps, shift = design
    t32 = [float(v) for v in gaussian_taps(np.float32, radius, sigma)]
    t64 = [float(v) for v in gaussian_taps(np.float64, radius, sigma)]
    th = t64 if taps == "f64" or (taps == "mixed" and hdt == F64) else t32
    tv = t64 if taps == "f64" or (taps == "mixed" and vdt == F64) else t32
    a = torch.from_numpy(a).to(F32)
    b = torch.from_numpy(b).to(F32)
    ka = torch.zeros_like(a[:, :1, :1])
    kb = torch.zeros_like(ka)
    if shift == "128":
        ka, kb = ka + 128.0, kb + 128.0
    elif shift == "first":
        ka, kb = a[:, :1, :1].clone(), b[:, :1, :1].clone()
    a, b = a - ka, b - kb
    h, w = a.shape[-2:]
    ap = ssim_cuda._pad_edge(a, radius).to(hdt)
    bp = ssim_cuda._pad_edge(b, radius).to(hdt)
    planes = [p.to(vdt) for p in ssim_cuda.hpass4(ap, bp, th, w)]
    ma, mb, ss, dd = (ssim_cuda.sym_blur(p, tv, 1, h).to(F64) for p in planes)
    sab4 = (ss - dd) - 4.0 * ma * mb
    ssum2 = (ss + dd) - 2.0 * (ma * ma + mb * mb)
    mua, mub = ma + ka.to(F64), mb + kb.to(F64)
    num = (2.0 * mua * mub + C1) * (0.5 * sab4 + C2)
    den = (mua * mua + mub * mub + C1) * (0.5 * ssum2 + C2)
    return (num / den).numpy()


def cases(seed=0):
    """name: list of (a, b) u8 (B, H, W) pairs."""
    rng = np.random.default_rng(seed)
    a1 = np.arange(256, dtype=np.uint8).reshape(256, 1, 1)

    def offset(x, o):
        return np.clip(x.astype(np.int32) + o, 0, 255).astype(np.uint8)

    halves = np.zeros((64, 32, 64), np.uint8)
    halves[:, :, :32] = rng.integers(0, 256, 64)[:, None, None]
    halves[:, :, 32:] = rng.integers(0, 256, 64)[:, None, None]
    a = rng.integers(0, 256, (4, 64, 96), dtype=np.uint8)
    noise = rng.normal(0, 12, a.shape).astype(np.int32)
    return {
        "1x1, b = a + o, o in +-128, -37, -5, 5, 20, 255":
            [(a1, offset(a1, o)) for o in (-128, -37, -5, 5, 20, 128, 255)],
        "(64, 32, 64) two flat halves, b = a + 9": [(halves, offset(halves, 9))],
        "2000 random 1x1 pairs": [tuple(rng.integers(0, 256, (2, 2000, 1, 1),
                                                     dtype=np.uint8))],
        "(4, 64, 96) random, b = a + N(0, 12)": [(a, offset(a, noise))],
    }


def oracle_map(a, b):
    return np.stack([reference.compute_ssim(x, y, with_map=True)[1]
                     for x, y in zip(a, b)])


def main():
    torch.set_num_threads(1)
    inputs = cases()
    want = {k: [oracle_map(a, b) for a, b in v] for k, v in inputs.items()}
    print(f"max |ssim - oracle| per pixel, and the pixels over {PIXEL_BOUND:g}")
    for name, design in DESIGNS.items():
        rows = []
        for k, v in inputs.items():
            err = np.concatenate([np.abs(ssim_map(a, b, design) - o).ravel()
                                  for (a, b), o in zip(v, want[k])])
            rows.append((k, err.max(), int((err > PIXEL_BOUND).sum()), err.size))
        verdict = "within" if max(r[1] for r in rows) <= PIXEL_BOUND else "OVER"
        print(f"{name}: {verdict}")
        for k, e, n, size in rows:
            print(f"    {k}: {e:.3g}, {n} of {size} over")


if __name__ == "__main__":
    main()
