"""The batch modes' packed row stream at a runtime radius
(csrc/fwd_batch_kernel.cuh, the kR = 0 instantiations that
csrc/ssim_fwd_batch_rt.cu launches), built for the host with g++ by
tests/test_torch_port_fwd_stream.py's emulator (tests/fwd_stream_emu: one
std::thread per CUDA thread, outputs and shared memory NaN at each block's
start) and held against ssim_parts_batch_plain at radii 1, 3, 8 and 16 in
kBatch, kBatchPrecise and the relaxed kBatch. A file of its own, so that
its emulator build and cases run beside the forward's other host builds.
"""

import numpy as np
import pytest
import torch

from test_torch_port_fwd_stream import (_RELAXED_GLOBAL, _RELAXED_PIXEL, _build_emulator,
                                        _emu_pair, _emulate_batch)

from ssim_tpu_torch.ops import ssim_cuda
from ssim_tpu_torch.windows import gaussian_taps


@pytest.fixture(scope="module")
def stream_emulator(tmp_path_factory):
    """The streaming kernels' source built for the host (_build_emulator);
    its path."""
    return _build_emulator(tmp_path_factory.mktemp("fwd_stream_emu"))


#: The batch stream at a runtime radius (ssim_fwd_batch_rt.cu): (radius,
#: sigma, f32, shape, pack (k, segment rows)), NaN pixels (image, y, x),
#: images whose pair is made equal (b = a: SSIM 1, a sum of exactly 0).
#: Each runs kBatch, kBatchPrecise and the relaxed kBatch: at a width whose
#: strips hold whole 16-column tiles of one image (32: the strip's tiles)
#: and one whose tiles straddle two (40, 5, 12, 65: the staged row's own
#: tiles, up to four sweeps at radius 16), 12 pieces a strip, images
#: straddling strips and tall ones in segments (the second pass,
#: batch_direct false), a NaN image, and images of one pixel, one row or
#: one column, where the window's every tap reads a clamped pixel.
_EMU_RT_BATCH_CASES = {
    "r1 u8 W=32, a short last packed row": (1, 0.8, False, (6, 9, 32), (4, 9), (), ()),
    "r1 f32 W=40, NaN in image 1 at a tile's straddle": (
        1, 0.8, True, (3, 7, 40), (3, 7), ((1, 5, 7),), ()),
    "r3 u8 W=65 straddling strips, the second pass": (
        3, 1.2, False, (3, 6, 65), (3, 6), (), ()),
    "r3 f32 W=5, 12 to a strip, NaN in image 4": (
        3, 1.2, True, (13, 7, 5), (12, 7), ((4, 3, 2),), ()),
    "r8 u8 W=40, segments, the second pass": (8, 2.5, False, (3, 33, 40), (3, 32), (), ()),
    "r8 f32 W=32, NaN in image 2": (8, 2.5, True, (5, 9, 32), (4, 9), ((2, 8, 31),), ()),
    "r8 u8 1x1 images, image 1's pair equal": (8, 2.5, False, (3, 1, 1), (3, 1), (), (1,)),
    "r8 u8 H=1, W=40, image 2's pair equal": (8, 2.5, False, (4, 1, 40), (4, 1), (), (2,)),
    "r8 f32 W=1, NaN in image 1": (8, 2.5, True, (3, 50, 1), (3, 50), ((1, 20, 0),), ()),
    "r16 u8 W=12, 10 a strip": (16, 3.0, False, (12, 5, 12), (10, 5), (), ()),
    "r16 f32 W=40, NaN in a segment's halo rows": (
        16, 3.0, True, (2, 34, 40), (2, 32), ((1, 33, 0),), ()),
}


@pytest.mark.parametrize("case", list(_EMU_RT_BATCH_CASES))
def test_batch_stream_source_runtime_radius_matches_twin_on_the_host(stream_emulator, case):
    """The batch modes' packed stream at a runtime radius
    (ssim_fwd_batch_stream_kernel<T, mode, kSplit, 0>, its staged rows and
    ring of 2r + 1 pushes in dynamic shared memory; relaxed with kSplit =
    ksteps(r)), built for the host, against ssim_parts_batch_plain at the
    same radius: per-image scores within 2e-7 (kBatchPrecise within 1e-12
    relative; the relaxed kBatch within 2e-6, never tighter than 2 * 2e-5 /
    sqrt(H W), and different from the standard kBatch), counts exact, NaN
    in exactly the images that hold a non-finite pixel, a sum of exactly 0
    where an image's pair is equal."""
    radius, sigma, f32, shape, pack, nans, same = _EMU_RT_BATCH_CASES[case]
    rng = np.random.default_rng(0x5F60 + len(case))
    a, b = _emu_pair(rng, shape, f32)
    for img in same:
        b[img] = a[img]
    for img, y, x in nans:
        a[img, y, x] = np.nan
    bsz, h, w = shape
    dr = 1.0 if f32 else 255.0
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    bad = sorted({img for img, _, _ in nans})
    std = None
    for precise, relaxed in ((False, False), (True, False), (False, True)):
        got = _emulate_batch(stream_emulator, a, b, precise, pack, relaxed, radius, sigma)
        want = ssim_cuda.ssim_parts_batch_plain(
            at, bt, precise, relaxed=relaxed,
            taps=gaussian_taps(np.float64 if precise else np.float32, radius, sigma),
            c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr))
        assert got.dtype == want.dtype
        assert torch.equal(got[:, 1], want[:, 1]) and (got[:, 1] == h * w).all()
        assert torch.isnan(got[:, 0]).nonzero().flatten().tolist() == bad, (precise, relaxed)
        gk = got[:, 0].double().numpy() / (h * w)
        gp = want[:, 0].double().numpy() / (h * w)
        ok = np.isfinite(gp)
        for img in same:
            assert gk[img] == gp[img] == 0.0, (precise, relaxed, img, gk[img], gp[img])
        if precise:
            # |gk - gp| <= 1e-12 |gp|, which at gp = 0 asks gk = 0 exactly.
            err, tol = np.abs(gk[ok] - gp[ok]) - 1e-12 * np.abs(gp[ok]), 0.0
        elif relaxed:
            err = np.abs(gk[ok] - gp[ok])
            tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / (h * w) ** 0.5)
            assert np.abs(gk[ok] - std[ok]).max() > 0
        else:
            err, tol, std = np.abs(gk[ok] - gp[ok]), 2e-7, gk
        assert err.max(initial=0.0) <= tol, (precise, relaxed, err.max())
