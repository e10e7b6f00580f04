"""The standard backward at every radius but 5 (csrc/bwd_std_rt.cuh, the
two-pass stream: pass A's weight maps into a scratch map on the mid grid,
pass B's adjoints from it; csrc/ssim_bwd_rt.cu also builds radius 5's
one-pass stream at the radii ops.ssim_grad.STD_WINDOW_RADII names, and
routes them there), as far
as the CPU can hold it: the routing and what the wrapper hands the C entry
(a stand-in library), the shared-memory model, and the kernels' own source
built for the host by g++ (tests/fwd_stream_emu/bwd_std_harness.cpp: one
std::thread per CUDA thread, std::barrier for __syncthreads, shared memory
and the scratch map NaN until written) against ssim_grad_plain within the
card's 1e-6 x max(1, max|g|), NaN over exactly the twin's tiles. The
kernels themselves run only on a card: tests/test_torch_port_cuda.py and
chip_smoke.py phase 15f hold them there.
"""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_port_bwd_stream import (_build_bwd_emulator, _emulate, _halo_band,
                                        _hold_std, _pair, fake_launch)  # noqa: F401

from ssim_tpu_torch.ops import _build, ssim_grad
from ssim_tpu_torch.windows import RADIUS, gaussian_taps

_RADII = [r for r in range(1, 17) if r != RADIUS]


@pytest.fixture(scope="module")
def std_emulator(tmp_path_factory):
    """The standard tier's streams built for the host
    (_build_bwd_emulator, bwd_std_harness.cpp); its path."""
    return _build_bwd_emulator(tmp_path_factory.mktemp("bwd_std_rt_emu"), "bwd_std_harness.cpp")


def test_routing_and_the_built_radii():
    """Every radius but 5 runs the two-pass stream but STD_WINDOW_RADII, the
    radii whose one-pass stream ssim_bwd_rt.cu builds (the source's `case`
    labels) and routes there."""
    src = open(os.path.join(_build.CSRC_DIR, "ssim_bwd_rt.cu")).read()
    body = src[src.index("cudaError_t with_window_radius"):]
    body = body[:body.index("default:")]
    assert tuple(int(x) for x in re.findall(r"case (\d+):", body)) == ssim_grad.STD_WINDOW_RADII
    assert RADIUS not in ssim_grad.STD_WINDOW_RADII
    assert not ssim_grad.std_two_pass(RADIUS)
    for radius in _RADII:
        assert ssim_grad.std_two_pass(radius) == (radius not in ssim_grad.STD_WINDOW_RADII)


@pytest.mark.parametrize("radius", _RADII)
def test_two_pass_shared_memory_holds_two_blocks_per_sm(radius):
    """The two-pass stream's shared-memory model (bwd_std_rt.cuh rt_smem_a /
    rt_smem_b, two rows a step) leaves at least 2 blocks of each pass on an
    H100's SM (228 KB, 1 KB reserved a block), where the one-pass stream
    with both windows as rings held 1 from radius 8; and more at small
    radii (at least 4 up to radius 9, 7 up to radius 4)."""
    blocks = ssim_grad.std_blocks_per_sm(radius, True)
    assert blocks >= 2
    if radius <= 9:
        assert blocks >= 4
    if radius <= 4:
        assert blocks >= 7
    a, b = ssim_grad.std_smem_bytes(radius)
    assert a == 16 * (4 * (128 + 2 * radius) + (2 * radius + 2) * 128)
    assert b == 16 * (2 * radius + 6) * (128 + 2 * radius)


@pytest.mark.parametrize("radius", [4, 16])
@pytest.mark.parametrize("two_pass", [None, False])
def test_launch_passes_scratch_to_the_two_pass_stream(fake_launch, radius, two_pass):
    """A routed standard launch at a radius other than 5 hands the C entry
    a scratch buffer of std_rt_scratch_bytes (the mid grid's float4 map and
    the tile mask) after its strip; a launch pinned to the one-pass stream
    passes none, where it is built (radius 16 has none: refused)."""
    bsz, h, w = 2, 100, 300
    a = torch.zeros((bsz, h, w))
    kw = dict(taps=gaussian_taps(np.float32, radius, 1.5), c1=1e-4, c2=9e-4,
              clip_bound=131072.0)
    if two_pass is False and radius not in ssim_grad.STD_WINDOW_RADII:
        with pytest.raises(ValueError):
            ssim_grad._launch(a, a, torch.ones(bsz), torch.zeros(bsz), None, segment=32,
                              two_pass=two_pass, **kw)
        return
    ssim_grad._launch(a, a, torch.ones(bsz), torch.zeros(bsz), None, segment=32,
                      two_pass=two_pass, **kw)
    (call,) = fake_launch.calls
    assert call[20:22] == (32, ssim_grad.STRIP_W)
    two = ssim_grad.std_two_pass(radius) if two_pass is None else two_pass
    assert (call[22] is not None) == two
    assert ssim_grad.std_rt_scratch_bytes(bsz, h, w, radius) == (
        16 * bsz * (h + 2 * radius) * (w + 2 * radius)
        + 4 * bsz * -(-h // ssim_grad.default_tile(radius)[0]) * -(-w // 64))


def _designs(radius):
    """The standard designs built at this radius: the two-pass stream, and
    the one-pass one where ssim_bwd_rt.cu builds it."""
    return [True] + ([False] if radius in ssim_grad.STD_WINDOW_RADII else [])


#: (radius, shape, segment, planted non-finite pixels (image, y, x, value)):
#: ragged last strips and segments, B = 2, segments of one and two tiles,
#: the 16 x 64 NaN tile at radius 16, W under one strip at radius 1.
_CASES = {
    "r1 W < a strip": (1, (1, 33, 60), 32, ()),
    "r2 B = 2, ragged strip and segment": (2, (2, 70, 200), 32, ()),
    "r4 2 tiles a segment": (4, (1, 75, 140), 64, ()),
    "r7 B = 2, NaN in image 1": (7, (2, 40, 140), 32, ((1, 20, 70, np.nan),)),
    "r8 ragged strip": (8, (1, 40, 150), 32, ()),
    "r12 two segments": (12, (1, 45, 140), 32, ()),
    "r15 ragged, inf": (15, (1, 40, 135), 32, ((0, 39, 134, np.inf),)),
    "r16 16-row tiles": (16, (2, 37, 150), 16, ()),
}


@pytest.mark.parametrize("with_g", [False, True], ids=["no g_map", "g_map"])
@pytest.mark.parametrize("case", list(_CASES))
def test_runtime_radius_source_matches_twin_on_the_host(std_emulator, case, with_g):
    """The two-pass stream (and the one-pass stream where it is built),
    built for the host, against ssim_grad_plain: within 1e-6 x max(1,
    max|g|), NaN over exactly the twin's tiles and only where a non-finite
    input lies, with and without g_map."""
    radius, shape, seg, planted = _CASES[case]
    rng = np.random.default_rng(0xD0 + radius + 32 * with_g)
    a, b = _pair(rng, shape)
    for img, y, x, v in planted:
        a[img, y, x] = v
    g_map = rng.normal(0, 1e-5, shape).astype(np.float32) if with_g else None
    for two in _designs(radius):
        da, db = _hold_std(std_emulator, a, b, seg, g_map, seed=radius, radius=radius,
                           two_pass=two)
        assert all(bool(x.isnan().any()) == bool(planted) for x in (da, db))
        if planted:
            assert not da.isnan().all()


@pytest.mark.parametrize("radius,flags", [(3, (1, 0)), (3, (0, 0)), (13, (0, 1)), (13, (1, 1))])
def test_runtime_radius_source_with_halo_operands_on_the_host(std_emulator, radius, flags):
    """Halo operands of 2r rows at radii 3 and 13: a band of 2r + 27 rows of
    a taller image (a segment of 32 and a ragged one), the operands read
    where a flag is clear, never read (NaN-filled) where it is set, the loss
    rows beyond a set flag dropped and the clamp folded onto the band's
    edge row there."""
    rng = np.random.default_rng(0xD8 + 2 * flags[0] + flags[1] + radius)
    lo = 2 * radius + 3
    a, b, vhalo = _halo_band(rng, (1, 6 * radius + 60, 150), lo, lo + 2 * radius + 27,
                             radius, flags)
    got = _hold_std(std_emulator, a, b, 32, vhalo=vhalo, vmask=flags, seed=radius,
                    radius=radius, two_pass=True)
    assert all(torch.isfinite(x).all() for x in got)


def test_runtime_radius_source_nonfinite_on_boundaries_on_the_host(std_emulator):
    """Non-finite inputs at radius 7 on a segment's first and last rows, a
    strip's last and first columns, 2r rows above a segment, the image's
    first and last pixels: NaN over exactly the twin's 32 x 64 tiles (those
    within 2r, the clamped border's copies included), nowhere else, and in
    no other image."""
    rng = np.random.default_rng(0xDA)
    a, b = _pair(rng, (3, 70, 260))
    a[0, 32, 50] = np.nan
    a[0, 31, 200] = np.inf
    b[1, 32 - 14, 127] = -np.inf
    a[1, 60, 128] = np.nan
    b[1, 69, 259] = np.nan
    a[2, 0, 0] = np.nan
    for two in _designs(7):
        da, db = _hold_std(std_emulator, a, b, 32, seed=7, radius=7, two_pass=two)
        assert da[0].isnan().any() and da[1].isnan().any() and da[2].isnan().any()
        assert not da[1].isnan().all() and not da[2].isnan().all()


@pytest.mark.parametrize("radius", [3, 9])
def test_runtime_radius_source_one_row_on_the_host(std_emulator, radius):
    """H = 1: every mid row but the image's one lies outside it, and both
    vertical folds land on that row; within 1e-6 x max(1, max|g|) of the
    twin, NaN nowhere."""
    rng = np.random.default_rng(0xDB + radius)
    a, b = _pair(rng, (2, 1, 200))
    for two in _designs(radius):
        got = _hold_std(std_emulator, a, b, 32, seed=radius, radius=radius, two_pass=two)
        assert all(torch.isfinite(x).all() for x in got)


@pytest.mark.parametrize("radius", [2, 11])
def test_two_pass_seam_mask_and_margin_on_the_host(std_emulator, tmp_path, radius):
    """What pass A hands pass B: the scratch the harness dumps is
    std_rt_scratch_bytes long; its tile mask is set exactly on the tiles
    the twin makes NaN (a NaN at the image's corner, whose clamped copies
    reach the tiles within 2r, and one where pass A's 128-column mid strips
    and pass B's output strips cut the image at different columns); its
    weight maps are finite on the whole mid grid, zero at every position
    outside the image (the r margin) and nonzero inside."""
    rng = np.random.default_rng(0xDC + radius)
    bsz, h, w = 2, 70, 300
    a, b = _pair(rng, (bsz, h, w))
    a[0, h - 1, 0] = np.nan
    b[1, 40, 128 - radius] = np.nan
    tile_h = ssim_grad.default_tile(radius)[0]
    dump = tmp_path / "scratch.bin"
    w_s = np.full(bsz, 1.0 / (h * w), np.float32)
    w_cs = np.full(bsz, 0.3 / (h * w), np.float32)
    da, _ = _emulate(std_emulator, a, b, w_s, w_cs, None, 32, radius=radius,
                     strip_w=ssim_grad.STRIP_W, two_pass=1, dump=dump)
    raw = np.fromfile(dump, np.uint8)
    assert raw.size == ssim_grad.std_rt_scratch_bytes(bsz, h, w, radius)
    ntr, ntc = -(-h // tile_h), -(-w // 64)
    mask = raw[:4 * bsz * ntr * ntc].view(np.uint32).reshape(bsz, ntr, ntc)
    want = da.isnan().numpy()[:, ::tile_h, ::64]
    assert np.array_equal(mask != 0, want) and want[0].any() and want[1].any()
    wmap = raw[4 * bsz * ntr * ntc:].view(np.float32).reshape(bsz, h + 2 * radius,
                                                              w + 2 * radius, 4)
    assert np.isfinite(wmap).all()
    inside = np.zeros(wmap.shape[1:3], bool)
    inside[radius:radius + h, radius:radius + w] = True
    assert (wmap[:, ~inside] == 0).all()
    assert (np.abs(wmap[:, inside]).sum(-1) > 0).all()
