"""The forward kernel's row-streaming instantiation, as far as the CPU can
hold it: which launches it serves (ops.ssim_cuda.stream_applies), the
segment its wrapper picks (stream_segment), the blocks it decodes
(stream_blocks), and its source built for the host by g++
(tests/fwd_stream_emu: one std::thread per CUDA thread, a std::barrier for
__syncthreads, no FMA contraction, as nvcc builds it with --fmad=false)
against the twins, maps bit for bit (the relaxed modes, whose band
products go through a host model of mma.sync, within the relaxed tier's
tolerance). The kernel itself runs only on a card:
tests/test_torch_port_cuda.py holds it against the twins there
(test_forward_stream_*, test_precise_stream_*, test_relaxed_stream_*). On the CPU every wrapper runs its twin, whose
per-pixel values and partials the JAX package's kernel holds in
tests/test_torch_port_kernel.py and tests/test_torch_port_spatial.py.
"""

import itertools
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ssim_tpu_torch.ops import _build, ssim_cuda, ssim_grad
from ssim_tpu_torch.windows import gaussian_taps

#: The main-path shapes (chip_smoke.py phase 4) and phase 9's bands:
#: 1080p x4 in 3 bands and in bands of 523, 20, 35 and 502 rows, 4K x4 in 4
#: bands, 1x1024x20480 in bands of 400, 300 and 324 rows, and the 16K frame
#: as one band.
SHAPES = [(4, 1080, 1920), (4, 2160, 3840), (1, 8640, 15360), (4, 360, 1920),
          (4, 523, 1920), (4, 20, 1920), (4, 35, 1920), (4, 502, 1920),
          (4, 540, 3840), (1, 400, 20480), (1, 300, 20480), (1, 324, 20480),
          (1, 1024, 20480)]


#: Streaming blocks an H100 holds at once: 8 per SM (64 registers a
#: thread, ssim_fwd_stream_occupancy) on each of its 132 SMs.
H100_RESIDENT = 132 * 8


def _blocks(bsz, h, w, seg):
    return bsz * -(-w // ssim_cuda.STRIP_W) * -(-h // seg)


@pytest.mark.parametrize("shape", SHAPES)
def test_stream_segment_fills_the_card(shape):
    """At the main-path shapes and phase 9's band heights, on an H100: the
    segment is 1 to MAX_SEG_TILES whole tiles and ends less than a tile
    past the image; where the one-tile segment gives no more blocks than
    the card holds, it is taken; else the blocks fill at least 75% of the
    slots of the waves they take, and 95% at the main-path shapes."""
    bsz, h, w = shape
    tile_h = ssim_cuda.TILE_H
    res = H100_RESIDENT
    seg = ssim_cuda.stream_segment(bsz, h, w, tile_h, 2 * ssim_cuda.STREAM_RADIUS, res)
    assert seg % tile_h == 0
    assert tile_h <= seg <= ssim_cuda.MAX_SEG_TILES * tile_h
    assert seg < h + tile_h
    if _blocks(bsz, h, w, tile_h) <= res:
        assert seg == tile_h, (shape, seg)
        return
    blocks = _blocks(bsz, h, w, seg)
    fill = blocks / (-(-blocks // res) * res)
    assert fill >= (0.95 if shape in SHAPES[:3] else 0.75), (shape, seg, fill)


def test_stream_segment_tail_allowance():
    """The forward's model charges a whole wave for any partial last wave
    (its sweeps on an H100, PERF.md); the backward's lets a last wave of at
    most a twentieth of the resident blocks run beside the others, and is
    otherwise the same model with the NaN tile's height and a 4r prologue."""
    for bsz, h, w in SHAPES:
        for radius in (1, 5, 16):
            tile_h = ssim_grad.default_tile(radius)[0]
            assert ssim_grad.stream_segment(bsz, h, w, radius, 528) == \
                ssim_cuda.stream_segment(bsz, h, w, tile_h, 4 * radius, 528, 1 / 20)
    # 16K at 8 blocks per SM: a segment of 480 rows leaves 48 blocks (under a
    # twentieth) past two full waves, measured 18% slower than 512 rows.
    assert ssim_cuda.stream_segment(1, 8640, 15360, 32, 10, H100_RESIDENT) == 512
    assert ssim_cuda.stream_segment(1, 8640, 15360, 32, 10, H100_RESIDENT, 1 / 20) == 480


#: Precise streaming blocks an H100 holds at once: 4 per SM (128 registers,
#: ssim_fwd_stream_occupancy in modes 4 and 5) on each of its 132 SMs.
H100_PRECISE_RESIDENT = 132 * 4


@pytest.mark.parametrize("shape,want", [((4, 1080, 1920), 64), ((4, 2160, 3840), 128),
                                        ((1, 8640, 15360), 512), ((1, 1024, 20480), 352)])
def test_stream_segment_at_the_precise_occupancy(shape, want):
    """The segment the precise modes' launches get at the H100's precise
    occupancy, half the f32 modes': at the main-path shapes the fastest,
    or within 1% of the fastest, of the --segments sweeps of the shipped
    kernel on an H100 (PERF.md), at 1x1024x20480 within 5.4%; the
    same model as the f32 modes (no correction needed), which fills at
    least 90% of the slots of the waves it takes."""
    bsz, h, w = shape
    res = H100_PRECISE_RESIDENT
    seg = ssim_cuda.stream_segment(bsz, h, w, ssim_cuda.TILE_H, 2 * ssim_cuda.STREAM_RADIUS,
                                   res)
    assert seg == want
    blocks = _blocks(bsz, h, w, seg)
    assert blocks / (-(-blocks // res) * res) >= 0.9


#: The runtime-radius stream's blocks per SM on an H100 at radius 1-16 (5:
#: the register-window kernel's), read with ssim_fwd_stream_occupancy:
#: kScore, kMap, the row and the components modes (u8 and f32), kPooled
#: (its raw ring adds 4 KB), the precise modes. Registers cap them at 8
#: (64 a thread) and 4 (128); the ring's 2r + 1 slots lower them from radius
#: 6 (precise from 6 too). tests/test_torch_port_cuda.py
#: (test_runtime_radius_occupancy_is_the_rings_shared_memory) holds the
#: card's occupancy query against the shared-memory model that gives them.
H100_RT_BLOCKS = {
    "score": [8, 8, 8, 8, 8, 7, 6, 5, 5, 4, 4, 4, 3, 3, 3, 3],
    "pooled": [8, 8, 8, 8, 8, 6, 5, 5, 4, 4, 4, 3, 3, 3, 3, 2],
    "precise": [4, 4, 4, 4, 4, 3, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1],
}


@pytest.mark.parametrize("radius", [1, 3, 8, 16])
@pytest.mark.parametrize("shape", [(4, 2160, 3840), (4, 1080, 1920), (1, 8640, 15360),
                                   (2, 540, 1000)])
def test_stream_segment_at_the_runtime_radius_occupancy(shape, radius):
    """At a runtime radius the wrapper's segment comes from the same model
    with the prologue 2r and the instantiation's occupancy at that radius:
    1 to MAX_SEG_TILES whole tiles, less than a tile past the image, the
    one-tile segment where it gives no more blocks than the card holds;
    a pick that takes more than one wave fills at least 75% of the slots
    of the waves it takes (f32 and precise)."""
    bsz, h, w = shape
    tile_h = ssim_cuda.TILE_H
    for mode in ("score", "precise"):
        res = 132 * H100_RT_BLOCKS[mode][radius - 1]
        seg = ssim_cuda.stream_segment(bsz, h, w, tile_h, 2 * radius, res)
        assert seg % tile_h == 0 and tile_h <= seg <= ssim_cuda.MAX_SEG_TILES * tile_h
        assert seg < h + tile_h
        if _blocks(bsz, h, w, tile_h) <= res:
            assert seg == tile_h, (mode, seg)
            continue
        blocks = _blocks(bsz, h, w, seg)
        if blocks > res:
            assert blocks / (-(-blocks // res) * res) >= 0.75, (mode, radius, seg)


#: Relaxed streaming blocks an H100 holds at once: 7 per SM (72 registers,
#: 29.1 KB of shared memory, ssim_fwd_stream_occupancy(relaxed=1)) on each
#: of its 132 SMs.
H100_RELAXED_RESIDENT = 132 * 7


@pytest.mark.parametrize("shape,want,best", [((4, 1080, 1920), 96, 128),
                                             ((4, 2160, 3840), 320, 96),
                                             ((1, 8640, 15360), 384, 416),
                                             ((1, 1024, 20480), 96, 96)])
def test_stream_segment_at_the_relaxed_occupancy(shape, want, best):
    """The segment the relaxed kScore / kMap launches get at the H100's
    relaxed occupancy: the model shared with the standard and precise modes
    (not tuned for this instantiation), whose pick filled at least 75% of
    the slots of the waves it takes; against a --segments sweep of the
    relaxed kernel on an H100 (PERF.md), the pick was the fastest at
    1x1024x20480 and within 0.2% at 16K, and 8.8% and 5.9% slower than the
    fastest (`best`) at 1080p x4 and 4K x4."""
    bsz, h, w = shape
    res = H100_RELAXED_RESIDENT
    seg = ssim_cuda.stream_segment(bsz, h, w, ssim_cuda.TILE_H, 2 * ssim_cuda.STREAM_RADIUS,
                                   res)
    assert seg == want and best % ssim_cuda.TILE_H == 0
    blocks = _blocks(bsz, h, w, seg)
    assert blocks / (-(-blocks // res) * res) >= 0.75


#: Relaxed batch stream blocks an H100 holds at once: 6 per SM (34.7 KB of
#: shared memory, ssim_fwd_batch_occupancy(relaxed=1)) on each of its 132
#: SMs.
H100_RELAXED_BATCH_RESIDENT = 132 * 6


#: Components and pooled streaming blocks an H100 holds at once: 8 per SM
#: (ssim_fwd_stream_occupancy in modes 2 and 3, as the f32 modes) on each of
#: its 132 SMs.
H100_COMP_RESIDENT = 132 * 8
#: The scales of msssim_1080_b4 (bench.py:59): 1080x1920 halved four times,
#: each the shape of one components or pooled launch.
MSSSIM_SCALES = [(4, 1080, 1920), (4, 540, 960), (4, 270, 480), (4, 135, 240),
                 (4, 67, 120)]


@pytest.mark.parametrize("shape", MSSSIM_SCALES)
def test_stream_segment_at_the_msssim_scales(shape):
    """Each scale of msssim_1080_b4 gets a segment that the streaming
    kernel's components and pooled modes take, at their occupancy on an
    H100: 1 to MAX_SEG_TILES whole tiles of the components wrappers' tile
    height (even, so a pooled block owns whole 2x2 blocks of its rows),
    less than a tile past the scale; where the one-tile segment gives no
    more blocks than the card holds (scales 1-4), it is taken. Of these
    launches only scales 0 and 1 stream (STREAM_COMP_MIN_PIX), relaxed
    only scale 0 (STREAM_RELAXED_COMP_MIN_PIX); a pinned segment streams
    at any of them."""
    bsz, h, w = shape
    kw = ssim_cuda._components_args(torch.zeros(1, 2, 2), torch.zeros(1, 2, 2), 1.0,
                                    ssim_cuda.STREAM_RADIUS, 1.5, 0.01, 0.03)
    tile_h = kw["tile_h"]
    assert tile_h % 2 == 0
    seg = ssim_cuda.stream_segment(bsz, h, w, tile_h, 2 * ssim_cuda.STREAM_RADIUS,
                                   H100_COMP_RESIDENT)
    assert seg % tile_h == 0 and tile_h <= seg <= ssim_cuda.MAX_SEG_TILES * tile_h
    assert seg < h + tile_h
    if _blocks(bsz, h, w, tile_h) <= H100_COMP_RESIDENT:
        assert seg == tile_h, (shape, seg)
    assert (_blocks(bsz, h, w, tile_h) <= H100_COMP_RESIDENT) == (h <= 540)
    # The size condition: scales 0 and 1 stream, 2-4 keep the tile body;
    # relaxed (scales 0 and 1, at least MXU_MIN_W wide), scale 0 streams.
    for mode in ("components", "pooled"):
        assert ssim_cuda.stream_applies(mode, ssim_cuda.STREAM_RADIUS, kw["tile_w"],
                                        npix=bsz * h * w) == (h >= 540)
        assert ssim_cuda.stream_applies(mode, ssim_cuda.STREAM_RADIUS, kw["tile_w"],
                                        relaxed=True, npix=bsz * h * w) == (h >= 1080)


@pytest.mark.parametrize("tile", [(32, 32), (32, 64), (64, 128), (7, 64), (1, 32),
                                  (256, 128)])
def test_stream_blocks_cover_each_pixel_once_with_whole_tiles(tile):
    """The streaming kernel's blocks (a strip of STRIP_W columns down a
    segment of rows, every segment the kernel takes up to MAX_SEG_TILES
    tiles) cover each output pixel of an image exactly once, and every
    TH x TW tile lies in one block, so a block alone writes each tile's
    partial, row pieces and NaN poison."""
    tile_h, tile_w = tile
    assert ssim_cuda.STRIP_W % tile_w == 0
    shapes = [(1, 1), (7, 5), (255, 63), (1, 64), (65, 131), (300, 517), (129, 300),
              (1080, 300), (40, 1000)]
    for h, w in shapes:
        for k in (1, 2, 3, ssim_cuda.MAX_SEG_TILES):
            seg = k * tile_h
            blocks = ssim_cuda.stream_blocks(h, w, seg)
            assert len(blocks) == -(-h // seg) * -(-w // ssim_cuda.STRIP_W)
            owner = np.full((h, w), -1, np.int32)
            cover = np.zeros((h, w), np.int32)
            for i, (y0, y1, x0, x1) in enumerate(blocks):
                assert y1 - y0 <= seg and x1 - x0 <= ssim_cuda.STRIP_W
                owner[y0:y1, x0:x1] = i
                cover[y0:y1, x0:x1] += 1
            assert (cover == 1).all(), (h, w, seg)
            for ty in range(0, h, tile_h):
                for tx in range(0, w, tile_w):
                    blk = owner[ty:ty + tile_h, tx:tx + tile_w]
                    assert (blk == blk[0, 0]).all(), (h, w, seg, ty, tx)


#: Image widths that the routing tests read the batch rule at: at least
#: one in each class of ssim_cuda.BATCH_RULE_WIDTHS and one above them.
_RULE_WIDTHS = (8, 32, 48, 100, 160, 300)


@pytest.mark.parametrize("mode", ssim_cuda._MODES)
def test_stream_applies_to_the_documented_launches(mode):
    """The streaming kernel takes exactly the score, map and row modes, the
    precise modes (kPrecise, kPreciseMap) and the MS-SSIM components and
    pooled modes, and relaxed the score, map, components and pooled modes,
    at every radius 1 to MAX_FUSED_RADIUS (radius 5 in its register-window
    instantiations, the others in the runtime-radius ones) with tiles 32
    to 128 wide; both batch modes (kBatch, kBatchPrecise) and the relaxed
    kBatch run its packed variant at every radius 1 to MAX_FUSED_RADIUS
    (ssim_fwd_batch_rt.cu's runtime radius but at 5), whatever the batch
    tile; tile width 256 keeps the tile body, as does a radius the kernel
    does not serve.
    Given the launch's pixels, the components and pooled modes stream only
    from STREAM_COMP_MIN_PIX, relaxed from STREAM_RELAXED_COMP_MIN_PIX; the
    other modes take no size condition; a relaxed launch so given keeps
    the tile body at the radii STREAM_RELAXED_TILE_RADII names for its mode
    and input dtype, and a batch launch at the radii
    STREAM_BATCH_TILE_RADII names for its mode, tier, input dtype and
    width class (a batch launch given its size and no width raises)."""
    main = mode in ("score", "map", "rowsum", "rowsum_map", "precise", "precise_map",
                    "components", "pooled")
    batch = mode in ("batch", "batch_precise")
    assert ssim_cuda.STREAM_MODES == ("score", "map", "rowsum", "rowsum_map",
                                      "precise", "precise_map", "components", "pooled")
    assert ssim_cuda.STREAM_RELAXED_MODES == ("score", "map", "components", "pooled", "batch")
    assert ssim_cuda.STREAM_BATCH_MODES == ("batch", "batch_precise")
    for radius in (0, 1, 2, 3, 4, 5, 6, 8, 11, 16, 17):
        for tile_w in (8, 16, 32, 64, 128, 256):
            for relaxed in (False, True):
                served = mode in ("score", "map", "components", "pooled") if relaxed else main
                radii = range(1, ssim_cuda.MAX_FUSED_RADIUS + 1)
                want = served and radius in radii and 32 <= tile_w <= 128
                if batch:
                    # kBatchPrecise has no relaxed form (the wrapper refuses it).
                    want = radius in radii and not (relaxed and mode == "batch_precise")
                assert ssim_cuda.stream_applies(mode, radius, tile_w, relaxed) == want
                big = (ssim_cuda.STREAM_RELAXED_COMP_MIN_PIX if relaxed
                       else ssim_cuda.STREAM_COMP_MIN_PIX)
                for is_float, width in itertools.product((False, True), _RULE_WIDTHS):
                    kept = relaxed and radius in ssim_cuda.STREAM_RELAXED_TILE_RADII.get(
                        (mode, is_float), ())
                    kept |= radius in ssim_cuda.STREAM_BATCH_TILE_RADII.get(
                        (mode, relaxed, is_float, ssim_cuda.batch_width_class(width)), ())
                    assert ssim_cuda.stream_applies(mode, radius, tile_w, relaxed, big,
                                                    is_float, width) == (want and not kept)
                    sized = want and not kept and mode not in ("components", "pooled")
                    assert ssim_cuda.stream_applies(mode, radius, tile_w, relaxed,
                                                    big - 1, is_float, width) == sized
                if batch:
                    with pytest.raises(ValueError, match="width"):
                        ssim_cuda.stream_applies(mode, radius, tile_w, relaxed, big)
    assert ssim_cuda.STREAM_COMP_MIN_PIX == 1 << 20
    assert ssim_cuda.STREAM_RELAXED_COMP_MIN_PIX == 1 << 22


def test_relaxed_tile_radii_are_the_measured_rule():
    """The radii at which a routed relaxed launch keeps the relaxed tile
    body (STREAM_RELAXED_TILE_RADII), as the H100 sweep measured them
    (ssim_cuda's comment, PERF.md): kScore and kMap at 16, kComponents at
    2 and 16, kPooled on u8 at every radius but 5, 8 and 9, kPooled on f32
    at 2, 15 and 16, for each input dtype; never radius 5 (its own
    register-window stream), never a batch mode, and the size-free rule (a
    pinned segment) streams at every one of them."""
    table = ssim_cuda.STREAM_RELAXED_TILE_RADII
    every = set(range(1, 17))
    want = {"score": ({16}, {16}), "map": ({16}, {16}),
            "components": ({2, 16}, {2, 16}),
            "pooled": (every - {5, 8, 9}, {2, 15, 16})}
    assert set(table) == {(m, f) for m in want for f in (False, True)}
    for (mode, is_float), radii in table.items():
        assert set(radii) == want[mode][is_float]
        assert ssim_cuda.STREAM_RADIUS not in radii
        for radius in radii:
            assert ssim_cuda.stream_applies(mode, radius, ssim_cuda.TILE_W, True)
            assert not ssim_cuda.stream_applies(mode, radius, ssim_cuda.TILE_W, True,
                                                1 << 30, is_float)
            assert ssim_cuda.stream_applies(mode, radius, ssim_cuda.TILE_W, False,
                                            1 << 30, is_float)
    assert ssim_cuda.stream_applies("pooled", 9, ssim_cuda.TILE_W, True, 1 << 30)
    assert ssim_cuda.stream_applies("components", 9, ssim_cuda.TILE_W, True, 1 << 30, True)


def test_batch_tile_radii_are_the_measured_rule():
    """The radii at which a routed batch launch keeps the tile body
    (STREAM_BATCH_TILE_RADII), as the H100 sweep at 14 widths from 8 to 192
    measured them (ssim_cuda's comment, PERF.md), by mode, tier, input
    dtype and width class (batch_width_class: the tile body's tile width,
    16, 32, 64, 128, then 192 and above): kBatch at 32 on r = 16 alone;
    kBatchPrecise at most radii from 2 at 32, at 7, 8 and 11-16 at 16, on
    u8 at 13-16 at 64 and at 12 at 128; the relaxed kBatch at most radii on
    u8 from 32 up, fewer on f32; never radius 5 (its own register-window
    stream). The size-free rule (a pinned pack) streams at each of them,
    and each entry is read at every width of its class and no other."""
    table = ssim_cuda.STREAM_BATCH_TILE_RADII
    every = set(range(1, 17))
    assert ssim_cuda.BATCH_RULE_WIDTHS == (16, 32, 64, 128, 192)
    assert [ssim_cuda.batch_width_class(w) for w in (1, 16, 17, 32, 33, 64, 65, 128, 129,
                                                     192, 193, 4096)] == \
        [16, 16, 32, 32, 64, 64, 128, 128, 192, 192, 192, 192]
    want = {("batch", False, False, 32): {16}, ("batch", False, True, 32): {16},
            ("batch_precise", False, False, 16): {7, 8, 11, 12, 13, 14, 15, 16},
            ("batch_precise", False, True, 16): {7, 8, 11, 12, 13, 14, 15, 16},
            ("batch_precise", False, False, 32): every - {1, 5},
            ("batch_precise", False, True, 32): every - {1, 5, 11},
            ("batch_precise", False, False, 64): {13, 14, 15, 16},
            ("batch_precise", False, False, 128): {12},
            ("batch", True, False, 32): every - {1, 2, 3, 4, 5, 9},
            ("batch", True, True, 32): {14, 15},
            ("batch", True, False, 64): every - {5, 8, 9},
            ("batch", True, True, 64): {2, 4, 6, 7, 14, 15},
            ("batch", True, False, 128): every - {5},
            ("batch", True, True, 128): every - {5, 8, 9, 13},
            ("batch", True, False, 192): {2, 3, 4, 6, 7, 14, 15, 16},
            ("batch", True, True, 192): {6, 7, 14, 15, 16}}
    assert {k: set(v) for k, v in table.items()} == want
    for (mode, relaxed, is_float, cls), radii in table.items():
        assert ssim_cuda.STREAM_RADIUS not in radii
        lo = max((e for e in ssim_cuda.BATCH_RULE_WIDTHS if e < cls), default=0)
        for radius in radii:
            assert ssim_cuda.stream_applies(mode, radius, ssim_cuda.TILE_W, relaxed)
            for w in (lo + 1, cls):
                assert not ssim_cuda.stream_applies(mode, radius, ssim_cuda.TILE_W, relaxed,
                                                    1 << 30, is_float, w)
            for w in (lo, cls + 1):
                if w and ssim_cuda.batch_width_class(w) != cls:
                    assert ssim_cuda.stream_applies(
                        mode, radius, ssim_cuda.TILE_W, relaxed, 1 << 30, is_float, w) == (
                        radius not in table.get(
                            (mode, relaxed, is_float, ssim_cuda.batch_width_class(w)), ()))
    for radius in every - {16}:
        for is_float, w in itertools.product((False, True), _RULE_WIDTHS):
            assert ssim_cuda.stream_applies("batch", radius, ssim_cuda.TILE_W, False, 1 << 30,
                                            is_float, w)
    assert ssim_cuda.stream_applies("batch_precise", 12, ssim_cuda.TILE_W, False, 1 << 30,
                                    False, 192)
    assert ssim_cuda.stream_applies("batch", 8, ssim_cuda.TILE_W, True, 1 << 30, False, 40)


def test_main_path_defaults_take_the_streaming_kernel():
    """The defaults every main-path call uses (windows.RADIUS, TILE_W, the
    standard, precise and relaxed tiers; the components wrappers' fixed
    TILE_H x TILE_W) take the streaming kernel, in all eight of its modes
    and the four relaxed ones (score, map, components, pooled); both batch
    modes and the relaxed batch mode take its packed variant whatever
    their tile-body tile (8 to 64 wide)."""
    from ssim_tpu_torch.windows import RADIUS

    assert RADIUS == ssim_cuda.STREAM_RADIUS
    for mode in ssim_cuda.STREAM_MODES:
        assert ssim_cuda.stream_applies(mode, RADIUS, ssim_cuda.TILE_W)
    for mode in ssim_cuda.STREAM_RELAXED_MODES:
        assert ssim_cuda.stream_applies(mode, RADIUS, ssim_cuda.TILE_W, relaxed=True)
    kw = ssim_cuda._components_args(torch.zeros(1, 8, 8, dtype=torch.uint8),
                                    torch.zeros(1, 8, 8, dtype=torch.uint8),
                                    255.0, RADIUS, 1.5, 0.01, 0.03)
    for mode in ("components", "pooled"):
        assert ssim_cuda.stream_applies(mode, RADIUS, kw["tile_w"])
        assert ssim_cuda.stream_applies(mode, RADIUS, kw["tile_w"], relaxed=True)
    assert kw["tile_h"] % 2 == 0  # the pooled blocks own whole 2x2 blocks
    assert ssim_cuda.fit_tile(None, None, RADIUS, precise=True) == (
        ssim_cuda.TILE_H, ssim_cuda.TILE_W)
    for bsz, h, w in [(4096, 64, 64), (8192, 32, 32), (512, 192, 192)]:
        _, tile_w, _, _ = ssim_cuda.batch_geometry(bsz, h, w)
        assert ssim_cuda.stream_applies("batch", RADIUS, tile_w)
        assert ssim_cuda.stream_applies("batch_precise", RADIUS, tile_w)
        assert ssim_cuda.stream_applies("batch", RADIUS, tile_w, relaxed=True)


#: The batch stream's shapes: phase 8's routed batches and its odd ones.
#: W: 1, 5 and 8 (12 to a strip), 12 (12 pieces a strip), 31 and 33, 32,
#: 47, 64, 65, 128, 130, 192, 200 and 2048 (several strips an image).
BATCH_SHAPES = [(8192, 32, 32), (4096, 64, 64), (1024, 128, 128), (512, 192, 192),
                (256, 64, 64), (4, 64, 64), (3, 33, 47), (2, 30, 200), (5, 11, 11),
                (3, 50, 1), (5, 16, 2048), (2, 8192, 64), (2, 1, 1), (2, 7, 5),
                (64, 32, 40), (3, 300, 64), (37, 9, 8), (40, 5, 12), (7, 20, 31),
                (9, 17, 65), (6, 40, 130)]


#: The runtime-radius batch stream's radii that the pack, plan and block
#: tests hold.
_BATCH_RADII = (1, 3, 8, 16)


@pytest.mark.parametrize("shape", BATCH_SHAPES)
def test_batch_pack_and_plan(shape):
    """batch_pack: a multiple of 8 from 16 up packs to whole strips (k W a
    multiple of 128, k <= 16: 4 at W = 32, 2 at 64 and 192, 1 at 128);
    other widths 128 // W (at most BATCH_MAX_PIECES), or 1 above 128, so
    that such an image never straddles two strips; never more than the
    batch; so a strip meets at most BATCH_MAX_PIECES images and k H W <
    2^31. batch_stream_plan at the H100's f32 and precise occupancies: a
    block a strip of one packed row, down all its rows or, only where the
    packed rows alone leave the card idle, a segment (a multiple of
    TILE_H), as for (2, 8192, 64); at the routed shapes (PERF.md's sweeps)
    all the rows, at 192x192 x512 segments of 96 rows. At radius 5 and at
    radii 1, 3, 8 and 16 (the runtime-radius stream) the same pack, and
    segments of the same kind, each block's rows counted with its 2r
    prologue; radius 5 is the default."""
    bsz, h, w = shape
    k = ssim_cuda.batch_pack(bsz, w)
    assert 1 <= k <= bsz
    assert k * h * w < 1 << 31
    if w % 8 == 0 and w >= 12 and k < bsz:
        assert (k * w) % ssim_cuda.STRIP_W == 0 and k <= 16
    if w < 12 or w % 8:
        assert k <= ssim_cuda.BATCH_MAX_PIECES
        assert k * w <= ssim_cuda.STRIP_W or k == 1
        if k < bsz and w <= ssim_cuda.STRIP_W:
            assert k == min(ssim_cuda.BATCH_MAX_PIECES, ssim_cuda.STRIP_W // w)
    want = {32: 4, 64: 2, 128: 1, 192: 2}
    if w in want and bsz >= want[w]:
        assert k == want[w]
    for resident in (H100_RESIDENT, H100_PRECISE_RESIDENT, 132 * 2, 132):
        for radius in (*_BATCH_RADII, ssim_cuda.STREAM_RADIUS):
            k2, seg = ssim_cuda.batch_stream_plan(bsz, h, w, resident, radius)
            groups = -(-bsz // k)
            nstrip = -(-(k * w) // ssim_cuda.STRIP_W)
            assert k2 == k and 1 <= seg <= h
            if seg < h:
                assert seg % ssim_cuda.TILE_H == 0
                assert groups * nstrip < resident
        assert ssim_cuda.batch_stream_plan(bsz, h, w, resident) == \
            ssim_cuda.batch_stream_plan(bsz, h, w, resident, ssim_cuda.STREAM_RADIUS)
    assert ssim_cuda.batch_stream_plan(2, 8192, 64, H100_RESIDENT) == (2, 32)
    for sh, want in [((8192, 32, 32), (4, 32)), ((4096, 64, 64), (2, 64)),
                     ((1024, 128, 128), (1, 128)), ((512, 192, 192), (2, 96))]:
        assert ssim_cuda.batch_stream_plan(*sh, H100_RESIDENT) == want
    assert ssim_cuda.batch_stream_plan(4096, 64, 64, H100_PRECISE_RESIDENT) == (2, 64)
    assert ssim_cuda.batch_stream_plan(100000, 8, 8, H100_RESIDENT) == (12, 8)


@pytest.mark.parametrize("shape", BATCH_SHAPES)
def test_batch_stream_blocks_cover_each_pixel_once(shape):
    """The batch stream's blocks (a strip of a packed row down all its rows
    or a segment of them) cover each pixel of each image exactly once, at
    every segment the kernel takes here, and at pinned packs wider than
    batch_pack's; a strip meets at most BATCH_MAX_PIECES images; each
    (image, segment, slot) is written once and the second pass reads
    exactly the slots the image's strips fill; and where batch_direct
    holds, each image lies whole in one block's piece, which writes its
    pair. At radii 1, 3, 8 and 16 each block's staged columns (its pieces'
    columns plus r on either side of each) fit the runtime-radius
    instantiation's staged rows (batch_rt_layout: 128 + 2r min(k, 127 // W
    + 2) columns) and its four loads a thread."""
    bsz, h, w = shape
    nps = -(-w // ssim_cuda.STRIP_W) + 1
    segs = sorted({h, max(1, h // 2), ssim_cuda.TILE_H if h > ssim_cuda.TILE_H else h})
    packs = sorted({ssim_cuda.batch_pack(bsz, w), min(bsz, 3)})
    for k in packs:
        for seg in segs:
            if bsz * h * w > (1 << 22) and (seg != h or k != packs[0]):
                continue  # the large shapes: one geometry, to keep the test short
            blocks = ssim_cuda.batch_stream_blocks(bsz, h, w, k, seg)
            cover = np.zeros((bsz, h, w), np.int32)
            slots = {}
            for pieces in blocks:
                assert len(pieces) <= ssim_cuda.BATCH_MAX_PIECES
                for radius in _BATCH_RADII:
                    staged = sum(x1 - x0 + 2 * radius for _, _, _, x0, x1, _ in pieces)
                    cols = ssim_cuda.STRIP_W + 2 * radius * min(k, 127 // w + 2)
                    assert staged <= cols <= 4 * ssim_cuda.STRIP_W, (radius, k, pieces)
                for img, y0, y1, x0, x1, slot in pieces:
                    cover[img, y0:y1, x0:x1] += 1
                    key = (img, y0 // seg, slot)
                    assert key not in slots and 0 <= slot < nps
                    slots[key] = (x0, x1)
                    if ssim_cuda.batch_direct(h, w, k, seg):
                        assert (y0, y1, x0, x1) == (0, h, 0, w)
            assert (cover == 1).all(), (shape, k, seg)
            for img in range(bsz):
                i = img % k
                ns = ((i + 1) * w - 1) // ssim_cuda.STRIP_W - i * w // ssim_cuda.STRIP_W + 1
                for sg in range(-(-h // seg)):
                    assert {s for (m, g, s) in slots if m == img and g == sg} == set(range(ns))
            nstrip = -(-(k * w) // ssim_cuda.STRIP_W)
            assert len(blocks) == nstrip * -(-h // seg) * -(-bsz // k)


EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fwd_stream_emu")
_EMU_MODES = {"score": 0, "map": 1, "rowsum": 8, "rowsum_map": 9}
_EMU_PRECISE_MODES = {"precise": 4, "precise_map": 5}
_EMU_COMP_MODES = {"components": 2, "pooled": 3}


@pytest.fixture(scope="module")
def stream_emulator(tmp_path_factory):
    """The streaming kernels' source (csrc/ssim_fwd.cu without the tile
    body and the launchers, csrc/fwd_batch_kernel.cuh and
    csrc/fwd_stream_kernel.cuh with their dynamic shared memory pointed at
    the harness's buffer) built with g++ into a host program; its path."""
    return _build_emulator(tmp_path_factory.mktemp("fwd_stream_emu"))


#: The runtime-radius instantiation's dynamic shared memory, as the
#: kernel declares it, and the harness's stand-in.
_DYN_DECL = "extern __shared__ __align__(16) unsigned char fwd_stream_smem[];"
_DYN_HOST = "unsigned char* fwd_stream_smem = emu_dynamic_shared();"
#: A static __shared__ declaration: type, name, array bounds.
_SHARED = re.compile(r"__shared__\s+(?:__align__\(\d+\)\s+)?([^;\[]+?)\s+(\w+)\s*"
                     r"((?:\[[^\]]*\])*)\s*;")


def _host_shared(text):
    """The source with each static __shared__ array taken from the
    harness's shared-memory arena (emu_threads.h emu_shared), which is NaN
    at each block's start as CUDA's is uninitialised, and its dynamic one
    from the arena's dynamic part."""
    assert text.count("extern __shared__") == text.count(_DYN_DECL)
    text = text.replace(_DYN_DECL, _DYN_HOST)
    return _SHARED.sub(lambda m: (f"using {m[2]}__emu_t = {m[1]}{m[3]}; {m[2]}__emu_t& {m[2]} = "
                                  f"*static_cast<{m[2]}__emu_t*>(emu_shared("
                                  f"sizeof({m[2]}__emu_t)));"), text)


def _build_emulator(out, edit=None):
    """Build the harness into directory `out`; edit(name, text) may change
    the text of each source copied there ("ssim_fwd_stream.cu",
    "fwd_batch_kernel.cuh", "fwd_stream_kernel.cuh") first."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    edit = edit or (lambda name, text: text)
    src = open(os.path.join(_build.CSRC_DIR, "ssim_fwd.cu")).read()
    a = src.index("template <typename T, int kMode, int kSplit>\n__global__")
    b = src.index("// ---------------------------------------------------------------------------\n"
                  "// The main-path modes: row-streaming column strips.")
    c = src.index("template <typename T, int kMode, int kSplit>\ncudaError_t launch_stream(")
    (out / "ssim_fwd_stream.cu").write_text(_host_shared(edit(
        "ssim_fwd_stream.cu", src[:a] + "}  // namespace\n" + src[b:c] + "}  // namespace\n")))
    for name in ("fwd_batch_kernel.cuh", "fwd_stream_kernel.cuh"):
        src = open(os.path.join(_build.CSRC_DIR, name)).read()
        assert src.count(_DYN_DECL) == 1
        (out / name).write_text(_host_shared(edit(name, src)))
    exe = out / "harness"
    # band_mma.cuh: the emulator's (a host model of mma), which includes
    # the kernels' own from csrc, next on the path.
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
                    "-pthread", "-I", str(out), "-I", EMU_DIR, "-I", _build.CSRC_DIR,
                    "-o", str(exe), os.path.join(EMU_DIR, "harness.cpp")],
                   check=True, capture_output=True, timeout=600)
    return exe


def _emulate(exe, mode, a, b, tile, seg, vhalo=None, vmask=(0, 0), relaxed=False,
             c2=None, radius=5, sigma=1.5):
    """The host build of the kernel in `mode` on NumPy (B, H, W) inputs at
    radius (the runtime-radius instantiation where it is not 5) and sigma:
    (partials (B, nty*ntx), f64 in the precise modes, (B, nty*ntx, 2) in
    the components modes, or row sums (B, H), then the map or, in the
    pooled mode, the pooled images (pool_a, pool_b), else None). The
    precise modes get the f64 taps and c1, c2 unrounded, as the wrapper
    passes them; relaxed (score, map, components, pooled) runs the relaxed
    instantiation; c2 replaces the data range's."""
    bsz, h, w = a.shape
    f32 = a.dtype == np.float32
    precise = mode in _EMU_PRECISE_MODES
    dr = 1.0 if f32 else 255.0
    head = np.array([{**_EMU_MODES, **_EMU_PRECISE_MODES, **_EMU_COMP_MODES}[mode],
                     int(f32), bsz, h, w, tile[0], tile[1], seg, vhalo is not None,
                     *vmask, int(precise), int(relaxed), radius], np.int32)
    ftype = np.float64 if precise else np.float32
    c2 = (0.03 * dr) ** 2 if c2 is None else c2
    consts = np.array([(0.01 * dr) ** 2, c2, max(131072.0, 4.0 * dr)], ftype)
    parts = [head, gaussian_taps(ftype, radius, sigma), consts, a, b, *(vhalo or ())]
    path_in, path_out = f"{exe}.{os.getpid()}.in", f"{exe}.{os.getpid()}.out"
    with open(path_in, "wb") as f:
        for x in parts:
            f.write(np.ascontiguousarray(x).tobytes())
    subprocess.run([str(exe), path_in, path_out], check=True, timeout=600)
    raw = np.fromfile(path_out, np.uint8)
    n = bsz * h if mode.startswith("rowsum") else bsz * (-(-h // tile[0])) * (-(-w // tile[1]))
    comp = mode in _EMU_COMP_MODES
    size = np.dtype(np.float64 if precise else np.float32).itemsize * n * (2 if comp else 1)
    first = raw[:size].view(np.float64 if precise else np.float32)
    first = torch.from_numpy(first.reshape((bsz, -1, 2) if comp else (bsz, -1)).copy())
    rest = raw[size:].view(np.float32)
    if mode.endswith("map"):
        return first, torch.from_numpy(rest.reshape(a.shape).copy())
    if mode == "pooled":
        pooled = torch.from_numpy(rest.reshape(2, bsz, h // 2, w // 2).copy())
        return first, (pooled[0], pooled[1])
    return first, None


def _emu_pair(rng, shape, f32):
    if f32:
        a = rng.random(shape).astype(np.float32)
        return a, np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.normal(0, 12, shape).astype(np.int32)
    return a, np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)


_EMU_CASES = {
    # name: (f32, shape, tile, segment)
    "u8 ragged": (False, (2, 65, 131), (32, 64), 64),
    "u8 2S+1, 32x32 tiles": (False, (2, 129, 300), (32, 32), 64),
    "f32 64x128 tiles": (True, (2, 129, 300), (64, 128), 128),
    "u8 W <= 2r": (False, (2, 33, 9), (32, 64), 64),
    "u8 H = 1": (False, (3, 1, 130), (32, 64), 32),
    "f32 7x64 tiles": (True, (2, 30, 200), (7, 64), 14),
    "f32 non-finite on boundaries": (True, (3, 135, 400), (32, 64), 64),
}


@pytest.mark.parametrize("case", list(_EMU_CASES))
def test_stream_kernel_source_matches_twin_on_the_host(stream_emulator, case):
    """The streaming kernel's own source, built for the host, in its four
    modes against the twins: H one past a segment and 2S + 1, a ragged last
    strip, W <= 2r, H = 1, tiles 32x32 to 64x128 and 7x64; non-finite
    pixels on a tile edge, a strip's last and first column, a segment's
    first and last row, 2r rows above an interior segment and the image's
    last pixel. Maps bit for bit (NaN over exactly the twin's tiles), row
    sums within W * 1e-5, per-image scores within 2e-7."""
    f32, shape, tile, seg = _EMU_CASES[case]
    rng = np.random.default_rng(0x5EED + len(case))
    a, b = _emu_pair(rng, shape, f32)
    if case.startswith("f32 non-finite"):
        a[0, seg, 200] = np.nan
        a[0, seg - 10, 40] = np.nan
        a[1, seg - 1, 127] = np.inf
        b[1, 3, 128] = -np.inf
        a[2, tile[0] - 1, tile[1]] = np.nan
        b[2, -1, -1] = np.nan
    _hold_emulated(stream_emulator, a, b, tile, seg)


@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_stream_kernel_source_row_modes_with_halo_on_the_host(stream_emulator, flags):
    """The row modes with halo operands, each flag pair, a band of 137 rows
    of a 301-row image in segments of two tiles: in f32 a NaN in the band,
    one in the rows the top operand holds (operand rows poison nothing)
    and NaN-filled operands under a set flag (never read)."""
    f32 = flags[0] == flags[1]
    rng = np.random.default_rng(0x5EEF + 2 * flags[0] + flags[1])
    a, b = _emu_pair(rng, (2, 301, 517), f32)
    if f32:
        a[1, 120, 40] = np.nan
        a[0, 97, 30] = np.nan
    lo, hi = 100, 237

    def ring(x):
        top = x[:, -5:] if flags[0] else x[:, lo - 5:lo]
        bot = x[:, :5] if flags[1] else x[:, hi:hi + 5]
        return np.ascontiguousarray(top), np.ascontiguousarray(bot)

    (a_top, a_bot), (b_top, b_bot) = ring(a), ring(b)
    if f32 and flags[0]:
        a_top = np.full_like(a_top, np.nan)
    if f32 and flags[1]:
        b_bot = np.full_like(b_bot, np.nan)
    _hold_emulated(stream_emulator, np.ascontiguousarray(a[:, lo:hi]),
                   np.ascontiguousarray(b[:, lo:hi]), (32, 64), 64,
                   vhalo=(a_top, a_bot, b_top, b_bot), vmask=flags)


def _hold_emulated(exe, a, b, tile, seg, vhalo=None, vmask=(0, 0), radius=5, sigma=1.5):
    """Each of the kernel's modes (only the row modes with halo operands)
    against its twin on the same inputs, at radius and sigma."""
    dr = 1.0 if a.dtype == np.float32 else 255.0
    kw = dict(taps=gaussian_taps(np.float32, radius, sigma), c1=(0.01 * dr) ** 2,
              c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=tile[0], tile_w=tile[1])
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    halo = {} if vhalo is None else dict(
        vhalo=tuple(torch.from_numpy(x) for x in vhalo), vmask=vmask)
    npix = a.shape[1] * a.shape[2]
    for mode in ("rowsum", "rowsum_map") if vhalo else tuple(_EMU_MODES):
        got, got_map = _emulate(exe, mode, a, b, tile, seg, vhalo, vmask, radius=radius,
                                sigma=sigma)
        if mode.startswith("rowsum"):
            want, want_map = ssim_cuda.ssim_rows_plain(at, bt, with_map=True, **halo, **kw)
        else:
            want, want_map = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, **kw)
        if got_map is not None:
            assert torch.equal(got_map.isnan(), want_map.isnan()), mode
            fin = ~want_map.isnan()
            assert torch.equal(got_map[fin], want_map[fin]), mode
        assert torch.equal(got.isnan(), want.isnan()), mode
        ok = ~want.isnan()
        if mode.startswith("rowsum"):
            if ok.any():
                assert (got[ok] - want[ok]).abs().max().item() <= 1e-5 * a.shape[2], mode
        else:
            gk = got.double().sum(-1) / npix
            gp = want.double().sum(-1) / npix
            fin = ~gp.isnan()
            if fin.any():
                assert (gk[fin] - gp[fin]).abs().max().item() <= max(2e-7, 2e-5 / npix**0.5)


_EMU_PRECISE_CASES = ["u8 ragged", "u8 2S+1, 32x32 tiles", "f32 non-finite on boundaries",
                      "u8 W <= 2r", "u8 H = 1", "f32 64x128 tiles", "u8 1x1 flat"]


@pytest.mark.parametrize("case", _EMU_PRECISE_CASES)
def test_stream_kernel_source_precise_matches_twin_on_the_host(stream_emulator, case):
    """The streaming kernel's precise modes (kPrecise, kPreciseMap: fp64
    blurs with the f64 taps, the formula and the tile sums in fp64), built
    for the host, against ssim_parts_precise_plain on the geometries of
    _EMU_CASES: maps bit for bit (NaN over exactly the twin's tiles),
    per-image scores within 1e-12 relative. The 1x1 pair is a flat window,
    where f32 taps would leave ~8e-7 against the f64 oracle (P4): its map
    equals the twin's and lies within 5e-7 of the oracle."""
    from ssim_tpu_torch import reference

    if case == "u8 1x1 flat":
        f32, shape, tile, seg = False, (2, 1, 1), (32, 64), 32
    else:
        f32, shape, tile, seg = _EMU_CASES[case]
    rng = np.random.default_rng(0x5EF0 + len(case))
    a, b = _emu_pair(rng, shape, f32)
    if case.startswith("f32 non-finite"):
        a[0, seg, 200] = np.nan
        a[0, seg - 10, 40] = np.nan
        a[1, seg - 1, 127] = np.inf
        b[1, 3, 128] = -np.inf
        a[2, tile[0] - 1, tile[1]] = np.nan
        b[2, -1, -1] = np.nan
    dr = 1.0 if f32 else 255.0
    kw = dict(taps=gaussian_taps(np.float64, 5, 1.5), c1=(0.01 * dr) ** 2,
              c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=tile[0], tile_w=tile[1])
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    npix = a.shape[1] * a.shape[2]
    for mode in _EMU_PRECISE_MODES:
        got, got_map = _emulate(stream_emulator, mode, a, b, tile, seg)
        want, want_map = ssim_cuda.ssim_parts_precise_plain(
            at, bt, with_map=mode == "precise_map", **kw)
        assert got.dtype == want.dtype == torch.float64
        if mode == "precise_map":
            assert torch.equal(got_map.isnan(), want_map.isnan())
            fin = ~want_map.isnan()
            assert torch.equal(got_map[fin], want_map[fin])
        else:
            assert got_map is None
        assert torch.equal(got.isnan(), want.isnan())
        gk = got.sum(-1).numpy() / npix
        gp = want.sum(-1).numpy() / npix
        assert np.array_equal(np.isnan(gk), np.isnan(gp))
        assert np.nanmax(np.abs(gk - gp) / np.abs(gp), initial=0.0) <= 1e-12, mode
    if case.startswith("f32 non-finite"):
        assert got.isnan().any() and not got.isnan().all()  # only the planted tiles
    if case == "u8 1x1 flat":
        _, oracle_map = reference.compute_ssim(a.astype(np.float64), b.astype(np.float64),
                                               with_map=True, data_range=255.0)
        assert np.abs(got_map.numpy().astype(np.float64) - oracle_map).max() <= 5e-7


#: Relaxed cases: (f32, shape, tile, segment). Every width >= MXU_MIN_W, as
#: the wrappers launch the relaxed mode; the stream rows run in chunks of 8
#: (ssim_fwd.cu kStreamChunk), whose boundaries fall inside tiles and
#: segments here.
_EMU_RELAXED_CASES = {
    "u8 ragged strip, H one past a segment": (False, (1, 65, 600), (32, 64), 64),
    "f32 7x64 tiles, segments of 14": (True, (2, 30, 520), (7, 64), 14),
    "u8 H = 1": (False, (1, 1, 530), (32, 64), 32),
    "u8 32x128 tiles, 2S+1": (False, (1, 129, 640), (32, 128), 64),
    "u8 32x32 tiles, one segment": (False, (1, 40, 700), (32, 32), 64),
    "f32 non-finite on boundaries": (True, (2, 100, 520), (32, 64), 64),
}
#: The relaxed tier's tolerances against its twin (chip_smoke.py
#: RELAXED_TWIN_*) and against the f64 oracle (RELAXED_ORACLE_*, the JAX
#: tests' envelope).
_RELAXED_GLOBAL, _RELAXED_PIXEL = 2e-6, 2e-5
_RELAXED_ORACLE_GLOBAL, _RELAXED_ORACLE_PIXEL = 1e-4, 5e-3


@pytest.mark.parametrize("case", list(_EMU_RELAXED_CASES))
def test_stream_kernel_source_relaxed_matches_twin_on_the_host(stream_emulator, case):
    """The relaxed streaming instantiation (kScore, kMap: the heavy
    horizontal blurs as bf16x3 band products, mma.sync modelled on the
    host), built for the host, against ssim_parts_plain(relaxed=True):
    within 2e-6 global (never tighter than 2 * 2e-5 / sqrt(npix)) and 2e-5
    per pixel, NaN over exactly the twin's tiles and partials; a map that
    differs from the standard tier's; within 1e-4 global and 5e-3 per
    interior pixel of the f64 oracle. Geometries: a ragged last strip, H
    one past a segment and 2S + 1, H = 1, 7-row tiles in segments of 14,
    tiles 32 to 128 wide, u8 and f32, non-finite pixels on a tile edge, a
    strip's last and first column and a segment's first row."""
    from ssim_tpu_torch import reference

    f32, shape, tile, seg = _EMU_RELAXED_CASES[case]
    rng = np.random.default_rng(0x5EF8 + len(case))
    a, b = _emu_pair(rng, shape, f32)
    if case.startswith("f32 non-finite"):
        a[0, seg, 300] = np.nan
        a[1, seg - 1, 127] = np.inf
        b[1, 3, 128] = -np.inf
        a[0, tile[0] - 1, tile[1]] = np.nan
    dr = 1.0 if f32 else 255.0
    kw = dict(taps=gaussian_taps(np.float32, 5, 1.5), c1=(0.01 * dr) ** 2,
              c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=tile[0], tile_w=tile[1])
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    npix = shape[1] * shape[2]
    want, want_map = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, relaxed=True, **kw)
    _, std_map = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, **kw)
    for mode in ("score", "map"):
        got, got_map = _emulate(stream_emulator, mode, a, b, tile, seg, relaxed=True)
        assert (got_map is None) == (mode == "score")
        assert torch.equal(got.isnan(), want.isnan()), mode
        gk = got.double().sum(-1) / npix
        gp = want.double().sum(-1) / npix
        fin = ~gp.isnan()
        assert torch.equal(gk.isnan(), gp.isnan()), mode
        tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / npix**0.5)
        if fin.any():
            assert (gk[fin] - gp[fin]).abs().max().item() <= tol, mode
    assert torch.equal(got_map.isnan(), want_map.isnan())
    ok = ~want_map.isnan()
    assert (got_map[ok] - want_map[ok]).abs().max().item() <= _RELAXED_PIXEL
    assert (got_map[ok] - std_map[ok]).abs().max().item() > 0
    if case.startswith("f32 non-finite"):
        assert got.isnan().any() and not got.isnan().all()  # only the planted tiles
        return
    oracle, oracle_map = reference.compute_ssim(a.astype(np.float64), b.astype(np.float64),
                                                with_map=True, data_range=dr)
    assert np.abs(gk.numpy() - np.asarray(oracle)).max() <= _RELAXED_ORACLE_GLOBAL
    inner = (Ellipsis, slice(5, -5), slice(5, -5))
    if shape[1] > 10:
        err = np.abs(got_map.numpy()[inner].astype(np.float64) - oracle_map[inner]).max()
        assert err <= _RELAXED_ORACLE_PIXEL


def test_stream_kernel_source_relaxed_mu_planes_are_the_twins(stream_emulator):
    """The relaxed instantiation's mu_a and mu_b are the f32 symmetric
    pass's, bit for bit the twin's sym_blur, and only the heavy blurs go
    through the band products: with c2 = 1e20 the structure term's
    0.5 sigma + c2 rounds to c2 in the numerator and the denominator alike
    (every sigma here is under half an ulp of c2), so each map value is
    (2 mu_a mu_b + c1) c2 / ((mu_a^2 + mu_b^2 + c1) c2), mu alone. The
    relaxed map then equals the relaxed twin's and the standard twin's bit
    for bit, u8 and f32, on a ragged strip with 7-row tiles."""
    c2 = 1e20
    for f32 in (False, True):
        rng = np.random.default_rng(0x5EF9 + f32)
        a, b = _emu_pair(rng, (1, 45, 600), f32)
        dr = 1.0 if f32 else 255.0
        kw = dict(taps=gaussian_taps(np.float32, 5, 1.5), c1=(0.01 * dr) ** 2, c2=c2,
                  clip_bound=max(131072.0, 4.0 * dr), tile_h=7, tile_w=64)
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        _, got = _emulate(stream_emulator, "map", a, b, (7, 64), 28, relaxed=True, c2=c2)
        _, twin = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, relaxed=True, **kw)
        _, std = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, **kw)
        assert torch.isfinite(got).all()
        assert torch.equal(got, twin) and torch.equal(got, std), f32


#: Components and pooled cases: (f32, shape, tile, segment). Odd H and W
#: (the last pooled row and column dropped), a ragged last strip, H one
#: past a segment and 2S + 1, W <= 2r, H = 1 (components only: pooling
#: needs H, W >= 2), tiles 32x32, 32x64 and 64x128.
_EMU_COMP_CASES = {
    "u8 ragged strip, odd H and W, H one past a segment": (False, (2, 65, 131), (32, 64), 64),
    "f32 2S+1, 32x32 tiles": (True, (2, 129, 300), (32, 32), 64),
    "u8 64x128 tiles, odd W": (False, (2, 129, 301), (64, 128), 128),
    "u8 W <= 2r": (False, (2, 33, 9), (32, 64), 64),
    "u8 H = 1": (False, (3, 1, 130), (32, 64), 32),
    "f32 non-finite on boundaries": (True, (3, 135, 400), (32, 64), 64),
}


@pytest.mark.parametrize("case", list(_EMU_COMP_CASES))
def test_stream_kernel_source_components_match_twins_on_the_host(stream_emulator, case):
    """The streaming kernel's components and pooled modes (the stream's
    blurs with the _l_cs_from_blurs epilogue, two partials per tile; the
    pooled mode also the 2x2 means of the raw inputs of its own rows and
    columns), built for the host, against ssim_components_plain and
    ssim_components_pooled_plain: pooled images bit for bit (NaN at the
    same pixels), per-image mean cs and ssim within max(2e-7, 2e-5 /
    sqrt(npix)), NaN in both partials of exactly the twin's tiles, and the
    pooled mode's partials equal to the components mode's. In f32, NaN and
    inf on a tile edge, a strip's first and last column, a segment's first
    and last row, 2r rows above an interior segment and the image's last
    pixel (which an odd H and W leave out of the pooled images)."""
    f32, shape, tile, seg = _EMU_COMP_CASES[case]
    rng = np.random.default_rng(0x5EFA + len(case))
    a, b = _emu_pair(rng, shape, f32)
    if case.startswith("f32 non-finite"):
        a[0, seg, 200] = np.nan
        a[0, seg - 10, 40] = np.nan
        a[1, seg - 1, 127] = np.inf
        b[1, 3, 128] = -np.inf
        a[2, tile[0] - 1, tile[1]] = np.nan
        a[2, 40, 255] = np.inf
        b[2, -1, -1] = np.nan
    dr = 1.0 if f32 else 255.0
    kw = dict(taps=gaussian_taps(np.float32, 5, 1.5), c1=(0.01 * dr) ** 2,
              c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=tile[0], tile_w=tile[1])
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    npix = shape[1] * shape[2]
    want = ssim_cuda.ssim_components_plain(at, bt, **kw)
    got, none = _emulate(stream_emulator, "components", a, b, tile, seg)
    assert none is None and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    gk = got.double().sum(-2) / npix
    gp = want.double().sum(-2) / npix
    assert torch.equal(gk.isnan(), gp.isnan())
    fin = ~gp.isnan()
    if fin.any():
        assert (gk[fin] - gp[fin]).abs().max().item() <= max(2e-7, 2e-5 / npix**0.5)
    if case.startswith("f32 non-finite"):
        assert got.isnan().any() and not got.isnan().all()  # only the planted tiles
    if shape[1] < 2:
        return
    parts, (pa, pb) = _emulate(stream_emulator, "pooled", a, b, tile, seg)
    assert torch.equal(parts.isnan(), got.isnan())
    assert torch.equal(parts.nan_to_num(), got.nan_to_num())
    for x, want_pool in ((pa, ssim_cuda.downsample2(at)), (pb, ssim_cuda.downsample2(bt))):
        assert x.shape == want_pool.shape
        assert torch.equal(x.isnan(), want_pool.isnan())
        assert torch.equal(x.nan_to_num(), want_pool.nan_to_num())
    if case.startswith("f32 non-finite"):
        assert pa[0, seg // 2, 100].isnan() and pa[2, 20, 127].isinf()


def _emulate_batch(exe, a, b, precise, pack, relaxed=False, radius=5, sigma=1.5):
    """The host build of the batch modes' packed stream (kBatch, or
    kBatchPrecise with the f64 taps and c1, c2 unrounded, or with relaxed
    the relaxed kBatch) on NumPy (B, H, W) inputs with pack = (k, segment
    rows) at radius (the runtime-radius instantiation where it is not 5)
    and sigma, its second pass where batch_direct does not hold: the (B, 2)
    partials."""
    bsz, h, w = a.shape
    f32 = a.dtype == np.float32
    dr = 1.0 if f32 else 255.0
    k, seg = pack
    head = np.array([7 if precise else 6, int(f32), bsz, h, w, k, seg,
                     int(not ssim_cuda.batch_direct(h, w, k, seg)), 0, 0, 0, int(precise),
                     int(relaxed), radius], np.int32)
    ftype = np.float64 if precise else np.float32
    consts = np.array([(0.01 * dr) ** 2, (0.03 * dr) ** 2, max(131072.0, 4.0 * dr)], ftype)
    path_in, path_out = f"{exe}.{os.getpid()}.in", f"{exe}.{os.getpid()}.out"
    with open(path_in, "wb") as f:
        for x in (head, gaussian_taps(ftype, radius, sigma), consts, a, b):
            f.write(np.ascontiguousarray(x).tobytes())
    subprocess.run([str(exe), path_in, path_out], check=True, timeout=600)
    return torch.from_numpy(np.fromfile(path_out, ftype).reshape(bsz, 2).copy())


#: Batch stream cases: (f32, shape, pack (k, segment rows); None:
#: batch_stream_plan's at the H100's occupancy), NaN pixels (image, y, x).
_EMU_BATCH_CASES = {
    "u8 W=32, B not a multiple of k, a short last packed row": (
        False, (6, 20, 32), (4, 20), ()),
    "f32 W=64, NaN in one image, not across or into the next packed row": (
        True, (5, 18, 64), (2, 18), ((2, 17, 63),)),
    "u8 W=192 straddling strips, a short last packed row": (False, (3, 12, 192), (2, 12), ()),
    "u8 W=130": (False, (2, 9, 130), None, ()),
    "f32 W=65 straddling strips, NaN near the strip boundary": (
        True, (3, 14, 65), (3, 14), ((1, 0, 62),)),
    "u8 W=47, segments": (False, (3, 40, 47), (3, 16), ()),
    "u8 W=1": (False, (3, 50, 1), None, ()),
    "u8 1x1": (False, (2, 1, 1), None, ()),
    "u8 W=5, 12 to a strip, two packed rows": (False, (18, 7, 5), (12, 7), ()),
    "u8 W=8, 12 pieces a strip": (False, (17, 9, 8), (12, 9), ()),
    "u8 W=12, 12 pieces a strip": (False, (24, 6, 12), (22, 6), ()),
    "f32 W=33": (True, (4, 11, 33), None, ()),
    "u8 W=31": (False, (5, 13, 31), None, ()),
    "u8 W=128, one image a packed row": (False, (3, 10, 128), (1, 10), ()),
    "f32 tall images in segments, NaN in a segment's halo rows": (
        True, (2, 100, 64), (2, 32), ((1, 33, 0),)),
    "f32 W=64, NaN in row 0 of image 1, warp 3 (the prologue's staged row)": (
        True, (4, 16, 64), None, ((1, 0, 40),)),
    "f32 W=47, two to a strip, NaN in the second": (True, (5, 12, 47), None, ((3, 5, 46),)),
}


@pytest.mark.parametrize("case", list(_EMU_BATCH_CASES))
def test_batch_stream_source_matches_twin_on_the_host(stream_emulator, case):
    """The batch modes' packed stream (ssim_fwd_batch_stream_kernel and
    batch_pieces_reduce_kernel), built for the host, against
    ssim_parts_batch_plain: per-image scores within 2e-7 (kBatchPrecise
    within 1e-12 relative), counts exact, NaN in exactly the images that
    hold a non-finite pixel (never a neighbour in its packed row or the
    next). Widths 1 to 192: 12 images to a strip, images
    straddling strips, a short last packed row, tall images in segments,
    odd widths (the precise thread pairs split across two images), a NaN in
    the first staged row."""
    f32, shape, pack, nans = _EMU_BATCH_CASES[case]
    rng = np.random.default_rng(0x5EFB + len(case))
    a, b = _emu_pair(rng, shape, f32)
    for img, y, x in nans:
        a[img, y, x] = np.nan
    bsz, h, w = shape
    dr = 1.0 if f32 else 255.0
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for precise in (False, True):
        plan = pack or ssim_cuda.batch_stream_plan(
            bsz, h, w, H100_PRECISE_RESIDENT if precise else H100_RESIDENT)
        got = _emulate_batch(stream_emulator, a, b, precise, plan)
        want = ssim_cuda.ssim_parts_batch_plain(
            at, bt, precise, taps=gaussian_taps(np.float64 if precise else np.float32, 5, 1.5),
            c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr))
        assert got.dtype == want.dtype
        assert torch.equal(got[:, 1], want[:, 1]) and (got[:, 1] == h * w).all()
        bad = sorted({img for img, _, _ in nans})
        assert torch.isnan(got[:, 0]).nonzero().flatten().tolist() == bad, (precise, plan)
        gk = got.double().sum(-1).numpy() / (h * w)
        gp = want.double().sum(-1).numpy() / (h * w)
        ok = np.isfinite(gp)
        err = np.abs(gk[ok] - gp[ok]) / (np.abs(gp[ok]) if precise else 1.0)
        assert err.max(initial=0.0) <= (1e-12 if precise else 2e-7), (precise, plan, err.max())


#: Relaxed components and pooled cases: (f32, shape, tile, segment),
#: planted pixels (image, y, x, value): non-finite ones in image 1 only,
#: and a finite one past the clip bound (the staged value is clipped, the
#: pooled one raw). Widths >= MXU_MIN_W, as the wrappers launch the relaxed
#: modes; odd H and W (the last pooled row and column dropped), H one past
#: a segment and 2S + 1, pinned segments of 1 to 4 tiles, the components
#: wrappers' tile (TILE_H x TILE_W).
_EMU_RELAXED_COMP_CASES = {
    "u8 odd H and W, H one past a segment": (False, (1, 65, 601), (32, 64), 64, ()),
    "f32 NaN in image 1 of 2, 32x32 tiles, segments of 32": (
        True, (2, 69, 520), (32, 32), 32, ((1, 40, 300, np.nan), (1, 31, 127, np.nan))),
    "f32 inf in image 1 of 2, a clipped value in image 0": (
        True, (2, 40, 530), (32, 64), 32, ((1, 7, 200, np.inf), (0, 21, 129, 3e5))),
    "u8 2S+1, 32x128 tiles": (False, (1, 129, 640), (32, 128), 64, ()),
    "f32 H = 3, a segment of 4 tiles": (True, (2, 3, 530), (32, 64), 128, ()),
    "u8 the wrappers' tile": (False, (1, 70, 520),
                              (ssim_cuda.TILE_H, ssim_cuda.TILE_W), ssim_cuda.TILE_H, ()),
}


@pytest.mark.parametrize("case", list(_EMU_RELAXED_COMP_CASES))
def test_stream_kernel_source_relaxed_components_match_twins_on_the_host(stream_emulator,
                                                                          case):
    """The relaxed streaming instantiation of the components and pooled
    modes (the relaxed blurs, with the heavy horizontal ones as bf16x3 band
    products through the host model of mma.sync, and the components
    epilogue; kPooled from u8 pools the staged rows, from f32 its raw
    ring), built for the host, against ssim_components_plain(relaxed=True)
    and downsample2: per-image mean cs and ssim within 2e-6 (never tighter
    than 2 * 2e-5 / sqrt(npix)), NaN in both partials of exactly the twin's
    tiles (a NaN in one image of two poisons its tiles only), partials that
    differ from the standard mode's, the pooled mode's partials equal to
    the components mode's, and pooled images bit for bit (NaN at the same
    pixels)."""
    f32, shape, tile, seg, planted = _EMU_RELAXED_COMP_CASES[case]
    rng = np.random.default_rng(0x5F00 + len(case))
    a, b = _emu_pair(rng, shape, f32)
    for img, y, x, v in planted:
        a[img, y, x] = v
    dr = 1.0 if f32 else 255.0
    kw = dict(taps=gaussian_taps(np.float32, 5, 1.5), c1=(0.01 * dr) ** 2,
              c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
              tile_h=tile[0], tile_w=tile[1])
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    npix = shape[1] * shape[2]
    want = ssim_cuda.ssim_components_plain(at, bt, relaxed=True, **kw)
    std = ssim_cuda.ssim_components_plain(at, bt, **kw)
    got, none = _emulate(stream_emulator, "components", a, b, tile, seg, relaxed=True)
    assert none is None and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    gk = got.double().sum(-2) / npix
    gp = want.double().sum(-2) / npix
    assert torch.equal(gk.isnan(), gp.isnan())
    fin = ~gp.isnan()
    tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / npix**0.5)
    assert (gk[fin] - gp[fin]).abs().max().item() <= tol
    assert (gk[fin] - (std.double().sum(-2) / npix)[fin]).abs().max().item() > 0
    if planted:
        assert gk[1].isnan().all() and not gk[0].isnan().any()
        assert got.isnan().any() and not got[1].isnan().all()  # only the planted tiles
    if shape[1] < 2:
        return
    parts, (pa, pb) = _emulate(stream_emulator, "pooled", a, b, tile, seg, relaxed=True)
    assert torch.equal(parts.isnan(), got.isnan())
    assert torch.equal(parts.nan_to_num(), got.nan_to_num())
    for x, want_pool in ((pa, ssim_cuda.downsample2(at)), (pb, ssim_cuda.downsample2(bt))):
        assert x.shape == want_pool.shape
        assert torch.equal(x.isnan(), want_pool.isnan())
        assert torch.equal(x.nan_to_num(), want_pool.nan_to_num())
    for img, y, x, v in planted:
        got_v = pa[img, y // 2, x // 2].item()
        assert np.isnan(got_v) if np.isnan(v) else got_v >= v / 4
    if planted:
        assert not pa[0].isnan().any() and not pa[0].isinf().any()


#: Relaxed batch stream cases: (f32, shape, pack (k, segment rows); None:
#: batch_stream_plan's at the relaxed occupancy), NaN pixels (image, y,
#: x). Widths whose 16-column tiles straddle two images (24, 40, 100, and
#: 1, 5, 47, 65: the staged row's own tiles, two sweeps) and aligned ones
#: (32, 64, 128, 192: the strip's tiles, one sweep), images straddling
#: strips, short last packed rows, tall images in segments, H = 1.
_EMU_RELAXED_BATCH_CASES = {
    "u8 W=32, a short last packed row": (False, (6, 20, 32), (4, 20), ()),
    "f32 W=64, NaN in image 1 of 2": (True, (2, 18, 64), (2, 18), ((1, 17, 63),)),
    "u8 W=128": (False, (3, 10, 128), None, ()),
    "u8 W=192 straddling strips": (False, (3, 12, 192), (2, 12), ()),
    "u8 W=24, tiles straddle images": (False, (7, 14, 24), None, ()),
    "f32 W=40, NaN in image 2 of 3 at a tile's straddle": (
        True, (3, 11, 40), (3, 11), ((2, 5, 7),)),
    "u8 W=100 straddling strips": (False, (3, 9, 100), (3, 9), ()),
    "f32 W=65, segments, NaN in a segment's halo rows": (
        True, (3, 40, 65), (3, 16), ((1, 17, 64),)),
    "u8 W=5, 12 to a strip": (False, (13, 7, 5), None, ()),
    "u8 W=1 and H = 1": (False, (3, 1, 1), None, ()),
    "u8 W=47, tall images in segments": (False, (2, 70, 47), (2, 32), ()),
}


@pytest.mark.parametrize("case", list(_EMU_RELAXED_BATCH_CASES))
def test_batch_stream_source_relaxed_matches_twin_on_the_host(stream_emulator, case):
    """The relaxed kBatch on the packed stream (the relaxed main-path
    stream's steps over packed rows: mu_a, mu_b by the f32 symmetric pass,
    the heavy blurs as bf16x3 band products through the host model of
    mma.sync, on the strip's tiles where each lies in one image, else on
    the staged row's own tiles), built for the host, against
    ssim_parts_batch_plain(relaxed=True): per-image scores within 2e-6
    (never tighter than 2 * 2e-5 / sqrt(H W)), counts exact, NaN in exactly
    the images that hold a non-finite pixel, scores that differ from the
    standard kBatch's where an image has more than one pixel, and within
    1e-4 of the f64 oracle."""
    from ssim_tpu_torch import reference

    f32, shape, pack, nans = _EMU_RELAXED_BATCH_CASES[case]
    rng = np.random.default_rng(0x5F10 + len(case))
    a, b = _emu_pair(rng, shape, f32)
    for img, y, x in nans:
        a[img, y, x] = np.nan
    bsz, h, w = shape
    dr = 1.0 if f32 else 255.0
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    kw = dict(taps=gaussian_taps(np.float32, 5, 1.5), c1=(0.01 * dr) ** 2,
              c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr))
    plan = pack or ssim_cuda.batch_stream_plan(bsz, h, w, H100_RELAXED_BATCH_RESIDENT)
    got = _emulate_batch(stream_emulator, a, b, False, plan, relaxed=True)
    want = ssim_cuda.ssim_parts_batch_plain(at, bt, False, relaxed=True, **kw)
    std = ssim_cuda.ssim_parts_batch_plain(at, bt, False, **kw)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got[:, 1], want[:, 1]) and (got[:, 1] == h * w).all()
    bad = sorted({img for img, _, _ in nans})
    assert torch.isnan(got[:, 0]).nonzero().flatten().tolist() == bad, plan
    gk = got[:, 0].double().numpy() / (h * w)
    gp = want[:, 0].double().numpy() / (h * w)
    ok = np.isfinite(gp)
    tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / (h * w) ** 0.5)
    assert np.abs(gk[ok] - gp[ok]).max() <= tol, (plan, np.abs(gk[ok] - gp[ok]).max())
    if h * w > 1:
        assert np.abs(gk[ok] - std[:, 0].double().numpy()[ok] / (h * w)).max() > 0
    oracle = np.array([reference.compute_ssim(a[i].astype(np.float64),
                                              b[i].astype(np.float64), data_range=dr)[0]
                       for i in range(bsz) if i not in bad])
    assert np.abs(gk[ok] + 1.0 - oracle).max() <= _RELAXED_ORACLE_GLOBAL


#: The runtime-radius instantiation's cases: (radius, sigma, f32, shape,
#: tile, segment). Widths over one strip with a ragged last strip, odd
#: heights, H one past a segment, W <= 2r at radius 16, u8 and f32.
_EMU_RT_CASES = {
    "r1 u8 ragged strips, odd H": (1, 0.8, False, (2, 67, 300), (32, 64), 64),
    "r1 f32 32x32 tiles": (1, 0.8, True, (1, 33, 131), (32, 32), 32),
    "r3 u8 odd H, H one past a segment": (3, 1.2, False, (2, 65, 261), (32, 64), 64),
    "r3 f32 64x128 tiles": (3, 1.2, True, (1, 71, 257), (64, 128), 128),
    "r4 u8 7x64 tiles, segments of 14": (4, 1.5, False, (1, 30, 200), (7, 64), 14),
    "r4 f32 odd H and W": (4, 1.5, True, (2, 41, 133), (32, 64), 64),
    "r6 u8 2S+1": (6, 2.0, False, (1, 129, 140), (32, 64), 64),
    "r6 f32 32x32 tiles": (6, 2.0, True, (1, 35, 300), (32, 32), 32),
    "r16 u8 W <= 2r": (16, 3.0, False, (2, 45, 9), (32, 64), 64),
    "r16 f32 ragged strips, odd H": (16, 3.0, True, (1, 69, 261), (32, 64), 64),
}


@pytest.mark.parametrize("case", list(_EMU_RT_CASES))
def test_stream_kernel_source_runtime_radius_matches_twins_on_the_host(stream_emulator,
                                                                       case):
    """The runtime-radius instantiation (kR = 0: the radius read at run
    time, the window's 2r + 1 rows in a ring in shared memory, the taps in
    shared memory), built for the host, in all eight of its modes against
    the twins at radii 1, 3, 4, 6 and 16: kScore, kMap, kRowsum and
    kRowsumMap (maps bit for bit, NaN over exactly the twin's tiles, row
    sums within W * 1e-5, scores within 2e-7), kPrecise and kPreciseMap
    (maps bit for bit, scores within 1e-12 relative), kComponents and
    kPooled (mean cs and ssim within max(2e-7, 2e-5 / sqrt(npix)), pooled
    images bit for bit). Outputs start as NaN and shared memory is NaN at
    each block's start, so an entry never written fails. f32 cases hold a
    NaN and an inf on a tile edge and a strip boundary."""
    radius, sigma, f32, shape, tile, seg = _EMU_RT_CASES[case]
    rng = np.random.default_rng(0x5F20 + len(case))
    a, b = _emu_pair(rng, shape, f32)
    if f32:
        a[0, tile[0] - 1, min(tile[1], shape[2] - 1)] = np.nan
        b[-1, shape[1] // 2, min(127, shape[2] - 1)] = np.inf
    _hold_emulated(stream_emulator, a, b, tile, seg, radius=radius, sigma=sigma)
    dr = 1.0 if f32 else 255.0
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    npix = shape[1] * shape[2]
    consts = dict(c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2,
                  clip_bound=max(131072.0, 4.0 * dr), tile_h=tile[0], tile_w=tile[1])
    kw64 = dict(taps=gaussian_taps(np.float64, radius, sigma), **consts)
    for mode in _EMU_PRECISE_MODES:
        got, got_map = _emulate(stream_emulator, mode, a, b, tile, seg, radius=radius,
                                sigma=sigma)
        want, want_map = ssim_cuda.ssim_parts_precise_plain(
            at, bt, with_map=mode == "precise_map", **kw64)
        assert got.dtype == want.dtype == torch.float64
        if mode == "precise_map":
            assert torch.equal(got_map.isnan(), want_map.isnan())
            assert torch.equal(got_map.nan_to_num(), want_map.nan_to_num())
        assert torch.equal(got.isnan(), want.isnan())
        gk, gp = got.sum(-1).numpy() / npix, want.sum(-1).numpy() / npix
        assert np.nanmax(np.abs(gk - gp) / np.abs(gp), initial=0.0) <= 1e-12, mode
    kw32 = dict(taps=gaussian_taps(np.float32, radius, sigma), **consts)
    want = ssim_cuda.ssim_components_plain(at, bt, **kw32)
    got, _ = _emulate(stream_emulator, "components", a, b, tile, seg, radius=radius,
                      sigma=sigma)
    assert torch.equal(got.isnan(), want.isnan())
    gk, gp = got.double().sum(-2) / npix, want.double().sum(-2) / npix
    fin = ~gp.isnan()
    if fin.any():
        assert (gk[fin] - gp[fin]).abs().max().item() <= max(2e-7, 2e-5 / npix**0.5)
    if tile[0] % 2 == 0:
        parts, (pa, pb) = _emulate(stream_emulator, "pooled", a, b, tile, seg,
                                   radius=radius, sigma=sigma)
        assert torch.equal(parts.isnan(), got.isnan())
        assert torch.equal(parts.nan_to_num(), got.nan_to_num())
        for x, y in ((pa, ssim_cuda.downsample2(at)), (pb, ssim_cuda.downsample2(bt))):
            assert torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(),
                                                                     y.nan_to_num())
    if f32:
        assert got.isnan().any() and not got.isnan().all()  # only the planted tiles


@pytest.mark.parametrize("radius,sigma,flags", [(1, 0.8, (0, 0)), (3, 1.2, (1, 0)),
                                                (6, 2.0, (0, 1)), (16, 3.0, (1, 1))])
def test_stream_kernel_source_runtime_radius_row_modes_with_halo(stream_emulator, radius,
                                                                   sigma, flags):
    """The runtime-radius instantiation's row modes with halo operands of r
    rows, a band of 61 rows of a 200-row image, each flag pair: the
    operands' rows read in place of the clamp where a flag is clear, and
    NaN-filled operands under a set flag never read; f32 with a NaN in the
    band (its tile's rows NaN) and one in the rows the top operand holds
    (operand rows poison nothing)."""
    f32 = flags != (1, 0)
    rng = np.random.default_rng(0x5F30 + radius)
    a, b = _emu_pair(rng, (2, 200, 300), f32)
    lo, hi = 60, 121
    if f32:
        a[1, 100, 140] = np.nan
        a[0, lo - 1, 30] = np.nan

    def ring(x):
        top = x[:, -radius:] if flags[0] else x[:, lo - radius:lo]
        bot = x[:, :radius] if flags[1] else x[:, hi:hi + radius]
        return np.ascontiguousarray(top), np.ascontiguousarray(bot)

    (a_top, a_bot), (b_top, b_bot) = ring(a), ring(b)
    if f32 and flags[0]:
        a_top = np.full_like(a_top, np.nan)
    if f32 and flags[1]:
        b_bot = np.full_like(b_bot, np.nan)
    _hold_emulated(stream_emulator, np.ascontiguousarray(a[:, lo:hi]),
                   np.ascontiguousarray(b[:, lo:hi]), (32, 64), 32,
                   vhalo=(a_top, a_bot, b_top, b_bot), vmask=flags, radius=radius,
                   sigma=sigma)


#: The relaxed runtime-radius instantiations' cases (kSplit =
#: band_mma::ksteps(r): 2 at radii 1 and 8, 3 at 9 and 16): (radius, sigma,
#: f32, shape, tile, segment, planted pixels (image, y, x, value)). Widths
#: over a strip with a ragged last one, odd H and W, H one past a segment,
#: a one-row image, W <= 2r at radius 16, NaN and inf on a tile edge and a
#: strip boundary, a finite value past the clip bound.
_EMU_RT_RELAXED_CASES = {
    "r1 u8 ragged strip, odd H and W": (1, 0.8, False, (2, 33, 301), (32, 64), 32, ()),
    "r1 f32 one row": (1, 0.8, True, (2, 1, 200), (32, 64), 32, ()),
    "r8 f32 NaN and inf, 32x32 tiles": (
        8, 2.5, True, (2, 41, 260), (32, 32), 32,
        ((0, 31, 64, np.nan), (1, 20, 127, np.inf), (0, 5, 129, 3e5))),
    "r9 u8 H one past a segment, 32x128 tiles": (9, 2.5, False, (1, 65, 257), (32, 128), 64,
                                                  ()),
    "r16 u8 W <= 2r": (16, 3.0, False, (2, 40, 30), (32, 64), 32, ()),
    "r16 f32 NaN on a strip boundary": (16, 3.0, True, (1, 50, 260), (32, 64), 64,
                                         ((0, 33, 128, np.nan),)),
}


@pytest.mark.parametrize("case", list(_EMU_RT_RELAXED_CASES))
def test_stream_kernel_source_relaxed_runtime_radius_matches_twins_on_the_host(
        stream_emulator, case):
    """The relaxed tier's runtime-radius instantiations (kR = 0, kSplit =
    band_mma::ksteps(r): the staged rows and one ring of mu_a, mu_b and the
    heavy blurs in dynamic shared memory, the band products through the
    host model of mma.sync), built for the host, in their four modes
    against the relaxed twins at radii 1, 8, 9 and 16: kScore and kMap
    within 2e-6 global (never tighter than 2 * 2e-5 / sqrt(npix)) and 2e-5
    per pixel, NaN over exactly the twin's tiles, a map that differs from
    the standard twin's; kComponents and kPooled within the same global
    bound, pooled images bit for bit. Outputs start as NaN and shared
    memory is NaN at each block's start, so an entry never written, or a
    ring slot read before it is written, fails."""
    radius, sigma, f32, shape, tile, seg, planted = _EMU_RT_RELAXED_CASES[case]
    rng = np.random.default_rng(0x5F50 + len(case))
    a, b = _emu_pair(rng, shape, f32)
    for img, y, x, v in planted:
        a[img, y, x] = v
    dr = 1.0 if f32 else 255.0
    kw = dict(taps=gaussian_taps(np.float32, radius, sigma), c1=(0.01 * dr) ** 2,
              c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr), tile_h=tile[0],
              tile_w=tile[1])
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    npix = shape[1] * shape[2]
    tol = max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / npix**0.5)
    want, want_map = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, relaxed=True, **kw)
    _, std_map = ssim_cuda.ssim_parts_plain(at, bt, with_map=True, **kw)
    for mode in ("score", "map"):
        got, got_map = _emulate(stream_emulator, mode, a, b, tile, seg, relaxed=True,
                                radius=radius, sigma=sigma)
        assert torch.equal(got.isnan(), want.isnan()), mode
        gk, gp = got.double().sum(-1) / npix, want.double().sum(-1) / npix
        fin = ~gp.isnan()
        if fin.any():
            assert (gk[fin] - gp[fin]).abs().max().item() <= tol, mode
    assert torch.equal(got_map.isnan(), want_map.isnan())
    ok = ~want_map.isnan()
    assert (got_map[ok] - want_map[ok]).abs().max().item() <= _RELAXED_PIXEL
    assert (got_map[ok] - std_map[ok]).abs().max().item() > 0
    want_c = ssim_cuda.ssim_components_plain(at, bt, relaxed=True, **kw)
    got_c, _ = _emulate(stream_emulator, "components", a, b, tile, seg, relaxed=True,
                        radius=radius, sigma=sigma)
    assert torch.equal(got_c.isnan(), want_c.isnan())
    gk, gp = got_c.double().sum(-2) / npix, want_c.double().sum(-2) / npix
    fin = ~gp.isnan()
    if fin.any():
        assert (gk[fin] - gp[fin]).abs().max().item() <= tol
    if planted:
        assert got_c.isnan().any() and not got_c.isnan().all()  # only the planted tiles
    if shape[1] >= 2:
        parts, (pa, pb) = _emulate(stream_emulator, "pooled", a, b, tile, seg, relaxed=True,
                                   radius=radius, sigma=sigma)
        assert torch.equal(parts.isnan(), got_c.isnan())
        assert torch.equal(parts.nan_to_num(), got_c.nan_to_num())
        for x, y in ((pa, ssim_cuda.downsample2(at)), (pb, ssim_cuda.downsample2(bt))):
            assert torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(),
                                                                     y.nan_to_num())


#: The P6 check's mutations of the kernel source: (file, the text, its
#: replacement). Each leaves one output entry or one shared array unwritten.
_SKIP_STORE = {
    "a map store skipped (runtime radius)": (
        "fwd_stream_kernel.cuh",
        "map[base + (size_t)(y0 + ly) * (size_t)W + (size_t)(x0 + tid)] = (float)v;",
        "if (y0 + ly != 3 || x0 + tid != 130) "
        "map[base + (size_t)(y0 + ly) * (size_t)W + (size_t)(x0 + tid)] = (float)v;"),
    "a tile partial skipped": (
        "fwd_stream_kernel.cuh",
        "          partials[((size_t)img * nty + (size_t)tyg) * (size_t)ntx + (size_t)txg] =",
        "          if (tyg != 1 || txg != 2) "
        "partials[((size_t)img * nty + (size_t)tyg) * (size_t)ntx + (size_t)txg] ="),
    "the tile mask left uninitialised": (
        "fwd_stream_kernel.cuh",
        "  if (tid < kMaxSegTiles) s_bad[tid] = 0u;\n",
        "\n"),
}


@pytest.mark.parametrize("mutation", list(_SKIP_STORE))
def test_emulator_poison_shows_an_unwritten_output(tmp_path, mutation):
    """The P6 check (ROADMAP Queue 3): the harness fills every output with
    NaN and shared memory with NaN bytes at each block's start, so a kernel
    that leaves one map pixel or one partial unwritten, or reads a shared
    array it never initialised, fails the comparison with its twin, where
    outputs that start as zeros or as an earlier right answer could hide
    it. Built from a copy of the source with one store skipped, the
    standard modes at radius 5 and 3 fail; the unmutated build passes them
    (the other tests)."""
    name, old, new = _SKIP_STORE[mutation]

    def edit(fname, text):
        if fname == name:
            assert text.count(old) == 1, mutation
            return text.replace(old, new)
        return text

    exe = _build_emulator(tmp_path, edit)
    rng = np.random.default_rng(0x5F40)
    a, b = _emu_pair(rng, (1, 70, 300), True)  # f32: the tile mask is read
    for radius, sigma in ((5, 1.5), (3, 1.2)):
        with pytest.raises(AssertionError):
            _hold_emulated(exe, a, b, (32, 64), 64, radius=radius, sigma=sigma)
