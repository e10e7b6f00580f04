"""Fused SSIM forward: the hand-written CUDA kernel's wrappers and their
plain PyTorch twins.

Counterpart of `ssim_tpu/ops/ssim_pallas.py` over `_nopad_overlap_call`
and `_chunked_overlap_call`, in these of their modes:

- standard tier, with or without the map: `ssim_parts_cuda`
  (`ssim_parts_pallas`), twin `ssim_parts_plain`;
- precise tier (precision="f64"), with or without the map:
  `ssim_parts_cuda(precise=True)` (`ssim_parts_pallas(precise=True)`),
  twin `ssim_parts_precise_plain`: the standard blurs in fp64 with the
  f64 taps where the TPU kernel blurs in f32 with f32 taps (which cancels
  to f32 rounding on flat windows), the SSIM formula in native fp64 where
  the TPU kernel compensates it in df32, and one fp64 partial per tile
  where the TPU kernel writes two f32 ones;
- MS-SSIM components, per-tile [sum cs, sum ssim]:
  `ssim_components_cuda` (`ssim_components_pallas`), twin
  `ssim_components_plain`;
- components plus the 2x2-mean images of the next pyramid scale:
  `ssim_components_pooled_cuda` (`ssim_components_pooled_pallas`), twin
  `ssim_components_pooled_plain`;
- one partial pair per image for batches of small images, standard and
  precise: `ssim_parts_batch_cuda` (`ssim_parts_pallas_bpacked`, whose
  lane packing becomes images side by side in the stream's strips), twin
  `ssim_parts_batch_plain`;
  the same mode serves the contract of `tools/probe_bpack.py::bpack_parts`;
- per-row sums of SSIM, with or without the map, of an image or of a row
  band of a taller image whose halo rows arrive as operands (spatial
  sharding, `parallel/spatial.py`): `ssim_rows_cuda`, also reached through
  `ssim_parts_cuda(rowsum=True)` and `ssim_parts_cuda(vhalo=...,
  vmask=...)` (the same keywords of `ssim_parts_pallas`), twin
  `ssim_rows_plain`, which splices (or, at a flagged edge, replicates) the
  operands and runs the plain blur algebra;
- the relaxed accuracy tier (accuracy="relaxed", the JAX "mxu3x" lane
  mode): `relaxed=True` on the standard, components, pooled and batch
  wrappers, where `relaxed_applies` (W >= MXU_MIN_W on the tile grid,
  always on the batch route). The two heavy horizontal blurs, of
  (a+b)^2 and (a-b)^2, run as bf16x3 band products on the tensor cores;
  their twin is `band_bf16x3_plain`, the rest of each twin as it is.
  The relaxed score, map, components and pooled modes stream rows like
  the standard ones, at every radius but where the relaxed tile body was
  measured faster (STREAM_RELAXED_TILE_RADII).

The kernel is `ssim_tpu_torch/csrc/ssim_fwd.cu`. Its partials and NaN
poison follow one 2-D grid of TILE_H x TILE_W output tiles that covers
every width, so the TPU's split at 16384 lanes and
`pooled_components_ok`'s VMEM limits have no counterpart. The main-path
modes (score, map, the row modes, the precise modes and the MS-SSIM
components and pooled modes, and the relaxed score, map, components and
pooled modes, at every radius to MAX_FUSED_RADIUS with tiles up to STRIP_W
wide, the relaxed ones but at STREAM_RELAXED_TILE_RADII: `stream_applies`)
run a row-streaming kernel,
one CUDA block per strip of STRIP_W columns and segment of rows
(`stream_segment` picks the segment's length to fill the card at the
instantiation's occupancy, `stream_blocks` lists the blocks); at
STREAM_RADIUS its window of 2r + 1 rows is in registers, at other radii
in a ring in shared memory (ssim_fwd_stream_rt.cu, relaxed
ssim_fwd_stream_rt_relaxed.cu). Every other mode, radius and tile runs the
tile body, one block per tile.
Both batch modes (and the relaxed kBatch) run a packed variant of the
row stream at every radius to MAX_FUSED_RADIUS (ssim_fwd_batch.cu at
STREAM_RADIUS, ssim_fwd_batch_rt.cu at the others): images side by side
in packed rows cut into strips (`batch_pack`), a block walking one strip
of a packed row, down all its rows or a segment of them
(`batch_stream_plan`, `batch_stream_blocks`), but at the radii where the
tile body's batch branch, each image's own grid of narrower tiles inside
a tile-body block (`batch_geometry`), was measured faster
(`STREAM_BATCH_TILE_RADII`).

Each wrapper launches the kernel for CUDA tensors and runs its plain twin
for CPU tensors, the counterpart of "compiled on TPU, interpreted
elsewhere"; any other device raises. The twins use the same tile grid,
the same clamp-to-edge rule, the four blurred signals a, b, (a+b)^2,
(a-b)^2 with the kernel's order of operations, the float sanitise and
per-tile NaN poison, and per-tile partials of x - 1 plus n_valid. They
are what the CPU tests run and what the kernel is held against on the
card. A wrapper never gives way to its twin on a CUDA tensor: if the
kernel does not build or launch, it raises.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..windows import RADIUS, SIGMA, gaussian_taps
from .pool import downsample2
from .ssim_torch import _pad_edge

#: Largest window radius the kernel serves (its taps live in a 33-float
#: array); larger radii route to ssim_parts_torch (precision="f64": the
#: f64 oracle).
MAX_FUSED_RADIUS = 16

#: Default output tile. TILE_W must be a power of two in [32, 256]: the
#: kernel's 256 threads cover one tile row with TILE_W of them.
TILE_H = 32
TILE_W = 64
_TILE_WIDTHS = (32, 64, 128, 256)
_MAX_TILE_H = 256

#: Dynamic shared memory a block may use on Hopper (227 KB), less the
#: kernel's static taps and warp-sum arrays.
_MAX_DYNAMIC_SMEM = 232448 - 256

#: Kernel launches made in this process by ssim_parts_cuda (standard
#: tier, with or without the map; PRECISE_LAUNCHES: the precise tier;
#: ROWSUM_LAUNCHES and ROWSUM_MAP_LAUNCHES: ssim_rows_cuda without and
#: with the map), ssim_components_cuda, ssim_components_pooled_cuda and
#: ssim_parts_batch_cuda (BATCH_LAUNCHES, and BATCH_PRECISE_LAUNCHES for
#: its precise tier), one counter per mode; RELAXED_LAUNCHES counts the
#: relaxed launches of every mode, which add to no other counter.
#: STREAM_LAUNCHES counts the launches that ran the row-streaming kernel
#: (stream_applies; the batch modes' packed stream too), beside their
#: mode's counter; the mode's other launches ran the tile body. Each is added to in one place, per launch,
#: and nowhere else, so a caller can show which modes, and which design,
#: a run went through.
LAUNCHES = 0
PRECISE_LAUNCHES = 0
COMPONENTS_LAUNCHES = 0
POOLED_LAUNCHES = 0
BATCH_LAUNCHES = 0
BATCH_PRECISE_LAUNCHES = 0
ROWSUM_LAUNCHES = 0
ROWSUM_MAP_LAUNCHES = 0
RELAXED_LAUNCHES = 0
STREAM_LAUNCHES = 0

#: The row-streaming kernel (fwd_stream.cuh kStripW, kMaxSegTiles, kStreamR):
#: a block owns a strip of STRIP_W output columns and walks down a segment
#: of at most MAX_SEG_TILES tiles' rows; it serves the modes STREAM_MODES:
#: the standard tier's score, map and row modes and the MS-SSIM components
#: and pooled modes (the same blurs, another epilogue) in f32, and the
#: precise tier's two modes in fp64 (the same body with double blurs), at
#: STREAM_RADIUS (windows.RADIUS) with its window in registers and at every
#: other radius to MAX_FUSED_RADIUS with its window in a ring in shared
#: memory (ssim_fwd_stream_rt.cu, the radius read at run time);
#: relaxed, the modes STREAM_RELAXED_MODES at every radius as well (the
#: heavy horizontal blurs as band products, two rows every other stream row;
#: other radii than STREAM_RADIUS in ssim_fwd_stream_rt_relaxed.cu; the
#: relaxed batch mode on the packed stream, at every radius as well).
STRIP_W = 128
MAX_SEG_TILES = 16
STREAM_RADIUS = 5
STREAM_MODES = ("score", "map", "rowsum", "rowsum_map", "precise", "precise_map",
                "components", "pooled")
STREAM_RELAXED_MODES = ("score", "map", "components", "pooled", "batch")
#: The batch modes, which stream packed rows at every radius (kBatch in
#: both tiers, kBatchPrecise) whatever the batch tile
#: (ssim_fwd_batch_stream_kernel: ssim_fwd_batch.cu at STREAM_RADIUS,
#: ssim_fwd_batch_rt.cu's runtime radius at the others).
STREAM_BATCH_MODES = ("batch", "batch_precise")
#: Rows' worth of fixed cost per block in stream_segment's model (launch,
#: prologue and the NaN check).
_BLOCK_OVERHEAD_ROWS = 8
#: The components and pooled modes stream from this many pixels a launch
#: (B * H * W) up, and run the tile body below it. A streaming block walks
#: at least one tile's rows plus 2r, one barrier a row, so a launch that
#: leaves the card mostly idle waits on that chain: measured on an H100
#: (kernel time in a profiler trace, tools/fwd_times.py; PERF.md), at the
#: MS-SSIM scales of msssim_1080_b4 the stream against the tile body took
#: components 0.054-0.056 / 0.064 ms at 4x540x960 (2.07 Mpix), 0.040 /
#: 0.026 at 4x270x480 (0.52 Mpix), 0.038-0.039 / 0.015 at 4x135x240 and
#: 0.040-0.041 / 0.0145 at 4x67x120, pooled 0.064-0.065 / 0.062-0.065,
#: 0.046 / 0.026, 0.055 / 0.015 and 0.053-0.056 / 0.015; the stream's
#: floor (~0.040 ms) meets a line through the tile body's times near 1.1
#: Mpix.
STREAM_COMP_MIN_PIX = 1 << 20
#: The same threshold for the relaxed components and pooled modes (their
#: row stream carries the relaxed tier's mma steps, longer than the
#: standard ones), one for both dtypes. Measured on an H100 (kernel time
#: in a profiler trace, `tools/fwd_times.py --relaxed`, two runs; PERF.md),
#: relaxed stream / relaxed tile body: at 2x1080x1920 (4.15 Mpix)
#: components f32 0.127 / 0.128 ms, pooled f32 0.169-0.171 / 0.137-0.138,
#: pooled u8 0.095-0.096 / 0.120; at 3x1080x1920 0.146-0.148 / 0.186-0.188,
#: 0.174-0.176 / 0.198, 0.142-0.150 / 0.174-0.176; at 2.07 Mpix (4x540x960,
#: MS-SSIM scale 1) 0.065-0.067 / 0.063, 0.071-0.072 / 0.066-0.067, 0.063 /
#: 0.063 (1x1080x1920 pooled u8 0.055 / 0.063-0.064). So the rule trades
#: pooled u8 from 2.07 to 4.19 Mpix, which streams as fast to 20% faster,
#: for pooled f32 at 4.15 Mpix, which streams 23-24% slower.
STREAM_RELAXED_COMP_MIN_PIX = 1 << 22
#: The radii at which a relaxed launch of a given size (stream_applies'
#: npix) keeps the relaxed tile body in its (mode, f32 input), where the
#: runtime-radius relaxed stream (ssim_fwd_stream_rt_relaxed.cu) serves it
#: but lost to the tile body. Measured on an H100 (`tools/fwd_times.py
#: --relaxed-radii`: stream and tile body in turns, the lower of two runs
#: each, radii 1-16; PERF.md §6), the stream's time over the tile body's:
#: kScore and kMap u8 4K x4 0.76-0.94x at radii 1-15, 1.05-1.06x at 16;
#: kComponents f32 1080p x4 0.78-0.97x but 1.03x at 2 and 16; kPooled u8
#: 1080p x4 0.93-0.94x at 8 and 9, 1.06-1.29x at every other radius but 5
#: (the stream takes about the f32 time, the u8 tile body less); kPooled
#: f32 0.78-0.98x but 1.05-1.09x at 2, 15 and 16. kScore and kMap on f32
#: and kComponents on u8, not measured, take the other dtype's radii.
STREAM_RELAXED_TILE_RADII = {
    ("score", False): (16,), ("score", True): (16,),
    ("map", False): (16,), ("map", True): (16,),
    ("components", False): (2, 16), ("components", True): (2, 16),
    ("pooled", False): (1, 2, 3, 4, 6, 7, 10, 11, 12, 13, 14, 15, 16),
    ("pooled", True): (2, 15, 16),
}

#: The width classes of the batch rule (STREAM_BATCH_TILE_RADII): a batch
#: of width w takes the class of the first edge at or above w, the last
#: above them all. The edges are the tile body's tile widths
#: (batch_geometry: 8 or 16, 32, 64 and 128 columns, two tiles a row from
#: 129 to PACK_MAX_W), which set how full its tiles are and so its cost.
BATCH_RULE_WIDTHS = (16, 32, 64, 128, 192)


def batch_width_class(w: int) -> int:
    """The class of the batch rule that a batch of width w reads: the first
    of BATCH_RULE_WIDTHS at or above w, the last above them all."""
    return next((e for e in BATCH_RULE_WIDTHS if w <= e), BATCH_RULE_WIDTHS[-1])


#: The radii at which a routed batch launch (stream_applies given its size
#: and width) keeps the tile body's batch branch, by (mode, relaxed, f32
#: input, width class), where the runtime-radius packed stream
#: (ssim_fwd_batch_rt.cu) serves it but took at least the tile body's time
#: at some measured width of the class. Measured on an H100
#: (`tools/fwd_times.py --batch --radii`: stream and tile body in turns,
#: the lower of two runs each, radii 1-16, every mode on u8 and f32 at 14
#: widths from 8 to 192, batch_tile_rule; PERF.md §6), the stream's time
#: over the tile body's: kBatch 0.31-0.96x but 1.04-1.06x at 32x32 r = 16;
#: kBatchPrecise 0.38-0.99x at widths 40-192 but 1.04-1.06x at 64x64 r =
#: 13-16 (u8) and 1.05x at 120x120 r = 12, 0.37-0.99x at 8-24 but 1.00-1.40x
#: at radii 7, 8 and 11-16, 0.95-1.54x at 32x32 (the tile body's tiles
#: full); the relaxed kBatch 0.26-0.92x at 8-16, 40 and 48, 1.03-1.05x at
#: 24x24 r = 13-15, 0.70-1.38x at 32, 64 and 96-192.
STREAM_BATCH_TILE_RADII = {
    ("batch", False, False, 32): (16,),
    ("batch", False, True, 32): (16,),
    ("batch_precise", False, False, 16): (7, 8, 11, 12, 13, 14, 15, 16),
    ("batch_precise", False, True, 16): (7, 8, 11, 12, 13, 14, 15, 16),
    ("batch_precise", False, False, 32): (2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16),
    ("batch_precise", False, True, 32): (2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16),
    ("batch_precise", False, False, 64): (13, 14, 15, 16),
    ("batch_precise", False, False, 128): (12,),
    ("batch", True, False, 32): (6, 7, 8, 10, 11, 12, 13, 14, 15, 16),
    ("batch", True, True, 32): (14, 15),
    ("batch", True, False, 64): (1, 2, 3, 4, 6, 7, 10, 11, 12, 13, 14, 15, 16),
    ("batch", True, True, 64): (2, 4, 6, 7, 14, 15),
    ("batch", True, False, 128): (1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16),
    ("batch", True, True, 128): (1, 2, 3, 4, 6, 7, 10, 11, 12, 14, 15, 16),
    ("batch", True, False, 192): (2, 3, 4, 6, 7, 14, 15, 16),
    ("batch", True, True, 192): (6, 7, 14, 15, 16),
}

#: The JAX package's width gate of the relaxed tier (ssim_pallas.py:115,
#: copied): the tile grid runs the relaxed mode at widths >= MXU_MIN_W and
#: the standard one below it; the batch route always runs it (JAX applies
#: it to the packed row, at least MXU_MIN_W wide, ssim_pallas.py:2284-2291).
MXU_MIN_W = 512

#: The JAX package's gate for its small-image batch route
#: (ssim_tpu/ops/ssim_pallas.py:2141-2158 and :2303-2326), copied so that
#: both packages send the same batches there. On the TPU, bpack_count's p
#: images share one lane row of BPACK_LANES (u8) or FLOAT_BPACK_LANES
#: (f32, ssim_pallas._FLOAT_FAST_PATH_BUDGET // 32) lanes; on the card p
#: only decides the route.
PACK_MAX_W = 192
BPACK_LANES = 4096
FLOAT_BPACK_LANES = 3072

#: The packed batch stream (ssim_fwd_batch.cu kBatchPieces): at most
#: BATCH_MAX_PIECES images meet one strip, each staged with its own clamped
#: columns (two staged columns a thread).
BATCH_MAX_PIECES = 12
#: A batch stream block's fixed cost in rows in batch_stream_plan's model,
#: fitted to the segment sweeps of `tools/fwd_times.py --batch --packs` on
#: an H100 (PERF.md).
_BATCH_BLOCK_OVERHEAD_ROWS = 2

#: The tile body's batch tiles (STREAM_BATCH_TILE_RADII, or pinned): the
#: tile grid's area, whose shared memory (68 KB at radius 5) lets three
#: blocks share an SM.
_BATCH_TILE_AREA = TILE_H * TILE_W
#: The batch modes aim at about _BATCH_BLOCKS blocks (some ten waves of
#: three blocks on 132 SMs), each walking at most _BATCH_MAX_RUN tiles:
#: enough blocks that the last wave's tail stays short (PERF.md).
_BATCH_BLOCKS = 4096
_BATCH_MAX_RUN = 8


def smem_bytes(tile_h: int, tile_w: int, radius: int, precise: bool = False) -> int:
    """Dynamic shared memory of one block: the a and b halo tiles (f32)
    plus four horizontally blurred planes (f64 in the precise modes)."""
    hr = tile_h + 2 * radius
    return 4 * 2 * hr * (tile_w + 2 * radius) + (8 if precise else 4) * 4 * hr * tile_w


def tile_grid(h: int, w: int, tile_h: int = TILE_H, tile_w: int = TILE_W):
    """(rows of tiles, columns of tiles) covering an h x w image."""
    return -(-h // tile_h), -(-w // tile_w)


def fit_tile(tile_h: Optional[int], tile_w: Optional[int], radius: int,
             precise: bool = False):
    """A tile setting (each >= 1, or None for TILE_H / TILE_W) brought into
    the range the kernel takes, as the JAX engine clamps its max_tile_h
    (ssim_pallas.py:728): tile_h to a multiple of 32 in [32, 256], tile_w
    to the power of two in [32, 256] at or below it; then tile_h, and
    where that is not enough tile_w, shrunk until a block's shared memory
    fits at this radius (with the precise modes' f64 planes where
    precise). Returns (tile_h, tile_w)."""
    th = TILE_H if tile_h is None else max(32, min(int(tile_h), _MAX_TILE_H) // 32 * 32)
    tw = TILE_W if tile_w is None else min(
        _TILE_WIDTHS[-1], max(_TILE_WIDTHS[0], 1 << (int(tile_w).bit_length() - 1)))
    while smem_bytes(th, tw, radius, precise) > _MAX_DYNAMIC_SMEM:
        if th > 32:
            th -= 32
        else:
            tw //= 2
    return th, tw


def bpack_count(w: int, batch: int, itemsize: int = 1) -> int:
    """How many w-wide images the JAX package's packed path lays side by
    side in one row (a copy of ssim_pallas.bpack_count): the largest p up
    to the row budget over w whose row p * w is a multiple of 128 lanes,
    else at most 2048 // w."""
    budget = FLOAT_BPACK_LANES if itemsize > 1 else BPACK_LANES
    cap = max(1, min(batch, budget // w))
    for p in range(cap, 0, -1):
        if (p * w) % 128 == 0:
            return p
    return max(1, min(cap, max(1, 2048 // w)))


def pack_preferred(w: int, batch: int, itemsize: int = 1) -> bool:
    """The JAX package's width policy for the small-image batch route (a
    copy of ssim_pallas.pack_preferred): at least two images to a packed
    row and w <= PACK_MAX_W."""
    return bpack_count(w, batch, itemsize) >= 2 and w <= PACK_MAX_W


def batch_geometry(batch: int, h: int, w: int):
    """The tile body's batch launch for a (batch, h, w) input, which runs
    at the radii STREAM_BATCH_TILE_RADII names and where _launch pins the
    tile body (the batch modes stream packed rows at the others, in every
    tier: batch_stream_plan): (tile_h, tile_w, images per block, runs per
    image). The tile is as wide as the image
    rounded up to a power of two in [8, TILE_W], so a narrow image leaves
    few of a block's threads idle, and holds _BATCH_TILE_AREA pixels (fewer
    for a short image). A block walks about batch * tiles / _BATCH_BLOCKS
    tiles (1.._BATCH_MAX_RUN): whole images where an image has fewer
    tiles, else one of the runs an image's tiles are split into."""
    tile_w = min(TILE_W, max(8, 1 << (w - 1).bit_length()))
    tile_h = min(h, _BATCH_TILE_AREA // tile_w)
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    tiles = nty * ntx
    run = max(1, min(_BATCH_MAX_RUN, batch * tiles // _BATCH_BLOCKS))
    if tiles >= run:
        return tile_h, tile_w, 1, -(-tiles // run)
    return tile_h, tile_w, run // tiles, 1


def stream_applies(mode: str, radius: int, tile_w: int, relaxed: bool = False,
                   npix: Optional[int] = None, is_float: bool = False,
                   width: Optional[int] = None) -> bool:
    """Whether a launch in `mode` runs the row-streaming kernel, else the
    tile body: the standard tier's score, map and row modes (with or
    without halo operands), the precise tier's score and map modes and the
    standard MS-SSIM components and pooled modes (STREAM_MODES), and the
    relaxed tier's score, map, components and pooled modes
    (STREAM_RELAXED_MODES), at every radius the fused kernel serves (1 to
    MAX_FUSED_RADIUS), each with a tile 32 to STRIP_W columns wide; the
    batch modes (STREAM_BATCH_MODES, kBatch in both tiers and
    kBatchPrecise) at every radius 1 to MAX_FUSED_RADIUS whatever tile_w
    (their packed stream has no tile), but given the launch's size and its
    images' width at the radii STREAM_BATCH_TILE_RADII names for its
    (mode, relaxed, input dtype, batch_width_class(width)), where the
    batch tile body was measured faster. The others at a
    tile_w of 256 run the tile body. npix: the launch's B * H * W; the
    components and pooled modes stream only from STREAM_COMP_MIN_PIX
    pixels (at msssim_1080_b4 scales 0 and 1; scales 2-4 run the tile
    body, measured faster there), relaxed from STREAM_RELAXED_COMP_MIN_PIX
    (scale 0); and a relaxed launch given its size keeps the relaxed tile
    body at the radii STREAM_RELAXED_TILE_RADII names for its mode and
    input dtype (is_float: f32), where the tile body was measured faster.
    None: the rule without these conditions, which a pinned segment asks
    for."""
    if mode in STREAM_BATCH_MODES:
        if npix is not None and width is None:
            raise ValueError("the batch modes' rule reads the images' width")
        if npix is not None and radius in STREAM_BATCH_TILE_RADII.get(
                (mode, relaxed, is_float, batch_width_class(width)), ()):
            return False
        return 1 <= radius <= MAX_FUSED_RADIUS and (not relaxed or mode in STREAM_RELAXED_MODES)
    least = STREAM_RELAXED_COMP_MIN_PIX if relaxed else STREAM_COMP_MIN_PIX
    if npix is not None and mode in ("components", "pooled") and npix < least:
        return False
    if npix is not None and relaxed and radius in STREAM_RELAXED_TILE_RADII.get(
            (mode, is_float), ()):
        return False
    served = mode in (STREAM_RELAXED_MODES if relaxed else STREAM_MODES)
    return served and 1 <= radius <= MAX_FUSED_RADIUS and 32 <= tile_w <= STRIP_W


@functools.lru_cache(maxsize=256)
def stream_segment(bsz: int, h: int, w: int, tile_h: int, prologue: int,
                   resident: int, tail: float = 0.0, strip_w: int = STRIP_W) -> int:
    """A row-streaming kernel's segment rows for (bsz, h, w) with tile
    height tile_h, `prologue` input rows read above the segment's first
    output row before it (2r in the forward, 4r in the backward) and
    `resident` blocks on the card at once (its SMs times the kernel's
    occupancy): the multiple of tile_h (1 to MAX_SEG_TILES tiles) that
    minimises the modelled time, the waves of resident blocks times a
    block's rows, the segment plus its prologue and a fixed cost. A last
    partial wave costs a whole one, unless it holds at most `tail` of the
    resident blocks: then it runs beside the others (the backward, 1/20,
    measured so on an H100; the forward's sweeps fit no such allowance,
    PERF.md). strip_w: a block's columns (the relaxed backward's narrower
    strip). Short segments fill the card, long ones recompute fewer halo
    rows."""
    nstrip = -(-w // strip_w)
    best = None
    for k in range(1, MAX_SEG_TILES + 1):
        seg = k * tile_h
        full, rest = divmod(bsz * nstrip * -(-h // seg), resident)
        waves = full + (1 if full == 0 or rest > resident * tail else 0)
        cost = waves * (min(seg, h) + prologue + _BLOCK_OVERHEAD_ROWS)
        if best is None or cost < best[0]:
            best = (cost, seg)
        if seg >= h:
            break
    return best[1]


def stream_blocks(h: int, w: int, seg: int):
    """The output rectangles (y0, y1, x0, x1) that a row-streaming kernel's
    blocks write in one image, in its block order (strips fastest): the
    kernels' own decoding of blockIdx.x."""
    nstrip, nseg = -(-w // STRIP_W), -(-h // seg)
    return [(j * seg, min(h, (j + 1) * seg), i * STRIP_W, min(w, (i + 1) * STRIP_W))
            for j in range(nseg) for i in range(nstrip)]


def batch_pack(batch: int, w: int) -> int:
    """Images of width w side by side in one packed row of the batch
    modes' stream: where w >= 12 is a multiple of 8, the smallest k whose
    row k * w is a multiple of STRIP_W columns (whole strips, as the JAX
    package's bpack_count asks whole lane rows of its p; at most 16); other
    widths STRIP_W // w (at most BATCH_MAX_PIECES), or 1 above STRIP_W, so
    that such an image never straddles two strips. At most `batch`. So a
    strip meets at most BATCH_MAX_PIECES images (at w >= 12, at most
    127 // w + 2)."""
    if w >= 12 and w % 8 == 0:
        k = STRIP_W // math.gcd(w, STRIP_W)
    else:
        k = max(1, min(BATCH_MAX_PIECES, STRIP_W // w))
    return min(k, batch)


@functools.lru_cache(maxsize=256)
def batch_stream_plan(batch: int, h: int, w: int, resident: int,
                      radius: int = STREAM_RADIUS):
    """The batch modes' packed stream for (batch, h, w) at `radius` with
    `resident` blocks on the card at once (its SMs times the kernel's
    occupancy at that radius): (k images a packed row, segment rows). Each
    block takes one strip of one packed row, down all its rows, or, where
    the packed rows alone give fewer blocks than the card holds, down a
    segment of them (a multiple of TILE_H). The choice minimises the waves
    of resident blocks, counted as a fraction (the card starts a block as
    another ends) but at least one, times a block's rows (its output rows
    plus 2r) plus a fixed cost."""
    k = batch_pack(batch, w)
    blocks = -(-batch // k) * -(-(k * w) // STRIP_W)

    def cost(nseg, rows):
        return max(1.0, blocks * nseg / resident) * (rows + _BATCH_BLOCK_OVERHEAD_ROWS)

    best = (cost(1, h + 2 * radius), h)
    for seg in range(TILE_H, h, TILE_H):
        c = cost(-(-h // seg), seg + 2 * radius)
        if c < best[0]:
            best = (c, seg)
    return k, best[1]


def batch_direct(h: int, w: int, k: int, seg: int) -> bool:
    """Whether the batch stream's blocks hold their images' every row and
    column (one segment, each image inside one strip), and so write each
    image's pair themselves; else they write pieces for a second pass."""
    return seg >= h and (k * w <= STRIP_W or STRIP_W % w == 0)


def batch_stream_blocks(batch: int, h: int, w: int, k: int, seg: int):
    """The pieces that the batch stream's blocks sum, in block order
    (strips fastest, then segments, then packed rows): per block a list of
    (image, y0, y1, x0, x1, slot), its output rows [y0, y1) and columns
    [x0, x1) of that image, whose sum it writes to slot `slot` (its strip
    less the image's first) of the image's segment y0 // seg: the kernel's
    own decoding of blockIdx.x."""
    nstrip = -(-(k * w) // STRIP_W)
    nseg = -(-h // seg)
    out = []
    for blk in range(nstrip * nseg * -(-batch // k)):
        strip, rest = blk % nstrip, blk // nstrip
        sg, g = rest % nseg, rest // nseg
        x0, y0, y1 = strip * STRIP_W, sg * seg, min(h, (sg + 1) * seg)
        pieces = []
        for i in range(x0 // w, min(k, batch - g * k)):
            lo, hi = max(x0, i * w), min(x0 + STRIP_W, (i + 1) * w)
            if lo >= hi:
                break
            pieces.append((g * k + i, y0, y1, lo - i * w, hi - i * w,
                           strip - i * w // STRIP_W))
        out.append(pieces)
    return out


@functools.lru_cache(maxsize=256)
def _stream_resident(index: int, mode: str, is_float: bool, relaxed: bool = False,
                     radius: int = STREAM_RADIUS, w: int = 1, k: int = 1) -> int:
    """Streaming-kernel blocks that card `index` holds at once in `mode`
    at `radius` (relaxed: its relaxed instantiation; the batch modes: their
    packed stream, relaxed or not, for images of width w packed k to a
    row, which size the runtime-radius instantiation's staged rows; another
    radius than STREAM_RADIUS: the runtime-radius instantiation with its
    shared memory at that radius): its SMs times the CUDA runtime's
    occupancy for the instantiation (ssim_fwd_stream_occupancy,
    ssim_fwd_batch_occupancy)."""
    from . import _build

    n = ctypes.c_int(0)
    lib = _build.load_library()
    with torch.cuda.device(index):
        if mode in STREAM_BATCH_MODES:
            err = lib.ssim_fwd_batch_occupancy(int(mode == "batch_precise"), int(relaxed),
                                               int(is_float), int(radius), int(w), int(k),
                                               ctypes.byref(n))
        else:
            err = lib.ssim_fwd_stream_occupancy(
                _MODES.index(mode), int(relaxed), int(is_float), int(radius), ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"the streaming kernel's occupancy ({mode}, radius {radius}) "
                           f"failed (cudaError {err}, {n.value} blocks per SM)")
    return torch.cuda.get_device_properties(index).multi_processor_count * n.value


def _tile_reduce(x: torch.Tensor, tile_h: int, tile_w: int, op) -> torch.Tensor:
    """Zero-pad (B, H, W) to whole tiles and reduce each tile with `op`
    over dims (2, 4) of (B, nty, tile_h, ntx, tile_w)."""
    bsz, h, w = x.shape
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    x = torch.nn.functional.pad(x, (0, ntx * tile_w - w, 0, nty * tile_h - h))
    return op(x.reshape(bsz, nty, tile_h, ntx, tile_w))


def sym_blur(x: torch.Tensor, t, dim: int, n: int) -> torch.Tensor:
    """Symmetric tap pairs along `dim`, smallest taps first, as the
    kernels add them: output k reads input k .. k + 2r (n outputs)."""
    r = len(t) // 2
    acc = None
    for d in range(r, 0, -1):
        term = t[r - d] * (x.narrow(dim, r - d, n) + x.narrow(dim, r + d, n))
        acc = term if acc is None else acc + term
    return acc + t[r] * x.narrow(dim, r, n)


def hpass4(ap: torch.Tensor, bp: torch.Tensor, t, n: int):
    """The kernels' horizontal pass of the four signals a, b, (a+b)^2 and
    (a-b)^2 over inputs padded by r columns: n output columns each, in
    the kernels' order of operations."""
    r = len(t) // 2

    def cols(x, k):
        return x[..., k : k + n]

    ma = mb = ss = dd = None
    for d in range(r, 0, -1):
        tk = t[r - d]
        al, ah = cols(ap, r - d), cols(ap, r + d)
        bl, bh = cols(bp, r - d), cols(bp, r + d)
        sl, sh, dl, dh = al + bl, ah + bh, al - bl, ah - bh
        terms = (
            tk * (al + ah), tk * (bl + bh),
            tk * (sl * sl + sh * sh), tk * (dl * dl + dh * dh),
        )
        if ma is None:
            ma, mb, ss, dd = terms
        else:
            ma, mb, ss, dd = (x + y for x, y in zip((ma, mb, ss, dd), terms))
    ac, bc = cols(ap, r), cols(bp, r)
    sc, dc = ac + bc, ac - bc
    return (
        ma + t[r] * ac, mb + t[r] * bc,
        ss + t[r] * (sc * sc), dd + t[r] * (dc * dc),
    )


def relaxed_applies(relaxed: bool, w: int, batch: bool = False) -> bool:
    """Whether a relaxed call runs the relaxed arithmetic: on the batch
    route always, on the tile grid at widths w >= MXU_MIN_W. Below that
    the wrappers run the standard mode, bit for bit the standard tier's,
    as the JAX kernels do (ssim_pallas.py:151, ssim_grad.py:324)."""
    return relaxed and (batch or w >= MXU_MIN_W)


#: Output columns of one band product in band_bf16x3_plain.
_BAND_OUT = 64


def _bf16_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x1, x2) with x1 = bf16(x) and x2 = bf16(x - x1), each rounded to
    nearest even and returned as f32 (the kernels' band_mma::split2)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _band_matrix(t: tuple) -> torch.Tensor:
    """The (64 + 2r, 64) f32 band: H[j + d, j] = t[d]."""
    r = len(t) // 2
    m = np.zeros((_BAND_OUT + 2 * r, _BAND_OUT), np.float32)
    for j in range(_BAND_OUT):
        m[j : j + 2 * r + 1, j] = t
    return torch.from_numpy(m)


def band_bf16x3_plain(x: torch.Tensor, t, n: int, dim: int = -1) -> torch.Tensor:
    """The relaxed tier's band pass: out[k] = sum_j t[j] * x[k + j] along
    `dim` (n outputs from n + 2r inputs), as band products of 64 + 2r input
    columns into 64 output columns with both operands split into bf16
    parts, x1 @ h1 + (x1 @ h2 + x2 @ h1) in f32: the fourth product x2 @ h2
    is dropped (ssim_pallas.py:_make_hpass_mxu(exact=False), :205-219;
    the kernels' band_mma.cuh). The matrix products need TF32 off on a
    card (torch.backends.cuda.matmul.allow_tf32 = False), or the lo parts
    round away."""
    r = len(t) // 2
    x = x.movedim(dim, -1)
    nch = -(-n // _BAND_OUT)
    x = torch.nn.functional.pad(x, (0, nch * _BAND_OUT - n))
    h1, h2 = _bf16_split(_band_matrix(tuple(float(v) for v in t)).to(x.device))
    x1, x2 = _bf16_split(x.unfold(-1, _BAND_OUT + 2 * r, _BAND_OUT))
    out = x1 @ h1 + (x1 @ h2 + x2 @ h1)
    return out.flatten(-2)[..., :n].movedim(-1, dim)


def _sanitize(x: torch.Tensor, clip_bound: float) -> torch.Tensor:
    """f32 of x; for float input nan_to_num and a clip to +-clip_bound,
    as the kernels load every value."""
    xf = x.to(torch.float32)
    if x.dtype != torch.float32:
        return xf
    return torch.nan_to_num(xf, nan=0.0).clamp(-clip_bound, clip_bound)


def _pad_cols(x: torch.Tensor, n: int) -> torch.Tensor:
    """Clamp-to-edge padding of the last dim by n."""
    w = x.shape[-1]
    cols = torch.arange(-n, w + n, device=x.device).clamp_(0, w - 1)
    return x.index_select(-1, cols)


def splice_rows(x, top, bot, is_top, is_bot):
    """(..., H, W) rows with n rows above from `top` and below from `bot`
    (each (..., n, W)); at a flagged edge the band's own edge row
    replicated instead, the operand unread: the kernels' halo-operand row
    rule as one tensor of H + 2n rows."""
    n = top.shape[-2]
    if is_top:
        top = x[..., :1, :].expand(*x.shape[:-2], n, x.shape[-1])
    if is_bot:
        bot = x[..., -1:, :].expand(*x.shape[:-2], n, x.shape[-1])
    return torch.cat([top, x, bot], dim=-2)


def _blurs_plain(a, b, taps, clip_bound, vhalo=None, vmask=(False, False),
                 relaxed=False, dtype=torch.float32):
    """The four blurred signals mu_a, mu_b, s_ss, s_dd of (B, H, W) u8 or
    f32 inputs in the kernel's order of operations, in `dtype` (f32, or
    f64 in the precise modes: the sanitised f32 inputs widened exactly),
    and for f32 the mask of non-finite input pixels (None for u8). vhalo:
    the four (B, r, W) halo operands (a_top, a_bot, b_top, b_bot) with
    their vmask flags, in place of the clamp at the top and bottom rows.
    relaxed: the relaxed modes' horizontal pass, the heavy (a+b)^2 and
    (a-b)^2 blurs as band_bf16x3_plain (the mu blurs and the vertical
    pass as they are).
    The kernels blur horizontally first and the JAX kernel vertically
    first; either order is inside the tier's error."""
    h, w = a.shape[-2], a.shape[-1]
    r = len(taps) // 2
    t = [float(v) for v in taps]
    bad = None
    if a.dtype == torch.float32:
        bad = ~(torch.isfinite(a) & torch.isfinite(b))
    af = _sanitize(a, clip_bound)
    bf = _sanitize(b, clip_bound)
    if vhalo is None:
        ap, bp = _pad_edge(af, r), _pad_edge(bf, r)
    else:
        at, ab, bt, bb = (_sanitize(x, clip_bound) for x in vhalo)
        flags = tuple(bool(f) for f in vmask)
        ap = _pad_cols(splice_rows(af, at, ab, *flags), r)
        bp = _pad_cols(splice_rows(bf, bt, bb, *flags), r)
    ap, bp = ap.to(dtype), bp.to(dtype)
    # Horizontal pass over all H + 2r rows, then the vertical pass.
    if relaxed:
        s, d = ap + bp, ap - bp
        planes = (sym_blur(ap, t, -1, w), sym_blur(bp, t, -1, w),
                  band_bf16x3_plain(s * s, t, w), band_bf16x3_plain(d * d, t, w))
    else:
        planes = hpass4(ap, bp, t, w)
    return tuple(sym_blur(p, t, 1, h) for p in planes), bad


def _sigmas(mu_a, mu_b, s_ss, s_dd):
    """mu_a^2, mu_b^2, mu_a*mu_b, 4*sigma_ab and 2*(sigma_a^2 + sigma_b^2)
    from the four blurs (ssim_pallas.py:470-474)."""
    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_ab_x4 = (s_ss - s_dd) - 4.0 * mu_ab
    sigma_sum_x2 = (s_ss + s_dd) - 2.0 * (mu_a2 + mu_b2)
    return mu_a2, mu_b2, mu_ab, sigma_ab_x4, sigma_sum_x2


def _poison(x, bad, tile_h, tile_w):
    """x with NaN over every tile that holds a non-finite input pixel of
    its own (bad None: x as it is)."""
    if bad is None:
        return x
    h, w = x.shape[-2], x.shape[-1]
    tile_bad = _tile_reduce(bad.to(torch.float32), tile_h, tile_w,
                            lambda v: v.amax(dim=(2, 4))) > 0
    px_bad = tile_bad.repeat_interleave(tile_h, 1).repeat_interleave(
        tile_w, 2)[:, :h, :w]
    return torch.where(px_bad, torch.full_like(x, float("nan")), x)


def _tile_partials(x, tile_h, tile_w):
    """(B, K) per-tile sum(x - 1) + n_valid of a (B, H, W) map, in the
    map's dtype (f32, or f64 in the precise tier)."""
    bsz, h, w = x.shape
    sums = _tile_reduce(x - 1.0, tile_h, tile_w, lambda v: v.sum(dim=(2, 4)))
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    vrows = [min(tile_h, h - i * tile_h) for i in range(nty)]
    vcols = [min(tile_w, w - j * tile_w) for j in range(ntx)]
    n_valid = torch.tensor(np.outer(vrows, vcols), dtype=x.dtype,
                           device=x.device)
    return (sums + n_valid).reshape(bsz, nty * ntx)


def _check_taps(taps, precise):
    """The precise modes take the f64 taps, the others the f32 taps
    (_prepare), so that kernel and twin blur with the same ones."""
    want = np.float64 if precise else np.float32
    if np.asarray(taps).dtype != want:
        raise ValueError(
            f"the {'precise' if precise else 'f32'} modes take "
            f"{np.dtype(want).name} taps, got {np.asarray(taps).dtype}")


def _ssim_map_plain(a, b, dtype, taps, c1, c2, clip_bound, tile_h, tile_w,
                    vhalo=None, vmask=(False, False), relaxed=False):
    """Per-pixel SSIM of the standard, relaxed and precise modes: the blurs
    and the formula of _ssim_from_blurs in `dtype` (f32, or f64 with the
    f64 taps in the precise modes), with NaN over the tiles of non-finite
    inputs."""
    _check_taps(taps, dtype == torch.float64)
    blurs, bad = _blurs_plain(a, b, taps, clip_bound, vhalo, vmask, relaxed, dtype)
    mu_a2, mu_b2, mu_ab, sigma_ab_x4, sigma_sum_x2 = _sigmas(*blurs)
    num = (2.0 * mu_ab + c1) * (0.5 * sigma_ab_x4 + c2)
    den = (mu_a2 + mu_b2 + c1) * (0.5 * sigma_sum_x2 + c2)
    return _poison(num / den, bad, tile_h, tile_w)


def ssim_parts_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    with_map: bool,
    taps: np.ndarray,
    c1: float,
    c2: float,
    clip_bound: float,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    relaxed: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The standard mode's plain twin on (B, H, W) u8 or f32 tensors, on
    any device (relaxed: the relaxed mode's). Returns (partials
    (B, nty*ntx) f32, map (B, H, W) f32 or None)."""
    ssim = _ssim_map_plain(a, b, torch.float32, taps, c1, c2, clip_bound,
                           tile_h, tile_w, relaxed=relaxed)
    partials = _tile_partials(ssim, tile_h, tile_w)
    return partials, (ssim if with_map else None)


def row_sums_plain(ssim: torch.Tensor, tile_w: int = TILE_W) -> torch.Tensor:
    """(B, H) row sums of a (B, H, W) f32 SSIM map as the row modes form
    them: each tile's f32 sum of its columns' ssim - 1, the row's tiles
    added in f64 and rounded to f32, then W added in f32."""
    bsz, h, w = ssim.shape
    ntx = -(-w // tile_w)
    x = torch.nn.functional.pad(ssim - 1.0, (0, ntx * tile_w - w))
    pieces = x.reshape(bsz, h, ntx, tile_w).sum(dim=-1)
    return pieces.to(torch.float64).sum(dim=-1).to(torch.float32) + float(w)


def ssim_rows_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    with_map: bool,
    taps: np.ndarray,
    c1: float,
    c2: float,
    clip_bound: float,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    vhalo=None,
    vmask=(False, False),
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The row modes' plain twin on (B, H, W) u8 or f32 tensors, on any
    device: the standard mode's per-pixel SSIM (with the halo operands
    spliced, or the band's edge rows replicated at a flagged edge, where
    vhalo is given), NaN over each tile of the band's own grid that holds
    a non-finite pixel of its own, then row_sums_plain. Returns (rows
    (B, H) f32, map (B, H, W) f32 or None)."""
    ssim = _ssim_map_plain(a, b, torch.float32, taps, c1, c2, clip_bound,
                           tile_h, tile_w, vhalo, vmask)
    return row_sums_plain(ssim, tile_w), (ssim if with_map else None)


def ssim_parts_precise_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    with_map: bool,
    taps: np.ndarray,
    c1: float,
    c2: float,
    clip_bound: float,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The precise mode's plain twin on (B, H, W) u8 or f32 tensors, on
    any device: the standard mode's blurs in f64 with the f64 taps (the
    inputs widened exactly), the SSIM formula in f64, both in the kernel's
    order, the
    per-tile NaN poison, and f64 tile sums over the same grid. Returns (partials (B, nty*ntx) f64,
    map (B, H, W) f32, the f64 values rounded, or None)."""
    ssim = _ssim_map_plain(a, b, torch.float64, taps, c1, c2, clip_bound,
                           tile_h, tile_w)
    partials = _tile_partials(ssim, tile_h, tile_w)
    return partials, (ssim.to(torch.float32) if with_map else None)


def ssim_parts_batch_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    precise: bool = False,
    *,
    taps: np.ndarray,
    c1: float,
    c2: float,
    clip_bound: float,
    relaxed: bool = False,
) -> torch.Tensor:
    """The batch modes' plain twin on (B, H, W) u8 or f32 tensors, on any
    device: the standard (precise, relaxed) tier's per-pixel SSIM, NaN
    over each image that holds a non-finite input pixel, and each image's
    sum(ssim - 1) in f64. Returns (B, 2) [sum(ssim - 1), H*W], f32 (f64
    with precise)."""
    h, w = a.shape[-2], a.shape[-1]
    dtype = torch.float64 if precise else torch.float32
    ssim = _ssim_map_plain(a, b, dtype, taps, c1, c2, clip_bound, h, w,
                           relaxed=relaxed)
    sums = (ssim - 1.0).to(torch.float64).sum(dim=(1, 2))
    return torch.stack([sums, torch.full_like(sums, h * w)], dim=1).to(dtype)


def ssim_components_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    taps: np.ndarray,
    c1: float,
    c2: float,
    clip_bound: float,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    relaxed: bool = False,
) -> torch.Tensor:
    """The components mode's plain twin on (B, H, W) u8 or f32 tensors, on
    any device (relaxed: the relaxed mode's): lum and cs from the four
    blurs (_l_cs_from_blurs), ssim = lum * cs. Returns (B, nty*ntx, 2) f32
    per-tile [sum(cs - 1) + n_valid, sum(ssim - 1) + n_valid]; a tile with
    a non-finite input pixel of its own has NaN in both."""
    blurs, bad = _blurs_plain(a, b, taps, clip_bound, relaxed=relaxed)
    mu_a2, mu_b2, mu_ab, sigma_ab_x4, sigma_sum_x2 = _sigmas(*blurs)
    lum = (2.0 * mu_ab + c1) / (mu_a2 + mu_b2 + c1)
    cs = (0.5 * sigma_ab_x4 + c2) / (0.5 * sigma_sum_x2 + c2)
    ssim = lum * cs
    return torch.stack([
        _tile_partials(_poison(cs, bad, tile_h, tile_w), tile_h, tile_w),
        _tile_partials(_poison(ssim, bad, tile_h, tile_w), tile_h, tile_w),
    ], dim=-1)


def ssim_components_pooled_plain(
    a: torch.Tensor, b: torch.Tensor, **kw,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pooled mode's plain twin: (ssim_components_plain(a, b, **kw),
    downsample2(a), downsample2(b)), the pooled images (B, H//2, W//2) f32
    from the raw inputs in the kernel's order of additions."""
    return ssim_components_plain(a, b, **kw), downsample2(a), downsample2(b)


#: The kernel's modes, in the order of the C entry's `mode` argument. The
#: precise tier has no components or pooled mode (nor has the TPU
#: kernel's): the C entry refuses any other mode number.
_MODES = ("score", "map", "components", "pooled", "precise", "precise_map",
          "batch", "batch_precise", "rowsum", "rowsum_map")


def _launch(a, b, *, mode, taps, c1, c2, clip_bound, tile_h, tile_w, ipb=1,
            groups=1, vhalo=None, vmask=(False, False), relaxed=False,
            segment=None, pack=None, tile_body=False):
    """Launch the CUDA kernel in `mode` (one of _MODES) on (B, H, W)
    contiguous tensors on one CUDA device; no synchronisation. ipb, groups:
    the tile body's batch modes' images per block and runs per image.
    vhalo, vmask: the row modes' four (B, r, W) halo operands and their two
    flags. relaxed: the mode's relaxed instantiation (score, map,
    components, pooled and batch; the C entry refuses the others). Where
    stream_applies at this launch's size, the row-streaming kernel runs,
    with `segment` rows per block (stream_segment's choice if None); a
    pinned segment runs it wherever stream_applies without the size
    condition; the tile body takes no segment. The batch modes' packed
    stream takes `pack` = (k, segment rows) in place of a segment
    (batch_stream_plan's choice if None), and a pinned pack runs it as a
    pinned segment does. tile_body: run the tile body
    whatever stream_applies says (to time or check the two designs side by
    side).
    Returns the mode's outputs: (partials, map or None) (partials f64 in
    the precise modes, (B, H) row sums in the row modes), (B, K, 2)
    partials, (partials, pooled_a, pooled_b), or the batch modes' (B, 2)
    partials."""
    global LAUNCHES, PRECISE_LAUNCHES, COMPONENTS_LAUNCHES, POOLED_LAUNCHES
    global BATCH_LAUNCHES, BATCH_PRECISE_LAUNCHES, ROWSUM_LAUNCHES
    global ROWSUM_MAP_LAUNCHES, RELAXED_LAUNCHES, STREAM_LAUNCHES
    from . import _build

    lib = _build.load_library()
    bsz, h, w = a.shape
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    if bsz * nty * ntx > 0x7FFFFFFF:
        raise ValueError(f"{bsz * nty * ntx} tiles exceed one launch's grid")
    r = len(taps) // 2
    batch = mode in STREAM_BATCH_MODES
    precise = mode in ("precise", "precise_map", "batch_precise")
    if tile_body and (segment is not None or pack is not None):
        raise ValueError("the tile body takes no segment or pack")
    stream = not tile_body and stream_applies(mode, r, tile_w, relaxed,
                                              None if segment or pack else bsz * h * w,
                                              a.dtype == torch.float32, w)
    if batch and segment is not None:
        raise ValueError("the batch modes' stream takes a pack, not a segment")
    if pack is not None and not (batch and stream):
        raise ValueError(f"only the batch modes' packed stream takes a pack ({mode}"
                         f"{', relaxed' if relaxed else ''}, radius {r})")
    if batch and stream:
        partials = _launch_batch_stream(lib, a, b, precise, relaxed, taps, c1, c2,
                                        clip_bound, pack)
    elif stream:
        seg = segment or stream_segment(
            bsz, h, w, tile_h, 2 * r,
            _stream_resident(a.device.index, mode, a.dtype == torch.float32, relaxed, r))
        if seg % tile_h or not tile_h <= seg <= MAX_SEG_TILES * tile_h:
            raise ValueError(f"segment {seg} is not 1-{MAX_SEG_TILES} tiles of "
                             f"{tile_h} rows")
    elif segment is not None:
        raise ValueError(f"the tile body ({mode}, radius {r}, tile_w {tile_w}"
                         f"{', relaxed' if relaxed else ''}) takes no segment")
    else:
        seg = 0
    comp = mode in ("components", "pooled")
    rows = mode in ("rowsum", "rowsum_map")
    if not (batch and stream):
        partials, ssim_map, pooled = _launch_tile_or_stream(
            lib, a, b, mode=mode, taps=taps, c1=c1, c2=c2, clip_bound=clip_bound,
            tile_h=tile_h, tile_w=tile_w, ipb=ipb, groups=groups, vhalo=vhalo,
            vmask=vmask, relaxed=relaxed, stream=stream, seg=seg)
    if stream:
        STREAM_LAUNCHES += 1
    if relaxed:
        RELAXED_LAUNCHES += 1
    elif rows:
        if mode == "rowsum":
            ROWSUM_LAUNCHES += 1
        else:
            ROWSUM_MAP_LAUNCHES += 1
    elif batch:
        if precise:
            BATCH_PRECISE_LAUNCHES += 1
        else:
            BATCH_LAUNCHES += 1
    elif mode == "pooled":
        POOLED_LAUNCHES += 1
    elif comp:
        COMPONENTS_LAUNCHES += 1
    elif precise:
        PRECISE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    if batch:
        return partials
    if mode == "pooled":
        return partials, pooled[0], pooled[1]
    if comp:
        return partials
    return partials, ssim_map


def _launch_tile_or_stream(lib, a, b, *, mode, taps, c1, c2, clip_bound, tile_h, tile_w,
                           ipb, groups, vhalo, vmask, relaxed, stream, seg):
    """_launch's call of ssim_fwd_launch: the tile body (seg 0) or the
    row-streaming kernel (seg rows a block) in `mode`. Returns (partials,
    map or None, (pooled_a, pooled_b) or (None, None)); raises if the C
    entry refuses the launch."""
    bsz, h, w = a.shape
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    r = len(taps) // 2
    batch = mode in STREAM_BATCH_MODES
    comp = mode in ("components", "pooled")
    rows = mode in ("rowsum", "rowsum_map")
    precise = mode in ("precise", "precise_map", "batch_precise")
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=a.device)
    if comp:
        partials = new(bsz, nty * ntx, 2)
    elif rows:
        partials = new(bsz, h)
    else:
        partials = torch.empty((bsz, 2) if batch else (bsz, nty * ntx),
                               device=a.device,
                               dtype=torch.float64 if precise else torch.float32)
    ssim_map = new(bsz, h, w) if mode in ("map", "precise_map", "rowsum_map") else None
    pooled = (new(bsz, h // 2, w // 2), new(bsz, h // 2, w // 2)) \
        if mode == "pooled" else (None, None)
    if rows:
        scratch = new(bsz, ntx, h)
    elif groups > 1:
        scratch = torch.empty((bsz, groups), dtype=torch.float64, device=a.device)
    else:
        scratch = None
    ptr = lambda x: None if x is None else x.data_ptr()
    halo = (None,) * 4 if vhalo is None else tuple(x.data_ptr() for x in vhalo)
    _check_taps(taps, precise)
    taps_c = (ctypes.c_double * len(taps))(*[float(v) for v in taps])
    with torch.cuda.device(a.device):
        err = lib.ssim_fwd_launch(
            _MODES.index(mode), int(relaxed), int(a.dtype == torch.float32),
            a.data_ptr(),
            b.data_ptr(), partials.data_ptr(), ptr(ssim_map), ptr(pooled[0]),
            ptr(pooled[1]), ptr(scratch), *halo, int(vmask[0]), int(vmask[1]),
            bsz, h, w, r, tile_h, tile_w, ipb, groups, seg,
            ctypes.cast(taps_c, ctypes.c_void_p), c1, c2, clip_bound,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssim_fwd kernel ({mode}{', relaxed' if relaxed else ''}"
            f"{f', streaming, segment {seg}' if stream else ''}) failed "
            f"with CUDA error {err}")
    return partials, ssim_map, pooled


def _launch_batch_stream(lib, a, b, precise, relaxed, taps, c1, c2, clip_bound, pack):
    """_launch's call of ssim_fwd_batch_launch: the batch modes' packed
    stream (relaxed: the relaxed kBatch's) at the taps' radius with pack =
    (k, segment rows), batch_stream_plan's choice at the instantiation's
    occupancy if None. Returns the (B, 2) partials; raises if the plan is
    out of range or the C entry refuses the launch."""
    bsz, h, w = a.shape
    r = len(taps) // 2
    is_float = a.dtype == torch.float32
    mode = "batch_precise" if precise else "batch"
    k, seg = pack or batch_stream_plan(
        bsz, h, w, _stream_resident(a.device.index, mode, is_float, relaxed, r, w,
                                    batch_pack(bsz, w)), r)
    if not (1 <= k <= bsz and 1 <= seg <= h):
        raise ValueError(f"batch stream plan {(k, seg)} out of range for {(bsz, h, w)}")
    _check_taps(taps, precise)
    partials = torch.empty((bsz, 2), device=a.device,
                           dtype=torch.float64 if precise else torch.float32)
    pieces = None if batch_direct(h, w, k, seg) else torch.empty(
        (bsz, -(-h // seg), -(-w // STRIP_W) + 1), dtype=torch.float64, device=a.device)
    taps_c = (ctypes.c_double * len(taps))(*[float(v) for v in taps])
    with torch.cuda.device(a.device):
        err = lib.ssim_fwd_batch_launch(
            int(precise), int(relaxed), int(is_float), a.data_ptr(), b.data_ptr(),
            partials.data_ptr(),
            None if pieces is None else pieces.data_ptr(), bsz, h, w, k, seg, r,
            ctypes.cast(taps_c, ctypes.c_void_p), c1, c2, clip_bound,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssim_fwd kernel ({mode}{', relaxed' if relaxed else ''}, packed "
                           f"stream, radius {r}, k {k}, segment {seg}) failed with CUDA "
                           f"error {err}")
    return partials


def _prepare(a, b, *, data_range, radius, sigma, k1, k2, precise=False):
    """Check what every mode of the kernel needs of its arguments (dtypes
    and the tile are each wrapper's own check) and return the launch's
    keyword arguments: taps (f32, or f64 for the precise modes), c1, c2,
    clip_bound."""
    if not 1 <= radius <= MAX_FUSED_RADIUS:
        raise ValueError(
            f"the fused kernel serves radius 1..{MAX_FUSED_RADIUS}; got "
            f"{radius} — use ssim_parts_torch for larger windows"
        )
    if data_range < 1e-6:
        raise ValueError(f"data_range {data_range} too small (must be >= 1e-6)")
    taps = gaussian_taps(np.float64 if precise else np.float32, radius, sigma)
    c1 = float((k1 * data_range) ** 2)
    c2 = float((k2 * data_range) ** 2)
    if c1 * c2 < 9e-32:
        raise ValueError(
            f"k1/k2 too small for data_range {data_range}: c1*c2 = "
            f"{c1 * c2:g} degenerates in f32 (needs >= 9e-32)"
        )
    if a.shape != b.shape or a.dim() not in (2, 3) or 0 in a.shape:
        raise ValueError(
            f"expected matching non-empty (H, W) or (B, H, W) tensors, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.device != b.device:
        raise ValueError(f"inputs on different devices: {a.device}, {b.device}")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused kernel for device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the fused kernel takes contiguous tensors")
    return dict(taps=taps, c1=c1, c2=c2,
                clip_bound=max(131072.0, 4.0 * float(data_range)))


def _check_tile(tile_h, tile_w, radius, precise=False):
    """A pinned tile the tile modes (precise: the precise modes) can take
    at this radius, or raise."""
    if tile_w not in _TILE_WIDTHS or not 1 <= tile_h <= _MAX_TILE_H:
        raise ValueError(
            f"tile {tile_h}x{tile_w}: tile_w must be one of {_TILE_WIDTHS} "
            f"and tile_h in 1..{_MAX_TILE_H}"
        )
    if smem_bytes(tile_h, tile_w, radius, precise) > _MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"tile {tile_h}x{tile_w} at radius {radius} needs "
            f"{smem_bytes(tile_h, tile_w, radius, precise)} bytes of shared memory "
            f"(at most {_MAX_DYNAMIC_SMEM})"
        )


def _tile_kw(a, b, allow_float, tile_h, tile_w, precise=False, **win):
    """The tile modes' checks and launch keywords (the tile pinned or the
    default TILE_H x TILE_W)."""
    _check_dtypes(a, b, allow_float)
    kw = _prepare(a, b, precise=precise, **win)
    kw["tile_h"] = TILE_H if tile_h is None else int(tile_h)
    kw["tile_w"] = TILE_W if tile_w is None else int(tile_w)
    _check_tile(kw["tile_h"], kw["tile_w"], win["radius"], precise)
    return kw


def _check_halo(a, radius, vhalo, vmask):
    """The JAX package's checks of the halo operands and their flags
    (ssim_pallas.py:1834-1853); returns (vhalo tuple or None, (is_top,
    is_bot) bools)."""
    if vmask is not None and vhalo is None:
        raise ValueError("vmask requires vhalo (it flags the halo operands)")
    if vhalo is None:
        return None, (False, False)
    vhalo = tuple(vhalo)
    want = tuple(a.shape[:-2]) + (radius, a.shape[-1])
    if len(vhalo) != 4 or any(
        not isinstance(x, torch.Tensor) or tuple(x.shape) != want
        or x.dtype != a.dtype or x.device != a.device or not x.is_contiguous()
        for x in vhalo
    ):
        raise ValueError(
            f"vhalo must be 4 contiguous tensors (a_top, a_bot, b_top, "
            f"b_bot) of shape {want}, dtype {a.dtype} on {a.device}; got "
            f"{[(tuple(getattr(x, 'shape', ())), getattr(x, 'dtype', None)) for x in vhalo]}"
        )
    flags = (False, False) if vmask is None else tuple(float(x) > 0 for x in vmask)
    if len(flags) != 2:
        raise ValueError(f"vmask must be (is_top, is_bot), got {vmask!r}")
    return vhalo, flags


def _check_dtypes(a, b, allow_float):
    """uint8 pairs, or float32 pairs with allow_float."""
    float_ok = (
        allow_float and a.dtype == torch.float32 and b.dtype == torch.float32
    )
    if not float_ok and (a.dtype != torch.uint8 or b.dtype != torch.uint8):
        raise ValueError(
            f"the fused kernel is specialized to uint8 inputs; got "
            f"{a.dtype}/{b.dtype} — use allow_float=True for float32 "
            f"images or ssim_parts_torch for wider integer dtypes"
        )


def ssim_parts_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    with_map: bool = False,
    data_range: float = 255.0,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
    allow_float: bool = False,
    precise: bool = False,
    tile_h: Optional[int] = None,
    tile_w: Optional[int] = None,
    rowsum: bool = False,
    vhalo=None,
    vmask=None,
    relaxed: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused-kernel SSIM. a, b: (H, W) or (B, H, W) contiguous tensors,
    uint8 (or, with allow_float=True, float32 in [0, data_range]).

    Returns (partials, map or None): partials is (..., K) f32 per-tile
    sums of per-pixel SSIM over valid pixels, K = ceil(H/tile_h) *
    ceil(W/tile_w) (finalize with engine.finalize_mean); map is
    (..., H, W) f32. On a CUDA tensor the kernel is launched; on a CPU
    tensor the plain twin runs. tile_h / tile_w pin the tile (defaults
    TILE_H x TILE_W).

    precise=True is the precise tier (precision="f64", the reference's
    RMGR_SSIM_USE_DOUBLE build): the blurs (with the f64 taps), the SSIM
    formula and the tile sums in native fp64 (the JAX kernel blurs in f32
    with f32 taps), and partials (..., K) f64, one per tile. Like the
    standard tier it runs the row-streaming kernel where stream_applies
    (every radius, tiles 32 to 128 wide), else the tile body.
    The JAX kernel's precise mode writes 2K f32 partials (df32 hi, lo +
    e); engine.finalize_mean sums either in f64, so the score is the same
    quantity. The map is the f32 rounding of the fp64 values.

    Float inputs are sanitised (NaN -> 0, clip to +-max(131072,
    4*data_range)); a tile whose own pixels include a NaN or inf gets a
    NaN partial and NaN map values, so an invalid input shows in its own
    image's score and no other's.

    rowsum=True returns ((..., H) f32 row sums of SSIM, None) in place of
    the tile partials (ssim_parts_pallas's rowsum; ssim_rows_cuda). It
    excludes with_map and precise.

    vhalo=(a_top, a_bot, b_top, b_bot) and vmask=(is_top, is_bot) mark a,
    b as a row band of a taller image whose halo rows arrive as operands
    (see ssim_rows_cuda). They serve rowsum and with_map, the standard tier
    only, as in the JAX package; with with_map they return (None, map of
    the band's own rows): the tiles' partials over a halo'd band are not
    exposed, and the sharded layer takes the row sums and the map of one
    launch from ssim_rows_cuda.

    relaxed=True is the relaxed tier (accuracy="relaxed"): at W >=
    MXU_MIN_W the heavy (a+b)^2 and (a-b)^2 horizontal blurs run as bf16x3
    band products on the tensor cores (RELAXED_LAUNCHES counts the
    launch), ~2^-17 relative per blur, inside the JAX tests' envelope of
    1e-4 global and 5e-3 per pixel against the f64 oracle; below it the
    standard mode runs, bit for bit. Like the standard tier it runs the
    row-streaming kernel where stream_applies (relaxed: radius 5, tiles 32
    to 128 wide), else the tile body. It excludes precise and the row modes
    (rowsum, vhalo), as the sharded layer never asks for it.
    """
    if relaxed and precise:
        raise ValueError(
            "relaxed (bf16-split blurs) contradicts precise (fp64 formula) "
            "— pick one accuracy tier"
        )
    if relaxed and (rowsum or vhalo is not None or vmask is not None):
        raise ValueError("relaxed serves the tile and batch modes, not the row modes")
    if rowsum and (with_map or precise):
        raise ValueError(
            "rowsum emits per-row sums INSTEAD of the map/partials — "
            "incompatible with with_map and precise"
        )
    if vhalo is not None and not (rowsum or with_map):
        raise ValueError(
            "vhalo serves the sharded layers' rowsum/map modes only "
            "(per-tile partials over a halo'd window are not exposed)"
        )
    if vhalo is not None and precise:
        raise ValueError("vhalo serves the standard tier only, not precise")
    if rowsum or vhalo is not None or vmask is not None:
        rows, ssim_map = ssim_rows_cuda(
            a, b, with_map=with_map, data_range=data_range, radius=radius,
            sigma=sigma, k1=k1, k2=k2, allow_float=allow_float, tile_h=tile_h,
            tile_w=tile_w, vhalo=vhalo, vmask=vmask)
        return (rows, None) if rowsum else (None, ssim_map)
    kw = _tile_kw(a, b, allow_float, tile_h, tile_w, precise, data_range=data_range,
                  radius=radius, sigma=sigma, k1=k1, k2=k2)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    relaxed = relaxed_applies(relaxed, a.shape[-1])
    if a.device.type == "cuda":
        if precise:
            mode = "precise_map" if with_map else "precise"
        else:
            mode = "map" if with_map else "score"
        partials, ssim_map = _launch(a, b, mode=mode, relaxed=relaxed, **kw)
    elif precise:
        partials, ssim_map = ssim_parts_precise_plain(a, b, with_map=with_map, **kw)
    else:
        partials, ssim_map = ssim_parts_plain(a, b, with_map=with_map,
                                              relaxed=relaxed, **kw)
    if squeeze:
        partials = partials[0]
        ssim_map = None if ssim_map is None else ssim_map[0]
    return partials, ssim_map


def ssim_rows_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    with_map: bool = False,
    data_range: float = 255.0,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
    allow_float: bool = False,
    tile_h: Optional[int] = None,
    tile_w: Optional[int] = None,
    vhalo=None,
    vmask=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused-kernel SSIM per row: the kernel's row modes. a, b as in
    ssim_parts_cuda (standard tier).

    Returns ((..., H) f32 row sums of SSIM, map (..., H, W) f32 or None)
    (finalize with engine.finalize_mean(rows, H*W)): each row's
    sum(ssim - 1), its tiles added in order in f64 and rounded to f32,
    plus W in f32. With the map, both come from one launch, so the map is
    never summed for a score.

    vhalo=(a_top, a_bot, b_top, b_bot), each (..., radius, W) of the
    inputs' dtype, marks a, b as a row band of a taller image whose r
    rows above and below arrive as operands (spatial sharding,
    parallel/spatial.py); the kernel reads them in place of the clamp and
    the outputs cover the band's own rows. vmask=(is_top, is_bot) (0/1
    numbers; requires vhalo) flags a band that holds the image's first /
    last row: there the band's edge row is replicated and the operand is
    never read, so raw ring outputs may be passed. Without vmask the
    operands are read at both edges. On a CUDA tensor the kernel is
    launched; on a CPU tensor the plain twin runs.
    """
    kw = _tile_kw(a, b, allow_float, tile_h, tile_w, data_range=data_range,
                  radius=radius, sigma=sigma, k1=k1, k2=k2)
    vhalo, vmask = _check_halo(a, radius, vhalo, vmask)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
        if vhalo is not None:
            vhalo = tuple(x[None] for x in vhalo)
    if a.device.type == "cuda":
        rows, ssim_map = _launch(a, b, mode="rowsum_map" if with_map else "rowsum",
                                 vhalo=vhalo, vmask=vmask, **kw)
    else:
        rows, ssim_map = ssim_rows_plain(a, b, with_map=with_map, vhalo=vhalo,
                                         vmask=vmask, **kw)
    if squeeze:
        rows = rows[0]
        ssim_map = None if ssim_map is None else ssim_map[0]
    return rows, ssim_map


def _components_args(a, b, data_range, radius, sigma, k1, k2):
    if a.dtype != b.dtype or a.dtype not in (torch.uint8, torch.float32):
        raise ValueError(
            f"the components kernel takes uint8 or float32 pairs, got "
            f"{a.dtype}/{b.dtype}"
        )
    return dict(_prepare(a, b, data_range=data_range, radius=radius,
                         sigma=sigma, k1=k1, k2=k2),
                tile_h=TILE_H, tile_w=TILE_W)


def ssim_components_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    data_range: float = 255.0,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
    relaxed: bool = False,
) -> torch.Tensor:
    """Fused-kernel MS-SSIM components. a, b: (H, W) or (B, H, W)
    contiguous uint8 or float32 pairs (float32 as sanitised and poisoned as
    in ssim_parts_cuda; relaxed as there, at W >= MXU_MIN_W).

    Returns (..., K, 2) f32 per-tile sums, [..., 0] of cs and [..., 1] of
    ssim = lum * cs, each as sum(x - 1) + n_valid over the tile's valid
    pixels; means follow by summing over K and dividing by H*W. On a CUDA
    tensor the kernel is launched (the row-streaming kernel from
    STREAM_COMP_MIN_PIX pixels, relaxed from STREAM_RELAXED_COMP_MIN_PIX at
    radius STREAM_RADIUS, the tile body below them and at the relaxed
    tier's other radii: stream_applies); on a CPU tensor the plain twin
    runs.
    """
    kw = _components_args(a, b, data_range, radius, sigma, k1, k2)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    kw["relaxed"] = relaxed_applies(relaxed, a.shape[-1])
    if a.device.type == "cuda":
        parts = _launch(a, b, mode="components", **kw)
    else:
        parts = ssim_components_plain(a, b, **kw)
    return parts[0] if squeeze else parts


def ssim_components_pooled_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    data_range: float = 255.0,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
    relaxed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ssim_components_cuda fused with the MS-SSIM pyramid's 2x2-mean
    downsample of the inputs: one launch returns the per-tile [cs, ssim]
    sums and the pooled next-scale images. a, b and relaxed as in
    ssim_components_cuda, with H, W >= 2 (the pool is exact in either
    tier).

    Returns (parts (..., K, 2), pooled_a, pooled_b), the pooled images f32
    (..., H//2, W//2): (a[2i, 2j] + a[2i+1, 2j]) + (a[2i, 2j+1] +
    a[2i+1, 2j+1]), times 0.25, from the raw inputs (a NaN reaches its own
    pooled pixel), with an odd last row or column dropped. Exact for uint8.
    The kernel design follows stream_applies, as in ssim_components_cuda.
    """
    kw = _components_args(a, b, data_range, radius, sigma, k1, k2)
    if a.shape[-2] < 2 or a.shape[-1] < 2:
        raise ValueError(f"pooling needs H, W >= 2, got {tuple(a.shape)}")
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    kw["relaxed"] = relaxed_applies(relaxed, a.shape[-1])
    if a.device.type == "cuda":
        out = _launch(a, b, mode="pooled", **kw)
    else:
        out = ssim_components_pooled_plain(a, b, **kw)
    return tuple(x[0] for x in out) if squeeze else out


def ssim_parts_batch_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    data_range: float = 255.0,
    precise: bool = False,
    allow_float: bool = False,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
    relaxed: bool = False,
) -> torch.Tensor:
    """Fused-kernel SSIM with one partial pair per image, for batches of
    small images. a, b: (B, H, W) contiguous tensors, uint8 (or, with
    allow_float=True, float32 in [0, data_range]), H * W < 2^24.

    Returns (B, 2) partials [sum(ssim - 1), H*W] (finalize with
    engine.finalize_mean), f32 as in ssim_parts_pallas_bpacked. With
    precise=True the precise tier: the blurs (with the f64 taps), the
    formula and the sums in fp64, and (B, 2) f64 where the JAX kernel writes (B, 3) f32
    [df32 hi, lo, H*W]; engine.finalize_mean and api._device_finalize sum
    the last axis in f64, so the score is the same quantity. Each pixel's
    SSIM is the tile modes' bit for bit; only the order of the sums
    differs. Float inputs are sanitised as in ssim_parts_cuda, and an image
    with a NaN or inf pixel gets a NaN sum, no other image does; the count
    stays H*W. relaxed=True runs the relaxed tier at every width (the JAX
    package applies it to the packed row); it excludes precise. On a CUDA
    tensor the kernel is launched; on a CPU tensor the plain twin runs.

    The design (stream_applies): at every radius, in either tier, the
    packed row stream (relaxed: its heavy blurs as band products; at radii
    other than STREAM_RADIUS its runtime-radius instantiation), but the
    tile body over each image's own tiles (batch_geometry) at the radii
    STREAM_BATCH_TILE_RADII names for the images' width class, where it
    measured faster. Images lie
    k to a packed row (batch_pack: 4 at W = 32, 2 at 64 and 192, 1 at
    128), cut into STRIP_W-column strips, each image's piece of a strip
    blurred from its own clamped columns; a block takes a strip of one
    packed row, down all its rows or a segment of them
    (batch_stream_plan); each image's sum is its columns' sums reduced in
    a fixed order, by one block or, where the image spans blocks, by a
    second pass over their pieces.
    Each launch counts BATCH_LAUNCHES (BATCH_PRECISE_LAUNCHES; relaxed:
    RELAXED_LAUNCHES), the stream's also STREAM_LAUNCHES.
    """
    if relaxed and precise:
        raise ValueError(
            "relaxed (bf16-split blurs) contradicts precise (fp64 formula) "
            "— pick one accuracy tier"
        )
    _check_dtypes(a, b, allow_float)
    if a.dim() != 3:
        raise ValueError(f"the batch modes take a (B, H, W) batch, got {tuple(a.shape)}")
    if a.shape[-2] * a.shape[-1] >= 1 << 24:
        raise ValueError(
            f"the batch modes need H*W < 2^24 for an exact f32 count, got "
            f"{a.shape[-2]}x{a.shape[-1]}"
        )
    kw = _prepare(a, b, data_range=data_range, radius=radius, sigma=sigma,
                  k1=k1, k2=k2, precise=precise)
    if a.device.type == "cuda":
        tile_h, tile_w, ipb, groups = batch_geometry(*a.shape)
        return _launch(a, b, mode="batch_precise" if precise else "batch",
                       tile_h=tile_h, tile_w=tile_w, ipb=ipb, groups=groups,
                       relaxed=relaxed, **kw)
    return ssim_parts_batch_plain(a, b, precise, relaxed=relaxed, **kw)
