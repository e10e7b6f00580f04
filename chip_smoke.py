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
   1/3/8/16 and small-image-batch shapes, and against the f64 oracle on
   the small ones, every output poisoned with NaN before the launch
   (`poisoned_outputs`, the unwritten-output check of ROADMAP Queue 3,
   P6) and every launch through the row stream (its counter);
4. the main path: one `compute_ssim` on NumPy input with no `device`
   (it must run on the card), then `compute_ssim` and `compute_ssim_map`
   on uint8 batches at 1080p x4, 4K x4 and 16K UHD x1, which must go
   through the kernel's row-streaming design (ssim_fwd_stream_kernel: its
   launch counter and the streaming counter must both rise by one per
   call) and give finite scores and maps that agree with the twin; then
   times the kernel and the twin with CUDA events and the whole call with
   the host clock;
5. training: the backward kernel against its plain twin with score,
   g_map and w_cs cotangents and per-image weights at tiny, ragged,
   1080p x4, 20480-wide, radius 1/16 and float-with-NaN shapes, and
   against autograd of the plain path at 1080p x4; five Adam steps on
   `ssim_loss` at 1080p x4 (the loss must fall, each kernel must launch
   exactly five times, the forward through its streaming design) and one
   `ssim_and_map` step with a map cotangent
   at 4K (it must launch the backward kernel with g_map); then times the
   backward kernel and its twin with CUDA events and a whole training
   step with the host clock, and traces five steps with torch.profiler
   for the device's busy time per step and the backward kernel's part of
   it (phases 6 and 9 likewise for their steps);
6. MS-SSIM: the forward kernel's components and pooled-components modes
   (row-streaming since the components redesign) against their plain
   twins (pooled images bit for bit, and for uint8 equal to an exact 2x2
   mean computed on the host; per-image [sum cs, sum ssim] within the
   twin tolerance) at tiny and ragged, 1080p x4, 1x1024x20480,
   float-with-NaN (the NaN reaches only its own image and pooled pixel)
   and custom sigma/k1/k2 shapes; one `compute_ms_ssim` on NumPy uint8
   (4, 1080, 1920) with no `device` (exactly 4 pooled and 1 components
   launch, scales 0 and 1 through the streaming kernel and scales 2-4,
   under `STREAM_COMP_MIN_PIX`, through the tile body; no standard-mode
   launch; scores within 2e-5 of `impl="torch"`), with every scale of its pyramid
   held against the twins at its own shape; the gradient of 1 - `ms_ssim`
   at (4, 1080, 1920) f32 against autograd of `impl="torch"` (2e-5 of
   max|g|); five Adam steps on 1 - `ms_ssim` there (the loss must fall;
   exactly 25 components launches, the 10 of scales 0 and 1 streaming,
   and 25 backward launches), and the components mode against its twin on the trained
   pair; then times each mode, the tile body beside it (a pinned 16x256
   tile) and its twin at the pyramid's shapes with CUDA events and in a
   trace, the whole `compute_ms_ssim` call and a training step with the
   host clock, traces five steps, and prints the bounds of K5;
7. the precise tier (`precision="f64"`): the forward kernel's precise
   modes, with and without the map, against their plain twin (maps bit
   for bit, per-image fp64 scores within 1e-12 relative) at tiny and
   ragged, 1080p x4, 1x1024x20480, float-with-NaN, radius 1/3/8/16 with
   custom sigma/k1/k2 and uint16 shapes, and against the f64 oracle on
   the small ones (each launch through the fp64 streaming kernel, at the
   other radii its runtime-radius instantiation); one
   `compute_ssim(precision="f64")` on NumPy uint8 (4, 1080, 1920) with
   no `device` (exactly one precise launch, the streaming kernel's, no
   other launch, no call of the oracle), then `compute_ssim` at the three
   main-path shapes and `compute_ssim_map` under the f64 default (all
   streaming); then
   times the precise modes, the standard mode beside them and the twin
   with CUDA events at those shapes and at 1x1024x20480,
   `compute_ssim(precision="f64")` with the host clock, and once the
   oracle route it replaced at (1, 1080, 1920);
8. batches of small images (the JAX package's packed route): the forward
   kernel's batch modes (kBatch, kBatchPrecise; one partial pair per
   image; at radius 5 the packed row stream, each launch counted by
   STREAM_LAUNCHES, at the CUSTOM_WINDOWS radii 1, 3, 8 and 16 the tile
   body) against their twin,
   against the tile modes' per-image scores, against the tile body's
   batch mode (pinned) and, on the small shapes, against the f64 oracle,
   at the JAX package's packed-path test shapes, (5, 16, 2048), a tall
   (2, 8192, 64), (3, 50, 1), (2, 1, 1) and (2, 7, 5), f32 with a NaN in
   one image (only that image's score is NaN), the CUSTOM_WINDOWS (radii
   1, 3, 8, 16 with custom sigma/k1/k2), and the routed shapes of (c);
   the route: one
   `compute_ssim` on NumPy uint8 (4096, 64, 64) with no `device` (exactly
   one kBatch launch, a streaming one, and no other), the same with
   `precision="f64"` (exactly one kBatchPrecise launch, streaming, no call
   of the oracle), the same with a tile pin in the config (exactly one
   standard launch), and one Adam step of `ssim_loss` on f32 (256, 64, 64)
   (one kBatch launch, streaming, and one backward launch, the kBatch
   partials held against the twin; the loss falls); then at 32x32 x8192,
   64x64 x4096, 128x128 x1024, 192x192 x512 (u8) and precise 64x64 x4096,
   the batch mode against the tile grid and the tile body's batch mode on
   the same inputs with CUDA events (in turns: tile grid, tile body,
   batch, batch, tile body, tile grid), each beside its bound (precise:
   also the FP64-pipe floor), `compute_ssim` on both routes (the tile
   route by a tile pin; in turns) with the host clock, and the twin;
9. spatial sharding (ssim_tpu_torch.parallel): (a) the forward kernel's
   row modes with halo operands (kRowsum, kRowsumMap) and the backward
   kernel's halo mode against their twins band by band, each band with
   the rows a mesh ring delivers (the other end's rows at the image's
   edges, which the kernels must replace on their flags), at 4K x4 in 4
   bands (u8 and f32), 1080p x4 in 3 bands and in bands of 523, 20, 35
   and 502 rows, the CUSTOM_WINDOWS (radii 1, 3, 8, 16 with custom
   sigma/k1/k2; every launch streaming), f32 with a NaN in a neighbour's
   rows, and NaN-filled operands under a set flag (not
   read); the bands concatenated against the unsharded kernels (the same
   map and the same rows as kMap and kRowsum; gradients against the
   unsharded backward); (b) on a one-rank nccl mesh (a file:// store in a
   temporary directory): `ssim_spatial_sharded` on one u8 (8640, 15360)
   pair, score and map (exactly one kRowsum / kRowsumMap launch with halo
   operands each, through the streaming design, the mean of the rows
   within 2e-7 of `compute_ssim`, the
   map bit for bit `compute_ssim_map`'s), one `mean_ssim_spatial`
   forward and backward on an f32 (8640, 15360) pair (one kRowsum and one
   backward halo launch; value and gradient against `ssim`'s) and the
   batched (4, 2160, 3840) call on a (1, 1) data x space mesh; the plain
   twins are made to raise there; (c) each new mode and its twin with
   CUDA events, the unsharded kernel beside it, the public calls and a
   `mean_ssim_spatial` step with the host clock, and one trace of the
   step;
10. the relaxed tier (`accuracy="relaxed"`: the heavy blurs as bf16x3
   band products on the tensor cores): (a) the forward kernel's relaxed
   kScore / kMap, kComponents, kPooled and kBatch and the backward
   kernel's relaxed mode (± g_map) against their relaxed twins at u8
   1080p x4 and 4K x4, f32 1080p x4, 1x1024x20480 (K2's widths), f32
   (4, 1080, 1920), u8 64x64 x4096 and grad_1080_b4, each also against
   the standard mode (it must differ); the forward against the f64 oracle
   at the JAX tests' envelope on independent random pairs (the tier's
   worst content), custom windows and a NaN; every relaxed kScore / kMap
   launch at radius 5 through the row-streaming kernel, those at radius
   1 and 16 and every relaxed components, pooled and batch launch
   through the tile body (by STREAM_LAUNCHES); below 512 columns a relaxed
   call must launch the standard modes and equal them; (b) the public
   path, each call's launches counted from 0: `compute_ssim(accuracy=
   "relaxed")` at 1080p x4, 4K x4 and 16K x1 (one relaxed launch each,
   streaming, against the twin), two Adam steps on
   `ssim_loss(accuracy="relaxed")` (every relaxed forward launch
   streaming) and on 1 - `ms_ssim(accuracy="relaxed")` at (4, 1080,
   1920) and one `compute_ms_ssim(accuracy="relaxed")` at msssim_1080_b4
   (relaxed at the scales >= 512 wide, on the tile body, and standard
   below, under `STREAM_COMP_MIN_PIX`: the tile body; within 1e-4 of
   `impl="torch"`); of all these calls' relaxed launches exactly the 6
   kScore / kMap ones stream, counted launch by launch apart from the
   standard ones, and no other launch streams; (c) each relaxed mode beside the
   standard mode on the same input with CUDA events (in turns), its twin
   and its bound: kScore and kMap at 1080p x4, 4K x4, 16K x1 and
   1x1024x20480 beside the standard streaming modes;
11. the edge-pad-and-align kernel (K4, csrc/pad.cu): (a) against its twin
   byte for byte (NaN payloads and -0.0 count), and on the small inputs
   against np.pad on the host, at the JAX pad tests' 13 geometries, u8
   and f32 4K x4 -> (4, 2176, 4096), u8 1080p x4 -> (4, 1088, 2176), f32
   and f64 with NaN, -0.0 and +-inf at the edges, u16, unaligned layouts
   (source, destination or both), H = 1, W = 1, and one u8 (16, 8640,
   15360) -> (16, 8672, 15616), an output past 2^31 elements; (b)
   `pad_align` on CUDA tensors at 4K x4 (u8, f32) and 1080p x4, each call
   counted from 0 (exactly one pad launch, no other) with the twin made to
   raise; (c) at 4K x4 the kernel (u8 and f32) with CUDA events and in a
   trace, its twin, and `torch.nn.functional.pad(mode="replicate")` on the
   same f32 input in turns with the kernel (its library call; equal to the
   kernel's output), each beside the bound;
12. the CLI (`ssim_tpu_torch.cli.main`, in this process, its output
   captured), on files the script writes into a temporary directory: an
   RGB 1080p and an RGB 4K pair as binary PPM, and 16 RGB 1080p pairs as
   uncompressed TGA for `--dir`. Every kernel's plain twin is made to
   raise, and each run's launches are counted from 0: per channel at 1080p
   (one streaming kScore launch for the (3, H, W) stack; each printed
   value `compute_ssim` of its plane to the printed digits), `-y` and `-1`
   (one launch each), `.pfm` and `.tga` maps (the PFM bit for bit
   `compute_ssim_map`'s maps, the TGA `quantize_map` of them), `--ms` at
   1080p (4 pooled and 1 components launch, those of >= 2^20 pixels
   streaming; `compute_ms_ssim` of the luminance), `--relaxed` at 4K (one
   relaxed launch, streaming), `--downsample=auto` at 4K (one launch;
   `compute_ssim(..., downsample="auto")` per plane), `--dir --batch=8`
   (two streaming kScore launches; each line `compute_ssim` of the pair's
   luminance), `--impl=host` at 1080p (the host library on the CPU, no
   launch, within 2e-6 of the kernel's scores), PIL made to raise too
   (the port decodes PPM and TGA itself); then `python3 -m
   ssim_tpu_torch.cli` as a fresh process (the same output; its wall
   time) and, by host clock, the median of 5 runs of each call split into
   decode, compute and map write, `--dir` as pairs/s and Mpix/s, its
   launches' CUDA-event time over its host time (the launch share), and
   one torch.profiler trace of `--dir` taken in a fresh process
   (`chip_smoke.py --trace-dir A B`) for the card's busy share; a trace
   with no device activity fails the phase;
13. the data-parallel and multi-process layer (`parallel/batch.py`,
   `parallel/multihost.py`) and the distributed training dry run
   (`entry.py`), on a one-rank nccl group made by
   `multihost.initialize("127.0.0.1:<free port>", 1, 0)` and destroyed at
   the end, every plain twin made to raise and each call's launches
   counted from 0: (a) `ssim_batch_sharded` ± map and `mean_ssim_sharded`
   on u8 (8, 2160, 3840) on a ("data",) mesh (one streaming kScore, kMap
   with the map, each; the partials equal the single-device route's, and
   their scores `engine.compute`'s, bit for bit; the map, a DTensor, has
   `compute_ssim_map`'s map as its local block); (b) the same on u8
   (4096, 64, 64) (one packed batch stream launch; with the map one kMap
   of the tile grid, the map's route as in JAX); (c) `global_mesh` and
   `distribute_batch` of (a)'s frames: the calls on the DTensor equal
   (a)'s bit for bit, and a mesh larger than the world raises; (d) the dry
   run's step at f32 (4, 1080, 1920) on a (1, 1) ("data", "space") mesh:
   the train step (the plain loss, SGD, and the kernel eval: one streaming
   kRowsum with halo operands) and the gradient check (one kRowsum and
   one K3 halo launch, within 2e-5 x max|g| of autograd of the unsharded
   plain path), then `dryrun_multichip(1)` on this group; (e) by host
   clock, median of 10 in turns, each sharded call beside
   `engine.compute` on the same batch, and the full-width step, also in
   one torch.profiler trace (device busy ms, K3's share);
14. the testing layer (`ssim_tpu_torch.testing`) on a one-rank nccl group
   made as in phase 13, every plain twin made to raise on the card: (a)
   each devicebench runner (cuda ± map, precise, relaxed; auto on the
   batch route; grad; msssim; spatial; torch) on a small input: the
   launches read around its CUDA-graph capture (each wrapper called once
   by the eager warm-up and once by the capture, none by the replays),
   five replays equal to the same five iterations run eagerly on the
   card, bit for bit, and within the f32 tier (2e-6 per pixel and
   iteration; relaxed 1e-4; grad 1e-6 x max|g| per element) of the runner
   on the CPU; (b) `device_throughput` on each of bench.py's 17
   configurations (pallas -> cuda, xla -> torch; bench.py's shapes and
   iters), no failure caught, each call's launches counted from 0; (c)
   each configuration whose shape an earlier phase times with CUDA
   events: its Mpix/s between 0.5x and 1.05x of the kernel's rate alone
   (the wrapper's call captured alone in a CUDA graph, CUDA events around
   20 replays: its device time with no host work);
   (d) `report.run_report()` on the card over a synthetic suite written
   with PIL under the suite's file names (the cuda row within 2e-6
   global and 1e-3 per pixel of the oracle; both device columns finite);
15. the forward's row stream at a runtime radius (ssim_fwd_stream_rt.cu):
   (a) all eight of its modes at every radius 1-16 but 5 against their
   twins, outputs poisoned, at the segment the wrapper picks (u8, and f32
   with NaN and inf; the row modes with halo operands of r rows), and at
   radii 1, 8 and 16 on a u8 pair 16500 wide (K2's widths); (b)
   `compute_ssim` with custom windows (radii 1, 3, 8 and 16; score, map,
   precision="f64") on NumPy uint8 4K x4 with no `device`, each call's
   launches counted from 0 (one forward launch, streaming), scores and
   maps against the twin; (c) the stream and the tile body in turns at
   radii 1, 3, 4, 6, 8 and 16 (`tools/fwd_times.radius_times`: u8 kScore
   and kMap at 4K x4, kPrecise at 4K x4, kComponents f32 at 1080p x4,
   kRowsum at 16K) beside each bound, and the twin at radius 8. The relaxed
   tier likewise: (a) its four forward modes at every radius 1-16 but 5
   and its tile body at `fit_tile(32, 256)`, relaxed K3 at its k-step
   edges ± g_map and with halo operands, all poisoned, against the twins;
   (b) relaxed `compute_ssim` with custom windows, three relaxed
   `ssim_loss` steps at radius 9 on f32 1080p x4 (each step's forward and
   K3 launch poisoned and held against its twin), and the relaxed
   components and pooled wrappers on msssim_1080_b4's scale-0 pair at
   radii 9 and 16, each call's launches counted from 0 (streaming but at
   radius 16, where the measured rule keeps the relaxed tile body);
   (c) the relaxed stream and tile body in turns, K3 beside its bound.

Prints phase 12's launches and times as one JSON line (`{"cli": ...}`),
phase 13's as one (`{"parallel": ...}`), phase 14's as one
(`{"devicebench": ...}`: Mpix/s by configuration, whether each runner
ran as a graph, the ratios to the kernels alone, the card), the kernel
records as one JSON line (with each kernel's roofline bound; each
forward entry names the design that ran; `launches_cli`,
`launches_parallel`, `launches_devicebench`: its launches in phases 12,
13 and 14's captures), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Inputs are random, made on the device
from a fixed seed. Imports no JAX. Where it cannot start (no CUDA, or no
`ssim_tpu_torch` package beside it) it prints one line
`{"ok": false, "error": ...}` and exits non-zero.
"""

import contextlib
import json
import os
import socket
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
# Phase 3's first comparison, repeated with fresh pairs at every segment of
# the streaming kMap (ROADMAP Queue 3, P6: it failed once as the script's
# first launch and has not been reproduced).
MAP_REPEAT_SHAPE = (1, 255, 63)
MAP_REPEATS = 100
# The custom windows that phases 3, 7, 8 and 9a hold against the twins: the
# forward's row stream serves radius 5 with its window in registers and
# the others at a radius read at run time (ssim_fwd_stream_rt.cu).
CUSTOM_WINDOWS = (dict(radius=1, sigma=0.8, k1=0.02, k2=0.05),
                  dict(radius=3, sigma=1.2, k1=0.01, k2=0.03),
                  dict(radius=8, sigma=2.5, k1=0.01, k2=0.03),
                  dict(radius=16, sigma=3.0, k1=0.015, k2=0.04))
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
# - K4, the pad kernel (csrc/pad.cu, phase 11): bytes only, one read of
#   (B, H, W) and one write of (B, hp, wp);
# - the batch modes (kBatch, kBatchPrecise: K1e, and the contract of K5,
#   tools/probe_bpack.py): per pixel the standard (precise) forward's
#   operations, u8 inputs, and two f32 (f64) partials per image;
# - precise (the forward's kPrecise mode), all in fp64: as the relaxed
#   bound counts its band products (split_bound), the eight band blurs (4
#   signals x 2 passes) as (2r + 1) multiply-adds each, 2 operations per
#   multiply-add, at the FP64 tensor-core rate of 67 TFLOP/s, and the
#   four signals plus the formula and tile sum, 27, at 34 TFLOP/s (FP64
#   outside the tensor cores; both H100 SXM data sheet), the two times
#   added; one f64 partial (8 bytes) per tile, and with the map 4 bytes
#   per pixel.
HBM_BYTES_PER_S, F32_OPS_PER_S, F64_OPS_PER_S = 3.35e12, 67e12, 34e12
F64_TC_OPS_PER_S = 67e12


def bound_ms(nbytes, ops):
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fwd_bound(shape, itemsize, radius=5, out_bytes=None):
    """out_bytes: the bytes written (default one f32 partial per tile)."""
    bsz, h, w = shape
    npix = bsz * h * w
    tiles = bsz * -(-h // 32) * -(-w // 64)
    out = 4 * tiles if out_bytes is None else out_bytes
    return bound_ms(2 * itemsize * npix + out, (24 * radius + 43) * npix)


def bwd_bound(shape, with_g, radius=5):
    bsz, h, w = shape
    npix = bsz * h * w
    return bound_ms((16 + 4 * with_g) * npix + 8 * bsz,
                    (48 * radius + 116 + with_g) * npix)


def precise_bound(shape, itemsize, with_map=False, radius=5, out_bytes=None):
    """out_bytes: the partials' bytes (default one f64 partial per tile)."""
    bsz, h, w = shape
    npix = bsz * h * w
    tiles = bsz * -(-h // 32) * -(-w // 64)
    out = 8 * tiles if out_bytes is None else out_bytes
    t_bytes = (2 * itemsize * npix + out + 4 * npix * with_map) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * 8 * (2 * radius + 1) / F64_TC_OPS_PER_S
             + 27 / F64_OPS_PER_S) * npix * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def precise_dp_floor(shape, radius=5):
    """The precise modes' floor on the FP64 pipe, a second figure beside
    precise_bound: the kernel is built without FMA contraction (so its maps
    stay bit for bit the twin's), so each fp64 add and multiply is one
    DADD or DMUL, and the pipe issues 64 of them a clock on each SM: 17e12
    a second, half the data sheet's 34 TFLOP/s, which counts a fused
    multiply-add as two. Per pixel 24r + 44: the eight blurs 8 (3r + 1),
    the staged signals 4, the formula with its IEEE division ~30, the
    tile sum 2 (164 at radius 5). Returns ms."""
    bsz, h, w = shape
    return (24 * radius + 44) * bsz * h * w / (F64_OPS_PER_S / 2) * 1e3


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


def twin(a, b, with_map, data_range=255.0, radius=5, sigma=1.5, k1=0.01, k2=0.03,
         relaxed=False):
    from ssim_tpu_torch.ops import ssim_cuda

    return ssim_cuda.ssim_parts_plain(
        a, b, with_map=with_map, relaxed=relaxed,
        taps=ssim_cuda.gaussian_taps(np.float32, radius, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range),
    )


def mismatch_report(a, b, mk, mp, rerun, win):
    """What a failed kernel-to-twin map comparison shows, for its message:
    the pixels that differ (their count, images, rows and columns), the
    kernel and the twin each against the f64 oracle there (which of the two
    is off), and the kernel run again on the same inputs (whether it
    repeats)."""
    from ssim_tpu_torch import reference

    idx = ((mk - mp).abs() > TWIN_PIXEL).nonzero().cpu()
    if idx.shape[0] == 0:
        return "no map pixel differs (the partials do)"
    imgs = sorted(set(idx[:, 0].tolist()))
    _, mo = reference.compute_ssim(a[imgs].cpu().numpy(), b[imgs].cpu().numpy(),
                                   with_map=True, **win)
    mo = np.asarray(mo).reshape((len(imgs),) + tuple(a.shape[-2:]))
    img, ys, xs = idx[:, 0].numpy(), idx[:, 1].numpy(), idx[:, 2].numpy()
    k = mk.cpu().numpy()[img, ys, xs].astype(np.float64)
    t = mp.cpu().numpy()[img, ys, xs].astype(np.float64)
    o = mo[np.searchsorted(imgs, img), ys, xs]
    again = rerun()
    torch.cuda.synchronize()
    first = [(int(i), int(y), int(x), float(kv), float(tv), float(ov))
             for i, y, x, kv, tv, ov in list(zip(img, ys, xs, k, t, o))[:4]]
    return (f"{idx.shape[0]} map pixels differ, images {imgs[:8]}, rows "
            f"{ys.min()}-{ys.max()} ({len(set(ys.tolist()))} of them), columns "
            f"{xs.min()}-{xs.max()}; there kernel vs oracle "
            f"{np.nanmax(np.abs(k - o)):.3g}, twin vs oracle {np.nanmax(np.abs(t - o)):.3g}; "
            f"the kernel again on the same inputs "
            f"{float((again - mp).abs().nan_to_num(0.0).max()):.3g} from the twin; first "
            f"(image, row, column, kernel, twin, oracle): {first}")


def twin_errors(name, a, b, pk, mk, win, rerun):
    """The kernel's partials pk and map mk against the twin on the same
    inputs; returns (global error, pixel error, the kernel's scores). On a
    mismatch it raises with mismatch_report's account (rerun() launches the
    kernel again and returns its map)."""
    npix = a.shape[-1] * a.shape[-2]
    pp, mp = twin(a, b, True, **win)
    gk, gp = scores(pk, npix), scores(pp, npix)
    check(np.array_equal(np.isnan(gk), np.isnan(gp)), f"{name}: NaN scores differ")
    check(torch.equal(mk.isnan(), mp.isnan()), f"{name}: NaN map pixels differ")
    g_err = float(np.nanmax(np.abs(gk - gp), initial=0.0))
    finite = ~mp.isnan()
    p_err = float((mk[finite] - mp[finite]).abs().max()) if finite.any() else 0.0
    pixel_tol = TWIN_PIXEL_R1 if win.get("radius", 5) == 1 else TWIN_PIXEL
    g_tol = max(TWIN_GLOBAL, 2 * pixel_tol / npix**0.5)
    if not (g_err <= g_tol and p_err <= pixel_tol):
        raise RuntimeError(
            f"{name}: kernel vs twin global {g_err:.3g} (tol {g_tol:.3g}), pixel "
            f"{p_err:.3g} (tol {pixel_tol:.3g}); "
            + mismatch_report(a, b, mk, mp, rerun, win))
    return g_err, p_err, gk


class poisoned_outputs:
    """An unwritten-output check by hand (ROADMAP Queue 3, P6; the card's
    machine refuses compute-sanitizer): inside the block every
    floating-point tensor that torch.empty or torch.empty_like makes on the
    card, as the wrappers make their outputs and scratch (the backward its
    da and db with empty_like), is filled with NaN first, so a partial, row
    piece, map pixel or gradient the kernel never writes shows as a
    mismatch with the twin, where the caching allocator could otherwise
    hand back a block that held an earlier launch's right answer. `count`:
    the tensors poisoned."""

    def __enter__(self):
        self.real, self.real_like, self.count = torch.empty, torch.empty_like, 0

        def poison(x):
            if x.is_cuda and x.is_floating_point():
                x.fill_(float("nan"))
                self.count += 1
            return x

        torch.empty = lambda *args, **kw: poison(self.real(*args, **kw))
        torch.empty_like = lambda *args, **kw: poison(self.real_like(*args, **kw))
        return self

    def __exit__(self, *exc):
        torch.empty, torch.empty_like = self.real, self.real_like


def poisoned(fn):
    """fn() with its outputs poisoned (poisoned_outputs); checks that at
    least one was."""
    with poisoned_outputs() as p:
        out = fn()
    check(p.count > 0, "no output was poisoned before the launch")
    return out


def compare_kernel_to_twin(name, a, b, *, oracle=False, **kw):
    """Kernel and twin on the same card tensors, the kernel's outputs
    poisoned with NaN before its launch; the launch must take the row
    stream (its STREAM_LAUNCHES: the map mode streams at every radius
    1-16 at the default tile). Returns max abs error and the kernel's
    scores."""
    from ssim_tpu_torch import reference
    from ssim_tpu_torch.ops import ssim_cuda
    from ssim_tpu_torch.ops.ssim_cuda import ssim_parts_cuda

    def run():
        return poisoned(lambda: ssim_parts_cuda(a, b, with_map=True,
                                                allow_float=a.dtype == torch.float32, **kw))

    npix = a.shape[-1] * a.shape[-2]
    stream = ssim_cuda.STREAM_LAUNCHES
    pk, mk = run()
    torch.cuda.synchronize()
    check(ssim_cuda.STREAM_LAUNCHES - stream == 1,
          f"{name}: {ssim_cuda.STREAM_LAUNCHES - stream} streaming launches, expected 1")
    win = {k: v for k, v in kw.items() if k != "allow_float"}
    g_err, p_err, gk = twin_errors(name, a, b, pk, mk, win, lambda: run()[1])
    line = (f"  {name}: kernel (streaming, outputs poisoned) "
            f"vs twin global {g_err:.3g} pixel {p_err:.3g}")
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


def map_repeats(gen):
    """Phase 3's first comparison again (ROADMAP Queue 3, P6): the streaming
    kMap on MAP_REPEAT_SHAPE, MAP_REPEATS fresh pairs at the picker's
    segment and at each segment it can take (pinned), each held against
    the twin. Returns the worst (global, pixel) error."""
    from ssim_tpu_torch.ops import ssim_cuda

    h = MAP_REPEAT_SHAPE[1]
    th = ssim_cuda.TILE_H
    top = min(ssim_cuda.MAX_SEG_TILES, -(-h // th)) * th
    n, worst_g, worst_p = 0, 0.0, 0.0
    t0 = time.perf_counter()
    for seg in [None] + list(range(th, top + 1, th)):
        for i in range(MAP_REPEATS):
            a, b = pair(gen, MAP_REPEAT_SHAPE)
            kw = ssim_cuda._tile_kw(a, b, False, None, None, data_range=255.0,
                                    radius=5, sigma=1.5, k1=0.01, k2=0.03)

            def run():
                return poisoned(lambda: ssim_cuda._launch(a, b, mode="map", segment=seg,
                                                          **kw))

            pk, mk = run()
            torch.cuda.synchronize()
            g_err, p_err, _ = twin_errors(
                f"u8 {MAP_REPEAT_SHAPE} kMap, segment {seg or 'picked'}, repeat {i}",
                a, b, pk, mk, {}, lambda: run()[1])
            n += 1
            worst_g, worst_p = max(worst_g, g_err), max(worst_p, p_err)
    print(f"  u8 {MAP_REPEAT_SHAPE} kMap repeated: {n} fresh pairs, the picker's segment "
          f"and every one of {th}-{top}: worst global {worst_g:.3g} pixel {worst_p:.3g} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst_g, worst_p


def phase_kernel(gen):
    print("phase 3: kernel against its plain twin on the card", flush=True)
    err = 0.0
    for shape in [(1, 255, 63), (1, 257, 65), (2, 1, 1), (2, 7, 5)]:
        a, b = pair(gen, shape)
        e, _ = compare_kernel_to_twin(f"u8 {shape}", a, b, oracle=True)
        err = max(err, e)
        if shape == MAP_REPEAT_SHAPE:
            err = max(err, *map_repeats(gen))
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
    for win in CUSTOM_WINDOWS:
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


def k3_ms(top):
    """The backward kernel's ms per call in a trace's operations (every
    instantiation of ssim_bwd.cu and ssim_bwd_relaxed_rt.cu: the standard
    and the relaxed stream kernels)."""
    return sum(ms for name, ms in top if "ssim_bwd" in name)


def fwd_ms(top):
    """The forward kernel's ms per call in a trace's operations (every
    instantiation of ssim_fwd.cu: the streaming kernel and the tile body)."""
    return sum(ms for name, ms in top if "ssim_fwd" in name)


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

#: The forward kernel's designs, named in the kernels line: the score,
#: map and row modes at radius 5 stream rows (ssim_cuda.stream_applies,
#: counted by ssim_cuda.STREAM_LAUNCHES), and so do the components and
#: pooled modes (COMP_STREAM_DESIGN) and the precise modes in fp64
#: (PRECISE_STREAM_DESIGN); every other mode keeps the tile body.
STREAM_DESIGN = ("row-streaming column strips (ssim_fwd_stream_kernel: 128 columns, "
                 "one thread each, a register window of 2r + 1 rows)")
COMP_STREAM_DESIGN = (
    "row-streaming column strips (ssim_fwd_stream_kernel<T, kComponents|kPooled>: 128 "
    "columns, one thread each, a register window of 2r + 1 rows) with the components "
    "epilogue: lum and cs per pixel, two warp sums per tile, [sum(cs - 1), sum(ssim - 1)] "
    "+ n per tile; kPooled keeps the strip's raw input rows in a shared-memory ring of 4 "
    "and 64 threads pool rows s - 1 and s at each odd output row; 8 blocks/SM); launches "
    "under STREAM_COMP_MIN_PIX pixels (MS-SSIM scales 2-4): the tile body")
PRECISE_STREAM_DESIGN = (
    "row-streaming column strips in fp64 (ssim_fwd_stream_kernel<T, kPrecise>: 128 "
    "columns, one thread each; a staged row of two double2 planes, blurred across by "
    "thread pairs, two columns each; a window of 2r + 1 rows, mu_a, mu_b and s_ss in "
    "registers, s_dd in a shared-memory ring; 4 blocks/SM)")
RELAXED_STREAM_DESIGN = (
    "row-streaming column strips, relaxed (ssim_fwd_stream_kernel<T, kScore|kMap, 2>: "
    "128 columns, one thread each; the heavy horizontal blurs as bf16x3 mma.sync band "
    "products over the strip's 8 tiles, one plane of one row per warp, every other step "
    "two rows by the block's 4 warps; mu_a, mu_b in a register window, (a+b)^2 and "
    "(a-b)^2 blurs in a shared-memory ring of 2 (2r + 1) rows; 7 blocks/SM); the "
    "components and pooled modes: RELAXED_COMP_STREAM_DESIGN; kBatch: "
    "RELAXED_BATCH_STREAM_DESIGN")
RELAXED_COMP_STREAM_DESIGN = (
    "the relaxed row stream with the components epilogue (ssim_fwd_stream_kernel<T, "
    "kComponents|kPooled, 2>: the relaxed kScore body, two warp sums per tile; kPooled "
    "keeps the strip's raw rows in a shared-memory ring of 4 and pools the last two "
    "rows staged at each odd output row; 6 blocks/SM); launches under "
    "STREAM_RELAXED_COMP_MIN_PIX pixels (MS-SSIM scale 1): the tile body")
RELAXED_BATCH_STREAM_DESIGN = (
    "the packed row stream, relaxed (ssim_fwd_batch_stream_kernel<T, kBatch, 2>: the "
    "relaxed stream's steps over packed rows; the heavy blurs as bf16x3 band products "
    "whose 8 lines are the strip's tiles where each lies in one image (W a multiple of "
    "16, or one image a strip), else the staged row's own tiles (two sweeps), each "
    "output read at its staged centre; an image's clamped rows copy the row before; one "
    "barrier a push; 6 blocks/SM)")

BATCH_STREAM_DESIGN = (
    "packed row-streaming strips (ssim_fwd_batch_stream_kernel: images k to a packed "
    "row, cut into 128-column strips, each image's piece staged with its own clamped "
    "columns; one thread a column, a window of 2r + 1 rows (kBatch: 3 signals in "
    "registers, s_dd in a shared-memory ring, 8 blocks/SM; kBatchPrecise: the precise "
    "stream's fp64 thread pairs, 4 blocks/SM); an image's clamped rows pushed again, not "
    "blurred; a block a strip of a packed row, down all its rows or a segment of them "
    "(ssim_cuda.batch_stream_plan); per-column sums, a segmented warp reduction per "
    "image, batch_pieces_reduce_kernel where an image spans blocks); relaxed kBatch: "
    "RELAXED_BATCH_STREAM_DESIGN; other radii: RT_BATCH_DESIGN")

RT_BATCH_DESIGN = (
    "the packed row stream at a radius read at run time (ssim_fwd_batch_stream_kernel<T, "
    "mode, kSplit, 0>, ssim_fwd_batch_rt.cu: kBatch, kBatchPrecise and the relaxed kBatch "
    "with kSplit = ksteps(r), radius 1-16 but 5): radius 5's packed strips, pushes and "
    "sums, the staged rows sized for the pack's pieces and the window's 2r + 1 pushes of "
    "four signals (one float4, fp64 two double2, a column) in dynamic shared memory, each "
    "thread blurring its own column, the taps in shared memory; relaxed: 4 staged {a, b} "
    "rows, the heavy blurs of 4 pushes, up to four sweeps of the staged row's tiles")
RT_STREAM_DESIGN = (
    "the row stream at a radius read at run time (ssim_fwd_stream_kernel<T, mode, 0, 0>, "
    "ssim_fwd_stream_rt.cu: radius 1-16 but 5): the same strips, segments and steps as "
    "at radius 5, the window's 2r + 1 rows of all four signals in a ring in dynamic "
    "shared memory, one step a loop iteration, the taps in shared memory; 8 blocks/SM "
    "at radii 1-4 down to 3 at 13-16 (precise 4 to 1)")
RELAXED_BWD_STREAM_DESIGN = (
    "row-streaming column strips, relaxed, at radius 5 (ssim_bwd_relaxed_stream_kernel: "
    "128 columns, 9 warps, one per 16-column tile of the 144 mid columns; 8 rows a step; "
    "all sixteen band passes as bf16x3 mma.sync products, the horizontal ones with the "
    "band as A and the 8 rows as lines, split as loaded from f32, the vertical ones with "
    "the band as B, their inputs kept split in bf16 rings of 18 rows, ldmatrix / "
    "stmatrix .trans; 4 barriers per 8 rows; ~108 KB, 2 blocks/SM); other radii: "
    "RT_RELAXED_BWD_DESIGN")
RT_RELAXED_FWD_DESIGN = (
    "the relaxed row stream at a radius read at run time (ssim_fwd_stream_kernel<T, mode, "
    "ksteps(r), 0>, ssim_fwd_stream_rt_relaxed.cu: kScore, kMap, kComponents, kPooled, "
    "radius 1-16 but 5): the radius-5 stream's steps (the heavy blurs of two rows every "
    "other step as bf16x3 band products by the block's 4 warps, 2 or 3 k-steps) with the "
    "runtime-radius stream's window: a ring of 2r + 1 rows of four signals, one float4 a "
    "column, in dynamic shared memory, beside 4 staged {a, b} rows and the heavy blurs "
    "of 4 rows; 7 blocks/SM (6 components / pooled) at small radii down to 2 at 16")
RT_RELAXED_BWD_DESIGN = (
    "the relaxed backward stream at a radius read at run time "
    "(ssim_bwd_relaxed_rt_kernel<kG, kSW, gmap>, ssim_bwd_relaxed_rt.cu, "
    "bwd_relaxed_stream.cuh: radius 1-16 but 5): radius 5's body, rings of 8 + 2r rows, "
    "the k-steps of its group of radii (horizontal 2 up to r = 8, 3 above; vertical 1, 2, "
    "2, 3 by groups of 4 radii), a strip of 128 columns (radii 1-4, 12-15) or one "
    "64-column NaN tile (6-11, 16: ssim_grad.RELAXED_STRIP_W, measured), 2 or 1 blocks/SM")


def phase_main(gen, label):
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import routing, ssim_cuda

    print("phase 4: main path (compute_ssim / compute_ssim_map)", flush=True)
    inputs = {name: pair(gen, shape) for name, shape in MAIN_CONFIGS}
    torch.cuda.synchronize()

    # NumPy input with no device runs on the card.
    a_np, b_np = (x.cpu().numpy() for x in inputs["1080p_b4"])
    ssim_cuda.LAUNCHES = ssim_cuda.STREAM_LAUNCHES = 0
    s_np = ssim_tpu_torch.compute_ssim(a_np, b_np)
    check(ssim_cuda.LAUNCHES == 1 and ssim_cuda.STREAM_LAUNCHES == 1,
          f"NumPy compute_ssim launched the kernel {ssim_cuda.LAUNCHES} times, "
          f"{ssim_cuda.STREAM_LAUNCHES} of them the streaming kernel")
    check(s_np.shape == (4,) and np.isfinite(s_np).all(), f"NumPy scores {s_np}")
    print(f"  NumPy input, no device: 1 launch (the streaming kernel), scores {s_np}",
          flush=True)

    ssim_cuda.LAUNCHES = ssim_cuda.STREAM_LAUNCHES = 0
    results = {}
    for name, shape in MAIN_CONFIGS:
        a, b = inputs[name]
        s = ssim_tpu_torch.compute_ssim(a, b)
        s_map, m = ssim_tpu_torch.compute_ssim_map(a, b)
        results[name] = (s, s_map, m)
    launches, stream = ssim_cuda.LAUNCHES, ssim_cuda.STREAM_LAUNCHES
    check(launches == 2 * len(MAIN_CONFIGS) and stream == launches,
          f"main path launched the kernel {launches} times ({stream} the streaming "
          f"kernel), expected {2 * len(MAIN_CONFIGS)}, all streaming")

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
    return launches, stream, records


def grad_twin(a, b, w_s, w_cs, g_map, data_range=1.0, radius=5, sigma=1.5,
              k1=0.01, k2=0.03, **halo):
    """halo: vhalo and vmask of the backward's halo mode, if any (and
    relaxed, the relaxed mode's twin)."""
    from ssim_tpu_torch.ops import ssim_grad

    return ssim_grad.ssim_grad_plain(
        a, b, w_s, w_cs, g_map,
        taps=ssim_grad.gaussian_taps(np.float32, radius, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range), **halo,
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
    ssim_cuda.LAUNCHES = ssim_cuda.STREAM_LAUNCHES = 0
    ssim_grad.LAUNCHES = 0
    results = [step() for _ in range(5)]
    fwd_launches, bwd_launches = ssim_cuda.LAUNCHES, ssim_grad.LAUNCHES
    fwd_stream = ssim_cuda.STREAM_LAUNCHES
    losses = [float(loss) for loss, _ in results]
    check(fwd_launches == 5 and fwd_stream == 5 and bwd_launches == 5,
          f"5 training steps launched the forward kernel {fwd_launches} ({fwd_stream} "
          f"streaming) and the backward kernel {bwd_launches} times, expected 5 "
          f"(all streaming) and 5")
    check(all(bool(f) for _, f in results), "non-finite gradients in training")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss did not fall: {losses}")
    print(f"  5 Adam steps on ssim_loss {shape}: 1-SSIM {losses}; launches "
          f"forward {fwd_launches} (streaming kernel), backward {bwd_launches}",
          flush=True)

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
              f"{n_ops:.0f} device operations per step; K3 {k3_ms(top):.4f} ms per "
              f"step, {k3_ms(top) / busy:.1%} of the device busy", flush=True)
        for name, ms in top[:8]:
            print(f"    {ms:.4f} ms  {name[:90]}", flush=True)
    records["train_step"] = dict(
        shape=list(shape), step_ms=t_step, step_ms_runs=steps,
        fwd_kernel_ms=t_fwd, adam_ms=t_adam, trace_busy_ms=busy,
        trace_window_ms=window, trace_ops_per_step=n_ops,
        trace_k3_ms=k3_ms(top), trace_top=top[:8])
    return fwd_launches, bwd_launches, max_err, records


def comp_twin(a, b, pooled, data_range=255.0, sigma=1.5, k1=0.01, k2=0.03,
              relaxed=False):
    """The plain twin of the pooled-components mode, (parts, pooled_a,
    pooled_b), or of the components mode, parts."""
    from ssim_tpu_torch.ops import ssim_cuda

    fn = (ssim_cuda.ssim_components_pooled_plain if pooled
          else ssim_cuda.ssim_components_plain)
    return fn(
        a, b, relaxed=relaxed, taps=ssim_cuda.gaussian_taps(np.float32, 5, sigma),
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
    from ssim_tpu_torch.ops import pad, ssim_cuda, ssim_grad

    return dict(standard=ssim_cuda.LAUNCHES, precise=ssim_cuda.PRECISE_LAUNCHES,
                components=ssim_cuda.COMPONENTS_LAUNCHES,
                pooled=ssim_cuda.POOLED_LAUNCHES, batch=ssim_cuda.BATCH_LAUNCHES,
                batch_precise=ssim_cuda.BATCH_PRECISE_LAUNCHES,
                rowsum=ssim_cuda.ROWSUM_LAUNCHES,
                rowsum_map=ssim_cuda.ROWSUM_MAP_LAUNCHES,
                relaxed=ssim_cuda.RELAXED_LAUNCHES,
                backward=ssim_grad.LAUNCHES,
                backward_vhalo=ssim_grad.VHALO_LAUNCHES,
                backward_relaxed=ssim_grad.RELAXED_LAUNCHES,
                pad=pad.PAD_LAUNCHES, stream=ssim_cuda.STREAM_LAUNCHES)


def streamed_by_mode(fn, key=None):
    """fn()'s result and its forward launches that streamed, by mode
    ("relaxed <mode>" for the relaxed ones; 0 where a mode launched only
    the tile body), or by key(launch keywords): STREAM_LAUNCHES read
    around each ssim_cuda._launch, which the wrappers look up in the
    module at each call."""
    from ssim_tpu_torch.ops import ssim_cuda

    launch, by = ssim_cuda._launch, {}
    key = key or (lambda kw: ("relaxed " if kw.get("relaxed") else "") + kw["mode"])

    def spied(*args, **kw):
        before = ssim_cuda.STREAM_LAUNCHES
        out = launch(*args, **kw)
        k = key(kw)
        by[k] = by.get(k, 0) + ssim_cuda.STREAM_LAUNCHES - before
        return out

    ssim_cuda._launch = spied
    try:
        out = fn()
    finally:
        ssim_cuda._launch = launch
    return out, by


def counts_of(**nonzero):
    """The launch counts with every mode at 0 but those given."""
    return dict(dict.fromkeys(launch_counts(), 0), **nonzero)


def counts_of_nonzero(**counts):
    """counts without its zeros: what {k: v for k, v in launch_counts()
    .items() if v} reads when exactly these launched."""
    return {k: v for k, v in counts.items() if v}


def zero_counts():
    from ssim_tpu_torch.ops import pad, ssim_cuda, ssim_grad

    ssim_cuda.LAUNCHES = ssim_cuda.PRECISE_LAUNCHES = 0
    ssim_cuda.COMPONENTS_LAUNCHES = ssim_cuda.POOLED_LAUNCHES = 0
    ssim_cuda.BATCH_LAUNCHES = ssim_cuda.BATCH_PRECISE_LAUNCHES = 0
    ssim_cuda.ROWSUM_LAUNCHES = ssim_cuda.ROWSUM_MAP_LAUNCHES = 0
    ssim_cuda.RELAXED_LAUNCHES = ssim_cuda.STREAM_LAUNCHES = 0
    ssim_grad.LAUNCHES = ssim_grad.VHALO_LAUNCHES = ssim_grad.RELAXED_LAUNCHES = 0
    pad.PAD_LAUNCHES = 0


def phase_msssim(gen, label):
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import ssim_cuda
    from ssim_tpu_torch.ops.ssim_cuda import (
        ssim_components_cuda, ssim_components_pooled_cuda,
    )
    from ssim_tpu_torch.tools.fwd_times import comp_tile_body

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
    s_np, infer_stream = streamed_by_mode(lambda: ssim_tpu_torch.compute_ms_ssim(a_np, b_np))
    infer = launch_counts()
    check(infer == counts_of(components=1, pooled=4, stream=2)
          and infer_stream == {"pooled": 2, "components": 0},
          f"compute_ms_ssim launches {infer}, streaming {infer_stream}; expected 4 pooled "
          f"and 1 components, the pooled ones of scales 0 and 1 streaming")
    s_plain = ssim_tpu_torch.compute_ms_ssim(a_np, b_np, impl="torch")
    d = float(np.abs(s_np - s_plain).max())
    check(s_np.shape == shape[:1] and np.isfinite(s_np).all() and d <= 2e-5,
          f"compute_ms_ssim {s_np} vs impl=torch {s_plain} ({d:.3g})")
    print(f"  compute_ms_ssim NumPy u8 {shape}, no device: launches {infer}, streaming "
          f"{infer_stream}; scores {s_np}; vs impl=\"torch\" on the card {d:.3g}", flush=True)
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
    results, train_stream = streamed_by_mode(lambda: [step() for _ in range(5)])
    train = launch_counts()
    losses = [float(loss) for loss, _ in results]
    check(train == counts_of(components=25, backward=25, stream=10)
          and train_stream == {"components": 10},
          f"5 MS-SSIM training steps launched {train}, streaming {train_stream}; "
          f"expected 25 components (the 10 of scales 0 and 1 streaming) and 25 backward")
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
    # JAX serves with K2); each mode's tile body (a pinned 16x256 tile) and
    # twin beside it. Kernel times by CUDA events around back-to-back calls
    # (the streaming kernel and the tile body in turns) and, from a profiler
    # trace, of the kernel alone (at the last scale the events measure the
    # wrapper's host work, longer than the kernel).
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
        tile = lambda: comp_tile_body(ta, tb, pooled, dr)
        t_t1 = cuda_ms(tile, 20)
        t_k1 = cuda_ms(lambda: fn(ta, tb, data_range=dr), 20)
        t_k2 = cuda_ms(lambda: fn(ta, tb, data_range=dr), 20)
        t_t2 = cuda_ms(tile, 20)
        t_k = min(t_k1, t_k2)
        # Both designs' kernels: ssim_fwd_stream_kernel and ssim_fwd_kernel.
        t_dev = kernel_trace_ms(lambda: fn(ta, tb, data_range=dr), 20, "ssim_fwd")
        t_tdev = kernel_trace_ms(tile, 20, "ssim_fwd")
        t_p = cuda_ms(lambda: comp_twin(ta, tb, pooled, data_range=dr), 5)
        # The two designs on the same input: pooled images bit for bit,
        # per-image means within the twin tolerance (other tile grids).
        got, ref = fn(ta, tb, data_range=dr), tile()
        if pooled:
            check(same(got[1], ref[1]) and same(got[2], ref[2]),
                  f"{name}: pooled images differ from the tile body's")
            got, ref = got[0], ref[0]
        npix = ta.shape[-1] * ta.shape[-2]
        d = float((got.double().sum(-2) - ref.double().sum(-2)).abs().max()) / npix
        check(d <= max(TWIN_GLOBAL, 2 * TWIN_PIXEL / npix**0.5),
              f"{name}: streaming vs tile body means {d:.3g}")
        bnd, by = comp_bound(tuple(ta.shape), ta.element_size(), pooled)
        mpix = ta.numel() / 1e6
        times[name] = dict(shape=list(ta.shape), ms=t_k, turns_ms=[t_k1, t_k2],
                           device_ms=t_dev, tile_body_ms=[t_t1, t_t2],
                           tile_body_device_ms=t_tdev, plain_ms=t_p, bound_ms=bnd,
                           bound_by=by, mpix_s=mpix / t_k * 1e3)
        dev = lambda t: "not recorded" if t is None else f"{t:.4f} ms"
        design = ("streaming" if ssim_cuda.stream_applies(
            "pooled" if pooled else "components", 5, ssim_cuda.TILE_W, npix=ta.numel())
            else "the tile body, under STREAM_COMP_MIN_PIX")
        times[name]["design"] = design
        print(f"  {name} {tuple(ta.shape)} {ta.dtype}: kernel ({design}) {t_k1:.4f} / "
              f"{t_k2:.4f} ms ({mpix / t_k * 1e3:.1f} Mpix/s), in the trace "
              f"{dev(t_dev)}; the tile body (16x256) {t_t1:.4f} / {t_t2:.4f} ms, in the "
              f"trace {dev(t_tdev)} (in turns: tile body, stream, stream, tile body), "
              f"means {d:.3g} apart; plain twin {t_p:.4f} ms; bound {bnd:.4f} ms ({by}) | "
              f"{label}", flush=True)
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
              f"operations per step; K3 {k3_ms(top):.4f} ms per step, "
              f"{k3_ms(top) / t_step:.1%} of the untraced step; the components "
              f"forward {fwd_ms(top):.4f} ms per step ({fwd_ms(top) / busy:.1%} of the "
              f"device busy time)", flush=True)
        for name, ms in top[:8]:
            print(f"    {ms:.4f} ms  {name[:90]}", flush=True)

    # (e) The bounds of K5 (K4's, and its library call, are phase 11's).
    k5 = {}
    for bsz, side in ((1024, 128), (4096, 64)):
        npix = bsz * side * side
        k5[f"{side}x{side}x{bsz}"] = bound_ms(2 * npix + 4 * bsz, (24 * 5 + 43) * npix)
    print("  K5 bounds " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in k5.items())
          + f" | {label}", flush=True)
    records = dict(times=times, infer=infer, train=train, infer_stream=infer_stream,
                   train_stream=train_stream, losses=losses,
                   grad_err=grad_err, grad_scale=grad_scale,
                   compute_ms_ssim_ms=e2e, train_step_ms=steps, trace_busy_ms=busy,
                   trace_window_ms=window, trace_ops_per_step=n_ops,
                   trace_k3_ms=k3_ms(top), trace_fwd_ms=fwd_ms(top), trace_top=top[:8],
                   k5_bounds=k5)
    return err, records


def precise_twin(a, b, with_map, data_range=255.0, radius=5, sigma=1.5, k1=0.01,
                 k2=0.03):
    from ssim_tpu_torch.ops import ssim_cuda

    return ssim_cuda.ssim_parts_precise_plain(
        a, b, with_map=with_map,
        taps=ssim_cuda.gaussian_taps(np.float64, radius, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range),
    )


def compare_precise(name, a, b, *, oracle=None, **kw):
    """Both precise modes (through ops.routing.ssim_parts_auto, which casts
    u16 to f32 as the engine's route does) and the twin on the same card
    tensors; with oracle=(global, pixel), also the f64 oracle. Both
    launches must take the fp64 streaming kernel, which serves every
    radius 1-16 at the default tile (STREAM_LAUNCHES). Returns the largest score or
    map difference from the twin, the kernel's per-image scores and the
    twin's. The default tile is pinned, so that the router keeps a batch
    of small images, which it would send to the batch modes (phase 8), on
    the tile modes held here."""
    from ssim_tpu_torch import reference
    from ssim_tpu_torch.ops import ssim_cuda
    from ssim_tpu_torch.ops.routing import ssim_parts_auto

    npix = a.shape[-1] * a.shape[-2]
    tile = dict(tile_h=ssim_cuda.TILE_H, tile_w=ssim_cuda.TILE_W)
    stream = ssim_cuda.STREAM_LAUNCHES
    pk, none = ssim_parts_auto(a, b, precise=True, **tile, **kw)
    pkm, mk = ssim_parts_auto(a, b, with_map=True, precise=True, **tile, **kw)
    torch.cuda.synchronize()
    check(ssim_cuda.STREAM_LAUNCHES - stream == 2,
          f"{name}: {ssim_cuda.STREAM_LAUNCHES - stream} of 2 precise launches took the "
          f"streaming kernel")
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
    line = (f"  {name}: precise kernel (streaming) vs "
            f"twin: maps bit for bit, scores {rel:.3g} relative")
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
    for win in CUSTOM_WINDOWS:
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
    check(first == counts_of(precise=1, stream=1),
          f'NumPy compute_ssim(precision="f64") launches {first}, expected 1 precise, '
          f"the streaming kernel")
    n_main = 2 + len(MAIN_CONFIGS)
    expected = counts_of(precise=n_main, stream=n_main)
    check(counts == expected, f"precise main path launches {counts}, expected {expected}, "
          f"all streaming")
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
          f"default), {counts['stream']} of them streaming, no other mode, no oracle "
          f"call", flush=True)

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
        floor = precise_dp_floor(shape)
        records[name] = dict(
            shape=list(shape), ms=t_p, map_ms=t_pm, standard_ms=[t_std_a, t_std_b],
            plain_ms=t_plain, bound_ms=bnd, bound_by=by, bound_map_ms=bnd_m,
            dp_floor_ms=floor,
            compute_ssim_f64_ms=statistics.median(e2e), compute_ssim_f64_runs=e2e,
        )
        print(f"  {name} {shape}: precise {t_p:.4f} ms ({mpix / t_p * 1e3:.1f} Mpix/s), "
              f"precise + map {t_pm:.4f} ms, standard {t_std_a:.4f} / {t_std_b:.4f} ms "
              f"(precise / standard {t_p / min(t_std_a, t_std_b):.3f}); twin "
              f"{t_plain:.3f} ms; compute_ssim(precision=\"f64\") "
              f"{statistics.median(e2e):.3f} ms median of 10 ({min(e2e):.3f}-"
              f"{max(e2e):.3f}); bound {bnd:.4f} ms ({by}), {bnd_m:.4f} ms with the "
              f"map; FP64-pipe floor {floor:.4f} ms | {label}", flush=True)
        del inputs[name]
        torch.cuda.empty_cache()
    # Wider than the 16384 lanes of K1's fast path: the JAX package's K2.
    shape = (1, 1024, 20480)
    a, b = pair(gen, shape)
    t_p = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(a, b, precise=True), 20)
    t_plain = cuda_ms(lambda: precise_twin(a, b, False), 5)
    bnd, by = precise_bound(shape, 1)
    floor = precise_dp_floor(shape)
    records["wide"] = dict(shape=list(shape), ms=t_p, plain_ms=t_plain, bound_ms=bnd,
                           bound_by=by, dp_floor_ms=floor)
    print(f"  wide {shape}: precise {t_p:.4f} ms; twin {t_plain:.3f} ms; bound "
          f"{bnd:.4f} ms ({by}); FP64-pipe floor {floor:.4f} ms | {label}", flush=True)
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
    records["launches_stream"] = counts["stream"]
    return launches, err, records


def batch_twin(a, b, precise, data_range=255.0, radius=5, sigma=1.5, k1=0.01,
               k2=0.03, relaxed=False):
    from ssim_tpu_torch.ops import ssim_cuda

    return ssim_cuda.ssim_parts_batch_plain(
        a, b, precise, relaxed=relaxed,
        taps=ssim_cuda.gaussian_taps(np.float64 if precise else np.float32,
                                     radius, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range),
    )


def batch_tile_body(a, b, precise, data_range=255.0, radius=5, sigma=1.5, k1=0.01,
                    k2=0.03):
    """The batch mode on the tile body (ssim_cuda.batch_geometry's tiles,
    the design the batch modes ran before the packed stream), pinned."""
    from ssim_tpu_torch.ops import ssim_cuda

    kw = ssim_cuda._prepare(a, b, data_range=data_range, radius=radius, sigma=sigma, k1=k1,
                            k2=k2, precise=precise)
    tile_h, tile_w, ipb, groups = ssim_cuda.batch_geometry(*a.shape)
    return ssim_cuda._launch(a, b, mode="batch_precise" if precise else "batch",
                             tile_h=tile_h, tile_w=tile_w, ipb=ipb, groups=groups,
                             tile_body=True, **kw)


def batch_stream_pinned(a, b, precise, relaxed=False, data_range=255.0, radius=5, sigma=1.5,
                        k1=0.01, k2=0.03):
    """The batch mode on the packed stream at batch_stream_plan's pack,
    pinned (so it streams where the measured rule would keep the tile
    body)."""
    from ssim_tpu_torch.ops import ssim_cuda

    bsz, h, w = a.shape
    mode = "batch_precise" if precise else "batch"
    kw = ssim_cuda._prepare(a, b, data_range=data_range, radius=radius, sigma=sigma, k1=k1,
                            k2=k2, precise=precise)
    k = ssim_cuda.batch_pack(bsz, w)
    res = ssim_cuda._stream_resident(a.device.index, mode, a.dtype == torch.float32, relaxed,
                                     radius, w, k)
    pack = ssim_cuda.batch_stream_plan(bsz, h, w, res, radius)
    tile_h, tile_w, ipb, groups = ssim_cuda.batch_geometry(bsz, h, w)
    return ssim_cuda._launch(a, b, mode=mode, tile_h=tile_h, tile_w=tile_w, ipb=ipb,
                             groups=groups, relaxed=relaxed, pack=pack, **kw)


def compare_batch(name, a, b, *, oracle=None, **kw):
    """Both batch modes, their outputs poisoned before the launch
    (poisoned_outputs), against their twin, the tile modes' per-image
    scores and the tile body's batch mode (pinned) on the same card
    tensors; each batch launch must take the design the rule gives
    (STREAM_LAUNCHES: the packed stream, ssim_fwd_batch.cu at radius 5,
    ssim_fwd_batch_rt.cu's runtime radius at the others, but the tile body
    at the radii ssim_cuda.STREAM_BATCH_TILE_RADII names, where the stream
    is also launched pinned and held against the twin); with
    oracle=(standard global, precise global), also the f64 oracle. Returns
    the largest score difference from the twin and each mode's per-image
    scores."""
    from ssim_tpu_torch import reference
    from ssim_tpu_torch.ops import ssim_cuda

    bsz, h, w = a.shape
    npix = h * w
    allow = a.dtype == torch.float32
    err, got, parts = 0.0, {}, []
    for precise in (False, True):
        mode = "batch_precise" if precise else "batch"
        streams = ssim_cuda.stream_applies(mode, kw.get("radius", 5), ssim_cuda.TILE_W,
                                           npix=bsz * npix, is_float=allow, width=w)
        before = ssim_cuda.STREAM_LAUNCHES
        pk = poisoned(lambda: ssim_cuda.ssim_parts_batch_cuda(a, b, precise=precise,
                                                              allow_float=allow, **kw))
        streamed = ssim_cuda.STREAM_LAUNCHES - before
        tag = "kBatchPrecise" if precise else "kBatch"
        check(streamed == int(streams), f"{name}: {tag} streamed {streamed} launches, "
              f"expected {int(streams)}")
        tk, _ = ssim_cuda.ssim_parts_cuda(a, b, precise=precise, allow_float=allow, **kw)
        if streams:
            other, bk = "tile body", batch_tile_body(a, b, precise, **kw)
        else:
            # The rule kept the tile body: the stream, pinned, is held too.
            before = ssim_cuda.STREAM_LAUNCHES
            other, bk = "pinned stream", poisoned(lambda: batch_stream_pinned(a, b, precise,
                                                                              **kw))
            check(ssim_cuda.STREAM_LAUNCHES == before + 1,
                  f"{name}: {tag} pinned stream did not stream")
        torch.cuda.synchronize()
        check(tuple(pk.shape) == (bsz, 2)
              and pk.dtype == (torch.float64 if precise else torch.float32),
              f"{name}: {tag} partials {tuple(pk.shape)} {pk.dtype}")
        check(bool((pk[:, 1] == npix).all()), f"{name}: {tag} count column is not {npix}")
        gk = scores(pk, npix)
        for label, ref in (("twin", batch_twin(a, b, precise, **kw)), ("tile modes", tk),
                           (other, bk)):
            gr = scores(ref, npix)
            check(np.array_equal(np.isnan(gk), np.isnan(gr)), f"{name}: {tag} NaN vs {label}")
            diff = np.abs(gk - gr)
            e = float(np.nanmax(diff / np.abs(gr) if precise else diff, initial=0.0))
            tol = PRECISE_REL if precise else TWIN_GLOBAL
            check(e <= tol, f"{name}: {tag} vs {label} {e:.3g} (tol {tol:g})")
            if label == "twin":
                err = max(err, float(np.nanmax(diff, initial=0.0)))
            parts.append(f"{tag} vs {label} {e:.3g}")
        got[precise] = gk
    if oracle is not None:
        wo, _ = reference.compute_ssim(a.cpu().numpy().astype(np.float64),
                                       b.cpu().numpy().astype(np.float64), **kw)
        wo = np.atleast_1d(np.asarray(wo))
        for precise, base in ((False, oracle[0]), (True, oracle[1])):
            pixel = PRECISE_PIXEL if precise else ORACLE_PIXEL
            tol = max(base, 2 * pixel / npix**0.5) if (npix < 64 or not precise) else base
            o = float(np.abs(got[precise] - wo).max())
            check(o <= tol, f"{name}: {'precise' if precise else 'standard'} batch vs "
                  f"oracle {o:.3g} (tol {tol:.3g})")
            parts.append(f"{'precise' if precise else 'standard'} vs f64 oracle {o:.3g}")
    print(f"  {name}: " + ", ".join(parts) + " (precise relative)", flush=True)
    return err, got


# The batch modes with a custom window (phase 8(a)): the odd shapes of
# 8(a) at every window of CUSTOM_WINDOWS (the oracle where a call holds at
# most BATCH_ORACLE_PIX pixels), a NaN image, and the relaxed kBatch at an
# aligned width (64: the strip's 16-column tiles) and a straddling one (40:
# the staged row's tiles).
BATCH_ODD_SHAPES = [(3, 33, 47), (2, 30, 200), (5, 11, 11), (3, 50, 1), (5, 16, 2048),
                    (2, 8192, 64), (2, 1, 1), (2, 7, 5)]
BATCH_ORACLE_PIX = 1 << 17
RELAXED_BATCH_RT_SHAPES = ((256, 64, 64), (256, 40, 40))
BATCH_RT_SEED = SEED + 8


def batch_custom_windows(gen):
    """8(a) at the runtime radius: compare_batch (both modes poisoned, on
    the design the measured rule gives, against the twin, the tile modes,
    the other design pinned and the f64 oracle) on BATCH_ODD_SHAPES at each
    of CUSTOM_WINDOWS; an f32 batch with a NaN in image 5 at radius 16 (NaN
    there alone, and image 6 alone equal to image 6 in the batch); the
    relaxed kBatch, poisoned, at RELAXED_BATCH_RT_SHAPES and each custom
    window (the wrapper's launch, and the stream pinned where the rule
    keeps the tile body) against its relaxed twin and its relaxed tile
    body (pinned), differing from the standard kBatch, and 16 images
    within the tier's bound of the f64 oracle. Returns the largest
    standard error from the twin."""
    from ssim_tpu_torch import reference
    from ssim_tpu_torch.ops import ssim_cuda

    err, rel_err, body_err, n = 0.0, 0.0, 0.0, 0
    for win in CUSTOM_WINDOWS:
        for shape in BATCH_ODD_SHAPES:
            a, b = pair(gen, shape)
            held = shape[0] * shape[1] * shape[2] <= BATCH_ORACLE_PIX
            e, _ = compare_batch(f"u8 {shape} radius {win['radius']}", a, b,
                                 oracle=(ORACLE_GLOBAL, DOUBLE_GLOBAL) if held else None, **win)
            err = max(err, e)
            n += 2
    win = CUSTOM_WINDOWS[-1]
    a, b = pair(gen, (64, 64, 64), torch.float32, 1.0)
    a[5, 40, 17] = float("nan")
    e, got = compare_batch(f"f32 (64, 64, 64) NaN in image 5, radius {win['radius']}", a, b,
                           data_range=1.0, **win)
    _, alone = compare_batch(f"f32 image 6 alone, radius {win['radius']}", a[6:7].contiguous(),
                             b[6:7].contiguous(), data_range=1.0, **win)
    for precise, g in got.items():
        check(np.isnan(g[5]) and np.isfinite(np.delete(g, 5)).all()
              and alone[precise][0] == g[6],
              f"radius {win['radius']} NaN isolation (precise={precise}): scores {g}")
    err = max(err, e)
    n += 4
    for shape in RELAXED_BATCH_RT_SHAPES:
        a, b = pair(gen, shape)
        for win in CUSTOM_WINDOWS:
            name = f"relaxed kBatch u8 {shape} radius {win['radius']}"
            kw = ssim_cuda._prepare(a, b, data_range=255.0, **win)
            th, tw, ipb, groups = ssim_cuda.batch_geometry(*shape)
            streams = int(ssim_cuda.stream_applies("batch", win["radius"], ssim_cuda.TILE_W,
                                                   True, shape[0] * shape[1] * shape[2],
                                                   width=shape[2]))
            before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
            run = lambda: ssim_cuda.ssim_parts_batch_cuda(a, b, relaxed=True, **win)
            rk = poisoned(run)
            torch.cuda.synchronize()
            check((ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
                  == (before[0] + streams, before[1] + 1),
                  f"{name}: {ssim_cuda.STREAM_LAUNCHES - before[0]} streaming launches, "
                  f"expected {streams}")
            rel_err = max(rel_err, relaxed_batch_errors(name, a, b, lambda: rk, **win))
            if not streams:
                # The rule kept the tile body: the stream, pinned, is held too.
                before = ssim_cuda.STREAM_LAUNCHES
                rel_err = max(rel_err, relaxed_batch_errors(
                    f"{name} pinned stream", a, b, lambda: poisoned(
                        lambda: batch_stream_pinned(a, b, False, relaxed=True, **win)), **win))
                check(ssim_cuda.STREAM_LAUNCHES == before + 1,
                      f"{name}: the pinned stream did not stream")
            body_err = max(body_err, relaxed_batch_errors(
                f"{name} tile body", a, b, lambda: poisoned(lambda: ssim_cuda._launch(
                    a, b, mode="batch", relaxed=True, tile_body=True, tile_h=th, tile_w=tw,
                    ipb=ipb, groups=groups, **kw)), **win))
            sk = ssim_cuda.ssim_parts_batch_cuda(a, b, **win)
            torch.cuda.synchronize()
            npix = shape[1] * shape[2]
            gk, gs = (x[:, 0].double().cpu().numpy() / npix for x in (rk, sk))
            an, bn = a[:16].cpu().numpy(), b[:16].cpu().numpy()
            o = max(abs(gk[i] + 1.0 - reference.compute_ssim(an[i], bn[i], **win)[0])
                    for i in range(16))
            check(np.abs(gk - gs).max() > 0 and o <= RELAXED_ORACLE_GLOBAL,
                  f"{name}: vs standard {np.abs(gk - gs).max():.3g}, vs oracle {o:.3g}")
            n += 1
    print(f"  custom windows (radii {[w['radius'] for w in CUSTOM_WINDOWS]}): {n} batch "
          f"calls, each with the runtime-radius packed stream held (the wrapper's launch, or "
          f"pinned where the measured rule keeps the tile body), outputs poisoned: the odd "
          f"shapes of 8(a), an f32 NaN image at radius 16, the relaxed kBatch at W = 64 and "
          f"40; largest error from the twin {err:.3g} (relaxed {rel_err:.3g}, its tile body "
          f"{body_err:.3g})", flush=True)
    return err


BATCH_CONFIGS = [("32x32_b8192", (8192, 32, 32), False),
                 ("64x64_b4096", (4096, 64, 64), False),
                 ("128x128_b1024", (1024, 128, 128), False),
                 ("192x192_b512", (512, 192, 192), False),
                 ("64x64_b4096_f64", (4096, 64, 64), True)]


def phase_batch(gen, label):
    import dataclasses

    import ssim_tpu_torch
    from ssim_tpu_torch import config, reference
    from ssim_tpu_torch.ops import routing, ssim_cuda

    print("phase 8: batches of small images (kBatch / kBatchPrecise)", flush=True)
    # (a) Both modes against the twin, the tile modes, the tile body's batch
    # mode and the oracle. The routed shapes of (c) are held there, before
    # they are timed.
    err = 0.0
    std_oracle = (ORACLE_GLOBAL, PRECISE_GLOBAL)
    for shape in [(4, 64, 64), (3, 33, 47), (2, 30, 200), (5, 11, 11), (3, 50, 1),
                  (5, 16, 2048), (2, 8192, 64), (2, 1, 1), (2, 7, 5)]:
        a, b = pair(gen, shape)
        e, _ = compare_batch(f"u8 {shape}", a, b, oracle=std_oracle)
        err = max(err, e)
    a, b = pair(gen, (64, 64, 64), torch.float32, 1.0)
    a[5, 40, 17] = float("nan")
    e, got = compare_batch("f32 (64, 64, 64) NaN in image 5", a, b, data_range=1.0)
    for precise, g in got.items():
        check(np.isnan(g[5]) and np.isfinite(np.delete(g, 5)).all(),
              f"NaN isolation (precise={precise}): scores {g}")
    e1, g1 = compare_batch("f32 image 6 alone", a[6:7].contiguous(), b[6:7].contiguous(),
                           data_range=1.0, oracle=std_oracle)
    check(g1[False][0] == got[False][6] and g1[True][0] == got[True][6],
          "image 6 alone differs from image 6 in the batch")
    print("  NaN reaches only image 5; image 6 alone equals image 6 in the batch",
          flush=True)
    err = max(err, e, e1)
    # A NaN in the first row a block stages (row 0), in warp 3's column.
    a, b = pair(gen, (4, 64, 64), torch.float32, 1.0)
    a[1, 0, 40] = float("nan")
    e2, got = compare_batch("f32 (4, 64, 64) NaN in row 0 of image 1", a, b, data_range=1.0)
    for precise, g in got.items():
        check(np.isnan(g[1]) and np.isfinite(np.delete(g, 1)).all(),
              f"NaN in row 0 (precise={precise}): scores {g}")
    err = max(err, e2)
    for win in CUSTOM_WINDOWS:
        a, b = pair(gen, (4, 64, 64))
        e, _ = compare_batch(f"u8 (4, 64, 64) {win}", a, b,
                             oracle=(ORACLE_GLOBAL, DOUBLE_GLOBAL), **win)
        err = max(err, e)
    # Its own generator, so that every later phase draws the inputs it drew
    # before these checks existed.
    err_rt = batch_custom_windows(torch.Generator(device="cuda").manual_seed(BATCH_RT_SEED))
    err = max(err, err_rt)

    # (b) The route: compute_ssim on NumPy u8 with no device, in both
    # tiers and with a tile pin; one ssim_loss step on an f32 batch.
    a, b = pair(gen, (4096, 64, 64))
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    oracle_calls = []
    real_oracle = reference.compute_ssim

    def counted_oracle(*args, **kw):
        oracle_calls.append(args[0].shape)
        return real_oracle(*args, **kw)

    route = {}
    old_cfg = config.get_config()
    torch.cuda.synchronize()
    reference.compute_ssim = counted_oracle
    try:
        zero_counts()
        s = ssim_tpu_torch.compute_ssim(a_np, b_np)
        route["compute_ssim"] = launch_counts()
        zero_counts()
        s64 = ssim_tpu_torch.compute_ssim(a_np, b_np, precision="f64")
        route["compute_ssim_f64"] = launch_counts()
        config.set_config(dataclasses.replace(old_cfg, max_tile_h=32, max_tile_w=64))
        try:
            zero_counts()
            s_tile = ssim_tpu_torch.compute_ssim(a_np, b_np)
            route["compute_ssim_tile_pin"] = launch_counts()
        finally:
            config.set_config(old_cfg)
    finally:
        reference.compute_ssim = real_oracle
    check(route["compute_ssim"] == counts_of(batch=1, stream=1),
          f"compute_ssim launches {route['compute_ssim']}, expected 1 kBatch (the packed "
          f"stream)")
    check(route["compute_ssim_f64"] == counts_of(batch_precise=1, stream=1),
          f'compute_ssim(precision="f64") launches {route["compute_ssim_f64"]}, '
          f"expected 1 kBatchPrecise (the packed stream)")
    check(oracle_calls == [], f"the f64 oracle was called: {oracle_calls}")
    check(route["compute_ssim_tile_pin"] == counts_of(standard=1, stream=1),
          f"compute_ssim with a tile pin launches {route['compute_ssim_tile_pin']}, "
          f"expected 1 standard (the streaming kernel)")
    npix = 64 * 64
    g_twin = scores(batch_twin(a, b, False), npix)
    g_twin64 = scores(batch_twin(a, b, True), npix)
    check(s.shape == (4096,) and np.isfinite(s).all()
          and np.abs(s - g_twin).max() <= TWIN_GLOBAL
          and np.abs(s_tile - g_twin).max() <= TWIN_GLOBAL,
          "compute_ssim on the batch or the tile route differs from the twin")
    check(np.isfinite(s64).all()
          and (np.abs(s64 - g_twin64) / np.abs(g_twin64)).max() <= PRECISE_REL,
          'compute_ssim(precision="f64") differs from the twin')
    shape = (256, 64, 64)
    clean = torch.rand(shape, generator=gen, device="cuda")
    noisy = (clean + 0.15 * torch.randn(shape, generator=gen, device="cuda")).clamp_(0, 1)
    x = noisy.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=0.02)
    # The step's own batch launch is held against the twin: a spy keeps
    # its inputs and partials.
    seen = []
    real_batch = routing.ssim_parts_batch_cuda

    def spy(*args, **kw):
        out = real_batch(*args, **kw)
        seen.append((args[0].detach().clone(), args[1].detach().clone(), out.clone()))
        return out

    torch.cuda.synchronize()
    routing.ssim_parts_batch_cuda = spy
    try:
        zero_counts()
        loss = ssim_tpu_torch.ssim_loss(x, clean)
        loss.backward()
        finite = bool(torch.isfinite(x.grad).all())
        opt.step()
        route["ssim_loss_step"] = launch_counts()
    finally:
        routing.ssim_parts_batch_cuda = real_batch
    with torch.no_grad():
        after = ssim_tpu_torch.ssim_loss(x.clamp(0.0, 1.0), clean)
    losses = [loss.detach().item(), after.item()]
    check(route["ssim_loss_step"] == counts_of(batch=1, backward=1, stream=1)
          and len(seen) == 1,
          f"ssim_loss step launches {route['ssim_loss_step']}, expected 1 kBatch (the "
          f"packed stream) and 1 backward")
    sa, sb, sp = seen[0]
    step_err = float(np.abs(scores(sp, npix) - scores(
        batch_twin(sa, sb, False, data_range=1.0), npix)).max())
    check(step_err <= TWIN_GLOBAL, f"ssim_loss step: kBatch vs twin {step_err:.3g}")
    err = max(err, step_err)
    del seen, sa, sb, sp
    check(finite and all(np.isfinite(losses)) and losses[1] < losses[0],
          f"ssim_loss step: losses {losses}, finite gradient {finite}")

    def step():
        opt.zero_grad(set_to_none=True)
        ssim_tpu_torch.ssim_loss(x, clean).backward()
        opt.step()
        with torch.no_grad():
            x.clamp_(0.0, 1.0)

    step_host = host_times(step, 20)
    step_busy, _, step_ops, _ = device_trace(step, 10)
    route_step_ms = dict(host_ms=statistics.median(step_host), host_runs=step_host,
                         trace_busy_ms=step_busy, trace_ops_per_step=step_ops)
    launches = sum(c["batch"] + c["batch_precise"] for c in route.values())
    launches_stream = sum(c["stream"] for k, c in route.items() if k != "compute_ssim_tile_pin")
    print(f"  compute_ssim NumPy u8 (4096, 64, 64), no device: {route['compute_ssim']}; "
          f"precision=\"f64\": {route['compute_ssim_f64']}, oracle calls 0; tile pin: "
          f"{route['compute_ssim_tile_pin']}; scores on both routes within "
          f"{float(np.abs(s - s_tile).max()):.3g}", flush=True)
    print(f"  ssim_loss Adam step f32 {shape}: {route['ssim_loss_step']}; its kBatch "
          f"partials vs twin {step_err:.3g}; 1-SSIM {losses[0]:.6f} -> "
          f"{losses[1]:.6f}; step {route_step_ms['host_ms']:.4f} ms (host clock, median "
          f"of 20), device busy "
          f"{'not measured' if step_busy is None else f'{step_busy:.4f} ms'} per step "
          f"(trace of 10) | {label}", flush=True)
    del x, opt, clean, noisy

    # (c) At the routed shapes: both modes held against the twin, the tile
    # modes and the tile body, then on the same inputs in turns the tile
    # grid, the tile body's batch mode (the design before the packed
    # stream), the batch mode twice, the tile body, the tile grid;
    # compute_ssim on both routes, the twin.
    times = {}
    for name, shape, precise in BATCH_CONFIGS:
        a, b = pair(gen, shape)
        e, _ = compare_batch(f"u8 {shape}", a, b)
        err = max(err, e)
        prec = dict(precision="f64") if precise else {}
        batch_fn = lambda: ssim_cuda.ssim_parts_batch_cuda(a, b, precise=precise)
        tile_fn = lambda: ssim_cuda.ssim_parts_cuda(a, b, precise=precise)
        body_fn = lambda: batch_tile_body(a, b, precise)
        t_tile_a = cuda_ms(tile_fn, 20)
        t_body_a = cuda_ms(body_fn, 20)
        t_batch_a = cuda_ms(batch_fn, 20)
        t_batch_b = cuda_ms(batch_fn, 20)
        t_body_b = cuda_ms(body_fn, 20)
        t_tile_b = cuda_ms(tile_fn, 20)
        t_plain = cuda_ms(lambda: batch_twin(a, b, precise), 3)
        # compute_ssim on both routes in turns: batch, tile, batch, tile.
        e2e, e2e_tile = [], []
        for _ in range(2):
            e2e += host_times(lambda: ssim_tpu_torch.compute_ssim(a, b, **prec), 10)
            config.set_config(dataclasses.replace(old_cfg, max_tile_h=32, max_tile_w=64))
            try:
                e2e_tile += host_times(lambda: ssim_tpu_torch.compute_ssim(a, b, **prec), 10)
            finally:
                config.set_config(old_cfg)
        if precise:
            bnd, by = precise_bound(shape, 1, out_bytes=16 * shape[0])
        else:
            bnd, by = fwd_bound(shape, 1, out_bytes=8 * shape[0])
        t_batch, t_tile = min(t_batch_a, t_batch_b), min(t_tile_a, t_tile_b)
        t_body = min(t_body_a, t_body_b)
        mpix = shape[0] * shape[1] * shape[2] / 1e6
        times[name] = dict(
            shape=list(shape), precise=precise, ms=t_batch, ms_runs=[t_batch_a, t_batch_b],
            tile_ms=t_tile, tile_ms_runs=[t_tile_a, t_tile_b],
            tile_body_ms=t_body, tile_body_ms_runs=[t_body_a, t_body_b], plain_ms=t_plain,
            bound_ms=bnd, bound_by=by, bound_share=bnd / t_batch,
            compute_ssim_ms=statistics.median(e2e), compute_ssim_runs=e2e,
            compute_ssim_tile_ms=statistics.median(e2e_tile),
            compute_ssim_tile_runs=e2e_tile,
        )
        floor = ""
        if precise:
            times[name]["dp_floor_ms"] = precise_dp_floor(shape)
            times[name]["dp_floor_share"] = times[name]["dp_floor_ms"] / t_batch
            floor = (f", FP64-pipe floor {times[name]['dp_floor_ms']:.4f} ms "
                     f"({100 * times[name]['dp_floor_share']:.1f}%)")
        print(f"  {name} {shape}{' precise' if precise else ''}: batch {t_batch_a:.4f} / "
              f"{t_batch_b:.4f} ms ({mpix / t_batch * 1e3:.1f} Mpix/s), tile body (the "
              f"earlier design) {t_body_a:.4f} / {t_body_b:.4f} ms, tile grid "
              f"{t_tile_a:.4f} / {t_tile_b:.4f} ms ({mpix / t_tile * 1e3:.1f} Mpix/s), "
              f"batch / tile grid {t_batch / t_tile:.3f}, batch / tile body "
              f"{t_batch / t_body:.3f}; twin {t_plain:.3f} ms; compute_ssim "
              f"{statistics.median(e2e):.3f} ms on the batch route, "
              f"{statistics.median(e2e_tile):.3f} ms on the tile route (medians of 20); "
              f"bound {bnd:.4f} ms ({by}, {100 * bnd / t_batch:.1f}% reached){floor} | "
              f"{label}", flush=True)
        del a, b
        torch.cuda.empty_cache()
    return dict(err=err, err_rt=err_rt, route=route, launches=launches,
                launches_stream=launches_stream, losses=losses, step=route_step_ms,
                times=times)


def ring_halo(x, lo, hi, rows, first, last):
    """The `rows` rows above and below the band [lo, hi) of x (..., H, W) as
    a mesh ring delivers them: the neighbouring rows, and at the image's
    first (last) band the other end's rows, which the kernels must replace
    on their flags. Contiguous, on the card."""
    top = x[..., -rows:, :] if first else x[..., lo - rows:lo, :]
    bot = x[..., :rows, :] if last else x[..., hi:hi + rows, :]
    return top.contiguous(), bot.contiguous()


def band_operands(a, b, lo, hi, rows, first, last):
    a_top, a_bot = ring_halo(a, lo, hi, rows, first, last)
    b_top, b_bot = ring_halo(b, lo, hi, rows, first, last)
    return a_top, a_bot, b_top, b_bot


def rows_twin(a, b, vhalo, vmask, data_range=255.0, radius=5, sigma=1.5, k1=0.01,
              k2=0.03):
    from ssim_tpu_torch.ops import ssim_cuda

    return ssim_cuda.ssim_rows_plain(
        a, b, with_map=True,
        taps=ssim_cuda.gaussian_taps(np.float32, radius, sigma),
        c1=float((k1 * data_range) ** 2), c2=float((k2 * data_range) ** 2),
        clip_bound=max(131072.0, 4.0 * data_range), vhalo=vhalo, vmask=vmask,
    )


def finite_err(x, y, what):
    """Max |x - y| where both are finite, after checking that NaN sits at
    the same places."""
    check(torch.equal(x.isnan(), y.isnan()), f"{what}: NaN positions differ")
    fin = ~y.isnan()
    return float((x[fin] - y[fin]).abs().max()) if fin.any() else 0.0


def bands_fwd(name, a, b, splits, **win):
    """9a forward: each band of a (B, H, W) pair, with its ring operands
    and flags, through kRowsum and kRowsumMap against the row twin; then
    the bands' rows and maps, concatenated, against the unsharded kMap
    (its map; its rows as the twin reduces them) and kRowsum, and the
    unsharded kRowsum against the twin. A NaN in the input: only where the
    unsharded map is NaN too, or the rows that hold it, may differ.
    Returns (max abs error against the twin, the bands' rows
    concatenated)."""
    from ssim_tpu_torch.ops import ssim_cuda

    r = win.get("radius", 5)
    w = a.shape[-1]
    allow = a.dtype == torch.float32
    row_tol = TWIN_PIXEL_R1 * w if r == 1 else TWIN_PIXEL * w
    pix_tol = TWIN_PIXEL_R1 if r == 1 else TWIN_PIXEL
    err, rows_all, maps_all = 0.0, [], []
    stream = ssim_cuda.STREAM_LAUNCHES
    for i, (lo, hi) in enumerate(splits):
        flags = (i == 0, i == len(splits) - 1)
        a_s, b_s = a[:, lo:hi].contiguous(), b[:, lo:hi].contiguous()
        vh = band_operands(a, b, lo, hi, r, *flags)
        kw = dict(vhalo=vh, vmask=flags, allow_float=allow, **win)
        rows_k, _ = ssim_cuda.ssim_rows_cuda(a_s, b_s, **kw)
        rows_m, map_k = ssim_cuda.ssim_rows_cuda(a_s, b_s, with_map=True, **kw)
        torch.cuda.synchronize()
        rows_p, map_p = rows_twin(a_s, b_s, vh, flags, **win)
        check(torch.equal(rows_k.isnan(), rows_m.isnan())
              and torch.equal(rows_k[~rows_k.isnan()], rows_m[~rows_m.isnan()]),
              f"{name} band {i}: kRowsum and kRowsumMap rows differ")
        e_map = finite_err(map_k, map_p, f"{name} band {i} map")
        e_rows = finite_err(rows_k, rows_p, f"{name} band {i} rows")
        check(e_map <= pix_tol and e_rows <= row_tol,
              f"{name} band {i} [{lo}, {hi}): kernel vs twin map {e_map:.3g} "
              f"(tol {pix_tol:.3g}), rows {e_rows:.3g} (tol {row_tol:.3g})")
        err = max(err, e_map, e_rows / w)
        rows_all.append(rows_k)
        maps_all.append(map_k)
        del map_p, rows_p
    rows = torch.cat(rows_all, dim=1)
    smap = torch.cat(maps_all, dim=1)
    _, map_u = ssim_cuda.ssim_parts_cuda(a, b, with_map=True, allow_float=allow, **win)
    rows_rs, _ = ssim_cuda.ssim_rows_cuda(a, b, allow_float=allow, **win)
    rows_u = ssim_cuda.row_sums_plain(map_u)
    torch.cuda.synchronize()
    # kRowsum and kRowsumMap a band, kMap and kRowsum unsharded: every one
    # streams at every radius 1-16.
    want = 2 * len(splits) + 2
    check(ssim_cuda.STREAM_LAUNCHES - stream == want,
          f"{name}: {ssim_cuda.STREAM_LAUNCHES - stream} streaming launches, expected {want}")
    rows_tw, _ = rows_twin(a, b, None, (False, False), **win)
    e_whole = finite_err(rows_rs, rows_tw, f"{name} unsharded kRowsum")
    check(e_whole <= row_tol,
          f"{name}: unsharded kRowsum vs twin {e_whole:.3g} (tol {row_tol:.3g})")
    err = max(err, e_whole / w)
    del rows_tw
    if not bool(map_u.isnan().any()):
        e_cat_map = float((smap - map_u).abs().max())
        e_cat_rows = float((rows - rows_u).abs().max())
        same_rs = torch.equal(rows, rows_rs)
    else:
        # Tiles start at each band's row 0: a NaN poisons other rows than
        # in the unsharded grid. The rows that hold it are NaN in both;
        # where both are finite they agree.
        bad_rows = (a.isnan() | b.isnan()).any(dim=-1)
        check(bool(rows[bad_rows].isnan().all() and rows_u[bad_rows].isnan().all()),
              f"{name}: a row holding a NaN pixel is finite")
        fin = ~(rows.isnan() | rows_u.isnan())
        e_cat_rows = float((rows[fin] - rows_u[fin]).abs().max())
        fin_m = ~(smap.isnan() | map_u.isnan())
        e_cat_map = float((smap[fin_m] - map_u[fin_m]).abs().max())
        fin_rs = ~(rows.isnan() | rows_rs.isnan())
        same_rs = torch.equal(rows[fin_rs], rows_rs[fin_rs])
    check(e_cat_map <= pix_tol and e_cat_rows <= row_tol,
          f"{name}: bands vs unsharded kMap map {e_cat_map:.3g}, rows {e_cat_rows:.3g}")
    print(f"  {name} {tuple(a.shape)} {a.dtype} bands {[hi - lo for lo, hi in splits]}"
          f"{' ' + str(win) if win else ''}: kernel vs twin {err:.3g} (map, rows / W); "
          f"bands vs unsharded kMap: map {e_cat_map:.3g}, rows {e_cat_rows:.3g}; "
          f"rows {'equal' if same_rs else 'NOT equal'} to the unsharded kRowsum's; "
          f"unsharded kRowsum vs twin {e_whole:.3g}", flush=True)
    check(same_rs, f"{name}: the bands' rows differ from the unsharded kRowsum's")
    del map_u, smap
    return err, rows


def bands_bwd(name, a, b, splits, w_s, w_cs, **win):
    """9a backward: each band of an f32 pair with its 2r-row ring operands
    and flags through the backward kernel's halo mode against its twin;
    then the bands' gradients, concatenated, against the unsharded
    backward kernel (where both are finite, with NaN at the input's NaN
    pixels in both). Returns the max abs error against the twin over
    max(1, max|g|)."""
    from ssim_tpu_torch.ops import ssim_grad

    r = win.get("radius", 5)
    dr = win.setdefault("data_range", 1.0)
    err, das, dbs, scale = 0.0, [], [], 1.0
    taps = ssim_grad.gaussian_taps(np.float32, r, win.get("sigma", 1.5))
    tw = dict(taps=taps, c1=float((win.get("k1", 0.01) * dr) ** 2),
              c2=float((win.get("k2", 0.03) * dr) ** 2),
              clip_bound=max(131072.0, 4.0 * dr))
    ws = torch.full((a.shape[0],), w_s, device=a.device)
    wcs = torch.full((a.shape[0],), w_cs, device=a.device)
    for i, (lo, hi) in enumerate(splits):
        flags = (i == 0, i == len(splits) - 1)
        a_s, b_s = a[:, lo:hi].contiguous(), b[:, lo:hi].contiguous()
        vh = band_operands(a, b, lo, hi, 2 * r, *flags)
        da, db = ssim_grad.ssim_grad_cuda(a_s, b_s, w_s, w_cs, vhalo=vh, vmask=flags,
                                          **win)
        torch.cuda.synchronize()
        pa, pb = ssim_grad.ssim_grad_plain(a_s, b_s, ws, wcs, None, vhalo=vh,
                                           vmask=flags, **tw)
        for k, p in ((da, pa), (db, pb)):
            e = finite_err(k, p, f"{name} band {i} gradient")
            fin = ~p.isnan()
            s = max(1.0, float(p[fin].abs().max())) if fin.any() else 1.0
            check(e <= GRAD_TWIN * s,
                  f"{name} band {i}: backward halo mode vs twin {e:.3g} (tol "
                  f"{GRAD_TWIN * s:.3g})")
            err = max(err, e / s)
            scale = max(scale, s)
        das.append(da)
        dbs.append(db)
        del pa, pb
    da, db = torch.cat(das, dim=1), torch.cat(dbs, dim=1)
    ua, ub = ssim_grad.ssim_grad_cuda(a, b, w_s, w_cs, **win)
    torch.cuda.synchronize()
    bad = a.isnan() | b.isnan()
    e_cat = 0.0
    for k, u in ((da, ua), (db, ub)):
        check(bool(k[bad].isnan().all() and u[bad].isnan().all()),
              f"{name}: a NaN pixel's gradient is finite")
        fin = ~(k.isnan() | u.isnan())
        e_cat = max(e_cat, float((k[fin] - u[fin]).abs().max()))
    check(e_cat <= GRAD_TWIN * scale,
          f"{name}: bands vs the unsharded backward {e_cat:.3g}")
    print(f"  {name} {tuple(a.shape)} bands {[hi - lo for lo, hi in splits]}"
          f"{' ' + str(win) if win else ''}: backward halo mode vs twin "
          f"{err:.3g} x max(1, max|g|); bands vs unsharded backward {e_cat:.3g} "
          f"(max|g| {scale:.3g})", flush=True)
    return err, da


def even_splits(h, n):
    step = h // n
    return [(i * step, h if i == n - 1 else (i + 1) * step) for i in range(n)]


def phase_spatial_kernels(gen):
    """9a: the row modes with halo operands and the backward kernel's halo
    mode against their twins on the card, band by band, and the bands
    against the unsharded kernels."""
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad

    print("phase 9a: row modes and halo operands (K1f, K1g, K3 vhalo) against "
          "their twins", flush=True)
    fwd_err, bwd_err = 0.0, 0.0
    for dtype, dr in ((torch.uint8, 255.0), (torch.float32, 1.0)):
        a, b = pair(gen, (4, 2160, 3840), dtype, dr)
        e, _ = bands_fwd(f"4K x4 {dtype} in 4 bands", a, b, even_splits(2160, 4),
                         data_range=dr)
        fwd_err = max(fwd_err, e)
        if dtype == torch.float32:
            e, _ = bands_bwd("4K x4 f32 in 4 bands", a, b, even_splits(2160, 4),
                             1.3, 0.0)
            bwd_err = max(bwd_err, e)
        del a, b
        torch.cuda.empty_cache()
    # Wider than the TPU kernel's 16384 lanes (K2's rowsum there): a band
    # at the top edge, one inside and one at the bottom edge.
    wide = [(0, 400), (400, 700), (700, 1024)]
    for dtype, dr in ((torch.uint8, 255.0), (torch.float32, 1.0)):
        a, b = pair(gen, (1, 1024, 20480), dtype, dr)
        e, _ = bands_fwd(f"wide {dtype}", a, b, wide, data_range=dr)
        fwd_err = max(fwd_err, e)
        if dtype == torch.float32:
            e, _ = bands_bwd("wide f32", a, b, wide, 1.0, 0.0)
            bwd_err = max(bwd_err, e)
        del a, b
        torch.cuda.empty_cache()
    a, b = pair(gen, (4, 1080, 1920))
    for splits in (even_splits(1080, 3),
                   [(0, 523), (523, 543), (543, 578), (578, 1080)]):
        e, _ = bands_fwd("1080p x4 u8", a, b, splits)
        fwd_err = max(fwd_err, e)
    af, bf = pair(gen, (4, 1080, 1920), torch.float32, 1.0)
    e, _ = bands_bwd("1080p x4 f32 in 3 bands, w_cs", af, bf, even_splits(1080, 3),
                     1.0, 0.2)
    bwd_err = max(bwd_err, e)
    for win in CUSTOM_WINDOWS:
        a2, b2 = pair(gen, (2, 540, 1000))
        e, _ = bands_fwd("u8", a2, b2, even_splits(540, 3), **win)
        fwd_err = max(fwd_err, e)
        a2, b2 = pair(gen, (2, 540, 1000), torch.float32, 1.0)
        e, _ = bands_bwd("f32", a2, b2, even_splits(540, 3), 1.0, 0.0, **win)
        bwd_err = max(bwd_err, e)
    # NaN in a neighbour's rows: row 361 is band 1's second row, inside band
    # 0's bottom operand (the forward reads r = 5 rows, the backward 2r).
    an = af.clone()
    an[1, 361, 700] = float("nan")
    e, rows = bands_fwd("f32 NaN at (1, 361, 700)", an, bf, even_splits(1080, 3),
                        data_range=1.0)
    fwd_err = max(fwd_err, e)
    check(bool(rows[1, 361].isnan()) and not bool(rows[0].isnan().any()),
          "the NaN reached another image's rows")
    e, da = bands_bwd("f32 NaN at (1, 361, 700)", an, bf, even_splits(1080, 3), 1.0, 0.0)
    bwd_err = max(bwd_err, e)
    # NaN-filled operands under a set flag are never read.
    lo, hi = 0, 360
    a_s, b_s = af[:, lo:hi].contiguous(), bf[:, lo:hi].contiguous()
    vh = band_operands(af, bf, lo, hi, 5, True, False)
    nan_vh = (torch.full_like(vh[0], float("nan")),) + vh[1:2] \
        + (torch.full_like(vh[2], float("nan")),) + vh[3:]
    kw = dict(vmask=(True, False), allow_float=True, data_range=1.0)
    r1, m1 = ssim_cuda.ssim_rows_cuda(a_s, b_s, with_map=True, vhalo=vh, **kw)
    r2, m2 = ssim_cuda.ssim_rows_cuda(a_s, b_s, with_map=True, vhalo=nan_vh, **kw)
    vh2 = band_operands(af, bf, lo, hi, 10, True, False)
    nan_vh2 = (torch.full_like(vh2[0], float("nan")),) + vh2[1:2] \
        + (torch.full_like(vh2[2], float("nan")),) + vh2[3:]
    g1 = ssim_grad.ssim_grad_cuda(a_s, b_s, 1.0, 0.0, vhalo=vh2, vmask=(1, 0))
    g2 = ssim_grad.ssim_grad_cuda(a_s, b_s, 1.0, 0.0, vhalo=nan_vh2, vmask=(1, 0))
    torch.cuda.synchronize()
    check(torch.equal(r1, r2) and torch.equal(m1, m2) and bool(torch.isfinite(r2).all())
          and all(torch.equal(x, y) and bool(torch.isfinite(y).all())
                  for x, y in zip(g1, g2)),
          "NaN-filled operands under a set flag changed the result")
    print("  NaN-filled operands under a set flag: rows, map and gradients "
          "equal to those with the ring's operands, finite", flush=True)
    del a, b, af, bf, an, a2, b2
    torch.cuda.empty_cache()
    return fwd_err, bwd_err


def phase_spatial(gen, label):
    """9b and 9c on a one-rank nccl process group (a file:// store in a
    temporary directory), destroyed at the end."""
    import shutil
    import tempfile

    import torch.distributed as dist

    store = tempfile.mkdtemp(prefix="ssim_spatial_store_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        return spatial_path(gen, label)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store)


@contextlib.contextmanager
def no_twins():
    """Within it, the row and backward twins raise: the calls must stay on
    the card."""
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad

    real = (ssim_cuda.ssim_rows_plain, ssim_grad.ssim_grad_plain)

    def no_twin(*args, **kw):
        raise RuntimeError("a plain twin ran on the spatial path")

    ssim_cuda.ssim_rows_plain = ssim_grad.ssim_grad_plain = no_twin
    try:
        yield
    finally:
        ssim_cuda.ssim_rows_plain, ssim_grad.ssim_grad_plain = real


def spatial_path(gen, label):
    """9b: the three public functions at full width through the kernels
    (exact launch counts, the twins made to raise); 9c: times."""
    from ssim_tpu_torch.parallel import make_mesh

    print("phase 9b: spatial sharding (ssim_spatial_sharded, mean_ssim_spatial, "
          "ssim_grad_spatial_sharded) on a one-rank nccl mesh", flush=True)
    mesh = make_mesh((1,), ("space",))
    with no_twins():
        calls, launches, errs, (a, b, fa, fb, grad) = spatial_calls(gen, mesh)
    times = spatial_times(gen, label, mesh, a, b, fa, fb, grad)
    return dict(launches=launches, calls=calls, times=times, errs=errs)


def spatial_calls(gen, mesh):
    """9b's calls and checks; returns the launch counts by call and in
    all, the largest value and gradient errors against `ssim`, and the
    16K u8 and f32 pairs and the f32 pair's gradient, for 9c."""
    import ssim_tpu_torch
    from ssim_tpu_torch.parallel import make_mesh, mean_ssim_spatial, ssim_spatial_sharded

    calls = {}
    shape = (1, 8640, 15360)
    h, w = shape[1:]
    npix = h * w
    a, b = pair(gen, shape)
    a2, b2 = a[0], b[0]
    torch.cuda.synchronize()
    zero_counts()
    rows, none = ssim_spatial_sharded(a2, b2, mesh)
    torch.cuda.synchronize()
    calls["score"] = launch_counts()
    zero_counts()
    rows_m, smap = ssim_spatial_sharded(a2, b2, mesh, with_map=True)
    torch.cuda.synchronize()
    calls["map"] = launch_counts()
    check(calls["score"] == counts_of(rowsum=1, stream=1),
          f"ssim_spatial_sharded launches {calls['score']}, expected 1 kRowsum with "
          f"halo (the streaming kernel)")
    check(calls["map"] == counts_of(rowsum_map=1, stream=1),
          f"ssim_spatial_sharded(with_map=True) launches {calls['map']}, expected 1 "
          f"kRowsumMap with halo (the streaming kernel)")
    check(none is None and rows.is_cuda and rows.shape == (h,) and smap.is_cuda
          and smap.shape == (h, w), "ssim_spatial_sharded: outputs")
    s_ref = float(ssim_tpu_torch.compute_ssim(a, b)[0])
    s_rows = float(rows.double().sum()) / npix
    _, m_ref = ssim_tpu_torch.compute_ssim_map(a2, b2)
    m_ref = torch.from_numpy(np.asarray(m_ref))
    same_map = torch.equal(smap.cpu(), m_ref)
    check(abs(s_rows - s_ref) <= TWIN_GLOBAL and torch.equal(rows, rows_m) and same_map,
          f"ssim_spatial_sharded: mean of rows {s_rows} vs compute_ssim {s_ref}; map "
          f"equal to compute_ssim_map's: {same_map}")
    print(f"  u8 {h}x{w}: score 1 kRowsum (halo), map 1 kRowsumMap (halo), no other "
          f"launch; mean of row sums {s_rows:.9f} vs compute_ssim {s_ref:.9f} "
          f"({abs(s_rows - s_ref):.3g}); map equal to compute_ssim_map's bit for bit",
          flush=True)
    del smap, m_ref, rows_m

    # mean_ssim_spatial forward and backward on one f32 pair.
    fa, fb = pair(gen, (h, w), torch.float32, 1.0)
    x = fa.clone().requires_grad_()
    torch.cuda.synchronize()
    zero_counts()
    val = mean_ssim_spatial(x, fb, mesh, data_range=1.0)
    (1.0 - val).backward()
    torch.cuda.synchronize()
    calls["mean_step"] = launch_counts()
    check(calls["mean_step"] == counts_of(rowsum=1, stream=1, backward_vhalo=1),
          f"mean_ssim_spatial step launches {calls['mean_step']}, expected 1 kRowsum "
          f"(halo, the streaming kernel) and 1 backward (halo)")
    y = fa.clone().requires_grad_()
    ref = ssim_tpu_torch.ssim(y, fb, data_range=1.0)
    (1.0 - ref).backward()
    g_scale = float(y.grad.abs().max())
    g_err = float((x.grad - y.grad).abs().max())
    v_err = abs(val.detach().item() - ref.detach().item())
    check(bool(torch.isfinite(x.grad).all()) and v_err <= TWIN_GLOBAL
          and g_err <= GRAD_TWIN * g_scale,
          f"mean_ssim_spatial vs ssim: value {v_err:.3g}, gradient {g_err:.3g} "
          f"(max|g| {g_scale:.3g})")
    print(f"  f32 {h}x{w} mean_ssim_spatial step: 1 kRowsum (halo) + 1 backward "
          f"(halo); value {val.detach().item():.9f} vs ssim {ref.detach().item():.9f}; gradient vs "
          f"ssim's K3 gradient {g_err:.3g} (max|g| {g_scale:.3g})", flush=True)
    del y, ref

    # The batched call on a (1, 1) data x space mesh.
    mesh2 = make_mesh((1, 1), ("data", "space"))
    ba, bb = pair(gen, (4, 2160, 3840), torch.float32, 1.0)
    xb = ba.clone().requires_grad_()
    torch.cuda.synchronize()
    zero_counts()
    vb = mean_ssim_spatial(xb, bb, mesh2, axis="space", batch_axis="data", data_range=1.0)
    (1.0 - vb).backward()
    torch.cuda.synchronize()
    calls["mean_batched_step"] = launch_counts()
    check(calls["mean_batched_step"] == counts_of(rowsum=1, stream=1, backward_vhalo=1),
          f"batched mean_ssim_spatial step launches {calls['mean_batched_step']}")
    yb = ba.clone().requires_grad_()
    refb = ssim_tpu_torch.ssim(yb, bb, data_range=1.0).mean()
    (1.0 - refb).backward()
    gb_scale = float(yb.grad.abs().max())
    gb_err = float((xb.grad - yb.grad).abs().max())
    vb_err = abs(vb.detach().item() - refb.detach().item())
    check(vb_err <= TWIN_GLOBAL and gb_err <= GRAD_TWIN * gb_scale,
          f"batched mean_ssim_spatial vs ssim: value {vb_err:.3g}, gradient {gb_err:.3g}")
    print(f"  f32 (4, 2160, 3840) on a (1, 1) data x space mesh: 1 kRowsum (halo) + 1 "
          f"backward (halo); value {vb.detach().item():.9f} vs ssim {refb.detach().item():.9f}; gradient "
          f"{gb_err:.3g} (max|g| {gb_scale:.3g})", flush=True)
    launches = {k: sum(c[k] for c in calls.values())
                for k in ("rowsum", "rowsum_map", "backward_vhalo", "stream")}
    grad = x.grad.detach()
    del yb, refb, xb, ba, bb, x
    torch.cuda.empty_cache()
    errs = dict(value=max(v_err, vb_err), grad=max(g_err, gb_err))
    return calls, launches, errs, (a, b, fa, fb, grad)


def spatial_times(gen, label, mesh, a, b, fa, fb, grad):
    """9c: the modes on one band of the whole image (both flags set, the
    band's own rows as operands, as on one rank), the unsharded kernel
    beside them and the twins, with CUDA events, each mode held against
    its twin on the inputs it is timed on, and 9b's mean_ssim_spatial
    gradient `grad` of (fa, fb) against the backward twin; then the
    public calls and a mean_ssim_spatial step with the host clock, and
    one trace."""
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
    from ssim_tpu_torch.parallel import mean_ssim_spatial, ssim_spatial_sharded

    print("phase 9c: times", flush=True)
    a2, b2 = a[0], b[0]
    h, w = a2.shape
    times = {}
    zero = (True, True)
    for name, (xa, xb_) in (("16k_b1", (a, b)), ("4k_b4", pair(gen, (4, 2160, 3840))),
                            ("wide_b1", pair(gen, (1, 1024, 20480)))):
        vh = (xa[..., -5:, :].contiguous(), xa[..., :5, :].contiguous(),
              xb_[..., -5:, :].contiguous(), xb_[..., :5, :].contiguous())
        kw = dict(vhalo=vh, vmask=zero)
        t_rows = cuda_ms(lambda: ssim_cuda.ssim_rows_cuda(xa, xb_, **kw), 20)
        t_rmap = cuda_ms(lambda: ssim_cuda.ssim_rows_cuda(xa, xb_, with_map=True, **kw), 20)
        t_std = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(xa, xb_), 20)
        t_map = cuda_ms(lambda: ssim_cuda.ssim_parts_cuda(xa, xb_, with_map=True), 20)
        t_rows2 = cuda_ms(lambda: ssim_cuda.ssim_rows_cuda(xa, xb_, **kw), 20)
        t_plain = cuda_ms(lambda: rows_twin(xa, xb_, vh, zero), 3)
        # The timed modes against the twin on the same inputs and operands.
        rows_k, _ = ssim_cuda.ssim_rows_cuda(xa, xb_, **kw)
        rows_mk, map_k = ssim_cuda.ssim_rows_cuda(xa, xb_, with_map=True, **kw)
        torch.cuda.synchronize()
        rows_p, map_p = rows_twin(xa, xb_, vh, zero)
        shp = tuple(xa.shape)
        e_map = finite_err(map_k, map_p, f"9c {name} map")
        e_rows = max(finite_err(rows_k, rows_p, f"9c {name} kRowsum rows"),
                     finite_err(rows_mk, rows_p, f"9c {name} kRowsumMap rows"))
        check(e_map <= TWIN_PIXEL and e_rows <= TWIN_PIXEL * shp[2],
              f"9c {name}: kRowsumMap map vs twin {e_map:.3g} (tol {TWIN_PIXEL:.3g}), "
              f"rows {e_rows:.3g} (tol {TWIN_PIXEL * shp[2]:.3g})")
        del rows_k, rows_mk, map_k, rows_p, map_p
        bnd, by = fwd_bound(shp, 1, out_bytes=4 * shp[0] * shp[1] + 4 * 5 * shp[0] * shp[2])
        bnd_m, by_m = fwd_bound(shp, 1, out_bytes=4 * shp[0] * shp[1] * (1 + shp[2])
                                + 4 * 5 * shp[0] * shp[2])
        times[name] = dict(shape=list(shp), rowsum_ms=min(t_rows, t_rows2),
                           rowsum_ms_runs=[t_rows, t_rows2], rowsum_map_ms=t_rmap,
                           standard_ms=t_std, standard_map_ms=t_map, plain_ms=t_plain,
                           bound_ms=bnd, bound_by=by, bound_map_ms=bnd_m,
                           bound_map_by=by_m, twin_err_map=e_map, twin_err_rows=e_rows)
        mpix = shp[0] * shp[1] * shp[2] / 1e6
        print(f"  {name} u8 {shp}: kRowsum (halo) {t_rows:.4f} / {t_rows2:.4f} ms "
              f"({mpix / min(t_rows, t_rows2) * 1e3:.1f} Mpix/s), kRowsumMap (halo) "
              f"{t_rmap:.4f} ms; unsharded kScore {t_std:.4f} ms, kMap {t_map:.4f} ms; "
              f"row twin {t_plain:.3f} ms; bound {bnd:.4f} ms ({by}), with the map "
              f"{bnd_m:.4f} ms ({by_m}); vs twin: map {e_map:.3g}, rows {e_rows:.3g} "
              f"| {label}", flush=True)
    del vh, xa, xb_
    torch.cuda.empty_cache()
    for name, gshape in (("16k_b1", (1, 8640, 15360)), ("4k_b4", (4, 2160, 3840))):
        ga, gb = (fa[None], fb[None]) if name == "16k_b1" else pair(
            gen, gshape, torch.float32, 1.0)
        vh = (ga[..., -10:, :].contiguous(), ga[..., :10, :].contiguous(),
              gb[..., -10:, :].contiguous(), gb[..., :10, :].contiguous())
        # At 16K the cotangent of 9b's step, -1 over the pixel count, so the
        # twin's gradient also holds 9b's.
        w_s = -1.0 / (ga.shape[-2] * ga.shape[-1]) if name == "16k_b1" else 1.0
        kw = dict(vhalo=vh, vmask=zero, data_range=1.0)
        t_v = cuda_ms(lambda: ssim_grad.ssim_grad_cuda(ga, gb, w_s, 0.0, **kw), 10)
        t_u = cuda_ms(lambda: ssim_grad.ssim_grad_cuda(ga, gb, w_s, 0.0,
                                                       data_range=1.0), 10)
        t_v2 = cuda_ms(lambda: ssim_grad.ssim_grad_cuda(ga, gb, w_s, 0.0, **kw), 10)
        ws = torch.full((gshape[0],), w_s, device=ga.device)
        zeros = torch.zeros(gshape[0], device=ga.device)
        t_p = cuda_ms(lambda: grad_twin(ga, gb, ws, zeros, None, vhalo=vh, vmask=zero),
                      1 if name == "16k_b1" else 3)
        # The timed mode against the twin on the same inputs and operands.
        got = ssim_grad.ssim_grad_cuda(ga, gb, w_s, 0.0, **kw)
        torch.cuda.synchronize()
        want = grad_twin(ga, gb, ws, zeros, None, vhalo=vh, vmask=zero)
        g_max = max(float(x.abs().max()) for x in want)
        # With w_s = 1 the gradients are of order 1: max(1, max|g|) as in
        # phase 5; at 16K's tiny cotangent, relative to max|g|.
        tol = GRAD_TWIN * (g_max if name == "16k_b1" else max(1.0, g_max))
        e_twin = max(finite_err(k, p, f"9c {name} backward") for k, p in zip(got, want))
        check(e_twin <= tol, f"9c {name}: backward (halo) vs twin {e_twin:.3g} "
              f"(tol {tol:.3g})")
        extra = ""
        if name == "16k_b1":
            e_9b = finite_err(grad, want[0][0], "9b gradient")
            check(e_9b <= tol, f"9b mean_ssim_spatial gradient vs the backward twin "
                  f"{e_9b:.3g} (tol {tol:.3g})")
            extra = f"; 9b's mean_ssim_spatial gradient vs twin {e_9b:.3g}"
        del got, want
        bnd, by = bwd_bound(gshape, False)
        times[f"bwd_{name}"] = dict(shape=list(gshape), vhalo_ms=min(t_v, t_v2),
                                    vhalo_ms_runs=[t_v, t_v2], standard_ms=t_u,
                                    plain_ms=t_p, bound_ms=bnd, bound_by=by,
                                    twin_err=e_twin, twin_scale=g_max)
        print(f"  {name} f32 {gshape}: backward (halo) {t_v:.4f} / {t_v2:.4f} ms, "
              f"unsharded backward {t_u:.4f} ms, twin {t_p:.3f} ms; bound {bnd:.4f} ms "
              f"({by}); vs twin {e_twin:.3g} (max|g| {g_max:.3g}){extra} | {label}",
              flush=True)
        del vh, ga, gb
    torch.cuda.empty_cache()
    # The public calls with the host clock, and one training step traced.
    t_score = host_times(lambda: ssim_spatial_sharded(a2, b2, mesh), 10)
    t_smap = host_times(lambda: ssim_spatial_sharded(a2, b2, mesh, with_map=True), 5)
    t_cs = host_times(lambda: ssim_tpu_torch.compute_ssim(a, b), 10)
    x = fa.clone().requires_grad_()

    def step():
        x.grad = None
        v = mean_ssim_spatial(x, fb, mesh, data_range=1.0)
        (1.0 - v).backward()
        return v

    t_step = host_times(step, 10)
    busy, window, n_ops, top = device_trace(step, 5)
    times["public"] = dict(
        spatial_score_ms=statistics.median(t_score), spatial_score_runs=t_score,
        spatial_map_ms=statistics.median(t_smap), spatial_map_runs=t_smap,
        compute_ssim_ms=statistics.median(t_cs), step_ms=statistics.median(t_step),
        step_runs=t_step, trace_busy_ms=busy, trace_window_ms=window,
        trace_ops_per_step=n_ops, trace_k3_ms=k3_ms(top), trace_top=top[:8])
    print(f"  u8 {h}x{w}: ssim_spatial_sharded {statistics.median(t_score):.3f} ms "
          f"(median of 10, {min(t_score):.3f}-{max(t_score):.3f}), with the map "
          f"{statistics.median(t_smap):.3f} ms (median of 5); compute_ssim "
          f"{statistics.median(t_cs):.3f} ms | {label}", flush=True)
    print(f"  f32 {h}x{w} mean_ssim_spatial step (forward + backward): "
          f"{statistics.median(t_step):.3f} ms median of 10 ({min(t_step):.3f}-"
          f"{max(t_step):.3f}) | {label}", flush=True)
    if busy is None:
        print("  trace: the profiler recorded no device activity", flush=True)
    else:
        print(f"  trace of 5 steps: device busy {busy:.4f} ms per step, "
              f"{busy / statistics.median(t_step):.1%} of the untraced step, "
              f"{busy / window:.1%} of the traced window ({window:.3f} ms per step); "
              f"{n_ops:.0f} device operations per step; K3 {k3_ms(top):.4f} ms per "
              f"step, {k3_ms(top) / busy:.1%} of the device busy", flush=True)
        for name, ms in top[:6]:
            print(f"    {ms:.4f} ms  {name[:90]}", flush=True)
    del a, b, a2, b2, fa, fb, x
    torch.cuda.empty_cache()
    return times


# The relaxed tier (phase 10). Kernel against its relaxed twin: 2e-6
# global (never tighter than twice the per-pixel bound over sqrt(npix))
# and 2e-5 per pixel; the backward 1e-4 * max|g|. Kernel and twin add the
# same three exact bf16 products per band pass, the kernel on the tensor
# cores (mma.sync, in its own order of f32 adds), the twin in f32 matrix
# products (TF32 off): they agree to the last few f32 roundings of each
# blur, which the SSIM formula and the gradient's cancellations amplify,
# so the bounds sit well above what phase 10 prints and far inside the
# tier's own error. Against the f64 oracle: the JAX tests' envelope, 1e-4
# global and 5e-3 per interior pixel (tests/test_pallas.py:361-373); the
# relaxed gradient within 1e-3 * max|g| of the standard one
# (tests/test_grad.py:335-379), and different from it.
RELAXED_TWIN_GLOBAL, RELAXED_TWIN_PIXEL, RELAXED_GRAD_TWIN = 2e-6, 2e-5, 1e-4
RELAXED_ORACLE_GLOBAL, RELAXED_ORACLE_PIXEL, RELAXED_GRAD_STD = 1e-4, 5e-3, 1e-3
# bf16 tensor cores, dense (H100 SXM data sheet, at 700 W).
BF16_OPS_PER_S = 989e12


def split_bound(nbytes, f32_ops, tc_ops):
    """The relaxed modes' bound: the larger of the bytes at 3.35 TB/s and
    the f32 operations left on the CUDA cores at 67 TFLOP/s plus the split
    products' operations (2 per multiply-add) at the bf16 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_OPS_PER_S + tc_ops / BF16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def relaxed_fwd_bound(shape, itemsize, radius=5, extra_ops=0, out_bytes=None):
    """The relaxed forward (kScore; kComponents / kPooled with extra_ops 2
    / 4, their out_bytes): the standard count 24r + 43 less the two heavy
    horizontal passes, 2 (3r + 2), on the CUDA cores, and the two split
    blurs' 3 (2r + 1) multiply-adds per pixel each on the tensor cores."""
    bsz, h, w = shape
    npix = bsz * h * w
    tiles = bsz * -(-h // 32) * -(-w // 64)
    out = 4 * tiles if out_bytes is None else out_bytes
    return split_bound(2 * itemsize * npix + out,
                       (18 * radius + 39 + extra_ops) * npix,
                       2 * 2 * 3 * (2 * radius + 1) * npix)


def relaxed_bwd_bound(shape, with_g, radius=5):
    """The relaxed backward: the standard count 48r + 116 less its sixteen
    band passes (48r + 32) on the CUDA cores, 84 (85 with g_map), and the
    sixteen split blurs' 3 (2r + 1) multiply-adds per pixel each."""
    bsz, h, w = shape
    npix = bsz * h * w
    return split_bound((16 + 4 * with_g) * npix + 8 * bsz, (84 + with_g) * npix,
                       2 * 16 * 3 * (2 * radius + 1) * npix)


def indep_pair(gen, shape, dtype=torch.uint8):
    """Independent random images: the relaxed tier's worst content (the
    squared signals are as large and as varied as they get)."""
    a = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.int32)
    b = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.int32)
    if dtype == torch.uint8:
        return a.to(torch.uint8), b.to(torch.uint8)
    return a.float() / 255.0, b.float() / 255.0


def max_finite(x, y):
    fin = ~(x.isnan() | y.isnan())
    return float((x[fin] - y[fin]).abs().max()) if fin.any() else 0.0


def compare_relaxed(name, a, b, oracle=False, **win):
    """kScore and kMap relaxed against the relaxed twin on the same card
    tensors, and the map against the standard mode's (it must differ);
    with oracle, also the f64 oracle at the JAX envelope. Returns (max
    kernel-vs-twin error, max |relaxed - standard| per pixel)."""
    from ssim_tpu_torch import reference
    from ssim_tpu_torch.ops.ssim_cuda import ssim_parts_cuda

    f32 = a.dtype == torch.float32
    npix = a.shape[-1] * a.shape[-2]
    torch.cuda.synchronize()
    zero_counts()
    sk, _ = ssim_parts_cuda(a, b, relaxed=True, allow_float=f32, **win)
    pk, mk = ssim_parts_cuda(a, b, with_map=True, relaxed=True, allow_float=f32, **win)
    torch.cuda.synchronize()
    counts = launch_counts()
    # Both relaxed launches stream at radius 5 (compiled in) and 1 (phase
    # 10a's custom window; the runtime-radius relaxed stream,
    # ssim_fwd_stream_rt_relaxed.cu); at 16 the measured rule
    # (ssim_cuda.STREAM_RELAXED_TILE_RADII) keeps the relaxed tile body.
    streamed = 0 if win.get("radius") == 16 else 2
    check(counts == counts_of(relaxed=2, stream=streamed),
          f"{name}: relaxed kScore / kMap launched {counts}, expected {streamed} streaming")
    _, ms = ssim_parts_cuda(a, b, with_map=True, allow_float=f32, **win)
    torch.cuda.synchronize()
    pp, mp = twin(a, b, True, relaxed=True, **win)
    gs, gk, gp = scores(sk, npix), scores(pk, npix), scores(pp, npix)
    check(torch.equal(mk.isnan(), mp.isnan()), f"{name}: NaN map pixels differ")
    check(np.array_equal(np.isnan(gk), np.isnan(gp)), f"{name}: NaN scores differ")
    g_err = float(max(np.nanmax(np.abs(gk - gp), initial=0.0),
                      np.nanmax(np.abs(gs - gp), initial=0.0)))
    p_err = max_finite(mk, mp)
    g_tol = max(RELAXED_TWIN_GLOBAL, 2 * RELAXED_TWIN_PIXEL / npix**0.5)
    check(g_err <= g_tol and p_err <= RELAXED_TWIN_PIXEL,
          f"{name}: relaxed kernel vs twin global {g_err:.3g} (tol {g_tol:.3g}), "
          f"pixel {p_err:.3g} (tol {RELAXED_TWIN_PIXEL:.3g})")
    d_std = max_finite(mk, ms)
    check(d_std > 0, f"{name}: the relaxed map equals the standard one")
    line = (f"  {name}: relaxed kScore / kMap (streaming) "
            f"vs twin global {g_err:.3g} pixel {p_err:.3g}; vs the standard map {d_std:.3g}")
    if oracle:
        r = win.get("radius", 5)
        wo, mo = reference.compute_ssim(a.cpu().numpy(), b.cpu().numpy(), with_map=True,
                                        **{k: v for k, v in win.items()})
        o_g = float(np.abs(gk - np.asarray(wo)).max())
        inner = (Ellipsis, slice(r, -r), slice(r, -r))
        o_p = float(np.abs(mk.cpu().numpy()[inner].astype(np.float64) - mo[inner]).max())
        check(o_g <= RELAXED_ORACLE_GLOBAL and o_p <= RELAXED_ORACLE_PIXEL,
              f"{name}: relaxed vs f64 oracle global {o_g:.3g}, interior pixel {o_p:.3g}")
        line += f"; vs f64 oracle global {o_g:.3g}, interior pixel {o_p:.3g}"
    print(line, flush=True)
    return max(g_err, p_err), d_std


def compare_relaxed_grad(name, a, b, w_s, w_cs, g_map, label):
    """K3 relaxed against its twin and against the standard K3 on the same
    card tensors, its launch the streaming kernel's (one RELAXED_LAUNCHES:
    the relaxed tier's one design), and both timed in turns (standard, relaxed,
    relaxed, standard) beside the twin and relaxed_bwd_bound; returns the
    max abs kernel-vs-twin error and the times."""
    from ssim_tpu_torch.ops import ssim_grad
    from ssim_tpu_torch.ops.ssim_grad import ssim_grad_cuda

    torch.cuda.synchronize()
    zero_counts()
    rk = ssim_grad_cuda(a, b, w_s, w_cs, g_map, data_range=1.0, relaxed=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == counts_of(backward_relaxed=1),
          f"{name}: relaxed K3 launched {counts}, expected the streaming kernel once")
    sk = ssim_grad_cuda(a, b, w_s, w_cs, g_map, data_range=1.0)
    torch.cuda.synchronize()
    rp = grad_twin(a, b, w_s, w_cs, g_map, relaxed=True)
    scale = max(float(x.abs().max()) for x in sk)
    e_twin = max(max_finite(x, y) for x, y in zip(rk, rp))
    e_std = max(max_finite(x, y) for x, y in zip(rk, sk))
    check(e_twin <= RELAXED_GRAD_TWIN * scale,
          f"{name}: relaxed K3 vs twin {e_twin:.3g} (tol {RELAXED_GRAD_TWIN * scale:.3g})")
    check(0 < e_std <= RELAXED_GRAD_STD * scale,
          f"{name}: relaxed K3 vs standard {e_std:.3g} (tol {RELAXED_GRAD_STD * scale:.3g})")
    print(f"  {name}: relaxed K3 (streaming) vs twin {e_twin / scale:.3g} x max|g|, vs "
          f"the standard K3 {e_std / scale:.3g} x max|g| (max|g| {scale:.3g})", flush=True)
    del rp, sk, rk
    fn = lambda relaxed: ssim_grad_cuda(a, b, w_s, w_cs, g_map, data_range=1.0,
                                        relaxed=relaxed)
    t_s1 = cuda_ms(lambda: fn(False), 10)
    t_r1 = cuda_ms(lambda: fn(True), 10)
    t_r2 = cuda_ms(lambda: fn(True), 10)
    t_s2 = cuda_ms(lambda: fn(False), 10)
    t_plain = cuda_ms(lambda: grad_twin(a, b, w_s, w_cs, g_map, relaxed=True), 3)
    bnd, by = relaxed_bwd_bound(tuple(a.shape), g_map is not None)
    print(f"  {name}: relaxed K3 {t_r1:.4f} / {t_r2:.4f} ms, standard K3 {t_s1:.4f} / "
          f"{t_s2:.4f} ms in turns (relaxed / standard "
          f"{min(t_r1, t_r2) / min(t_s1, t_s2):.3f}); twin {t_plain:.3f} ms; bound "
          f"{bnd:.4f} ms ({by}) | {label}", flush=True)
    return e_twin, dict(shape=list(a.shape), ms=min(t_r1, t_r2), relaxed_ms=[t_r1, t_r2],
                        standard_ms=[t_s1, t_s2], plain_ms=t_plain, bound_ms=bnd,
                        bound_by=by)


# The relaxed components, pooled and batch streams' comparisons repeated on
# fresh pairs, at the picker's segment (pack) and pinned ones in turn: a
# race in a stream shows as one that fails.
RELAXED_REPEATS = 100


def relaxed_mismatch(got, want, tol, rerun):
    """What a failed relaxed comparison shows, for its message: the entries
    of got that differ from want by more than tol or in NaN (their count,
    the first indices with kernel and twin there), and the kernel run again
    on the same inputs (rerun() returns what got holds): whether it
    repeats."""
    bad = ((got - want).abs() > tol) | (got.isnan() != want.isnan())
    idx = bad.nonzero().cpu()
    again = rerun()
    torch.cuda.synchronize()
    first = [(tuple(int(v) for v in i), float(got[tuple(i)]), float(want[tuple(i)]))
             for i in idx[:4]]
    return (f"{idx.shape[0]} of {got.numel()} entries differ by more than {tol:.3g}, first "
            f"(index, kernel, twin): {first}; the kernel again on the same inputs "
            f"{float((again - want).abs().nan_to_num(0.0).max()):.3g} from the twin, "
            f"{float((again - got).abs().nan_to_num(0.0).max()):.3g} from its first run")


def relaxed_comp_errors(name, a, b, pooled, run):
    """run(): a relaxed components launch on a, b (pooled: (parts, pooled_a,
    pooled_b)), held against the relaxed twin: per-image [mean cs, mean
    ssim] within the tier's global bound, NaN in the twin's tiles, pooled
    images bit for bit. On a mismatch it raises with relaxed_mismatch's
    account of the tiles (or pooled pixels); returns the global error."""
    dr = 1.0 if a.dtype == torch.float32 else 255.0
    out = run()
    torch.cuda.synchronize()
    tw = comp_twin(a, b, pooled, data_range=dr, relaxed=True)
    parts, want = (out[0], tw[0]) if pooled else (out, tw)
    npix = a.shape[-1] * a.shape[-2]
    tol = max(RELAXED_TWIN_GLOBAL, 2 * RELAXED_TWIN_PIXEL / npix**0.5)
    gk, gp = parts.double().sum(-2) / npix, want.double().sum(-2) / npix
    err = float((gk - gp).abs().nan_to_num(0.0).max())
    if not (torch.equal(parts.isnan(), want.isnan()) and err <= tol):
        # A tile's sums: TILE_H x TILE_W pixels, each within the pixel bound.
        raise RuntimeError(
            f"{name}: relaxed kernel vs twin global {err:.3g} (tol {tol:.3g}); tiles: "
            + relaxed_mismatch(parts, want, RELAXED_TWIN_PIXEL * 32 * 64,
                               lambda: run()[0] if pooled else run()))
    if pooled:
        for i in (1, 2):
            if not same(out[i], tw[i]):
                raise RuntimeError(f"{name}: pooled image {'ab'[i - 1]} differs from the "
                                   f"twin's: " + relaxed_mismatch(out[i], tw[i], 0.0,
                                                                  lambda: run()[i]))
    return err


def relaxed_batch_errors(name, a, b, run, **win):
    """run(): a relaxed kBatch launch on a, b, held against the relaxed
    twin (at the window win: radius, sigma, k1, k2; radius 5 by default):
    per-image scores within the tier's global bound, NaN in the same
    images, counts exact. On a mismatch it raises with relaxed_mismatch's
    account of the images; returns the global error."""
    dr = 1.0 if a.dtype == torch.float32 else 255.0
    out = run()
    torch.cuda.synchronize()
    want = batch_twin(a, b, False, data_range=dr, relaxed=True, **win)
    npix = a.shape[-1] * a.shape[-2]
    tol = max(RELAXED_TWIN_GLOBAL, 2 * RELAXED_TWIN_PIXEL / npix**0.5)
    gk, gp = out[:, 0].double() / npix, want[:, 0].double() / npix
    err = float((gk - gp).abs().nan_to_num(0.0).max())
    if not (torch.equal(out[:, 1], want[:, 1]) and torch.equal(gk.isnan(), gp.isnan())
            and err <= tol):
        raise RuntimeError(
            f"{name}: relaxed kBatch vs twin global {err:.3g} (tol {tol:.3g}); images: "
            + relaxed_mismatch(gk, gp, tol, lambda: run()[:, 0].double() / npix))
    return err


def relaxed_comp_pinned(gen):
    """The relaxed components and pooled streams at pinned segments
    (ssim_cuda._launch(segment=...)), one streaming launch each: odd H and
    W with H one past a segment (u8), and f32 with NaN pixels in image 1 of
    2 and a value past the clip bound in image 0 (its pooled pixel raw).
    Returns the worst global error."""
    from ssim_tpu_torch.ops import ssim_cuda

    worst = 0.0
    a, b = pair(gen, (2, 65, 601))
    fa, fb = pair(gen, (2, 69, 777), torch.float32, 1.0)
    fa[1, 40, 300] = fa[1, 31, 127] = float("nan")
    fa[0, 21, 129] = 3e5
    for name, (x, y) in (("u8 (2, 65, 601)", (a, b)), ("f32 NaN, clipped (2, 69, 777)",
                                                         (fa, fb))):
        dr = 1.0 if x.dtype == torch.float32 else 255.0
        kw = ssim_cuda._components_args(x, y, dr, 5, 1.5, 0.01, 0.03)
        for seg in (32, 64, 96):
            for mode in ("components", "pooled"):
                zero_counts()
                e = relaxed_comp_errors(
                    f"{name} relaxed {mode}, segment {seg}", x, y, mode == "pooled",
                    lambda: ssim_cuda._launch(x, y, mode=mode, relaxed=True, segment=seg,
                                              **kw))
                counts = launch_counts()
                check(counts == counts_of(relaxed=1, stream=1),
                      f"{name} relaxed {mode}, segment {seg}: launched {counts}")
                worst = max(worst, e)
    print(f"  relaxed kComponents / kPooled (streaming) at pinned segments 32, 64, 96: u8 "
          f"(2, 65, 601), f32 (2, 69, 777) with NaN in image 1 and a clipped value in image "
          f"0: worst global {worst:.3g} from the twin, pooled images bit for bit", flush=True)
    return worst


def relaxed_batch_pinned(gen):
    """The relaxed kBatch stream at pinned packs (ssim_cuda._launch(pack=
    ...)), one streaming launch each: widths whose 16-column tiles straddle
    two images (24, 40, 100, 1: the staged row's tiles) and aligned ones
    (32, 192: the strip's tiles), images straddling strips, segments; u8,
    and f32 with a NaN in image 1. Returns the worst global error."""
    from ssim_tpu_torch.ops import ssim_cuda

    worst = 0.0
    for shape, pack in (((40, 20, 24), (5, 20)), ((30, 33, 40), (3, 16)),
                        ((9, 21, 100), (3, 21)), ((64, 32, 32), (4, 32)),
                        ((16, 192, 192), (2, 96)), ((7, 50, 1), (7, 50))):
        for dtype in (torch.uint8, torch.float32):
            a, b = pair(gen, shape, dtype, 1.0 if dtype == torch.float32 else 255.0)
            if dtype == torch.float32:
                a[1, shape[1] // 2, shape[2] - 1] = float("nan")
            dr = 1.0 if dtype == torch.float32 else 255.0
            kw = ssim_cuda._prepare(a, b, data_range=dr, radius=5, sigma=1.5, k1=0.01,
                                    k2=0.03)
            th, tw, ipb, groups = ssim_cuda.batch_geometry(*shape)
            name = f"{'f32 NaN in image 1' if dtype == torch.float32 else 'u8'} {shape}"
            zero_counts()
            e = relaxed_batch_errors(
                f"{name} pack {pack}", a, b,
                lambda: ssim_cuda._launch(a, b, mode="batch", relaxed=True, pack=pack,
                                          tile_h=th, tile_w=tw, ipb=ipb, groups=groups, **kw))
            counts = launch_counts()
            check(counts == counts_of(relaxed=1, stream=1),
                  f"{name} relaxed kBatch, pack {pack}: launched {counts}")
            worst = max(worst, e)
    print(f"  relaxed kBatch (packed stream) at pinned packs, W = 24, 40, 100, 1 (straddling "
          f"tiles) and 32, 192 (aligned), u8 and f32 with a NaN: worst global {worst:.3g} "
          f"from the twin, NaN in exactly the planted images", flush=True)
    return worst


def relaxed_repeats(gen):
    """The new relaxed streams' comparisons on RELAXED_REPEATS fresh pairs
    each: kComponents (f32) and kPooled (u8, then f32) at (2, 256, 1024),
    at the picker's segment and pinned 32, 64 and 128 in turn; kBatch on
    (300, 40, 40) (tiles straddle images) and (128, 64, 64), at the plan's
    pack and segments of 16 and 32 in turn. Returns the worst error."""
    from ssim_tpu_torch.ops import ssim_cuda

    t0 = time.perf_counter()
    worst, n = 0.0, 0
    shape = (2, 256, 1024)
    for mode, dtype, reps in (("components", torch.float32, RELAXED_REPEATS),
                              ("pooled", torch.uint8, RELAXED_REPEATS // 2),
                              ("pooled", torch.float32, RELAXED_REPEATS // 2)):
        f32 = dtype == torch.float32
        res = ssim_cuda._stream_resident(torch.cuda.current_device(), mode, f32, True)
        segs = [ssim_cuda.stream_segment(*shape, ssim_cuda.TILE_H, 10, res), 32, 64, 128]
        for i in range(reps):
            a, b = pair(gen, shape, dtype, 1.0 if f32 else 255.0)
            kw = ssim_cuda._components_args(a, b, 1.0 if f32 else 255.0, 5, 1.5, 0.01, 0.03)
            seg = segs[i % len(segs)]
            e = relaxed_comp_errors(
                f"{'f32' if f32 else 'u8'} {shape} relaxed {mode}, segment {seg}, repeat {i}",
                a, b, mode == "pooled",
                lambda: ssim_cuda._launch(a, b, mode=mode, relaxed=True, segment=seg, **kw))
            worst, n = max(worst, e), n + 1
    for shape in ((300, 40, 40), (128, 64, 64)):
        res = ssim_cuda._stream_resident(torch.cuda.current_device(), "batch", False, True)
        k, _ = ssim_cuda.batch_stream_plan(*shape, res)
        packs = [None, (k, 16), (k, 32)]
        th, tw, ipb, groups = ssim_cuda.batch_geometry(*shape)
        for i in range(RELAXED_REPEATS // 2):
            a, b = pair(gen, shape)
            kw = ssim_cuda._prepare(a, b, data_range=255.0, radius=5, sigma=1.5, k1=0.01,
                                    k2=0.03)
            pk = packs[i % len(packs)]
            e = relaxed_batch_errors(
                f"u8 {shape} relaxed kBatch, pack {pk or 'planned'}, repeat {i}", a, b,
                lambda: ssim_cuda._launch(a, b, mode="batch", relaxed=True, pack=pk,
                                          tile_h=th, tile_w=tw, ipb=ipb, groups=groups, **kw))
            worst, n = max(worst, e), n + 1
    print(f"  relaxed kComponents / kPooled / kBatch streams repeated: {n} fresh pairs "
          f"({RELAXED_REPEATS} a stream), the picker's segment (pack) and pinned ones in "
          f"turn: worst global {worst:.3g} from the twin ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return worst


def phase_relaxed_kernels(gen, label):
    """10a: every relaxed mode against its twin on the card; the forward
    against the f64 oracle on independent random pairs; the standard mode
    below MXU_MIN_W; K3 relaxed at grad_1080_b4 through the streaming
    kernel, timed beside the standard K3."""
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad

    print('phase 10a: relaxed modes (accuracy="relaxed") against their twins',
          flush=True)
    err, d_std = 0.0, 0.0
    # The f64 oracle, on independent (and one correlated) pairs, custom
    # windows and a NaN, all at least MXU_MIN_W wide.
    for name, (a, b), win in [
        ("u8 independent (2, 256, 1024)", indep_pair(gen, (2, 256, 1024)), {}),
        ("u8 correlated (2, 257, 650)", pair(gen, (2, 257, 650)), {}),
        ("f32 independent (1, 300, 640)", indep_pair(gen, (1, 300, 640), torch.float32),
         dict(data_range=1.0)),
        ("u8 independent (1, 200, 700) radius 1", indep_pair(gen, (1, 200, 700)),
         dict(radius=1, sigma=0.8, k1=0.02, k2=0.05)),
        ("u8 independent (1, 200, 1000) radius 16", indep_pair(gen, (1, 200, 1000)),
         dict(radius=16, sigma=3.0, k1=0.015, k2=0.04)),
    ]:
        e, d = compare_relaxed(name, a, b, oracle=True, **win)
        err, d_std = max(err, e), max(d_std, d)
    a, b = pair(gen, (2, 300, 600), torch.float32, 1.0)
    a[0, 123, 321] = float("nan")
    e, _ = compare_relaxed("f32 NaN in image 0 of 2 (2, 300, 600)", a, b, data_range=1.0)
    err = max(err, e)
    inputs = {}
    for name, shape, dtype in [("1080p_b4", (4, 1080, 1920), torch.uint8),
                               ("4k_b4", (4, 2160, 3840), torch.uint8),
                               ("1080p_b4_f32", (4, 1080, 1920), torch.float32),
                               ("wide_b1", (1, 1024, 20480), torch.uint8)]:
        inputs[name] = pair(gen, shape, dtype, 1.0 if dtype == torch.float32 else 255.0)
        win = dict(data_range=1.0) if dtype == torch.float32 else {}
        e, d = compare_relaxed(f"{name} {shape}", *inputs[name], **win)
        err, d_std = max(err, e), max(d_std, d)

    # The relaxed components (f32) and pooled (u8) modes at (4, 1080, 1920)
    # through the wrappers: one streaming launch each (from
    # STREAM_RELAXED_COMP_MIN_PIX pixels); components and pooled f32 at
    # MS-SSIM scale 1 (4, 540, 960), under it: the tile body. Against the
    # relaxed twin and the standard mode (pooled images equal to both bit for
    # bit).
    for pooled, dtype, shape, streams in ((False, torch.float32, (4, 1080, 1920), 1),
                                          (True, torch.uint8, (4, 1080, 1920), 1),
                                          (False, torch.float32, (4, 540, 960), 0),
                                          (True, torch.float32, (4, 540, 960), 0)):
        f32 = dtype == torch.float32
        dr = 1.0 if f32 else 255.0
        a, b = pair(gen, shape, dtype, dr)
        fn = (ssim_cuda.ssim_components_pooled_cuda if pooled
              else ssim_cuda.ssim_components_cuda)
        mode = "kPooled" if pooled else "kComponents"
        name = f"{mode} {'f32' if f32 else 'u8'} {shape}"
        torch.cuda.synchronize()
        zero_counts()
        e = relaxed_comp_errors(f"{name} relaxed", a, b, pooled,
                                lambda: fn(a, b, data_range=dr, relaxed=True))
        counts = launch_counts()
        check(counts == counts_of(relaxed=1, stream=streams),
              f"{name} relaxed launched {counts}, expected "
              f"{'the streaming kernel' if streams else 'the tile body'} once")
        rk, sk = fn(a, b, data_range=dr, relaxed=True), fn(a, b, data_range=dr)
        torch.cuda.synchronize()
        parts = (lambda x: x[0] if pooled else x)
        npix = shape[1] * shape[2]
        d = float((parts(rk).double().sum(-2) / npix
                   - parts(sk).double().sum(-2) / npix).abs().max())
        check(d > 0, f"{name} relaxed equals the standard mode")
        if pooled:
            check(same(rk[1], sk[1]) and same(rk[2], sk[2]),
                  f"{name} relaxed: pooled images differ from the standard mode's")
        print(f"  {name} ({'streaming' if streams else 'tile body'}): per-image [mean cs, "
              f"mean ssim] relaxed vs twin {e:.3g}, vs the standard mode {d:.3g}"
              + ("; pooled images equal the twin's and the standard mode's bit for bit"
                 if pooled else ""), flush=True)
        err = max(err, e)
        if shape == (4, 1080, 1920):
            inputs["pooled" if pooled else "components"] = (a, b)
        elif pooled:
            inputs["pooled_f32_scale1"] = (a, b)
    err = max(err, relaxed_comp_pinned(gen))

    # kBatch at 64^2 x4096 (independent images) through the wrapper: one
    # packed-stream launch; against its twin, the standard kBatch and, for 32
    # of the images, the f64 oracle; the relaxed tile body (which radii other
    # than 5 launch) on the same images against the twin; then at pinned
    # packs.
    from ssim_tpu_torch import reference

    a, b = indep_pair(gen, (4096, 64, 64))
    torch.cuda.synchronize()
    zero_counts()
    e = relaxed_batch_errors("u8 independent (4096, 64, 64)", a, b,
                             lambda: ssim_cuda.ssim_parts_batch_cuda(a, b, relaxed=True))
    check(launch_counts() == counts_of(relaxed=1, stream=1),
          f"kBatch relaxed launched {launch_counts()}, expected the packed stream once")
    kw = ssim_cuda._prepare(a, b, data_range=255.0, radius=5, sigma=1.5, k1=0.01, k2=0.03)
    th, tw, ipb, groups = ssim_cuda.batch_geometry(*a.shape)
    zero_counts()
    e_body = relaxed_batch_errors(
        "u8 independent (4096, 64, 64) tile body", a, b,
        lambda: ssim_cuda._launch(a, b, mode="batch", relaxed=True, tile_body=True, tile_h=th,
                                  tile_w=tw, ipb=ipb, groups=groups, **kw))
    check(launch_counts() == counts_of(relaxed=1),
          f"kBatch relaxed tile body launched {launch_counts()}, expected it once")
    rk = ssim_cuda.ssim_parts_batch_cuda(a, b, relaxed=True)
    sk = ssim_cuda.ssim_parts_batch_cuda(a, b)
    torch.cuda.synchronize()
    gk, gs = (x[:, 0].double() / 4096 for x in (rk, sk))
    d = float((gk - gs).abs().max())
    an, bn = a[:32].cpu().numpy(), b[:32].cpu().numpy()
    o = max(abs(float(gk[i]) + 1.0 - reference.compute_ssim(an[i], bn[i])[0])
            for i in range(32))
    check(d > 0 and o <= RELAXED_ORACLE_GLOBAL,
          f"kBatch relaxed: vs standard {d:.3g}, vs oracle {o:.3g}")
    print(f"  kBatch u8 independent (4096, 64, 64) (packed stream): per-image score relaxed "
          f"vs twin {e:.3g}, vs standard kBatch {d:.3g}; 32 images vs the f64 oracle {o:.3g}; "
          f"the relaxed tile body vs twin {e_body:.3g}", flush=True)
    err = max(err, e, e_body)
    inputs["batch"] = (a, b)
    err = max(err, relaxed_batch_pinned(gen))
    err = max(err, relaxed_repeats(gen))

    # Below MXU_MIN_W the relaxed call launches the standard mode and equals it.
    a, b = pair(gen, (1, 256, 448))
    fa, fb = pair(gen, (1, 256, 448), torch.float32, 1.0)
    zero_counts()
    _, m1 = ssim_cuda.ssim_parts_cuda(a, b, with_map=True, relaxed=True)
    g1 = ssim_grad.ssim_grad_cuda(fa, fb, 1.0, 0.0, data_range=1.0, relaxed=True)
    counts = launch_counts()
    _, m0 = ssim_cuda.ssim_parts_cuda(a, b, with_map=True)
    g0 = ssim_grad.ssim_grad_cuda(fa, fb, 1.0, 0.0, data_range=1.0)
    check(counts == counts_of(standard=1, stream=1, backward=1),
          f"(1, 256, 448) relaxed calls launched {counts}, expected the standard modes")
    check(torch.equal(m0, m1) and all(torch.equal(x, y) for x, y in zip(g0, g1)),
          "(1, 256, 448): the relaxed call differs from the standard one")
    print("  (1, 256, 448) below MXU_MIN_W: relaxed calls launched the standard "
          "kMap and K3 (no relaxed launch) and equal them bit for bit", flush=True)

    # K3 relaxed at grad_1080_b4, with and without g_map.
    shape = (4, 1080, 1920)
    fa, fb = pair(gen, shape, torch.float32, 1.0)
    w_s = torch.rand(4, generator=gen, device="cuda") / (shape[1] * shape[2])
    w_cs = torch.rand(4, generator=gen, device="cuda") * 0.3 / (shape[1] * shape[2])
    g_map = torch.randn(shape, generator=gen, device="cuda") * 1e-7
    e1, t1 = compare_relaxed_grad(f"grad_1080_b4 {shape}", fa, fb, w_s, w_cs, None,
                                  label)
    e2, t2 = compare_relaxed_grad(f"grad_1080_b4 {shape} g_map", fa, fb, w_s, w_cs,
                                  g_map, label)
    inputs["grad"] = (fa, fb)
    inputs["grad_times"] = {"K3 grad_1080_b4": t1, "K3 grad_1080_b4 g_map": t2}
    return err, max(e1, e2), d_std, inputs


def phase_relaxed_path(gen, inputs):
    """10b: the public entry points with accuracy="relaxed", each call's
    launches counted from 0."""
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import ssim_cuda

    print('phase 10b: the public path with accuracy="relaxed"', flush=True)
    fwd = bwd = streamed = relaxed_streamed = 0
    by_call, streamed_modes = {}, {}

    def counted(name, fn):
        # The relaxed launches that streamed are counted launch by launch,
        # apart from the standard launches beside them, and by mode.
        nonlocal fwd, bwd, streamed, relaxed_streamed
        torch.cuda.synchronize()
        zero_counts()
        out, by_mode = streamed_by_mode(fn)
        relaxed_streamed += sum(v for k, v in by_mode.items() if k.startswith("relaxed"))
        for k, v in by_mode.items():
            streamed_modes[k] = streamed_modes.get(k, 0) + v
        torch.cuda.synchronize()
        counts = launch_counts()
        by_call[name] = {k: v for k, v in counts.items() if v}
        fwd += counts["relaxed"]
        bwd += counts["backward_relaxed"]
        streamed += counts["stream"]
        return out, counts

    big = pair(gen, (1, 8640, 15360))
    inputs["16k_b1"] = big
    for name, (a, b) in (("1080p_b4", inputs["1080p_b4"]), ("4k_b4", inputs["4k_b4"]),
                         ("16k_b1", big)):
        s, counts = counted(f"compute_ssim {name}",
                            lambda: ssim_tpu_torch.compute_ssim(a, b, accuracy="relaxed"))
        check(counts == counts_of(relaxed=1, stream=1),
              f"compute_ssim(accuracy='relaxed') {name}: launches {counts}")
        pp, _ = twin(a, b, False, relaxed=True)
        g_twin = scores(pp, a.shape[-1] * a.shape[-2])
        s = np.atleast_1d(np.asarray(s, np.float64))
        check(np.isfinite(s).all() and np.abs(s - g_twin).max() <= RELAXED_TWIN_GLOBAL,
              f"compute_ssim(accuracy='relaxed') {name}: {s} vs the twin {g_twin}")
        print(f"  compute_ssim(accuracy=\"relaxed\") {name} {tuple(a.shape)}: launches "
              f"{by_call[f'compute_ssim {name}']}, scores {s} (twin "
              f"{float(np.abs(s - g_twin).max()):.3g} apart)", flush=True)
        del pp
    del big  # kept in inputs for 10c

    # Training: two Adam steps on ssim_loss(accuracy="relaxed").
    shape = (4, 1080, 1920)
    clean = torch.rand(shape, generator=gen, device="cuda")
    noisy = (clean + 0.15 * torch.randn(shape, generator=gen, device="cuda")).clamp_(0, 1)

    def train(loss_fn, steps=2):
        x = noisy.clone().requires_grad_()
        opt = torch.optim.Adam([x], lr=0.02)
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(x)
            loss.backward()
            check(bool(torch.isfinite(x.grad).all()), "non-finite relaxed gradient")
            opt.step()
            with torch.no_grad():
                x.clamp_(0.0, 1.0)
            losses.append(float(loss.detach()))
        final = float(loss_fn(x.detach()))
        check(np.isfinite(losses).all() and final < losses[0], f"the loss did not fall: "
              f"{losses} then {final}")
        return losses + [final]

    losses, counts = counted("ssim_loss step", lambda: train(
        lambda x: ssim_tpu_torch.ssim_loss(x, clean, accuracy="relaxed")))
    check(counts == counts_of(relaxed=3, backward_relaxed=2, stream=3),
          f"2 relaxed ssim_loss steps (and the final loss) launched {counts}")
    print(f"  2 Adam steps on ssim_loss(accuracy=\"relaxed\") {shape}: 1-SSIM {losses}; "
          f"launches {by_call['ssim_loss step']}", flush=True)

    # MS-SSIM: scales 0 (1920) and 1 (960) are relaxed, scale 0 streaming
    # (STREAM_RELAXED_COMP_MIN_PIX), scale 1 (4x540x960) on the tile body;
    # scales 2-4 standard (under STREAM_COMP_MIN_PIX: the tile body).
    a, b = inputs["pooled"]
    ms, counts = counted("compute_ms_ssim", lambda: ssim_tpu_torch.compute_ms_ssim(
        a, b, accuracy="relaxed"))
    check(counts == counts_of(relaxed=2, pooled=2, components=1, stream=1),
          f"compute_ms_ssim(accuracy='relaxed') launches {counts}")
    want = ssim_tpu_torch.compute_ms_ssim(a, b, impl="torch")
    d = float(np.abs(np.asarray(ms) - np.asarray(want)).max())
    check(d <= RELAXED_ORACLE_GLOBAL, f"compute_ms_ssim relaxed vs impl='torch' {d:.3g}")
    print(f"  compute_ms_ssim(accuracy=\"relaxed\") msssim_1080_b4: launches "
          f"{by_call['compute_ms_ssim']}; {d:.3g} from impl=\"torch\"", flush=True)
    losses, counts = counted("ms_ssim step", lambda: train(
        lambda x: 1.0 - ssim_tpu_torch.ms_ssim(x, clean, data_range=1.0,
                                               accuracy="relaxed").mean()))
    check(counts == counts_of(relaxed=6, components=9, backward_relaxed=4, backward=6,
                              stream=3),
          f"2 relaxed MS-SSIM steps (and the final loss) launched {counts}")
    print(f"  2 Adam steps on 1 - ms_ssim(accuracy=\"relaxed\") {shape}: {losses}; "
          f"launches {by_call['ms_ssim step']}", flush=True)

    # The batch route: compute_ssim(accuracy="relaxed") on the routed u8
    # batch, one relaxed kBatch on the packed stream.
    a, b = inputs["batch"]
    s, counts = counted("compute_ssim batch",
                        lambda: ssim_tpu_torch.compute_ssim(a, b, accuracy="relaxed"))
    check(counts == counts_of(relaxed=1, stream=1),
          f"compute_ssim(accuracy='relaxed') on (4096, 64, 64) launched {counts}")
    want = batch_twin(a, b, False, relaxed=True)[:, 0].double().cpu().numpy() / 4096 + 1.0
    d = float(np.abs(np.asarray(s, np.float64) - want).max())
    check(d <= RELAXED_TWIN_GLOBAL, f"compute_ssim relaxed batch vs the twin {d:.3g}")
    print(f"  compute_ssim(accuracy=\"relaxed\") u8 (4096, 64, 64): launches "
          f"{by_call['compute_ssim batch']}; {d:.3g} from the twin", flush=True)
    want_modes = {"relaxed score": 6, "relaxed pooled": 1, "relaxed components": 3,
                  "relaxed batch": 1}
    got_modes = {k: v for k, v in streamed_modes.items() if k.startswith("relaxed")}
    check(got_modes == want_modes, f"the public path's relaxed launches streamed by mode "
          f"{got_modes}, expected {want_modes}")
    check(relaxed_streamed == 11, f"{relaxed_streamed} of the public path's {fwd} relaxed "
          f"launches streamed, expected 11: 6 kScore (3 compute_ssim, 3 ssim_loss), "
          f"compute_ms_ssim's scale-0 kPooled, the MS-SSIM steps' 3 scale-0 kComponents, "
          f"the batch route's kBatch")
    check(streamed == relaxed_streamed, f"{streamed} of the public path's forward launches "
          f"streamed, expected the {relaxed_streamed} relaxed ones (MS-SSIM's standard "
          f"scales 2-4 run the tile body)")
    check(bwd == 6, f"the public path's relaxed K3 launches {bwd}, expected 6 (every one "
          f"streams: the relaxed tier's one design)")
    print(f"  relaxed launches {fwd}, {relaxed_streamed} of them streaming ({got_modes}); "
          f"all forward launches streaming {streamed}", flush=True)
    return fwd, bwd, relaxed_streamed, by_call, got_modes


def phase_relaxed_times(gen, label, inputs):
    """10c: relaxed kScore and kMap beside the standard mode on the same
    input, in turns (standard, relaxed, relaxed, standard), the twin and
    the bound; the components, pooled and batch streams beside their tile
    body too (relaxed_stream_times); K3's from 10a; the ssim_loss step,
    relaxed beside standard."""
    from ssim_tpu_torch.ops import ssim_cuda

    print("phase 10c: times, relaxed beside standard", flush=True)
    fw = lambda **kw: (lambda a, b, relaxed: ssim_cuda.ssim_parts_cuda(
        a, b, relaxed=relaxed, **kw))
    map_bytes = lambda shape: 4 * shape[0] * shape[1] * shape[2]
    cases = [
        ("kScore 4k_b4", inputs["4k_b4"], fw(), False, relaxed_fwd_bound((4, 2160, 3840), 1)),
        ("kMap 4k_b4", inputs["4k_b4"], fw(with_map=True), True,
         relaxed_fwd_bound((4, 2160, 3840), 1, out_bytes=map_bytes((4, 2160, 3840)))),
        ("kScore 1080p_b4", inputs["1080p_b4"], fw(), False,
         relaxed_fwd_bound((4, 1080, 1920), 1)),
        ("kMap 1080p_b4", inputs["1080p_b4"], fw(with_map=True), True,
         relaxed_fwd_bound((4, 1080, 1920), 1, out_bytes=map_bytes((4, 1080, 1920)))),
        ("kScore 16k_b1", inputs["16k_b1"], fw(), False,
         relaxed_fwd_bound((1, 8640, 15360), 1)),
        ("kMap 16k_b1", inputs["16k_b1"], fw(with_map=True), True,
         relaxed_fwd_bound((1, 8640, 15360), 1, out_bytes=map_bytes((1, 8640, 15360)))),
        ("kScore 1080p_b4 f32", inputs["1080p_b4_f32"], fw(allow_float=True, data_range=1.0),
         False, relaxed_fwd_bound((4, 1080, 1920), 4)),
        ("kScore wide_b1 (K2)", inputs["wide_b1"], fw(), False,
         relaxed_fwd_bound((1, 1024, 20480), 1)),
        ("kMap wide_b1 (K2)", inputs["wide_b1"], fw(with_map=True), True,
         relaxed_fwd_bound((1, 1024, 20480), 1, out_bytes=map_bytes((1, 1024, 20480)))),
    ]
    times = {}
    for name, (a, b), fn, with_map, (bnd, by) in cases:
        t_s1 = cuda_ms(lambda: fn(a, b, False), 20)
        t_r1 = cuda_ms(lambda: fn(a, b, True), 20)
        t_r2 = cuda_ms(lambda: fn(a, b, True), 20)
        t_s2 = cuda_ms(lambda: fn(a, b, False), 20)
        dr = 1.0 if a.dtype == torch.float32 else 255.0
        t_plain = cuda_ms(lambda: twin(a, b, with_map, data_range=dr, relaxed=True), 3)
        shape = list(a.shape)
        times[name] = dict(shape=shape, ms=min(t_r1, t_r2), relaxed_ms=[t_r1, t_r2],
                           standard_ms=[t_s1, t_s2], plain_ms=t_plain, bound_ms=bnd,
                           bound_by=by)
        print(f"  {name} {tuple(shape)}: relaxed {t_r1:.4f} / {t_r2:.4f} ms, standard "
              f"{t_s1:.4f} / {t_s2:.4f} ms (relaxed / standard "
              f"{min(t_r1, t_r2) / min(t_s1, t_s2):.3f}); twin {t_plain:.3f} ms; bound "
              f"{bnd:.4f} ms ({by}) | {label}", flush=True)
    times.update(relaxed_stream_times(label, inputs))
    # K3's times are 10a's (compare_relaxed_grad).
    times.update(inputs["grad_times"])
    fa, fb = inputs["grad"]
    times["ssim_loss step"] = relaxed_step_times(fa, fb, label)
    return times


def relaxed_stream_times(label, inputs):
    """10c: the relaxed components, pooled and batch streams, each in turns
    with its relaxed tile body (_launch(tile_body=True), the design before
    the streams) and the standard mode's stream on the same input (tile
    body, relaxed, standard, standard, relaxed, tile body), the twin and
    the bound; at MS-SSIM scale 1 (pooled f32 4x540x960, under
    STREAM_RELAXED_COMP_MIN_PIX) the wrapper runs the tile body and the
    stream is timed pinned at the picker's segment beside it."""
    from ssim_tpu_torch.ops import ssim_cuda

    def comp(pooled, dr):
        mode = "pooled" if pooled else "components"

        def launch(a, b, design):
            kw = ssim_cuda._components_args(a, b, dr, 5, 1.5, 0.01, 0.03)
            if design == "standard":
                return ssim_cuda._launch(a, b, mode=mode, **kw)
            if design == "tile body":
                return ssim_cuda._launch(a, b, mode=mode, relaxed=True, tile_body=True, **kw)
            res = ssim_cuda._stream_resident(a.device.index, mode,
                                             a.dtype == torch.float32, True)
            seg = ssim_cuda.stream_segment(*a.shape, kw["tile_h"], 10, res)
            return ssim_cuda._launch(a, b, mode=mode, relaxed=True, segment=seg, **kw)
        return launch

    def batch(a, b, design):
        kw = ssim_cuda._prepare(a, b, data_range=255.0, radius=5, sigma=1.5, k1=0.01, k2=0.03)
        th, tw, ipb, groups = ssim_cuda.batch_geometry(*a.shape)
        geo = dict(tile_h=th, tile_w=tw, ipb=ipb, groups=groups)
        if design == "standard":
            return ssim_cuda._launch(a, b, mode="batch", **geo, **kw)
        return ssim_cuda._launch(a, b, mode="batch", relaxed=True,
                                 tile_body=design == "tile body", **geo, **kw)

    comp_parts = lambda shape: 8 * shape[0] * -(-shape[1] // 32) * -(-shape[2] // 64)
    pooled_out = lambda shape: comp_parts(shape) + 8 * shape[0] * (shape[1] // 2) * (
        shape[2] // 2)
    cases = [
        ("kComponents f32 1080p_b4", inputs["components"], comp(False, 1.0),
         lambda a, b: comp_twin(a, b, False, data_range=1.0, relaxed=True),
         relaxed_fwd_bound((4, 1080, 1920), 4, extra_ops=2,
                           out_bytes=comp_parts((4, 1080, 1920)))),
        ("kPooled u8 1080p_b4", inputs["pooled"], comp(True, 255.0),
         lambda a, b: comp_twin(a, b, True, relaxed=True),
         relaxed_fwd_bound((4, 1080, 1920), 1, extra_ops=4,
                           out_bytes=pooled_out((4, 1080, 1920)))),
        ("kPooled f32 4x540x960 (MS-SSIM scale 1)", inputs["pooled_f32_scale1"],
         comp(True, 1.0), lambda a, b: comp_twin(a, b, True, data_range=1.0, relaxed=True),
         relaxed_fwd_bound((4, 540, 960), 4, extra_ops=4, out_bytes=pooled_out((4, 540, 960)))),
        ("kBatch u8 64x64_b4096", inputs["batch"], batch,
         lambda a, b: batch_twin(a, b, False, relaxed=True),
         relaxed_fwd_bound((4096, 64, 64), 1, out_bytes=8 * 4096)),
    ]
    times = {}
    for name, (a, b), launch, plain, (bnd, by) in cases:
        t = {d: [] for d in ("tile body", "stream", "standard")}
        for d in ("tile body", "stream", "standard", "standard", "stream", "tile body"):
            t[d].append(cuda_ms(lambda: launch(a, b, d), 20))
        t_plain = cuda_ms(lambda: plain(a, b), 3)
        best = min(t["stream"])
        times[name] = dict(shape=list(a.shape), ms=best, stream_ms=t["stream"],
                           tile_body_ms=t["tile body"], standard_ms=t["standard"],
                           plain_ms=t_plain, bound_ms=bnd, bound_by=by,
                           bound_share=bnd / best)
        print(f"  {name} {tuple(a.shape)}: relaxed stream {t['stream'][0]:.4f} / "
              f"{t['stream'][1]:.4f} ms, relaxed tile body {t['tile body'][0]:.4f} / "
              f"{t['tile body'][1]:.4f} (stream / tile body "
              f"{best / min(t['tile body']):.3f}), standard stream {t['standard'][0]:.4f} / "
              f"{t['standard'][1]:.4f} (relaxed / standard {best / min(t['standard']):.3f}); "
              f"twin {t_plain:.3f} ms; bound {bnd:.4f} ms ({by}, {bnd / best:.1%} reached) | "
              f"{label}", flush=True)
    return times


def relaxed_step_times(clean, noisy, label):
    """The ssim_loss training step (forward, backward, Adam, clamp, ending
    in a synchronize) on (4, 1080, 1920) f32, relaxed beside standard:
    host-clock ms in turns (standard, relaxed, relaxed, standard; median of
    10), then one trace of five steps each: the device's busy ms per step
    and K3's ms and share of it."""
    import ssim_tpu_torch

    x = noisy.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=0.02)

    def step(accuracy):
        opt.zero_grad(set_to_none=True)
        ssim_tpu_torch.ssim_loss(x, clean, accuracy=accuracy).backward()
        opt.step()
        with torch.no_grad():
            x.clamp_(0.0, 1.0)

    runs = {}
    for acc in ("standard", "relaxed", "relaxed", "standard"):
        runs.setdefault(acc, []).append(host_ms(lambda: step(acc), 10))
    out = {}
    for acc in ("relaxed", "standard"):
        busy, window, n_ops, top = device_trace(lambda: step(acc), 5)
        k3 = k3_ms(top)
        out[acc] = dict(step_ms=runs[acc], trace_busy_ms=busy, trace_k3_ms=k3,
                        trace_window_ms=window, trace_ops_per_step=n_ops,
                        trace_top=top[:6])
        if busy is None:
            print(f"  {acc} ssim_loss step: the trace recorded no device activity",
                  flush=True)
            continue
        print(f"  {acc} ssim_loss step {tuple(clean.shape)}: {runs[acc][0]:.3f} / "
              f"{runs[acc][1]:.3f} ms (host clock, median of 10, in turns); trace of 5 "
              f"steps: device busy {busy:.4f} ms per step, K3 {k3:.4f} ms "
              f"({k3 / busy:.1%} of it), {n_ops:.0f} device operations per step | "
              f"{label}", flush=True)
    del x, opt
    return out


def phase_relaxed(gen, label):
    err_fwd, err_bwd, d_std, inputs = phase_relaxed_kernels(gen, label)
    fwd, bwd, streamed, by_call, modes = phase_relaxed_path(gen, inputs)
    times = phase_relaxed_times(gen, label, inputs)
    del inputs
    torch.cuda.empty_cache()
    return dict(err_fwd=err_fwd, err_bwd=err_bwd, d_std=d_std, launches_fwd=fwd,
                launches_bwd=bwd, launches_stream=streamed,
                launches_stream_by_mode=modes, by_call=by_call, times=times)


# Phase 11: the edge-pad-and-align kernel (K4, csrc/pad.cu). It moves
# bytes, so the kernel is held against its twin byte for byte (the values
# viewed as integers of their size: NaN payloads and -0.0 count).
# Bound: bytes only, one read of (B, H, W) and one write of (B, hp, wp).
PAD_4K = ((4, 2160, 3840), 2176, 4096)  # pad.py's layout: hp % 32, wp % 128
PAD_1080 = ((4, 1080, 1920), 1088, 2176)
PAD_BIG = ((16, 8640, 15360), 8672, 15616)  # 2.17e9 output elements > 2^31
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def raw(x):
    """x's bits, as a signed integer tensor of its itemsize."""
    return x.view(_BITS[x.element_size()])


def pad_bound(shape, hp, wp, itemsize):
    return bound_ms(pad_bytes(shape, hp, wp, itemsize), 0)


def pad_bytes(shape, hp, wp, itemsize):
    """The bytes the pad must move: one read of (B, H, W), one write of
    (B, hp, wp)."""
    bsz, h, w = shape
    return itemsize * bsz * (h * w + hp * wp)


def pad_input(gen, shape, dtype, specials=False):
    """A random (B, H, W) input on the card; with specials, NaN (quiet and
    with a payload), -0.0 and +-inf at the image's corners and edges."""
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=dtype)
    if dtype == torch.uint16:
        return torch.randint(-32768, 32768, shape, generator=gen, device="cuda",
                             dtype=torch.int16).view(dtype)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    if specials:
        h, w = shape[1], shape[2]
        x[:, 0, 0] = float("nan")
        x[:, 0, w - 1] = -0.0
        x[:, h - 1, 0] = float("inf")
        x[:, h // 2, 0] = float("-inf")
        x[:, 0, w // 2] = -0.0
        payload = 0x7FC0ABCD if dtype == torch.float32 else 0x7FF8000000ABCDEF
        raw(x)[:, h - 1, w - 1] = payload
        raw(x)[:, h // 2, w - 1] = payload
    return x


def host_pad(x, hp, wp):
    """np.pad(mode="edge") of x on the host, an independent reference."""
    a = x.cpu().numpy()
    return np.pad(a, ((0, 0), (8, hp - a.shape[1] - 8), (128, wp - a.shape[2] - 128)),
                  mode="edge")


def compare_pad(name, x, hp, wp):
    """pad_align_cuda against pad_align_plain on x, byte for byte (on small
    inputs also against np.pad on the host); returns the largest |value
    difference| of the elements that differ, 0.0 where none does."""
    from ssim_tpu_torch.ops.pad import pad_align_cuda, pad_align_plain

    k = pad_align_cuda(x, hp=hp, wp=wp)
    p = pad_align_plain(x, hp, wp)
    torch.cuda.synchronize()
    check(k.dtype == x.dtype and tuple(k.shape) == (x.shape[0], hp, wp),
          f"pad {name}: {k.dtype} {tuple(k.shape)}")
    diff = raw(k) != raw(p)
    n_diff = int(diff.sum())
    err = 0.0 if n_diff == 0 else float((k[diff].double() - p[diff].double()).abs().max())
    del diff
    check(n_diff == 0, f"pad {name}: {n_diff} elements differ from the twin "
                       f"(max |d| {err:.3g})")
    host = ""
    if k.numel() <= 1 << 24:
        want = host_pad(x, hp, wp)
        got = k.cpu().numpy()
        check(np.array_equal(got.view(np.uint8), want.view(np.uint8)),
              f"pad {name}: the kernel differs from np.pad on the host")
        host = ", and np.pad's on the host"
    print(f"  {name} {tuple(x.shape)} {str(x.dtype)[6:]} -> ({hp}, {wp}): byte for "
          f"byte the twin's{host}", flush=True)
    return err


def jax_test_geometries():
    """The geometries of tests/test_pad.py (the five of
    test_pad_pallas_matches_jnp, then test_pad_fuzz's eight)."""
    geos = [((2, 64, 128), 96, 384), ((1, 1080, 1920), 1120, 2176),
            ((3, 40, 256), 96, 512), ((1, 88, 128), 96, 384), ((1, 32, 128), 96, 384)]
    for seed in range(8):
        r = np.random.default_rng(500 + seed)
        h = max(32, int(r.integers(4, 40)) * 8)
        w = int(r.integers(1, 18)) * 128
        hp = ((h + 8 + 31) // 32 + int(r.integers(0, 3))) * 32
        wp = ((w + 128 + 5 + 127) // 128 + int(r.integers(0, 3))) * 128
        geos.append(((2, h, w), hp, wp))
    return geos


def phase_pad_kernel(gen):
    print("phase 11a: the pad kernel (K4) against its twin, byte for byte", flush=True)
    u8, u16, f32, f64 = torch.uint8, torch.uint16, torch.float32, torch.float64
    err = 0.0
    for shape, hp, wp in jax_test_geometries():
        err = max(err, compare_pad("u8 (JAX test)", pad_input(gen, shape, u8), hp, wp))
    cases = [
        ("u8 4K x4", PAD_4K, u8, False),
        ("f32 4K x4", PAD_4K, f32, False),
        ("u8 1080p x4", PAD_1080, u8, False),
        ("f32 NaN/-0.0/inf", ((2, 64, 128), 96, 384), f32, True),
        ("f32 NaN/-0.0/inf, unaligned", ((3, 37, 200), 96, 512), f32, True),
        ("u16 1080p x2", ((2, 1080, 1920), 1088, 2176), u16, False),
        ("u16, unaligned store", ((2, 37, 37), 50, 171), u16, False),
        ("f64 NaN/-0.0/inf", ((2, 540, 960), 552, 1152), f64, True),
        ("u8 unaligned", ((3, 37, 200), 96, 512), u8, False),
        ("u8 unaligned store", ((2, 64, 128), 72, 300), u8, False),
        ("u8 H = 1", ((2, 1, 300), 9, 450), u8, False),
        ("u8 W = 1", ((2, 20, 1), 40, 129), u8, False),
        ("f32 H = 1, W = 1", ((3, 1, 1), 9, 129), f32, True),
    ]
    for name, (shape, hp, wp), dtype, specials in cases:
        x = pad_input(gen, shape, dtype, specials)
        err = max(err, compare_pad(name, x, hp, wp))
    shape, hp, wp = PAD_BIG
    x = pad_input(gen, shape, u8)
    err = max(err, compare_pad(f"u8, {x.shape[0] * hp * wp} output elements", x, hp, wp))
    del x
    torch.cuda.empty_cache()
    return err


def phase_pad_path(gen):
    """pad_align on CUDA tensors, each call's launches counted from 0 with
    the twin made to raise."""
    from ssim_tpu_torch.ops import pad

    print("phase 11b: pad_align on CUDA tensors (the twin patched to raise)", flush=True)
    inputs = [(pad_input(gen, PAD_4K[0], torch.uint8),) + PAD_4K[1:],
              (pad_input(gen, PAD_4K[0], torch.float32),) + PAD_4K[1:],
              (pad_input(gen, PAD_1080[0], torch.uint8),) + PAD_1080[1:]]
    twin = pad.pad_align_plain

    def no_twin(*args, **kw):
        raise RuntimeError("pad_align ran its plain twin on a CUDA tensor")

    outs, launches = [], 0
    pad.pad_align_plain = no_twin
    try:
        for x, hp, wp in inputs:
            torch.cuda.synchronize()
            zero_counts()
            outs.append(pad.pad_align(x, hp, wp))
            torch.cuda.synchronize()
            got = launch_counts()
            check(got == counts_of(pad=1),
                  f"pad_align {tuple(x.shape)} launched {got}, expected one pad launch")
            launches += got["pad"]
    finally:
        pad.pad_align_plain = twin
    for (x, hp, wp), out in zip(inputs, outs):
        check(torch.equal(raw(out), raw(twin(x, hp, wp))),
              f"pad_align {tuple(x.shape)} differs from the twin")
        print(f"  pad_align {tuple(x.shape)} {str(x.dtype)[6:]} -> ({hp}, {wp}): one "
              f"pad launch, no other, no twin call; byte for byte the twin's", flush=True)
    return launches


def phase_pad_times(gen, label):
    """The kernel (u8, f32), its twin and F.pad(mode="replicate") (f32; the
    card's replicate pad takes floating types) at 4K x4, CUDA events around
    20 back-to-back launches, median of 3; the kernel and F.pad in turns.
    The u8 kernel is shorter than the wrapper's host work, so its time is
    the trace's (events_ms keeps the events' reading of the host)."""
    from ssim_tpu_torch.ops.pad import pad_align_cuda, pad_align_plain

    print("phase 11c: times at 4K x4", flush=True)
    shape, hp, wp = PAD_4K
    h, w = shape[1], shape[2]
    spec = (128, wp - w - 128, 8, hp - h - 8)
    out = {}
    for dtype in (torch.uint8, torch.float32):
        x = pad_input(gen, shape, dtype)
        kern = lambda: pad_align_cuda(x, hp=hp, wp=wp)
        t_twin = cuda_ms(lambda: pad_align_plain(x, hp, wp), 5)
        t_trace = kernel_trace_ms(kern, 20, "pad_align_kernel")
        bnd, by = pad_bound(shape, hp, wp, x.element_size())
        rec = dict(shape=[*shape], out_shape=[shape[0], hp, wp], plain_ms=t_twin,
                   device_ms=t_trace, bound_ms=bnd, bound_by=by)
        if dtype == torch.float32:
            lib = lambda: torch.nn.functional.pad(x, spec, mode="replicate")
            check(torch.equal(raw(lib()), raw(kern())),
                  "F.pad(replicate) differs from the kernel")
            turns = [cuda_ms(kern, 20), cuda_ms(lib, 20), cuda_ms(lib, 20),
                     cuda_ms(kern, 20)]
            rec.update(ms=min(turns[0], turns[3]), library_ms=min(turns[1], turns[2]),
                       turns=turns)
            lib_txt = (f"; F.pad(replicate) {turns[1]:.4f} / {turns[2]:.4f} ms (in turns "
                       f"kernel, F.pad, F.pad, kernel), "
                       f"{rec['library_ms'] / rec['ms']:.2f}x the kernel's time, "
                       f"{bnd / rec['library_ms']:.1%} of the bound")
            ktxt = f"{turns[0]:.4f} / {turns[3]:.4f}"
        else:
            check(t_trace is not None, "the trace holds no u8 pad_align_kernel")
            rec.update(ms=t_trace, events_ms=cuda_ms(kern, 20), library_ms=None)
            lib_txt = "; no library call (the card's replicate pad takes no u8)"
            ktxt = (f"{t_trace:.4f} (trace; CUDA events {rec['events_ms']:.4f}, "
                    f"the wrapper's host work)")
        dev = "not recorded" if t_trace is None else f"{t_trace:.4f} ms"
        print(f"  {str(dtype)[6:]} {shape} -> ({hp}, {wp}): kernel {ktxt} ms "
              f"({bnd / rec['ms']:.1%} of the bound, "
              f"{pad_bytes(shape, hp, wp, x.element_size()) / 1e6 / rec['ms']:.1f} GB/s), "
              f"in the trace {dev}; "
              f"twin {t_twin:.4f} ms; bound {bnd:.4f} ms ({by}){lib_txt} | {label}",
              flush=True)
        out[str(dtype)[6:]] = rec
        del x
    return out


def phase_pad(gen, label):
    err = phase_pad_kernel(gen)
    launches = phase_pad_path(gen)
    times = phase_pad_times(gen, label)
    torch.cuda.empty_cache()
    return dict(err=err, launches=launches, times=times)


# Phase 12: the port's CLI (`python -m ssim_tpu_torch.cli`) on the card, on
# image files the script writes from the fixed seed: binary PPM pairs for
# single-pair runs and uncompressed TGA pairs for `--dir` (the directory
# loader's file filter, which is the JAX one, lists .tga and not .ppm).
CLI_1080P, CLI_4K = (1080, 1920), (2160, 3840)
DIR_PAIRS, DIR_BATCH = 16, 8
CLI_REPS = 5
# The --dir trace: runs in it, and traces taken while one holds no device
# activity.
CLI_TRACE_REPS, CLI_TRACE_TRIES = 3, 3
# A printed score ("% 7.4f") equals a score computed beside it when it is
# that score rounded: within half a unit of the last digit, with 1e-7 for
# two f32 sums of the same pixels in another order (TWIN_GLOBAL).
PRINT_TOL = 0.5e-4 + 1e-7
# The host backend (f32 pixels, f64 sums) against the kernel: the f32
# tier's tolerance against the f64 oracle.
HOST_TOL = ORACLE_GLOBAL


def rgb_pair(gen, hw):
    """A correlated RGB uint8 pair (H, W, 3), made on the card, as NumPy."""
    a, b = pair(gen, hw + (3,))
    return a.cpu().numpy(), b.cpu().numpy()


def write_ppm(path, img):
    """Binary PPM (P6, maxval 255)."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img).tobytes())


def write_tga(path, img):
    """Uncompressed 24-bit TGA (type 2, stored BGR), top-left origin."""
    import struct

    h, w, _ = img.shape
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0x20)
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(img[:, :, ::-1]).tobytes())


@contextlib.contextmanager
def no_plain_twins():
    """Within it every kernel's plain twin raises: the calls must stay on
    the card."""
    from ssim_tpu_torch.ops import pad, ssim_cuda, ssim_grad

    names = [(ssim_cuda, n) for n in (
        "ssim_parts_plain", "ssim_parts_precise_plain", "ssim_parts_batch_plain",
        "ssim_components_plain", "ssim_components_pooled_plain", "ssim_rows_plain")]
    names += [(ssim_grad, "ssim_grad_plain"), (pad, "pad_align_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in names]

    def no_twin(*args, **kw):
        raise RuntimeError("a plain twin ran where the kernels must")

    for mod, name, _ in saved:
        setattr(mod, name, no_twin)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def no_pil():
    """Within it the image reader's PIL raises: the PPM and TGA files of
    phase 12 must be decoded by the port itself."""
    from ssim_tpu_torch.utils import imageio

    saved = imageio._pil_image

    def no_pil_image(what):
        raise RuntimeError(f"PIL ran on the CLI's path ({what})")

    imageio._pil_image = no_pil_image
    try:
        yield
    finally:
        imageio._pil_image = saved


def run_cli(args):
    """cli.main(args) in this process with its output captured; returns
    the exit code, stdout, stderr, the whole call's host-clock ms, and the
    stages it spent in: decode (load_image, in this thread or the
    loader's), compute (engine.compute / compute_ms_ssim, each ending with
    the scores on the host; their results kept) and map write (save_map);
    every forward launch (mode, relaxed, streamed, shape), and the card's
    ms from just before to just after each launch (CUDA events: the
    kernel, and the wrapper's host work before it is queued, so an upper
    bound on the kernel's time)."""
    import io

    import ssim_tpu_torch.models
    import ssim_tpu_torch.utils
    from ssim_tpu_torch import cli, engine
    from ssim_tpu_torch.ops import ssim_cuda
    from ssim_tpu_torch.utils import dataset

    stages = dict(decode=[], compute=[], write=[], scores=[], launches=[], events=[])

    def timed(stage, fn, keep=False):
        def spy(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            stages[stage].append((time.perf_counter() - t0) * 1e3)
            if keep:
                stages["scores"].append(out[0] if isinstance(out, tuple) else out)
            return out
        return spy

    launch = ssim_cuda._launch

    def launch_spy(a, b, **kw):
        before = ssim_cuda.STREAM_LAUNCHES
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(a, b, **kw)
        end.record()
        stages["events"].append((start, end))
        stages["launches"].append((kw["mode"], bool(kw.get("relaxed")),
                                   ssim_cuda.STREAM_LAUNCHES > before, tuple(a.shape)))
        return out

    spies = [(ssim_tpu_torch.utils, "load_image", "decode", False),
             (dataset, "load_image", "decode", False),
             (engine, "compute", "compute", True),
             (ssim_tpu_torch.models, "compute_ms_ssim", "compute", True),
             (ssim_tpu_torch.utils, "save_map", "write", False)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in spies]
    for mod, name, stage, keep in spies:
        setattr(mod, name, timed(stage, getattr(mod, name), keep))
    ssim_cuda._launch = launch_spy
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(list(args))
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
    finally:
        ssim_cuda._launch = launch
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    launch_ms = sum(start.elapsed_time(end) for start, end in stages["events"])
    return dict(rc=rc, out=out.getvalue(), err=err.getvalue(), total_ms=total,
                launch_ms=launch_ms,
                decode_ms=sum(stages["decode"]), compute_ms=sum(stages["compute"]),
                write_ms=sum(stages["write"]), scores=stages["scores"],
                launches=stages["launches"])


def cli_checked(name, args, expect_counts):
    """One run of the CLI with the counts set to 0 just before it and read
    just after, which must be `expect_counts`; returns the run and its
    printed rows [(label, value)]."""
    torch.cuda.synchronize()
    zero_counts()
    run = run_cli(args)
    counts = launch_counts()
    check(run["rc"] == 0, f"cli {name}: exit {run['rc']}: {run['err'][-2000:]}")
    check(counts == expect_counts, f"cli {name}: launches {counts}, expected "
          f"{ {k: v for k, v in expect_counts.items() if v} }")
    run["counts"] = {k: v for k, v in counts.items() if v}
    return run, printed_rows(run["out"])


def printed_rows(out):
    """The CLI's printed lines as (label, value): "Channel 0", "Average  ",
    a file name, or "" for a bare score."""
    rows = []
    for line in out.strip().splitlines():
        label, _, value = line.rpartition(":")
        rows.append((label, float(value)))
    return rows


def check_printed(name, rows, labels, want):
    """The printed rows carry `labels` and equal the scores `want`
    computed beside them, to the printed digits."""
    check([label for label, _ in rows] == labels, f"cli {name}: lines {rows}")
    err = max(abs(v - w) for (_, v), w in zip(rows, want))
    check(err <= PRINT_TOL, f"cli {name}: printed {rows} vs computed {want}")
    return err


def stage_times(args, reps=CLI_REPS):
    """Host-clock medians over `reps` runs of the CLI: the whole call and
    its decode, compute and map-write stages, ms; and the launches'
    CUDA-event ms (run_cli's launch_ms)."""
    runs = []
    for _ in range(reps):
        run = run_cli(args)
        check(run["rc"] == 0, f"cli {args}: exit {run['rc']}: {run['err'][-2000:]}")
        runs.append(run)
    med = {k: statistics.median(r[k] for r in runs)
           for k in ("total_ms", "decode_ms", "compute_ms", "write_ms", "launch_ms")}
    med["total_runs_ms"] = [r["total_ms"] for r in runs]
    return med


def phase_cli(gen, label):
    import shutil
    import tempfile

    print("phase 12: the CLI (ssim_tpu_torch.cli) on the card, on PPM and TGA files",
          flush=True)
    work = tempfile.mkdtemp(prefix="ssim_cli_")
    try:
        return cli_runs(gen, label, work)
    finally:
        shutil.rmtree(work)


def cli_runs(gen, label, work):
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import ssim_cuda
    from ssim_tpu_torch.utils import imageio

    paths, imgs = {}, {}
    t0 = time.perf_counter()
    for name, hw in (("1080p", CLI_1080P), ("4k", CLI_4K)):
        imgs[name] = rgb_pair(gen, hw)
        paths[name] = [os.path.join(work, f"{name}_{s}.ppm") for s in "ab"]
        for path, img in zip(paths[name], imgs[name]):
            write_ppm(path, img)
    dirs = [os.path.join(work, f"dir_{s}") for s in "ab"]
    for d in dirs:
        os.mkdir(d)
    dir_imgs = {}
    for i in range(DIR_PAIRS):
        name = f"frame{i:02d}.tga"
        dir_imgs[name] = rgb_pair(gen, CLI_1080P)
        for d, img in zip(dirs, dir_imgs[name]):
            write_tga(os.path.join(d, name), img)
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for root, _, fs in os.walk(work) for f in fs)
    print(f"  wrote {nbytes / 1e6:.0f} MB in {time.perf_counter() - t0:.1f} s: an RGB "
          f"1080p and an RGB 4K pair (PPM), {DIR_PAIRS} RGB 1080p pairs (TGA); "
          f"decoded by the port's own PPM / TGA decoder", flush=True)
    p1, p4 = paths["1080p"], paths["4k"]
    a1, b1 = imgs["1080p"]
    a4, b4 = imgs["4k"]
    compute = lambda a, b, **kw: ssim_tpu_torch.compute_ssim(a, b, **kw)
    one = counts_of(standard=1, stream=1)
    res, errs = {}, {}
    channels = ["Channel 0", "Channel 1", "Channel 2", "Average  "]

    with no_plain_twins(), no_pil():
        # (a) Per channel at 1080p: one streaming launch for the (3, H, W) stack.
        run, rows = cli_checked("per channel 1080p", p1, one)
        want = [compute(a1[:, :, c], b1[:, :, c]) for c in range(3)]
        want_channels = want + [float(np.mean(want))]
        errs["per_channel"] = check_printed("per channel 1080p", rows, channels,
                                            want_channels)
        kernel_scores = np.asarray(run["scores"][0], np.float64)
        d = float(np.abs(kernel_scores - want).max())
        check(d <= TWIN_GLOBAL, f"cli per channel: scores {kernel_scores} vs {want}")
        per_channel_out = run["out"]
        res["per_channel_1080p"] = run

        # (b) -y and -1: one launch each.
        run, rows = cli_checked("-y 1080p", ["-y"] + p1, one)
        lum = (imageio.luminance_bt601(a1), imageio.luminance_bt601(b1))
        errs["luminance"] = check_printed("-y", rows, [""], [compute(*lum)])
        res["luminance_1080p"] = run
        run, rows = cli_checked("-1 1080p", ["-1"] + p1, one)
        errs["channel_1"] = check_printed("-1", rows, [""],
                                          [compute(a1[:, :, 1], b1[:, :, 1])])
        res["channel1_1080p"] = run

        # (c) Map export: the PFM bit for bit compute_ssim_map's maps, the
        # TGA quantize_map of them.
        maps = np.stack([ssim_tpu_torch.compute_ssim_map(a1[:, :, c], b1[:, :, c])[1]
                         for c in range(3)], axis=-1)
        for ext in ("pfm", "tga"):
            mp = os.path.join(work, f"map.{ext}")
            run, rows = cli_checked(f"map .{ext}", p1 + [mp], one)
            check_printed(f"map .{ext}", rows, channels, want_channels)
            if ext == "pfm":
                got = imageio.load_pfm(mp)
                check(got.shape == maps.shape and np.array_equal(got, maps),
                      "cli .pfm map differs from compute_ssim_map's")
            else:
                got = imageio.load_image(mp)
                check(np.array_equal(got, imageio.quantize_map(maps)),
                      "cli .tga map differs from quantize_map of compute_ssim_map's")
            res[f"map_{ext}_1080p"] = run
        print(f"  maps: .pfm {maps.shape} bit for bit compute_ssim_map's per "
              f"channel; .tga quantize_map of it", flush=True)

        # (d) --ms at 1080p: phase 6's launch kinds, 4 pooled and 1
        # components; the pooled ones of >= STREAM_COMP_MIN_PIX pixels stream.
        n_stream, (h, w) = 0, CLI_1080P
        for _ in range(4):
            n_stream += h * w >= ssim_cuda.STREAM_COMP_MIN_PIX
            h, w = h // 2, w // 2
        run, rows = cli_checked("--ms 1080p", ["--ms"] + p1,
                                counts_of(components=1, pooled=4, stream=n_stream))
        errs["ms"] = check_printed("--ms", rows, [""],
                                   [ssim_tpu_torch.compute_ms_ssim(*lum)])
        res["ms_1080p"] = run

        # (e) --relaxed at 4K: one relaxed launch, streaming.
        run, rows = cli_checked("--relaxed 4K", ["--relaxed"] + p4,
                                counts_of(relaxed=1, stream=1))
        want = [compute(a4[:, :, c], b4[:, :, c], accuracy="relaxed") for c in range(3)]
        errs["relaxed"] = check_printed("--relaxed 4K", rows, channels,
                                        want + [float(np.mean(want))])
        res["relaxed_4k"] = run

        # (f) --downsample=auto at 4K: pooled on the card (factor 8), one
        # forward launch on the f32 stack.
        torch.cuda.synchronize()
        zero_counts()
        run = run_cli(["--downsample=auto"] + p4)
        counts = {k: v for k, v in launch_counts().items() if v}
        check(run["rc"] == 0 and len(run["launches"]) == 1,
              f"cli --downsample=auto 4K: exit {run['rc']}, launches {run['launches']}")
        want = [compute(a4[:, :, c], b4[:, :, c], downsample="auto") for c in range(3)]
        errs["downsample"] = check_printed("--downsample=auto 4K", printed_rows(run["out"]),
                                           channels, want + [float(np.mean(want))])
        run["counts"] = counts
        res["downsample_auto_4k"] = run

        # (g) --dir --batch=8: each line compute_ssim of the pair's luminance.
        run, rows = cli_checked("--dir", ["--dir", f"--batch={DIR_BATCH}"] + dirs,
                                counts_of(standard=2, stream=2))
        names = sorted(dir_imgs)
        want = [compute(imageio.luminance_bt601(dir_imgs[n][0]),
                        imageio.luminance_bt601(dir_imgs[n][1])) for n in names]
        errs["dir"] = check_printed("--dir", rows, names, want)
        got = np.concatenate([np.atleast_1d(s) for s in run["scores"]])
        d = float(np.abs(got - want).max())
        check(d <= TWIN_GLOBAL, f"cli --dir: scores vs compute_ssim {d:.3g}")
        designs = []
        for mode, relaxed, streamed, shape in run["launches"]:
            check(mode == "score" and not relaxed and streamed
                  and shape == (DIR_BATCH,) + CLI_1080P,
                  f"cli --dir launch {mode} relaxed={relaxed} streamed={streamed} {shape}")
            designs.append(dict(mode=mode, shape=list(shape), design=STREAM_DESIGN))
        run["designs"] = designs
        res["dir_1080p"] = run
        print(f"  --dir --batch={DIR_BATCH}: {DIR_PAIRS} pairs in {len(designs)} launches "
              f"of kScore on {(DIR_BATCH,) + CLI_1080P} u8, each through {STREAM_DESIGN}; "
              f"scores vs compute_ssim {d:.3g}", flush=True)

        # (h) --impl=host at 1080p: the host library on the CPU, no launch.
        run, rows = cli_checked("--impl=host 1080p", ["--impl=host"] + p1,
                                counts_of())
        host_scores = np.asarray(run["scores"][0], np.float64)
        d_host = float(np.abs(host_scores - kernel_scores).max())
        check(d_host <= HOST_TOL,
              f"cli --impl=host {host_scores} vs the kernel's {kernel_scores}")
        res["host_1080p"] = run

    for name, run in res.items():
        print(f"  {name}: {run['out'].strip().splitlines()}; launches {run['counts']}",
              flush=True)
    print(f"  printed vs computed beside them, max {max(errs.values()):.3g} (the "
          f"printed digits); the kernel's channel scores vs compute_ssim "
          f"{TWIN_GLOBAL:g} or less; --impl=host vs the kernel {d_host:.3g} "
          f"(tol {HOST_TOL:g})", flush=True)

    # A fresh process with the build cached: its wall time, and the same output.
    fresh = []
    for _ in range(CLI_REPS):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "ssim_tpu_torch.cli"] + p1, cwd=HERE,
                             capture_output=True, text=True, timeout=300)
        fresh.append((time.perf_counter() - t0) * 1e3)
        check(out.returncode == 0 and out.stdout == per_channel_out,
              f"python -m ssim_tpu_torch.cli: exit {out.returncode}, printed "
              f"{out.stdout!r}: {out.stderr[-2000:]}")
    print(f"  python3 -m ssim_tpu_torch.cli on the 1080p pair (a fresh process, the "
          f"build cached): {', '.join(f'{t:.0f}' for t in fresh)} ms; prints the "
          f"in-process run's lines", flush=True)

    return dict(res=res, fresh_ms=statistics.median(fresh), fresh_runs_ms=fresh, errs=errs, host_vs_kernel=d_host,
                launches=cli_launches(res), times=cli_times(p1, p4, dirs, label))


def cli_launches(res):
    """Phase 12's launches by counter, over its checked runs."""
    total = {}
    for run in res.values():
        for k, v in run["counts"].items():
            total[k] = total.get(k, 0) + v
    return total


def cli_times(p1, p4, dirs, label):
    """Host-clock medians of 5 runs of each CLI call, split into stages;
    --dir as pairs/s and Mpix/s, its launch share (the launches'
    CUDA-event ms over the host-clock ms) and, from one torch.profiler
    trace of it in a fresh process, the card's busy share (how far
    decode-ahead keeps the card fed)."""
    calls = {
        "per_channel_1080p": p1,
        "luminance_1080p": ["-y"] + p1,
        "channel1_1080p": ["-1"] + p1,
        "map_pfm_1080p": p1 + [os.path.join(os.path.dirname(p1[0]), "t.pfm")],
        "map_tga_1080p": p1 + [os.path.join(os.path.dirname(p1[0]), "t.tga")],
        "ms_1080p": ["--ms"] + p1,
        "per_channel_4k": p4,
        "relaxed_4k": ["--relaxed"] + p4,
        "downsample_auto_4k": ["--downsample=auto"] + p4,
        "dir_1080p": ["--dir", f"--batch={DIR_BATCH}"] + dirs,
        "host_1080p": ["--impl=host"] + p1,
    }
    times = {}
    with no_plain_twins(), no_pil():
        for name, args in calls.items():
            times[name] = stage_times(args)
    for name, t in times.items():
        print(f"  {name}: {t['total_ms']:.1f} ms (decode {t['decode_ms']:.1f}, compute "
              f"{t['compute_ms']:.1f}, map write {t['write_ms']:.1f}; runs "
              f"{', '.join(f'{x:.1f}' for x in t['total_runs_ms'])}) | {label}", flush=True)
    t = times["dir_1080p"]
    t["pairs_per_s"] = DIR_PAIRS / (t["total_ms"] / 1e3)
    t["mpix_per_s"] = t["pairs_per_s"] * CLI_1080P[0] * CLI_1080P[1] / 1e6
    t["launch_share"] = t["launch_ms"] / t["total_ms"]
    out = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                          "--trace-dir"] + dirs, cwd=HERE, capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0 and out.stdout.strip(),
          f"chip_smoke.py --trace-dir: exit {out.returncode}: {out.stderr[-3000:]}")
    trace = json.loads(out.stdout.strip().splitlines()[-1])
    check(trace["busy_ms"] is not None,
          f"the --dir trace held no device activity in {trace['empty_traces']} tries")
    t.update(trace_busy_ms=trace["busy_ms"], trace_window_ms=trace["window_ms"],
             trace_ops=trace["ops"], trace_top=trace["top"],
             trace_empty_tries=trace["empty_traces"],
             busy_share=trace["busy_ms"] / trace["window_ms"])
    print(f"  --dir --batch={DIR_BATCH}, {DIR_PAIRS} RGB 1080p TGA pairs: "
          f"{t['pairs_per_s']:.1f} pairs/s, {t['mpix_per_s']:.1f} Mpix/s; launch share "
          f"{t['launch_share']:.2%} (the launches by CUDA events {t['launch_ms']:.3f} ms "
          f"of {t['total_ms']:.1f} ms); busy share {t['busy_share']:.2%} (one trace of "
          f"{CLI_TRACE_REPS} runs in a fresh process: the card busy "
          f"{trace['busy_ms']:.3f} ms of {trace['window_ms']:.1f} ms a run, "
          f"{trace['ops']:g} device operations a run; "
          f"{', '.join(f'{n} {ms:.3f} ms' for n, ms in trace['top'])}; "
          f"{trace['empty_traces']} empty traces before it) | {label}", flush=True)
    return times


def trace_dir_main(dirs):
    """`chip_smoke.py --trace-dir A B`: one torch.profiler trace of
    CLI_TRACE_REPS runs of `--dir --batch=8 A B` (cli.main in this fresh
    process, its output discarded, the plain twins and PIL made to raise),
    taken again up to CLI_TRACE_TRIES times while it holds no device
    activity. Prints one JSON line: the device's busy ms and the traced
    window's host ms a run, the device operations a run, the largest
    operations' ms a run, and how many traces before it were empty
    (busy_ms null where all were)."""
    import io

    from ssim_tpu_torch import cli

    args = ["--dir", f"--batch={DIR_BATCH}"] + dirs

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(args)
        check(rc == 0, f"cli {args}: exit {rc}")

    empty = 0
    with no_plain_twins(), no_pil():
        for _ in range(CLI_TRACE_TRIES):
            busy, window, nops, top = device_trace(run, CLI_TRACE_REPS)
            if busy is not None:
                break
            empty += 1
    print(json.dumps(dict(busy_ms=busy, window_ms=window, ops=nops, top=top[:6],
                          empty_traces=empty)), flush=True)
    return 0


# Phase 13: the data-parallel and multi-process layer (parallel/batch.py,
# parallel/multihost.py) and the distributed training dry run (entry.py) on
# a one-rank nccl group that multihost.initialize makes on a free port of
# 127.0.0.1. NCCL refuses two ranks on one GPU, so the group has one rank:
# the gather and the all-reduce are over one rank, and every launch is the
# same kernel on the same block as the single-device engine's, so the
# per-image partials equal it bit for bit.
PAR_FRAMES = (8, 2160, 3840)
PAR_SMALL = (4096, 64, 64)
PAR_STEP = (4, 1080, 1920)
PAR_REPS = 10
PAR_TRACE_REPS = 3
PAR_TRACE_TRIES = 3


def counted(fn):
    """(the launch counts of fn() from 0, fn()'s result)."""
    torch.cuda.synchronize()
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return launch_counts(), out


def phase_parallel(gen, label):
    """Phase 13 on a one-rank nccl group made by `multihost.initialize`,
    destroyed at the end."""
    import torch.distributed as dist

    from ssim_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        return parallel_path(gen, label)
    finally:
        dist.destroy_process_group()


def parallel_path(gen, label):
    """13(a)-(d) with every plain twin made to raise and each call's
    launches counted from 0; then (e), the times."""
    from ssim_tpu_torch.parallel import make_mesh

    print("phase 13: data parallel and multi-process (ssim_batch_sharded, "
          "mean_ssim_sharded, multihost, the dry run's step) on a one-rank nccl "
          "group", flush=True)
    mesh = make_mesh((1,), ("data",))
    calls, res = {}, {}
    with no_plain_twins():
        frames = pair(gen, PAR_FRAMES)
        small = pair(gen, PAR_SMALL)
        res["frames"] = parallel_batch_calls("frames", frames, mesh, calls,
                                             counts_of(standard=1, stream=1))
        res["small"] = parallel_batch_calls("small", small, mesh, calls,
                                            counts_of(batch=1, stream=1))
        res["multihost"] = parallel_multihost(frames, res["frames"], calls)
        step_inputs, res["step"] = parallel_step(gen, calls)
    launches = {k: sum(c[k] for c in calls.values()) for k in launch_counts()}
    times = parallel_times(mesh, frames, small, step_inputs, label)
    return dict(calls=calls, launches=launches, res=res, times=times)


def parallel_batch_calls(name, ab, mesh, calls, one):
    """ssim_batch_sharded ± map and mean_ssim_sharded on one batch: each
    call one launch (`one`; with the map, kMap of the tile grid, the map's
    route as in JAX); the partials equal the single-device route's and
    their scores engine.compute's, bit for bit; the map's local block
    equals compute_ssim_map's; the mean that of engine.compute's scores."""
    import ssim_tpu_torch
    from ssim_tpu_torch import engine
    from ssim_tpu_torch.ops.routing import ssim_parts_auto
    from ssim_tpu_torch.parallel import mean_ssim_sharded, ssim_batch_sharded

    a, b = ab
    bsz, h, w = a.shape
    calls[f"{name}_score"], (parts, none) = counted(lambda: ssim_batch_sharded(a, b, mesh))
    calls[f"{name}_map"], (parts_m, smap) = counted(
        lambda: ssim_batch_sharded(a, b, mesh, with_map=True))
    calls[f"{name}_mean"], mean = counted(lambda: mean_ssim_sharded(a, b, mesh))
    for key in ("score", "mean"):
        check(calls[f"{name}_{key}"] == one,
              f"{name} {key}: launches {calls[f'{name}_{key}']}, expected {one}")
    check(calls[f"{name}_map"] == counts_of(standard=1, stream=1),
          f"{name} map: launches {calls[f'{name}_map']}, expected one streaming kMap")
    want_parts, _ = ssim_parts_auto(a, b)
    want = engine.compute(a, b)[0]
    got = engine.finalize_mean(parts.cpu().numpy(), h * w)
    local = smap.to_local()
    _, want_map = ssim_tpu_torch.compute_ssim_map(a, b)
    same_map = torch.equal(local.cpu(), torch.from_numpy(np.asarray(want_map)))
    mean_err = abs(float(mean) - float(np.mean(want)))
    check(none is None and parts.is_cuda and parts.shape[0] == bsz
          and torch.equal(parts, want_parts) and np.array_equal(got, want)
          and mean.dtype == torch.float32 and mean.dim() == 0,
          f"{name}: partials against the single-device route")
    check(local.is_cuda and tuple(smap.shape) == (bsz, h, w) and same_map
          and tuple(smap.full_tensor().shape) == (bsz, h, w),
          f"{name}: the map's local block against compute_ssim_map's")
    check(mean_err <= TWIN_GLOBAL, f"{name}: mean {float(mean)} vs {np.mean(want)}")
    print(f"  {name} u8 {bsz}x{h}x{w}: score {calls[f'{name}_score']['standard']} kScore / "
          f"{calls[f'{name}_score']['batch']} kBatch, map 1 kMap, mean 1 launch, all "
          f"streaming; partials equal the single-device route's and their scores "
          f"engine.compute's bit for bit; the map's block equals compute_ssim_map's; mean "
          f"{float(mean):.9f} ({mean_err:.3g} from engine.compute's scores)", flush=True)
    del smap, local, want_map
    torch.cuda.empty_cache()
    return dict(mean=float(mean), mean_err=mean_err, partials=parts)


def parallel_multihost(frames, ref, calls):
    """(c): global_mesh and distribute_batch of the frames; the sharded
    calls on the DTensor equal (a)'s; the mesh's errors."""
    from ssim_tpu_torch.parallel import mean_ssim_sharded, multihost, ssim_batch_sharded

    gmesh = multihost.global_mesh((1,), ("data",))
    da, db = (multihost.distribute_batch(x, gmesh) for x in frames)
    check(tuple(da.shape) == tuple(frames[0].shape) and da.to_local().is_cuda,
          f"distribute_batch: global shape {tuple(da.shape)}")
    calls["dtensor_mean"], mean = counted(lambda: mean_ssim_sharded(da, db, gmesh))
    calls["dtensor_score"], (parts, _) = counted(lambda: ssim_batch_sharded(da, db, gmesh))
    for key in ("dtensor_mean", "dtensor_score"):
        check(calls[key] == counts_of(standard=1, stream=1),
              f"{key}: launches {calls[key]}, expected one streaming kScore")
    check(float(mean) == ref["mean"] and torch.equal(parts, ref["partials"]),
          f"on the DTensor: mean {float(mean)} vs {ref['mean']}")
    try:
        multihost.global_mesh((2,), ("data",))
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("need 2 ranks" in raised, "global_mesh((2,)) on one rank must raise 'need 2 ranks'")
    print(f"  global_mesh((1,)) + distribute_batch of the frames: mean_ssim_sharded and "
          f"ssim_batch_sharded on the DTensor equal (a)'s bit for bit, one streaming kScore "
          f"each", flush=True)
    return dict(mean=float(mean))


def parallel_step(gen, calls):
    """(d): the dry run's step at full width on a (1, 1) ("data", "space")
    mesh, f32 PAR_STEP: the train step (plain loss, SGD, the kernel eval:
    one kRowsum with halo) and the gradient check (one kRowsum and one K3
    halo launch) within 2e-5 x max|g| of autograd of the unsharded plain
    path; then dryrun_multichip(1) on this group."""
    from ssim_tpu_torch import entry
    from ssim_tpu_torch.parallel import make_mesh

    mesh2 = make_mesh((1, 1), ("data", "space"))
    a = torch.randint(0, 256, PAR_STEP, generator=gen, device="cuda").float() / 255.0
    b = torch.randint(0, 256, PAR_STEP, generator=gen, device="cuda").float() / 255.0
    delta = torch.zeros_like(a)
    big_a, big_b = pair(gen, PAR_STEP, torch.float32, 1.0)
    calls["step_train"], (new_delta, loss, ev) = counted(
        lambda: entry.train_step(mesh2, a, b, delta))
    calls["step_grad"], (err, scale) = counted(lambda: entry.grad_check(mesh2, big_a, big_b))
    check(calls["step_train"] == counts_of(rowsum=1, stream=1),
          f"train step: launches {calls['step_train']}, expected one streaming kRowsum")
    check(calls["step_grad"] == counts_of(rowsum=1, stream=1, backward_vhalo=1),
          f"gradient check: launches {calls['step_grad']}, expected one streaming "
          f"kRowsum and one K3 halo launch")
    res = dict(loss=float(loss), eval_ssim=float(ev), delta_max=float(new_delta.abs().max()),
               grad_err=err, grad_scale=scale, grad_relerr=err / max(scale, 1e-12))
    entry.check_dryrun(res)
    check(res["grad_relerr"] <= GRAD_AUTOGRAD,
          f"full-width step: sharded gradient {err:.3g} from autograd (max|g| {scale:.3g}; "
          f"bound {GRAD_AUTOGRAD} x max|g|)")
    print(f"  dry run's step, f32 {PAR_STEP} on a (1, 1) data x space mesh: loss "
          f"{res['loss']:.9f}, kernel eval {res['eval_ssim']:.9f}, max|delta| "
          f"{res['delta_max']:.3g}; train step 1 kRowsum (halo), gradient check 1 kRowsum "
          f"+ 1 K3 (halo); gradient vs autograd of the plain path {err:.3g} (max|g| "
          f"{scale:.3g}, {res['grad_relerr']:.3g} relative)", flush=True)
    calls["dryrun_multichip_1"], small = counted(lambda: entry.dryrun_multichip(1))
    check(calls["dryrun_multichip_1"] == counts_of(rowsum=2, stream=2, backward_vhalo=1),
          f"dryrun_multichip(1): launches {calls['dryrun_multichip_1']}")
    res["dryrun_multichip_1"] = small
    return (mesh2, a, b, delta, big_a, big_b), res


def parallel_times(mesh, frames, small, step_inputs, label):
    """(e): host clock, median of PAR_REPS, of each sharded call beside
    engine.compute on the same batch (in turns); the full-width step by
    host clock and one trace (device busy ms, K3's share)."""
    from ssim_tpu_torch import engine, entry
    from ssim_tpu_torch.parallel import mean_ssim_sharded, ssim_batch_sharded

    print("phase 13e: times", flush=True)
    times = {}
    for name, (a, b) in (("frames", frames), ("small", small)):
        npix = a.shape[1] * a.shape[2]
        fns = {
            "compute_ms": lambda: engine.compute(a, b),
            "batch_sharded_ms": lambda: engine.finalize_mean(
                ssim_batch_sharded(a, b, mesh)[0].cpu().numpy(), npix),
            "mean_sharded_ms": lambda: float(mean_ssim_sharded(a, b, mesh)),
        }
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                runs[k] += host_times(fns[k], PAR_REPS // 2)
        times[name] = {k: statistics.median(v) for k, v in runs.items()}
        times[name]["runs_ms"] = runs
        times[name]["shape"] = list(a.shape)
        t = times[name]
        print(f"  {name} {tuple(a.shape)}: engine.compute {t['compute_ms']:.3f} ms, "
              f"ssim_batch_sharded + finalize {t['batch_sharded_ms']:.3f}, "
              f"mean_ssim_sharded {t['mean_sharded_ms']:.3f} (host clock, median of "
              f"{PAR_REPS}, in turns) | {label}", flush=True)
    step = lambda: entry.dryrun_step(*step_inputs)
    step_runs = host_times(step, PAR_REPS)
    for _ in range(PAR_TRACE_TRIES):
        busy, window, nops, top = device_trace(step, PAR_TRACE_REPS)
        if busy is not None:
            break
    check(busy is not None, f"the step's trace held no device activity in "
                            f"{PAR_TRACE_TRIES} tries")
    k3 = k3_ms(top)
    times["step"] = dict(step_ms=statistics.median(step_runs), runs_ms=step_runs,
                         trace_busy_ms=busy, trace_window_ms=window, trace_ops=nops,
                         trace_k3_ms=k3, trace_fwd_ms=fwd_ms(top), k3_share=k3 / busy,
                         trace_top=top[:8], shape=list(PAR_STEP))
    t = times["step"]
    print(f"  the dry run's step at {PAR_STEP}: {t['step_ms']:.3f} ms (host clock, median "
          f"of {PAR_REPS}); trace: device busy {busy:.3f} ms of {window:.3f} ms a step, "
          f"{nops:g} device operations, K3 {k3:.3f} ms ({t['k3_share']:.1%} of busy), "
          f"forward kernel {t['trace_fwd_ms']:.3f} ms; "
          f"{', '.join(f'{n[:40]} {ms:.3f}' for n, ms in top[:5])} | {label}", flush=True)
    return times


# Phase 14: the testing layer (ssim_tpu_torch.testing) on the card.
#: bench.py's configurations (bench.py:26-61), with bench.py's shapes and
#: iters, the JAX names pallas -> cuda and xla -> torch. The data a
#: `benchmark` PR takes as its cells; not cells yet.
DEVICEBENCH_CONFIGS = [
    ("cuda_4k_nomap", dict(impl="cuda", with_map=False, batch=4, h=2160, w=3840, iters=128)),
    ("cuda_4k_map", dict(impl="cuda", with_map=True, batch=4, h=2160, w=3840, iters=128)),
    ("cuda_1080_nomap", dict(impl="cuda", with_map=False)),
    ("cuda_1080_map", dict(impl="cuda", with_map=True)),
    ("cuda_8k_nomap", dict(impl="cuda", with_map=False, batch=1, h=4320, w=7680, iters=64)),
    ("cuda_16k_nomap", dict(impl="cuda", with_map=False, batch=1, h=8640, w=15360,
                            iters=16)),
    ("cuda_4k_f64mode", dict(impl="cuda", with_map=False, batch=4, h=2160, w=3840, iters=64,
                             precise=True)),
    ("cuda_4k_f64_float", dict(impl="cuda", with_map=False, batch=4, h=2160, w=3840,
                               iters=64, precise=True, float_input=True,
                               call_kwargs={"allow_float": True})),
    ("cuda_4k_relaxed", dict(impl="cuda", with_map=False, batch=4, h=2160, w=3840,
                             iters=128, relaxed=True)),
    ("auto_64sq_b4096", dict(impl="auto", with_map=False, batch=4096, h=64, w=64, iters=32)),
    ("auto_128sq_b1024", dict(impl="auto", with_map=False, batch=1024, h=128, w=128,
                              iters=64)),
    ("auto_128sq_b1024_map", dict(impl="auto", with_map=True, batch=1024, h=128, w=128,
                                  iters=48)),
    ("auto_64sq_b4096_f64", dict(impl="auto", with_map=False, batch=4096, h=64, w=64,
                                 iters=16, precise=True)),
    ("grad_1080_b4", dict(impl="grad", batch=4, h=1080, w=1920, iters=48)),
    ("grad_1080_b4_relaxed", dict(impl="grad", batch=4, h=1080, w=1920, iters=48,
                                  relaxed=True)),
    ("msssim_1080_b4", dict(impl="msssim", batch=4, h=1080, w=1920, iters=48)),
    ("torch_1080_nomap", dict(impl="torch", with_map=False, iters=24)),
]

#: The launches of one iteration of each configuration: device_throughput
#: calls the wrappers twice (the eager warm-up, then the capture); the
#: replays call none. msssim at 1080p x4: 4 pooled and 1 components launch,
#: scales 0 and 1 streaming (STREAM_COMP_MIN_PIX).
DEVICEBENCH_LAUNCHES = {
    "cuda_4k_relaxed": dict(relaxed=1, stream=1),
    "cuda_4k_f64mode": dict(precise=1, stream=1),
    "cuda_4k_f64_float": dict(precise=1, stream=1),
    "auto_64sq_b4096": dict(batch=1, stream=1),
    "auto_128sq_b1024": dict(batch=1, stream=1),
    "auto_64sq_b4096_f64": dict(batch_precise=1, stream=1),
    "grad_1080_b4": dict(backward=1),
    "grad_1080_b4_relaxed": dict(backward_relaxed=1),
    "msssim_1080_b4": dict(pooled=4, components=1, stream=2),
    "torch_1080_nomap": {},
}

#: 14(a): each runner on a small input, from the graph, eagerly on the
#: card and on the CPU; (name, impl, with_map, options, shape, f32, the
#: launches one iteration makes).
RUNNER_CASES = [
    ("cuda", "cuda", False, {}, (2, 270, 480), False, dict(standard=1, stream=1)),
    ("cuda_map", "cuda", True, {}, (2, 270, 480), False, dict(standard=1, stream=1)),
    ("cuda_precise", "cuda", False, dict(precise=True), (2, 270, 480), False,
     dict(precise=1, stream=1)),
    ("cuda_relaxed", "cuda", False, dict(relaxed=True), (1, 270, 640), False,
     dict(relaxed=1, stream=1)),
    ("auto", "auto", False, {}, (256, 64, 64), False, dict(batch=1, stream=1)),
    ("grad", "grad", False, {}, (2, 270, 480), True, dict(backward=1)),
    ("msssim", "msssim", False, {}, (2, 270, 480), False, dict(pooled=4, components=1)),
    ("spatial", "spatial", False, {}, (2, 270, 480), False, dict(rowsum=1, stream=1)),
    ("torch", "torch", False, {}, (2, 270, 480), False, {}),
]
RUNNER_ITERS = 5
#: 14(c): a configuration's Mpix/s over pixels / (its kernel's ms alone).
VS_KERNEL_MIN, VS_KERNEL_MAX = 0.5, 1.05


def graph_ms(fn, reps=20):
    """Device ms of one fn() call with no host work in it: fn captured
    once in a CUDA graph (after one eager call), then cuda_ms of the
    graph's replays. Events around back-to-back eager calls read the
    host's work where it is as long as the kernel (the batch wrappers',
    ~0.2 ms)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def kernel_alone_calls():
    """14(c): the configurations whose shape an earlier phase times with
    CUDA events, each with the wrapper call that is its kernel alone."""
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad

    fwd, batch = ssim_cuda.ssim_parts_cuda, ssim_cuda.ssim_parts_batch_cuda
    return {
        "cuda_4k_nomap": lambda a, b: fwd(a, b),
        "cuda_4k_map": lambda a, b: fwd(a, b, with_map=True),
        "cuda_16k_nomap": lambda a, b: fwd(a, b),
        "cuda_4k_f64mode": lambda a, b: fwd(a, b, precise=True),
        "cuda_4k_relaxed": lambda a, b: fwd(a, b, relaxed=True),
        "auto_64sq_b4096": lambda a, b: batch(a, b),
        "auto_128sq_b1024": lambda a, b: batch(a, b),
        "auto_64sq_b4096_f64": lambda a, b: batch(a, b, precise=True),
        "grad_1080_b4": lambda a, b: ssim_grad.ssim_grad_cuda(a, b, 1.0, 0.0),
        "grad_1080_b4_relaxed": lambda a, b: ssim_grad.ssim_grad_cuda(a, b, 1.0, 0.0,
                                                                      relaxed=True),
    }


def phase_testing(gen, label):
    """Phase 14 on a one-rank nccl group made by `multihost.initialize`,
    destroyed at the end."""
    import torch.distributed as dist

    from ssim_tpu_torch.parallel import multihost

    print("phase 14: the testing layer (ssim_tpu_torch.testing: devicebench's CUDA-graph "
          "loop, the report) on a one-rank nccl group", flush=True)
    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        runners, launches = testing_runners(gen, label)
        bench, counts, vs_kernel = testing_bench(gen, label)
    finally:
        dist.destroy_process_group()
    rep = testing_report(label)
    return dict(runners=runners, launches=launches, bench=bench, counts=counts,
                vs_kernel=vs_kernel, report=rep, seconds=time.perf_counter() - t0)


def testing_runners(gen, label):
    """14(a): each runner's graph (its launches read around the capture:
    each wrapper called twice, by the eager warm-up and by the capture;
    none by the replays) against the same iterations run eagerly on the
    card (bit for bit) and on the CPU (RUNNER_TOL). Returns the results
    and the launches of every capture, counted from 0."""
    from ssim_tpu_torch.testing import devicebench

    res, total = {}, dict.fromkeys(launch_counts(), 0)
    for name, impl, with_map, opts, shape, f32, one in RUNNER_CASES:
        a, b = pair(gen, shape, torch.float32 if f32 else torch.uint8,
                    1.0 if f32 else 255.0)
        if f32:  # grad's inputs are pixel values, as device_throughput makes them
            a, b = (a * 255.0).round_(), (b * 255.0).round_()
        with no_plain_twins():
            run = devicebench.make_runner(impl, with_map, device="cuda", **opts)
            check(run.graph, f"{name}: the runner on the card has no graph")
            captured, _ = counted(lambda: run.capture(a, b))
            replayed, g = counted(lambda: run(a, b, RUNNER_ITERS))
            e = run.eager(a, b, RUNNER_ITERS)
        want = counts_of(**{k: 2 * v for k, v in one.items()})
        check(captured == want, f"{name}: launches around the capture {captured}, "
                                f"expected {want}")
        check(not any(replayed.values()), f"{name}: the replays called a wrapper: "
                                          f"{replayed}")
        check(np.isfinite(g) and g == e, f"{name}: graph {g!r} vs eager {e!r} on the card")
        cpu = devicebench.make_runner(impl, with_map, device="cpu", **opts)(
            a.cpu(), b.cpu(), RUNNER_ITERS)
        # The card against the CPU: per iteration and summed value, the
        # f32 tier's global bound (relaxed: its tier's) for each pixel's
        # SSIM, and for each MS-SSIM or mean; the backward twin's bound for
        # each of grad's da + db at one pixel of an image.
        if impl == "grad":
            from ssim_tpu_torch.ops import ssim_grad

            da, db = ssim_grad.ssim_grad_cuda(a, b, 1.0, 0.0, data_range=255.0)
            scale = max(1.0, float(da.abs().max()), float(db.abs().max()))
            tol = GRAD_TWIN * scale * 2 * shape[0]
        elif impl in ("msssim", "spatial"):
            tol = ORACLE_GLOBAL * shape[0]
        else:
            tol = (RELAXED_ORACLE_GLOBAL if opts.get("relaxed") else ORACLE_GLOBAL) * a.numel()
        tol *= RUNNER_ITERS
        check(abs(g - cpu) <= tol, f"{name}: card {g!r} vs CPU {cpu!r} (tolerance {tol:.3g})")
        for k, v in captured.items():
            total[k] += v
        res[name] = dict(shape=list(shape), graph_loop=run.graph, graph=g, cpu=cpu,
                         err_cpu=abs(g - cpu), tol=tol,
                         launches_per_iteration={k: v for k, v in one.items()})
        print(f"  {name} {shape}: graph {g!r} == eager on the card; CPU {cpu!r} "
              f"(|diff| {abs(g - cpu):.3g} <= {tol:.3g}); capture launches "
              f"{ {k: v for k, v in captured.items() if v} } | {label}", flush=True)
    return res, total


def testing_bench(gen, label):
    """14(b): device_throughput on every configuration of bench.py, no
    failure caught; each call's launches counted from 0 (warm-up and
    capture: twice one iteration's). 14(c): where an earlier phase times
    the configuration's kernel, the kernel alone timed right after it on a
    pair of its shape (graph_ms: the wrapper's call with no host work, as
    the loop replays it); the configuration's Mpix/s over that rate held
    to [VS_KERNEL_MIN, VS_KERNEL_MAX]."""
    from ssim_tpu_torch.testing import devicebench

    alone_calls = kernel_alone_calls()
    bench, counts, ratios = {}, {}, {}
    for name, kw in DEVICEBENCH_CONFIGS:
        t0 = time.perf_counter()
        one = DEVICEBENCH_LAUNCHES.get(name, dict(standard=1, stream=1))
        with contextlib.ExitStack() as stack:
            if kw["impl"] != "torch":  # the torch configuration is the plain path
                stack.enter_context(no_plain_twins())
            counts[name], mpix = counted(lambda: devicebench.device_throughput(**kw))
            if name in alone_calls:
                shape = (kw.get("batch", 8), kw.get("h", 1080), kw.get("w", 1920))
                a, b = pair(gen, shape)
                if kw["impl"] == "grad":  # f32 pixel values, as device_throughput's
                    a, b = a.float(), b.float()
                ms = graph_ms(lambda: alone_calls[name](a, b))
                del a, b
        want = counts_of(**{k: 2 * v for k, v in one.items()})
        check(counts[name] == want, f"{name}: launches {counts[name]}, expected {want}")
        check(np.isfinite(mpix) and mpix > 0, f"{name}: {mpix} Mpix/s")
        bench[name] = mpix
        alone = ""
        if name in alone_calls:
            rate = shape[0] * shape[1] * shape[2] / ms / 1e3
            ratios[name] = mpix / rate
            alone = (f"; the kernel alone {rate:.1f} Mpix/s ({ms:.4f} ms): "
                     f"{ratios[name]:.3f}")
        print(f"  {name}: {mpix:.1f} Mpix/s{alone} ({time.perf_counter() - t0:.1f} s) | "
              f"{label}", flush=True)
        if name in ratios:
            check(VS_KERNEL_MIN <= ratios[name] <= VS_KERNEL_MAX,
                  f"{name}: {ratios[name]:.3f} of the kernel alone, outside "
                  f"[{VS_KERNEL_MIN}, {VS_KERNEL_MAX}]")
        torch.cuda.empty_cache()
    return bench, counts, ratios


def write_suite(root, seed=SEED):
    """A synthetic suite under the reference suite's file names: six gray
    256 x 256 Einstein PNGs (a smooth image and five distortions), the RGB
    640 x 360 big_buck_bunny PNG and its JPEGs at quality 0 (1), 50 and
    100, from a seed."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:256, 0:256]
    ref = 128 + 60 * np.sin(x / 9.0) * np.cos(y / 13.0) + rng.normal(0, 10, (256, 256))
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    Image.fromarray(ref).save(os.path.join(root, "einstein.png"))
    distort = {
        "meanshift.png": ref.astype(np.int32) + 12,
        "contrast.png": (ref.astype(np.float64) - 128) * 0.6 + 128,
        "impulse.png": np.where(rng.random(ref.shape) < 0.03, 255, ref),
        "blur.png": (ref.astype(np.float64) + np.roll(ref, 1, 0) + np.roll(ref, 1, 1)
                     + np.roll(ref, -1, 0) + np.roll(ref, -1, 1)) / 5,
        "jpg.png": ref.astype(np.float64) + rng.normal(0, 9, ref.shape),
    }
    for name, img in distort.items():
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(root, name))
    y, x = np.mgrid[0:360, 0:640]
    png = np.stack([128 + 80 * np.sin(x / (7.0 + 3 * c)) * np.cos(y / 11.0)
                    for c in range(3)], axis=-1) + rng.normal(0, 6, (360, 640, 3))
    png = Image.fromarray(np.clip(png, 0, 255).astype(np.uint8))
    png.save(os.path.join(root, "big_buck_bunny_360_07806.png"))
    for q in (0, 50, 100):
        png.save(os.path.join(root, f"big_buck_bunny_360_07806_{q:02d}.jpg"),
                 quality=max(q, 1))


def testing_report(label):
    """14(d): run_report(quick=False) on the card over a synthetic suite
    (SSIM_TPU_IMAGES_DIR pointed at it): the cuda row within 2e-6 global
    and 1e-3 per pixel of the oracle, both cuda device columns finite."""
    import io
    import shutil
    import tempfile

    from ssim_tpu_torch.testing import report

    work = tempfile.mkdtemp(prefix="ssim_report_")
    saved = os.environ.get("SSIM_TPU_IMAGES_DIR")
    try:
        write_suite(work)
        os.environ["SSIM_TPU_IMAGES_DIR"] = work
        out = io.StringIO()
        t0 = time.perf_counter()
        with no_plain_twins():
            rc = report.run_report(quick=False, out=out, device="cuda")
        seconds = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("SSIM_TPU_IMAGES_DIR", None)
        else:
            os.environ["SSIM_TPU_IMAGES_DIR"] = saved
        shutil.rmtree(work)
    text = out.getvalue()
    print("\n".join("  | " + line for line in text.splitlines()), flush=True)
    check(rc == 0, f"run_report returned {rc}")
    lines = text.splitlines()
    check(lines[0].startswith("backend: cuda ("), f"report backend line {lines[0]!r}")
    rows = {}
    for title in ("Accuracy vs float64 oracle", "Throughput (Mpix/s)"):
        for line in lines[lines.index(title) + 2:]:
            cells = [c.strip() for c in line.split("|")]
            if len(cells) != 5:
                break
            rows[(title[:3], cells[0])] = [float(c) for c in cells[1:]]
    acc, thr = rows[("Acc", "cuda")], rows[("Thr", "cuda")]
    check(acc[1] <= ORACLE_GLOBAL and acc[3] <= ORACLE_PIXEL,
          f"report: cuda max global {acc[1]}, max pixel {acc[3]}")
    check(all(np.isfinite(v) and v > 0 for v in thr), f"report: cuda throughput {thr}")
    return dict(seconds=seconds, backend=lines[0], accuracy={k[1]: v for k, v in rows.items()
                                                             if k[0] == "Acc"},
                throughput={k[1]: v for k, v in rows.items() if k[0] == "Thr"})

# ---------------------------------------------------------------------------
# Phase 15: the forward's row stream at a runtime radius.

RT_MODES = ("score", "map", "rowsum", "rowsum_map", "precise", "precise_map",
            "components", "pooled")
# The main path's custom windows: compute_ssim on NumPy 4K x4 u8 frames.
RT_MAIN_RADII = (1, 3, 8, 16)
RT_MAIN_SHAPE = (4, 2160, 3840)
# The kernels line's figures: kScore on 4K x4 u8 at this radius.
RT_LINE_RADIUS = 8


def rt_kw(a, mode, radius, sigma):
    """The launch's and the twin's keywords for `mode` at radius (f64 taps
    in the precise modes)."""
    from ssim_tpu_torch.ops import ssim_cuda

    dr = 1.0 if a.dtype == torch.float32 else 255.0
    precise = mode.startswith("precise")
    return dict(taps=ssim_cuda.gaussian_taps(np.float64 if precise else np.float32, radius,
                                             sigma),
                c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr),
                tile_h=ssim_cuda.TILE_H, tile_w=ssim_cuda.TILE_W)


def rt_twin(a, b, mode, kw, **halo):
    """The plain twin of `mode` on the same card tensors, returned as
    ssim_cuda._launch returns the kernel's outputs."""
    from ssim_tpu_torch.ops import ssim_cuda

    if mode.startswith("rowsum"):
        return ssim_cuda.ssim_rows_plain(a, b, with_map=mode == "rowsum_map", **halo, **kw)
    if mode.startswith("precise"):
        return ssim_cuda.ssim_parts_precise_plain(a, b, with_map=mode == "precise_map", **kw)
    if mode == "pooled":
        return ssim_cuda.ssim_components_pooled_plain(a, b, **kw)
    if mode == "components":
        return ssim_cuda.ssim_components_plain(a, b, **kw)
    return ssim_cuda.ssim_parts_plain(a, b, with_map=mode == "map", **kw)


def rt_errors(name, mode, got, want, shape):
    """A runtime-radius launch against its twin: maps and pooled images bit
    for bit (NaN at the same pixels), NaN at the same partials, scores
    within TWIN_GLOBAL (never tighter than 2 TWIN_PIXEL / sqrt(npix); 5e-5
    per pixel at radius 1 as elsewhere), row sums within W TWIN_PIXEL,
    precise scores within PRECISE_REL relative. Returns the largest
    absolute score or row error."""
    npix = shape[-2] * shape[-1]
    if mode in ("components", "pooled"):
        if mode == "pooled":
            for x, y in zip(got[1:], want[1:]):
                check(same(x, y), f"{name}: pooled images differ from the twin's")
            got, want = got[0], want[0]
        check(torch.equal(got.isnan(), want.isnan()), f"{name}: NaN tiles differ")
        gk = got.double().sum(-2).cpu().numpy() / npix
        gp = want.double().sum(-2).cpu().numpy() / npix
        err = float(np.nanmax(np.abs(gk - gp), initial=0.0))
        tol = max(TWIN_GLOBAL, 2 * TWIN_PIXEL / npix**0.5)
        check(err <= tol, f"{name}: components vs twin {err:.3g} (tol {tol:.3g})")
        return err
    (pk, mk), (pp, mp) = got, want
    if mp is not None:
        check(same(mk, mp), f"{name}: the map differs from the twin's")
    check(torch.equal(pk.isnan(), pp.isnan()), f"{name}: NaN partials differ")
    if mode.startswith("rowsum"):
        ok = ~pp.isnan()
        err = float((pk[ok] - pp[ok]).abs().max()) if ok.any() else 0.0
        check(err <= TWIN_PIXEL * shape[-1], f"{name}: rows vs twin {err:.3g}")
        return err / shape[-1]
    gk, gp = scores(pk, npix), scores(pp, npix)
    err = float(np.nanmax(np.abs(gk - gp), initial=0.0))
    if mode.startswith("precise"):
        rel = float(np.nanmax(np.abs(gk - gp) / np.abs(gp), initial=0.0))
        check(rel <= PRECISE_REL, f"{name}: precise vs twin {rel:.3g} relative")
    else:
        tol = max(TWIN_GLOBAL, 2 * TWIN_PIXEL / npix**0.5)
        check(err <= tol, f"{name}: scores vs twin {err:.3g} (tol {tol:.3g})")
    return err


def rt_launches(fn):
    """fn()'s result and its forward launches at a radius other than 5 that
    streamed (streamed_by_mode by radius)."""
    out, by = streamed_by_mode(fn, key=lambda kw: len(kw["taps"]) // 2)
    return out, sum(n for r, n in by.items() if r != 5)


# The relaxed tier at a runtime radius (phase 15a-c): the forward's four
# relaxed modes, K3 relaxed at the k-step edges (horizontal passes 2 k-steps
# up to radius 8 and 3 above, vertical ones 1 / 2 / 3 at radii up to 4 / 12
# / 16), the main path's relaxed custom windows and the kernels line's
# figures (relaxed kScore 4K x4 at RT_LINE_RADIUS, K3 at RT_RELAXED_LINE_RADIUS).
RT_RELAXED_MODES = ("score", "map", "components", "pooled")
RT_RELAXED_GRAD_RADII = (1, 3, 4, 8, 9, 12, 13, 16)
RT_RELAXED_LINE_RADIUS = 9
RT_RELAXED_STEPS = 3


def rt_relaxed_kw(a, radius, sigma, tile=None):
    """The relaxed launch's and twin's keywords at radius (tile: the
    default TILE_H x TILE_W)."""
    from ssim_tpu_torch.ops import ssim_cuda

    dr = 1.0 if a.dtype == torch.float32 else 255.0
    th, tw = tile or (ssim_cuda.TILE_H, ssim_cuda.TILE_W)
    return dict(taps=ssim_cuda.gaussian_taps(np.float32, radius, sigma), c1=(0.01 * dr) ** 2,
                c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr), tile_h=th, tile_w=tw)


def rt_relaxed_twin(a, b, mode, kw):
    """The relaxed twin of `mode`, returned as ssim_cuda._launch returns the
    kernel's outputs."""
    from ssim_tpu_torch.ops import ssim_cuda

    if mode == "pooled":
        return ssim_cuda.ssim_components_pooled_plain(a, b, relaxed=True, **kw)
    if mode == "components":
        return ssim_cuda.ssim_components_plain(a, b, relaxed=True, **kw)
    return ssim_cuda.ssim_parts_plain(a, b, with_map=mode == "map", relaxed=True, **kw)


def rt_relaxed_errors(name, mode, got, want, shape, rerun):
    """A relaxed launch against its relaxed twin: per-image scores (mean cs
    and ssim in the components modes) within RELAXED_TWIN_GLOBAL (never
    tighter than 2 RELAXED_TWIN_PIXEL / sqrt(npix)), NaN at the same
    partials, maps within RELAXED_TWIN_PIXEL (NaN at the same pixels),
    pooled images bit for bit. A failed comparison prints relaxed_mismatch
    (rerun(): the launch again). Returns the largest score error."""
    npix = shape[-2] * shape[-1]
    tol = max(RELAXED_TWIN_GLOBAL, 2 * RELAXED_TWIN_PIXEL / npix**0.5)
    if mode in ("components", "pooled"):
        if mode == "pooled":
            for x, y in zip(got[1:], want[1:]):
                check(same(x, y), f"{name}: pooled images differ from the twin's")
            got, want = got[0], want[0]
            again = lambda: rerun()[0].double().sum(-2) / npix
        else:
            again = lambda: rerun().double().sum(-2) / npix
        gk, gp = got.double().sum(-2) / npix, want.double().sum(-2) / npix
    else:
        (pk, mk), (pp, mp) = got, want
        if mp is not None and not (torch.equal(mk.isnan(), mp.isnan())
                                   and max_finite(mk, mp) <= RELAXED_TWIN_PIXEL):
            raise RuntimeError(f"{name}: map vs twin: " + relaxed_mismatch(
                mk, mp, RELAXED_TWIN_PIXEL, lambda: rerun()[1]))
        gk, gp = pk.double().sum(-1) / npix, pp.double().sum(-1) / npix
        again = lambda: rerun()[0].double().sum(-1) / npix
    err = max_finite(gk, gp)
    if not (torch.equal(gk.isnan(), gp.isnan()) and err <= tol):
        raise RuntimeError(f"{name}: scores vs twin (tol {tol:.3g}): "
                           + relaxed_mismatch(gk, gp, tol, again))
    return err


def radius_relaxed_kernels(gen):
    """15a, relaxed: the forward's four relaxed modes at every radius 1-16
    but 5 (u8, and f32 with NaN and inf), poisoned, at the segment the
    picker gives at the relaxed occupancy pinned (each must stream: one
    STREAM_LAUNCHES and one RELAXED_LAUNCHES a launch), and the relaxed tile
    body pinned at fit_tile(32, 256) at radii 1-16 (which tile_w 256 still
    reaches); then K3 relaxed at RT_RELAXED_GRAD_RADII, with and without
    g_map and once with halo operands, poisoned, every launch streaming,
    against its twin and the standard K3. Returns (forward error, tile body
    error, K3 error / max|g|, launches checked by kind)."""
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
    from ssim_tpu_torch.tools import fwd_times

    sigma = fwd_times.RADIUS_SIGMA.__getitem__
    err, body_err, checked = 0.0, 0.0, dict(stream=0, tile_body=0, k3=0)
    u8 = pair(gen, (2, 301, 517))
    f32 = pair(gen, (2, 133, 300), torch.float32, 1.0)
    f32[0][0, 31, 64] = float("nan")
    f32[1][1, 70, 127] = float("inf")
    for radius in range(1, ssim_cuda.MAX_FUSED_RADIUS + 1):
        body_tile = ssim_cuda.fit_tile(32, 256, radius)
        for mode in RT_RELAXED_MODES:
            for a, b in (u8, f32):
                name = f"relaxed {mode} {a.dtype} radius {radius}"
                kt = rt_relaxed_kw(a, radius, sigma(radius), body_tile)
                run = lambda: ssim_cuda._launch(a, b, mode=mode, relaxed=True, tile_body=True,
                                                **kt)
                before = ssim_cuda.STREAM_LAUNCHES
                got = poisoned(run)
                torch.cuda.synchronize()
                check(ssim_cuda.STREAM_LAUNCHES == before,
                      f"{name}: the pinned relaxed tile body streamed")
                body_err = max(body_err, rt_relaxed_errors(
                    f"tile body {body_tile} {name}", mode, got,
                    rt_relaxed_twin(a, b, mode, kt), a.shape, run))
                checked["tile_body"] += 1
                if radius == ssim_cuda.STREAM_RADIUS:
                    continue
                kw = rt_relaxed_kw(a, radius, sigma(radius))
                res = ssim_cuda._stream_resident(a.device.index, mode,
                                                 a.dtype == torch.float32, True, radius)
                seg = ssim_cuda.stream_segment(*a.shape, kw["tile_h"], 2 * radius, res)
                run = lambda: ssim_cuda._launch(a, b, mode=mode, relaxed=True, segment=seg,
                                                **kw)
                before = (ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
                got = poisoned(run)
                torch.cuda.synchronize()
                check((ssim_cuda.STREAM_LAUNCHES, ssim_cuda.RELAXED_LAUNCHES)
                      == (before[0] + 1, before[1] + 1),
                      f"{name}: the pinned relaxed launch did not stream")
                err = max(err, rt_relaxed_errors(name, mode, got,
                                                 rt_relaxed_twin(a, b, mode, kw), a.shape,
                                                 run))
                checked["stream"] += 1
    del u8, f32

    # K3 relaxed at the k-step edges, with a NaN (its tiles NaN in both).
    a, b = pair(gen, (2, 200, 600), torch.float32, 1.0)
    a[1, 100, 250] = float("nan")
    w_s = torch.rand(2, generator=gen, device="cuda") / (200 * 600)
    w_cs = torch.rand(2, generator=gen, device="cuda") * 0.3 / (200 * 600)
    g_map = torch.randn(a.shape, generator=gen, device="cuda") * 1e-6
    grad_err = 0.0
    runs = [(r, g, {}) for r in RT_RELAXED_GRAD_RADII for g in (None, g_map)]
    band = (slice(None), slice(40, 160))
    halo_r = RT_RELAXED_LINE_RADIUS
    halo = dict(vhalo=tuple(x[:, s].contiguous() for x in (a, b)
                            for s in (slice(40 - 2 * halo_r, 40), slice(160, 160 + 2 * halo_r))),
                vmask=(0, 0))
    runs.append((halo_r, None, halo))
    for radius, gm, extra in runs:
        x, y = (a[band].contiguous(), b[band].contiguous()) if extra else (a, b)
        name = (f"K3 relaxed radius {radius}{' g_map' if gm is not None else ''}"
                f"{' halo operands' if extra else ''}")
        kw = dict(taps=ssim_grad._taps(radius, float(sigma(radius))), c1=1e-4, c2=9e-4,
                  clip_bound=131072.0, **extra)
        before = ssim_grad.RELAXED_LAUNCHES
        run = lambda: ssim_grad._launch(x, y, w_s, w_cs, gm, relaxed=True, **kw)
        got = poisoned(run)
        torch.cuda.synchronize()
        check(ssim_grad.RELAXED_LAUNCHES == before + 1,
              f"{name}: the launch did not stream (RELAXED_LAUNCHES)")
        want = ssim_grad.ssim_grad_plain(x, y, w_s, w_cs, gm, relaxed=True, **kw)
        std = ssim_grad._launch(x, y, w_s, w_cs, gm, **kw)
        torch.cuda.synchronize()
        scale = max(float(t[~t.isnan()].abs().max()) for t in std)
        for k, p_, s_, what in zip(got, want, std, ("da", "db")):
            e_twin, e_std = max_finite(k, p_), max_finite(k, s_)
            if not (torch.equal(k.isnan(), p_.isnan()) and e_twin <= RELAXED_GRAD_TWIN * scale):
                raise RuntimeError(f"{name} {what} vs twin: " + relaxed_mismatch(
                    k, p_, RELAXED_GRAD_TWIN * scale,
                    lambda: run()[0 if what == "da" else 1]))
            check(0 < e_std <= RELAXED_GRAD_STD * scale,
                  f"{name} {what}: vs the standard K3 {e_std / scale:.3g} x max|g|")
            grad_err = max(grad_err, e_twin / scale)
        checked["k3"] += 1
    return err, body_err, grad_err, checked


def captured(module, fn):
    """fn()'s result and, for each module._launch call in it (the wrappers
    look it up in the module at each call), its tensor arguments cloned
    before the launch, its keywords, its outputs (launched with the
    outputs poisoned, poisoned_outputs) cloned after it, and a rerun() of
    it on the clones."""
    launch, seen = module._launch, []

    def spied(*args, **kw):
        kept = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
        out = poisoned(lambda: launch(*args, **kw))
        torch.cuda.synchronize()
        flat = lambda o: (tuple(flat(x) for x in o) if isinstance(o, (tuple, list))
                          else o.clone() if isinstance(o, torch.Tensor) else o)
        seen.append((kept, kw, flat(out), lambda: launch(*kept, **kw)))
        return out

    module._launch = spied
    try:
        out = fn()
    finally:
        module._launch = launch
    return out, seen


def twin_window(kw):
    """A forward launch's keywords as its twin takes them."""
    return {k: kw[k] for k in ("taps", "c1", "c2", "clip_bound", "tile_h", "tile_w")}


def radius_relaxed_path(gen, a_np, b_np):
    """15b, relaxed: compute_ssim(accuracy="relaxed") with the custom windows
    RT_MAIN_RADII on NumPy 4K x4 u8 (score and map); RT_RELAXED_STEPS Adam
    steps of ssim_loss(accuracy="relaxed") at RT_RELAXED_LINE_RADIUS on f32
    (4, 1080, 1920), each step's forward and K3 launch, outputs poisoned,
    held against their twins on the same card tensors; and the relaxed
    components and pooled wrappers on msssim_1080_b4's scale-0 pair at
    RT_RELAXED_LINE_RADIUS and at 16 (compute_ms_ssim keeps radius 5, as
    the JAX package's does, so a custom radius reaches these modes through
    the wrappers), against their twins (pooled images bit for bit). Counts
    from 0 before each call; each check states its streaming count: one a
    launch but at radius 16, where the measured rule
    (STREAM_RELAXED_TILE_RADII) keeps the relaxed tile body. Returns (forward launches streaming at a radius other
    than 5, backward launches, calls, largest error, largest K3 error /
    max|g|)."""
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import ssim_cuda, ssim_grad
    from ssim_tpu_torch.tools import fwd_times

    sigma = fwd_times.RADIUS_SIGMA.__getitem__
    fwd, bwd, calls, err, grad_err = 0, 0, {}, 0.0, 0.0
    a, b = torch.from_numpy(a_np).cuda(), torch.from_numpy(b_np).cuda()
    npix = a.shape[1] * a.shape[2]
    for radius in RT_MAIN_RADII:
        win = dict(radius=radius, sigma=sigma(radius))
        for extra in (dict(), dict(with_map=True)):
            # The measured rule (STREAM_RELAXED_TILE_RADII) keeps the relaxed
            # tile body for kScore / kMap at 16 alone.
            streams = 0 if radius == 16 else 1
            zero_counts()
            got, n = rt_launches(lambda: ssim_tpu_torch.compute_ssim(
                a_np, b_np, accuracy="relaxed", **win, **extra))
            counts = {k: v for k, v in launch_counts().items() if v}
            check(n == streams and counts == counts_of_nonzero(relaxed=1, stream=streams),
                  f"relaxed compute_ssim radius {radius} {extra}: launches {counts}, "
                  f"runtime-radius streams {n}, expected {streams}")
            fwd += n
            calls[f"relaxed r{radius}{' map' if extra else ''}"] = counts
            pp, mp = rt_relaxed_twin(a, b, "map", rt_relaxed_kw(a, radius, win["sigma"]))
            if extra:
                check(max_finite(torch.from_numpy(np.asarray(got[1])), mp.cpu())
                      <= RELAXED_TWIN_PIXEL,
                      f"relaxed compute_ssim radius {radius}: the map vs the twin's")
                got = got[0]
            e = float(np.abs(np.asarray(got, np.float64) - scores(pp, npix)).max())
            check(e <= max(RELAXED_TWIN_GLOBAL, 2 * RELAXED_TWIN_PIXEL / npix**0.5),
                  f"relaxed compute_ssim radius {radius}: {got} vs the twin's")
            err = max(err, e)
            del pp, mp
    del a, b
    # Training with a custom window, relaxed: each step's forward and K3,
    # launched with their outputs poisoned, against their twins.
    radius = RT_RELAXED_LINE_RADIUS
    shape = (4, 1080, 1920)
    clean, noisy = pair(gen, shape, torch.float32, 1.0)
    x = noisy.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=1e-3)
    losses, fwd_seen, bwd_seen = [], [], []

    def step():
        opt.zero_grad()
        loss = ssim_tpu_torch.ssim_loss(x, clean, accuracy="relaxed", radius=radius,
                                        sigma=sigma(radius))
        loss.backward()
        return loss

    zero_counts()
    for _ in range(RT_RELAXED_STEPS):
        (loss, seen_b), seen_f = captured(ssim_cuda, lambda: captured(ssim_grad, step))
        fwd_seen += seen_f
        bwd_seen += seen_b
        opt.step()
        with torch.no_grad():
            x.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    n = RT_RELAXED_STEPS
    check(counts == counts_of_nonzero(relaxed=n, stream=n, backward_relaxed=n)
          and len(fwd_seen) == len(bwd_seen) == n
          and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"relaxed ssim_loss radius {radius}: launches {counts}, losses {losses}")
    for i, (args, kw, got, rerun) in enumerate(fwd_seen):
        check(kw.get("relaxed") and len(kw["taps"]) == 2 * radius + 1,
              f"relaxed ssim_loss step {i}: its forward launch {kw.get('mode')} was not "
              f"relaxed at radius {radius}")
        want = rt_relaxed_twin(args[0], args[1], kw["mode"], twin_window(kw))
        err = max(err, rt_relaxed_errors(f"relaxed ssim_loss step {i} forward", kw["mode"],
                                         got, want, args[0].shape, rerun))
    for i, (args, kw, got, rerun) in enumerate(bwd_seen):
        name = f"relaxed ssim_loss step {i} K3 {tuple(args[0].shape)} radius {radius}"
        check(kw.get("relaxed") and len(kw["taps"]) == 2 * radius + 1,
              f"{name}: the launch was not relaxed at radius {radius}")
        want = ssim_grad.ssim_grad_plain(*args, **kw)
        torch.cuda.synchronize()
        scale = max(float(t[~t.isnan()].abs().max()) for t in want)
        for k, p_, what in zip(got, want, ("da", "db")):
            e_twin = max_finite(k, p_)
            if not (torch.equal(k.isnan(), p_.isnan()) and e_twin <= RELAXED_GRAD_TWIN * scale):
                raise RuntimeError(f"{name} {what} vs twin: " + relaxed_mismatch(
                    k, p_, RELAXED_GRAD_TWIN * scale,
                    lambda: rerun()[0 if what == "da" else 1]))
            grad_err = max(grad_err, e_twin / scale)
        del want
    fwd += n
    bwd += n
    calls[f"relaxed ssim_loss r{radius} x{n}"] = counts
    del clean, noisy, x, opt, fwd_seen, bwd_seen
    # The MS-SSIM scale-0 modes at a custom window on msssim_1080_b4's pair:
    # pooled on u8, components on f32 (the pyramid's input dtypes).
    a8, b8 = pair(gen, shape)
    af, bf = a8.float() / 255.0, b8.float() / 255.0
    wrappers = (("pooled", ssim_cuda.ssim_components_pooled_cuda, a8, b8, 255.0),
                ("components", ssim_cuda.ssim_components_cuda, af, bf, 1.0))
    for mode, wrapper, p, q, dr in wrappers:
        # Both stream at radius 9; the measured rule keeps the relaxed tile
        # body for both at 16.
        for radius, streams in ((RT_RELAXED_LINE_RADIUS, 1), (16, 0)):
            name = f"relaxed {mode} {p.dtype} {shape} radius {radius}"
            zero_counts()
            _, seen = captured(ssim_cuda, lambda: wrapper(
                p, q, data_range=dr, radius=radius, sigma=sigma(radius), relaxed=True))
            counts = {k: v for k, v in launch_counts().items() if v}
            check(counts == counts_of_nonzero(relaxed=1, stream=streams) and len(seen) == 1,
                  f"{name}: launches {counts}, expected one, {streams} streaming")
            args, kw, got, rerun = seen[0]
            want = rt_relaxed_twin(args[0], args[1], mode, twin_window(kw))
            err = max(err, rt_relaxed_errors(name, mode, got, want, shape, rerun))
            fwd += streams
            calls[name] = counts
            del want, got, seen
    del a8, b8, af, bf
    torch.cuda.empty_cache()
    return fwd, bwd, calls, err, grad_err


def radius_relaxed_times(gen, label):
    """15c, relaxed: the relaxed forward stream and its tile body in turns
    (tools/fwd_times.radius_times, RELAXED_RADIUS_CASES) at fwd_times.RADII,
    and K3 relaxed at grad_1080_b4 at RT_RELAXED_GRAD_RADII, each beside its
    bound (relaxed_fwd_bound, relaxed_bwd_bound); the twins' times at the
    kernels line's radii."""
    from ssim_tpu_torch.ops import ssim_grad
    from ssim_tpu_torch.tools import fwd_times

    sigma = fwd_times.RADIUS_SIGMA.__getitem__
    ms, times = {}, {}
    fwd_times.radius_times(gen, ms, cases=fwd_times.RELAXED_RADIUS_CASES, relaxed=True)
    for name, mode, shape, f32 in fwd_times.RELAXED_RADIUS_CASES:
        bsz, h, w = shape
        item = 4 if f32 else 1
        for radius in fwd_times.RADII:
            if mode == "pooled":
                bnd, by = relaxed_fwd_bound(shape, item, radius, 4,
                                            8 * bsz * -(-h // 32) * -(-w // 64)
                                            + 2 * bsz * h * w)
            elif mode == "components":
                bnd, by = relaxed_fwd_bound(shape, item, radius, 2,
                                            8 * bsz * -(-h // 32) * -(-w // 64))
            else:
                bnd, by = relaxed_fwd_bound(shape, item, radius)
            key = f"{name} r{radius}"
            times[key] = dict(ms=ms[key], tile_body_ms=ms[f"{key} tile body"],
                              segment=ms[f"{key} segment"], bound_ms=bnd, bound_by=by,
                              shape=list(shape))
            print(f"  {key}: stream {ms[key]:.4f} ms, tile body {ms[f'{key} tile body']:.4f} "
                  f"ms (stream / tile body {ms[key] / ms[f'{key} tile body']:.3f}), bound "
                  f"{bnd:.4f} ms ({by}) | {label}", flush=True)
    shape = (4, 1080, 1920)
    a, b = pair(gen, shape, torch.float32, 1.0)
    w_s = torch.full((4,), 1.0 / (shape[1] * shape[2]), device="cuda")
    w_cs = torch.zeros(4, device="cuda")
    for radius in RT_RELAXED_GRAD_RADII:
        fn = lambda: ssim_grad.ssim_grad_cuda(a, b, w_s, w_cs, None, data_range=1.0,
                                              radius=radius, sigma=sigma(radius),
                                              relaxed=True)
        t = [cuda_ms(fn, 10), cuda_ms(fn, 10)]
        bnd, by = relaxed_bwd_bound(shape, False, radius)
        key = f"K3 relaxed grad_1080_b4 r{radius}"
        times[key] = dict(ms=min(t), runs_ms=t, bound_ms=bnd, bound_by=by, shape=list(shape),
                          strip=ssim_grad.relaxed_strip_w(radius))
        print(f"  {key}: {t[0]:.4f} / {t[1]:.4f} ms (strip "
              f"{ssim_grad.relaxed_strip_w(radius)}), bound {bnd:.4f} ms ({by}) | {label}",
              flush=True)
    radius = RT_RELAXED_LINE_RADIUS
    kw = dict(taps=ssim_grad._taps(radius, float(sigma(radius))), c1=1e-4, c2=9e-4,
              clip_bound=131072.0)
    bwd_line = dict(times[f"K3 relaxed grad_1080_b4 r{radius}"], radius=radius)
    bwd_line["plain_ms"] = cuda_ms(lambda: ssim_grad.ssim_grad_plain(
        a, b, w_s, w_cs, None, relaxed=True, **kw), 3)
    del a, b
    a, b = pair(gen, RT_MAIN_SHAPE)
    fwd_line = dict(times[f"relaxed kScore 4k_b4 r{RT_LINE_RADIUS}"], radius=RT_LINE_RADIUS)
    kw = rt_relaxed_kw(a, RT_LINE_RADIUS, sigma(RT_LINE_RADIUS))
    fwd_line["plain_ms"] = cuda_ms(lambda: rt_relaxed_twin(a, b, "score", kw), 3)
    print(f"  relaxed kScore 4k_b4 r{RT_LINE_RADIUS}: twin {fwd_line['plain_ms']:.3f} ms; "
          f"K3 relaxed grad_1080_b4 r{radius}: twin {bwd_line['plain_ms']:.3f} ms", flush=True)
    del a, b
    torch.cuda.empty_cache()
    return times, fwd_line, bwd_line


# The batch modes at a runtime radius (phase 15d): compute_ssim on the
# routed batch at RT_MAIN_RADII, one ssim_loss step at RT_LINE_RADIUS, then
# times (tools/fwd_times.batch_radius_times) at fwd_times.RADII.
RT_BATCH_SHAPE = (4096, 64, 64)
RT_BATCH_STEP_SHAPE = (256, 64, 64)


def batch_rt_bound(shape, radius, precise=False, relaxed=False, itemsize=1):
    """The bound of a batch launch on (B, H, W) inputs of itemsize bytes at
    radius: one partial pair per image (f32, f64 in kBatchPrecise)."""
    if precise:
        return precise_bound(shape, itemsize, radius=radius, out_bytes=16 * shape[0])
    if relaxed:
        return relaxed_fwd_bound(shape, itemsize, radius, out_bytes=8 * shape[0])
    return fwd_bound(shape, itemsize, radius=radius, out_bytes=8 * shape[0])


def radius_batch(gen, label):
    """15d: the batch route with a custom window, every plain twin made to
    raise (no_plain_twins) while the calls run: compute_ssim on NumPy u8
    RT_BATCH_SHAPE (the routed batch) at RT_MAIN_RADII in the standard,
    f64 and relaxed tiers, counts from 0 (one batch launch each, on the
    runtime-radius packed stream but where the measured rule,
    ssim_cuda.STREAM_BATCH_TILE_RADII, keeps the tile body; phase 8(a)
    holds the stream there), the scores against the twin; one
    ssim_loss Adam step on f32 RT_BATCH_STEP_SHAPE at RT_LINE_RADIUS, its
    forward launch (outputs poisoned, captured) against the twin; then the
    stream and the tile body in turns (tools/fwd_times.batch_radius_times)
    at fwd_times.RADII beside each bound, and the twin's time at
    RT_LINE_RADIUS. Returns a dict: launches, calls, err, times, line."""
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import ssim_cuda
    from ssim_tpu_torch.tools import fwd_times

    sigma = fwd_times.RADIUS_SIGMA.__getitem__
    a, b = pair(gen, RT_BATCH_SHAPE)
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    npix = RT_BATCH_SHAPE[1] * RT_BATCH_SHAPE[2]
    launches, calls, err = 0, {}, 0.0
    tiers = (("standard", {}, "batch", False), ("f64", dict(precision="f64"), "batch_precise",
                                                 False),
             ("relaxed", dict(accuracy="relaxed"), "relaxed", True))
    for radius in RT_MAIN_RADII:
        win = dict(radius=radius, sigma=sigma(radius))
        for tier, extra, counter, relaxed in tiers:
            # The measured rule (stream_applies) decides stream or tile body.
            streams = int(ssim_cuda.stream_applies(
                "batch_precise" if tier == "f64" else "batch", radius, ssim_cuda.TILE_W,
                relaxed, int(np.prod(RT_BATCH_SHAPE)), width=RT_BATCH_SHAPE[2]))
            want_counts = counts_of_nonzero(**{counter: 1}, stream=streams)
            zero_counts()
            with no_plain_twins():
                got = ssim_tpu_torch.compute_ssim(a_np, b_np, **win, **extra)
            counts = {k: v for k, v in launch_counts().items() if v}
            check(counts == want_counts,
                  f"batch compute_ssim radius {radius} {tier}: launches {counts}, expected "
                  f"{want_counts}")
            launches += streams
            calls[f"r{radius} {tier}"] = counts
            g_twin = scores(batch_twin(a, b, tier == "f64", relaxed=tier == "relaxed",
                                       **win), npix)
            got = np.asarray(got, np.float64)
            e = float(np.abs(got - g_twin).max())
            tol = (PRECISE_REL * float(np.abs(g_twin).max()) if tier == "f64" else
                   max(RELAXED_TWIN_GLOBAL, 2 * RELAXED_TWIN_PIXEL / npix**0.5)
                   if tier == "relaxed" else TWIN_GLOBAL)
            check(got.shape == (RT_BATCH_SHAPE[0],) and e <= tol,
                  f"batch compute_ssim radius {radius} {tier}: {e:.3g} from the twin "
                  f"(tol {tol:.3g})")
            err = max(err, e)
    # One training step with a custom window on the batch route.
    radius = RT_LINE_RADIUS
    clean = torch.rand(RT_BATCH_STEP_SHAPE, generator=gen, device="cuda")
    noisy = (clean + 0.15 * torch.randn(RT_BATCH_STEP_SHAPE, generator=gen,
                                        device="cuda")).clamp_(0, 1)
    x = noisy.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=0.02)
    zero_counts()
    with no_plain_twins():
        loss, seen = captured(ssim_cuda, lambda: ssim_tpu_torch.ssim_loss(
            x, clean, radius=radius, sigma=sigma(radius)))
        loss.backward()
        opt.step()
    counts = {k: v for k, v in launch_counts().items() if v}
    with torch.no_grad():
        after = ssim_tpu_torch.ssim_loss(x.clamp(0.0, 1.0), clean, radius=radius,
                                         sigma=sigma(radius))
    losses = [float(loss.detach()), float(after)]
    streams = int(ssim_cuda.stream_applies("batch", radius, ssim_cuda.TILE_W, False,
                                           int(np.prod(RT_BATCH_STEP_SHAPE)), True,
                                           RT_BATCH_STEP_SHAPE[2]))
    check(counts == counts_of_nonzero(batch=1, backward=1, stream=streams) and len(seen) == 1
          and bool(torch.isfinite(x.grad).all()) and losses[1] < losses[0],
          f"batch ssim_loss step radius {radius}: launches {counts}, losses {losses}")
    args, kw, got, _ = seen[0]
    check(kw["mode"] == "batch" and len(kw["taps"]) == 2 * radius + 1,
          f"batch ssim_loss step: its launch {kw['mode']} at {len(kw['taps']) // 2}")
    step_npix = RT_BATCH_STEP_SHAPE[1] * RT_BATCH_STEP_SHAPE[2]
    e = float(np.abs(scores(got, step_npix) - scores(batch_twin(
        args[0], args[1], False, data_range=1.0, radius=radius, sigma=sigma(radius)),
        step_npix)).max())
    check(e <= TWIN_GLOBAL, f"batch ssim_loss step radius {radius}: vs twin {e:.3g}")
    err = max(err, e)
    launches += streams
    calls[f"ssim_loss r{radius}"] = counts
    print(f"  batch route, radius != 5: compute_ssim NumPy u8 {RT_BATCH_SHAPE} at radii "
          f"{RT_MAIN_RADII} (standard, f64, relaxed) and an ssim_loss step on f32 "
          f"{RT_BATCH_STEP_SHAPE} at radius {radius} (1-SSIM {losses[0]:.6f} -> "
          f"{losses[1]:.6f}), the twins made to raise: {launches} runtime-radius packed "
          f"stream launches, largest error from the twin {err:.3g}; {calls}", flush=True)
    del x, opt, clean, noisy, seen, args, got

    ms = {}
    fwd_times.batch_radius_times(gen, ms, radii=fwd_times.RADII)
    times = {}
    for name, shape, precise, relaxed, f32 in fwd_times.BATCH_RADIUS_CASES:
        for radius in fwd_times.RADII:
            bnd, by = batch_rt_bound(shape, radius, precise, relaxed, 4 if f32 else 1)
            key = f"{name} r{radius}"
            times[key] = dict(ms=ms[key], tile_body_ms=ms[f"{key} tile body"],
                              pack=ms[f"{key} pack"], bound_ms=bnd, bound_by=by,
                              shape=list(shape))
            print(f"  {key}: stream {ms[key]:.4f} ms, tile body {ms[f'{key} tile body']:.4f} "
                  f"ms (stream / tile body {ms[key] / ms[f'{key} tile body']:.3f}), bound "
                  f"{bnd:.4f} ms ({by}) | {label}", flush=True)
    line = dict(times[f"kBatch 64x64_b4096 r{RT_LINE_RADIUS}"], radius=RT_LINE_RADIUS)
    win = dict(radius=RT_LINE_RADIUS, sigma=sigma(RT_LINE_RADIUS))
    line["plain_ms"] = cuda_ms(lambda: batch_twin(a, b, False, **win), 3)
    print(f"  kBatch 64x64_b4096 r{RT_LINE_RADIUS}: twin {line['plain_ms']:.3f} ms", flush=True)
    del a, b
    torch.cuda.empty_cache()
    return dict(launches=launches, calls=calls, err=err, times=times, line=line,
                losses=losses)


def phase_radius(gen, label):
    """Phase 15: (a) the runtime-radius instantiation in all eight modes at
    every radius 1-16 but 5 against the twins, outputs poisoned, at the
    segment the wrapper picks pinned (u8 and f32 with NaN and inf), the row
    modes with halo operands of r rows, every launch streaming (no rule
    keeps the tile body there); beside it the tile body (pinned), which
    still serves a tile_w of 256, in the same eight modes at every radius
    1-16 at the tile fit_tile gives a 32 x 256 setting, outputs poisoned,
    against the twin at that tile; (b) the main path: compute_ssim with
    custom windows on NumPy 4K x4 u8, counts from 0 (one forward launch a
    call, streaming), scores and the map against the twin;
    (c) the stream and the tile body in turns at radii 1, 3, 4, 6, 8, 16
    (tools/fwd_times.radius_times) beside each bound, and the twin's time
    at RT_LINE_RADIUS. The relaxed tier likewise (radius_relaxed_kernels,
    radius_relaxed_path, radius_relaxed_times): its forward modes and K3
    at a runtime radius, the main path's relaxed custom windows, times;
    (d) the batch modes on the runtime-radius packed stream (radius_batch;
    their kernels are held in phase 8(a)): the batch route's public calls
    with custom windows, times."""
    import ssim_tpu_torch
    from ssim_tpu_torch.ops import ssim_cuda
    from ssim_tpu_torch.tools import fwd_times

    print("phase 15: the forward's row stream at a runtime radius "
          "(ssim_fwd_stream_rt.cu)", flush=True)
    t0 = time.perf_counter()
    sigma = fwd_times.RADIUS_SIGMA.__getitem__
    err, checked, body_err, body_checked = 0.0, 0, 0.0, 0
    # (a) Every mode at every radius.
    u8 = pair(gen, (2, 301, 517))
    f32 = pair(gen, (2, 133, 300), torch.float32, 1.0)
    f32[0][0, 31, 64] = float("nan")
    f32[1][1, 70, 127] = float("inf")
    for radius in range(1, ssim_cuda.MAX_FUSED_RADIUS + 1):
        for mode in RT_MODES:
            body_tile = ssim_cuda.fit_tile(32, 256, radius, mode.startswith("precise"))
            for a, b in (u8, f32):
                kw = rt_kw(a, mode, radius, sigma(radius))
                halo = {}
                if mode.startswith("rowsum"):
                    h = a.shape[1]
                    halo = dict(vhalo=(a[:, h - radius:].contiguous(),
                                       a[:, :radius].contiguous(),
                                       b[:, h - radius:].contiguous(),
                                       b[:, :radius].contiguous()), vmask=(0, 1))
                # The tile body, pinned, at the tile a tile_w 256 setting gets.
                kt = dict(kw, tile_h=body_tile[0], tile_w=body_tile[1])
                before = ssim_cuda.STREAM_LAUNCHES
                got = poisoned(lambda: ssim_cuda._launch(a, b, mode=mode, tile_body=True,
                                                         **halo, **kt))
                torch.cuda.synchronize()
                check(ssim_cuda.STREAM_LAUNCHES == before,
                      f"{mode} radius {radius}: the pinned tile body streamed")
                body_err = max(body_err, rt_errors(
                    f"tile body {body_tile} {mode} {a.dtype} radius {radius}", mode, got,
                    rt_twin(a, b, mode, kt, **halo), a.shape))
                body_checked += 1
                if radius == ssim_cuda.STREAM_RADIUS:
                    continue
                res = ssim_cuda._stream_resident(a.device.index, mode,
                                                 a.dtype == torch.float32, False, radius)
                seg = ssim_cuda.stream_segment(*a.shape, kw["tile_h"], 2 * radius, res)
                before = ssim_cuda.STREAM_LAUNCHES
                got = poisoned(lambda: ssim_cuda._launch(a, b, mode=mode, segment=seg,
                                                         **halo, **kw))
                torch.cuda.synchronize()
                check(ssim_cuda.STREAM_LAUNCHES == before + 1,
                      f"{mode} radius {radius}: the pinned launch did not stream")
                want = rt_twin(a, b, mode, kw, **halo)
                err = max(err, rt_errors(f"{mode} {a.dtype} radius {radius}", mode, got,
                                         want, a.shape))
                checked += 1
    # Wider than the TPU kernel's 16384 lanes (K2's widths): the same grid.
    wide = pair(gen, (1, 70, 16500))
    for radius in (1, 8, 16):
        for mode in RT_MODES:
            kw = rt_kw(wide[0], mode, radius, sigma(radius))
            before = ssim_cuda.STREAM_LAUNCHES
            got = poisoned(lambda: ssim_cuda._launch(*wide, mode=mode, **kw))
            torch.cuda.synchronize()
            check(ssim_cuda.STREAM_LAUNCHES == before + 1,
                  f"{mode} radius {radius} (1, 70, 16500): the launch did not stream")
            err = max(err, rt_errors(f"{mode} u8 (1, 70, 16500) radius {radius}", mode, got,
                                     rt_twin(*wide, mode, kw), wide[0].shape))
            checked += 1
    print(f"  {checked} streaming launches (8 modes, radii 1-16 but 5, u8 (2, 301, 517) "
          f"and f32 (2, 133, 300) with NaN and inf, row modes with halo operands of r rows; "
          f"radii 1, 8, 16 on u8 (1, 70, 16500)), outputs poisoned: all match the twins, "
          f"largest score / row error {err:.3g}; the tile body (pinned, fit_tile(32, 256)) "
          f"in the same modes at radii 1-16: {body_checked} launches, outputs poisoned, all "
          f"match the twins, largest error {body_err:.3g}", flush=True)
    del u8, f32, wide
    rel_err, rel_body_err, rel_grad_err, rel_checked = radius_relaxed_kernels(gen)
    print(f"  relaxed: {rel_checked['stream']} streaming launches (score, map, components, "
          f"pooled; radii 1-16 but 5; u8 and f32 with NaN and inf), outputs poisoned: all "
          f"match the relaxed twins, largest score error {rel_err:.3g}; the relaxed tile body "
          f"(pinned, fit_tile(32, 256)) at radii 1-16: {rel_checked['tile_body']} "
          f"launches, largest error {rel_body_err:.3g}; K3 relaxed at radii "
          f"{RT_RELAXED_GRAD_RADII} +- g_map and at {RT_RELAXED_LINE_RADIUS} with halo "
          f"operands: {rel_checked['k3']} streaming launches, poisoned, within "
          f"{rel_grad_err:.3g} x max|g| of the twin", flush=True)

    # (b) The main path.
    a, b = pair(gen, RT_MAIN_SHAPE)
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    launches, calls = 0, {}
    for radius in RT_MAIN_RADII:
        win = dict(radius=radius, sigma=sigma(radius))
        for extra in (dict(), dict(with_map=True), dict(precision="f64")):
            zero_counts()
            got, n = rt_launches(lambda: ssim_tpu_torch.compute_ssim(a_np, b_np, **win,
                                                                      **extra))
            counts = {k: v for k, v in launch_counts().items() if v}
            mode = ("precise" if extra.get("precision") else
                    "map" if extra.get("with_map") else "score")
            check(n == 1 and counts.get("stream", 0) == 1
                  and counts.get("precise" if mode == "precise" else "standard") == 1
                  and sum(counts.values()) == 2,
                  f"compute_ssim radius {radius} {extra}: launches {counts}, runtime-radius "
                  f"streams {n}, expected 1")
            launches += n
            calls[f"r{radius} {mode}"] = counts
            kw = rt_kw(a, mode, radius, win["sigma"])
            pp, mp = rt_twin(a, b, mode, kw)
            g_twin = scores(pp, a.shape[1] * a.shape[2])
            if extra.get("with_map"):
                check(torch.equal(torch.from_numpy(np.asarray(got[1])), mp.cpu()),
                      f"compute_ssim radius {radius}: the map differs from the twin's")
                got = got[0]
            got = np.asarray(got, np.float64)
            e = float(np.abs(got - g_twin).max())
            tol = (PRECISE_REL * float(np.abs(g_twin).max()) if mode == "precise"
                   else TWIN_GLOBAL)
            check(got.shape == (RT_MAIN_SHAPE[0],) and e <= tol,
                  f"compute_ssim radius {radius} {extra}: {got} vs the twin {g_twin}")
            err = max(err, e)
            del pp, mp
    print(f"  compute_ssim NumPy u8 {RT_MAIN_SHAPE}, no device, radii {RT_MAIN_RADII}, "
          f"score / map / f64: {launches} runtime-radius streaming launches; "
          f"{calls}", flush=True)
    rel_fwd, rel_bwd, rel_calls, rel_path_err, rel_path_grad_err = radius_relaxed_path(
        gen, a_np, b_np)
    print(f"  relaxed: compute_ssim (score, map) at radii {RT_MAIN_RADII}, "
          f"{RT_RELAXED_STEPS} ssim_loss steps at radius {RT_RELAXED_LINE_RADIUS} on f32 "
          f"(4, 1080, 1920) (each step's forward and K3 poisoned, against their twins: K3 "
          f"within {rel_path_grad_err:.3g} x max|g|), the components / pooled wrappers at "
          f"msssim_1080_b4 scale 0, radii {RT_RELAXED_LINE_RADIUS} and 16: {rel_fwd} relaxed "
          f"forward and {rel_bwd} relaxed K3 runtime-radius streaming launches, largest "
          f"score error {rel_path_err:.3g}; {rel_calls}", flush=True)

    # (c) Times.
    ms = {}
    fwd_times.radius_times(gen, ms)
    times = {}
    for name, mode, shape, is_f32 in fwd_times.RADIUS_CASES:
        bsz, h, w = shape
        npix = bsz * h * w
        tiles = bsz * -(-h // 32) * -(-w // 64)
        for radius in fwd_times.RADII:
            if mode == "precise":
                bnd, by = precise_bound(shape, 1, radius=radius)
            elif mode == "components":
                bnd, by = comp_bound(shape, 4, False, radius=radius)
            elif mode == "map":
                bnd, by = fwd_bound(shape, 1, radius=radius, out_bytes=4 * tiles + 4 * npix)
            elif mode == "rowsum":
                bnd, by = fwd_bound(shape, 1, radius=radius,
                                    out_bytes=4 * bsz * h + 4 * radius * bsz * w)
            else:
                bnd, by = fwd_bound(shape, 1, radius=radius)
            key = f"{name} r{radius}"
            times[key] = dict(ms=ms[key], tile_body_ms=ms[f"{key} tile body"],
                              segment=ms[f"{key} segment"], bound_ms=bnd, bound_by=by,
                              shape=list(shape))
            print(f"  {key}: stream {ms[key]:.4f} ms, tile body "
                  f"{ms[f'{key} tile body']:.4f} ms (stream / tile body "
                  f"{ms[key] / ms[f'{key} tile body']:.3f}), bound {bnd:.4f} ms ({by}) | "
                  f"{label}", flush=True)
    a, b = pair(gen, RT_MAIN_SHAPE)
    kw = rt_kw(a, "score", RT_LINE_RADIUS, sigma(RT_LINE_RADIUS))
    line = dict(times[f"kScore 4k_b4 r{RT_LINE_RADIUS}"])
    line["plain_ms"] = cuda_ms(lambda: rt_twin(a, b, "score", kw), 3)
    print(f"  kScore 4k_b4 r{RT_LINE_RADIUS}: twin {line['plain_ms']:.3f} ms", flush=True)
    del a, b
    torch.cuda.empty_cache()
    rel_times, rel_fwd_line, rel_bwd_line = radius_relaxed_times(gen, label)
    batch = radius_batch(gen, label)
    seconds = time.perf_counter() - t0
    print(f"  phase 15: {seconds:.1f} s", flush=True)
    return dict(err=err, launches=launches, calls=calls, times=times, line=line,
                checked=checked, body_err=body_err, body_checked=body_checked,
                seconds=seconds, batch=batch, relaxed=dict(
                    err=max(rel_err, rel_path_err), body_err=rel_body_err,
                    grad_err=max(rel_grad_err, rel_path_grad_err),
                    checked=rel_checked, launches_fwd=rel_fwd, launches_bwd=rel_bwd,
                    calls=rel_calls, times=rel_times, fwd_line=rel_fwd_line,
                    bwd_line=rel_bwd_line))


def fail_line(error):
    """The one line printed when the script cannot start, before its
    nonzero exit."""
    print(json.dumps({"ok": False, "error": error}), flush=True)


def main():
    if not torch.cuda.is_available():
        fail_line("CUDA is not available: this script needs a GPU")
        return 2
    try:
        from ssim_tpu_torch.ops import _build
    except ImportError as e:
        fail_line(f"cannot import the ssim_tpu_torch package ({e}): run the "
                  f"script from a checkout of the repo")
        return 1

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
    launches, stream_launches, records = phase_main(gen, label)
    train_fwd, train_bwd, grad_err, train = phase_train(gen, label)
    comp_err, ms = phase_msssim(gen, label)
    prec_launches, prec_err, prec = phase_precise(gen, label)
    batch = phase_batch(gen, label)
    halo_fwd_err, halo_bwd_err = phase_spatial_kernels(gen)
    spatial = phase_spatial(gen, label)
    relaxed = phase_relaxed(gen, label)
    pad = phase_pad(gen, label)
    cli = phase_cli(gen, label)
    par = phase_parallel(gen, label)
    testing = phase_testing(gen, label)
    radius = phase_radius(gen, label)
    check("jax" not in sys.modules, "JAX was imported")

    ref = records["4k_b4"]
    bwd = train["grad_1080_b4"]
    cli_launches = cli["launches"]
    print(json.dumps({"cli": {
        "launches": cli_launches,
        "dir_designs": cli["res"]["dir_1080p"]["designs"],
        "printed_vs_computed": cli["errs"],
        "host_vs_kernel": cli["host_vs_kernel"],
        "fresh_process_ms": cli["fresh_ms"],
        "fresh_process_runs_ms": cli["fresh_runs_ms"],
        "times": cli["times"],
    }}))
    pres = par["res"]
    print(json.dumps({"parallel": {
        "launches": par["launches"],
        "launches_by_call": par["calls"],
        "mean_vs_engine": {k: pres[k]["mean_err"] for k in ("frames", "small")},
        "means": {k: pres[k]["mean"] for k in ("frames", "small", "multihost")},
        "step": pres["step"],
        "times": par["times"],
        "device": label,
    }}))
    print(json.dumps({"devicebench": {
        **testing["bench"],
        "graph": {c[1]: testing["runners"][c[0]]["graph_loop"] for c in RUNNER_CASES},
        "vs_kernel": testing["vs_kernel"],
        "launches_by_config": {k: {m: n for m, n in v.items() if n}
                               for k, v in testing["counts"].items()},
        "runners": testing["runners"],
        "report": testing["report"],
        "phase_s": testing["seconds"],
        "device": label,
    }}))
    tl = testing["launches"]
    print(json.dumps({"kernels": [{
        "name": "ssim_fwd",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710, ssim_tpu/ops/ssim_pallas.py:1364",
        "design": STREAM_DESIGN,
        "launches": launches,
        "launches_stream": stream_launches,
        "launches_training": train_fwd,
        "launches_cli": cli_launches.get("standard", 0),
        "launches_parallel": {k: par["launches"][k]
                              for k in ("standard", "batch", "rowsum", "stream")},
        "launches_devicebench": tl["standard"],
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
        "launches_parallel": par["launches"]["backward_vhalo"],
        "launches_devicebench": tl["backward"],
        "max_abs_err": grad_err,
        "ms": bwd["kernel_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,
        "shape": bwd["shape"],
        "ms_gmap": bwd["kernel_gmap_ms"],
        "ms_4k_b4": train["grad_4k_b4"]["kernel_ms"],
        "ms_4k_b4_gmap": train["grad_4k_b4"]["kernel_gmap_ms"],
        "train_step_ms": train["train_step"]["step_ms"],
        "train_step_trace_busy_ms": train["train_step"]["trace_busy_ms"],
        "train_step_trace_k3_ms": train["train_step"]["trace_k3_ms"],
        "msssim_train_step_ms": statistics.median(ms["train_step_ms"]),
        "msssim_step_trace_busy_ms": ms["trace_busy_ms"],
        "msssim_step_trace_k3_ms": ms["trace_k3_ms"],
        "launches_msssim_training": ms["train"]["backward"],
        "msssim_grad_vs_autograd": ms["grad_err"],
        "msssim_grad_max": ms["grad_scale"],
    }, {
        "name": "ssim_fwd_components",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "design": COMP_STREAM_DESIGN,
        "replaces": "ssim_tpu/ops/ssim_pallas.py:1957 (K1 mode c), "
                    "ssim_tpu/ops/ssim_pallas.py:1364 (K2 components)",
        "launches": ms["infer"]["components"],
        "launches_stream": ms["infer_stream"]["components"],
        "launches_training": ms["train"]["components"],
        "launches_stream_training": ms["train_stream"]["components"],
        "launches_cli": cli_launches.get("components", 0),
        "launches_devicebench": tl["components"],
        "max_abs_err": comp_err,
        **{k: ms["times"]["components_f32_train_scale0"][k]
           for k in ("ms", "turns_ms", "device_ms", "tile_body_ms", "tile_body_device_ms",
                     "plain_ms", "bound_ms", "bound_by", "shape")},
        "library_ms": None,
        **{f"{k}_last_scale": ms["times"]["components_f32_scale4"][k]
           for k in ("design", "ms", "device_ms", "tile_body_ms", "tile_body_device_ms",
                     "plain_ms", "bound_ms", "shape")},
        **{f"{k}_wide": ms["times"]["components_u8_wide"][k]
           for k in ("ms", "device_ms", "tile_body_ms", "tile_body_device_ms", "plain_ms",
                     "bound_ms", "shape")},
    }, {
        "name": "ssim_fwd_pooled",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "design": COMP_STREAM_DESIGN,
        "replaces": "ssim_tpu/ops/ssim_pallas.py:2066 (K1 mode d)",
        "launches": ms["infer"]["pooled"],
        "launches_stream": ms["infer_stream"]["pooled"],
        "launches_cli": cli_launches.get("pooled", 0),
        "launches_devicebench": tl["pooled"],
        "max_abs_err": comp_err,
        **{k: ms["times"]["pooled_u8_scale0"][k]
           for k in ("ms", "turns_ms", "device_ms", "tile_body_ms", "tile_body_device_ms",
                     "plain_ms", "bound_ms", "bound_by", "shape")},
        "library_ms": None,
        **{f"{k}_f32_scale1": ms["times"]["pooled_f32_scale1"][k]
           for k in ("ms", "device_ms", "tile_body_ms", "tile_body_device_ms", "plain_ms",
                     "bound_ms")},
        "compute_ms_ssim_ms": statistics.median(ms["compute_ms_ssim_ms"]),
        "msssim_train_step_ms": statistics.median(ms["train_step_ms"]),
        "msssim_step_trace_busy_ms": ms["trace_busy_ms"],
        "msssim_step_trace_fwd_ms": ms["trace_fwd_ms"],
    }, {
        "name": "ssim_fwd_precise",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "design": PRECISE_STREAM_DESIGN,
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710 (K1 mode b), "
                    "ssim_tpu/ops/ssim_pallas.py:1364 (K2 precise)",
        "launches": prec_launches,
        "launches_stream": prec["launches_stream"],
        "launches_devicebench": tl["precise"],
        "max_abs_err": prec_err,
        **{k: prec["4k_b4"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "library_ms": None,
        "dp_floor_ms": prec["4k_b4"]["dp_floor_ms"],
        "map_ms": prec["4k_b4"]["map_ms"],
        "standard_ms": prec["4k_b4"]["standard_ms"],
        "ms_1080p_b4": prec["1080p_b4"]["ms"],
        "map_ms_1080p_b4": prec["1080p_b4"]["map_ms"],
        "ms_16k_b1": prec["16k_b1"]["ms"],
        "map_ms_16k_b1": prec["16k_b1"]["map_ms"],
        "bound_ms_16k_b1": prec["16k_b1"]["bound_ms"],
        "dp_floor_ms_16k_b1": prec["16k_b1"]["dp_floor_ms"],
        "ms_wide": prec["wide"]["ms"],
        "plain_ms_wide": prec["wide"]["plain_ms"],
        "bound_ms_wide": prec["wide"]["bound_ms"],
        "dp_floor_ms_wide": prec["wide"]["dp_floor_ms"],
        "shape_wide": prec["wide"]["shape"],
        "compute_ssim_f64_ms_1080p_b4": prec["1080p_b4"]["compute_ssim_f64_ms"],
        "compute_ssim_f64_ms_16k_b1": prec["16k_b1"]["compute_ssim_f64_ms"],
        "compute_ssim_f64_ms": prec["4k_b4"]["compute_ssim_f64_ms"],
        "oracle_route_ms_1080p_b1": prec["oracle_1080p_b1_ms"],
        "card_route_ms_1080p_b1": prec["card_1080p_b1_ms"],
    }, {
        "name": "ssim_fwd_batch",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd_batch.cu",
        "header": "ssim_tpu_torch/csrc/fwd_batch_kernel.cuh",
        "design": BATCH_STREAM_DESIGN,
        "runtime_radius": "ssim_fwd_batch_rt",
        "launches_rt": radius["batch"]["launches"],
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710 (K1 mode e, colsum/pchunk), "
                    "tools/probe_bpack.py:56 (K5)",
        "launches": batch["launches"],
        "launches_stream": batch["launches_stream"],
        "launches_by_call": batch["route"],
        "launches_parallel": par["launches"]["batch"],
        "launches_devicebench": tl["batch"],
        "max_abs_err": batch["err"],
        **{k: batch["times"]["64x64_b4096"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share", "shape")},
        "library_ms": None,
        "tile_grid_ms": batch["times"]["64x64_b4096"]["tile_ms"],
        "tile_body_ms": batch["times"]["64x64_b4096"]["tile_body_ms"],
        "precise_ms": batch["times"]["64x64_b4096_f64"]["ms"],
        "precise_bound_ms": batch["times"]["64x64_b4096_f64"]["bound_ms"],
        "precise_dp_floor_ms": batch["times"]["64x64_b4096_f64"]["dp_floor_ms"],
        "precise_dp_floor_share": batch["times"]["64x64_b4096_f64"]["dp_floor_share"],
        "times": batch["times"],
        "loss": batch["losses"],
        "loss_step_ms": batch["step"],
    }, {
        "name": "ssim_fwd_rowsum",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:1080 (K1 mode f, rowsum), "
                    "ssim_tpu/ops/ssim_pallas.py:1641 (K2 rowsum)",
        "design": STREAM_DESIGN,
        "launches": spatial["launches"]["rowsum"],
        "launches_stream": spatial["launches"]["stream"],
        "launches_parallel": par["launches"]["rowsum"],
        "launches_devicebench": tl["rowsum"],
        "max_abs_err": halo_fwd_err,
        "ms": spatial["times"]["16k_b1"]["rowsum_ms"],
        "plain_ms": spatial["times"]["16k_b1"]["plain_ms"],
        "bound_ms": spatial["times"]["16k_b1"]["bound_ms"],
        "bound_by": spatial["times"]["16k_b1"]["bound_by"],
        "library_ms": None,
        "shape": spatial["times"]["16k_b1"]["shape"],
        "standard_ms": spatial["times"]["16k_b1"]["standard_ms"],
        "ms_4k_b4": spatial["times"]["4k_b4"]["rowsum_ms"],
        "plain_ms_4k_b4": spatial["times"]["4k_b4"]["plain_ms"],
        "bound_ms_4k_b4": spatial["times"]["4k_b4"]["bound_ms"],
        "standard_ms_4k_b4": spatial["times"]["4k_b4"]["standard_ms"],
        **{f"{k}_wide": spatial["times"]["wide_b1"][k]
           for k in ("rowsum_ms", "rowsum_map_ms", "plain_ms", "bound_ms", "standard_ms",
                     "shape")},
        "launches_by_call": spatial["calls"],
    }, {
        "name": "ssim_fwd_halo",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:884 (K1 mode g, vhalo/vmask "
                    "operands; halo_band_matrices :681)",
        "design": STREAM_DESIGN,
        "launches": spatial["launches"]["rowsum"] + spatial["launches"]["rowsum_map"],
        "launches_stream": spatial["launches"]["stream"],
        "launches_map": spatial["launches"]["rowsum_map"],
        "launches_devicebench": tl["rowsum"],
        "max_abs_err": halo_fwd_err,
        "ms": spatial["times"]["16k_b1"]["rowsum_map_ms"],
        "plain_ms": spatial["times"]["16k_b1"]["plain_ms"],
        "bound_ms": spatial["times"]["16k_b1"]["bound_map_ms"],
        "bound_by": spatial["times"]["16k_b1"]["bound_map_by"],
        "library_ms": None,
        "shape": spatial["times"]["16k_b1"]["shape"],
        "standard_map_ms": spatial["times"]["16k_b1"]["standard_map_ms"],
        "spatial_score_ms": spatial["times"]["public"]["spatial_score_ms"],
        "spatial_map_ms": spatial["times"]["public"]["spatial_map_ms"],
    }, {
        "name": "ssim_bwd_vhalo",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_bwd.cu",
        "replaces": "ssim_tpu/ops/ssim_grad.py:278 (vhalo/vmask: "
                    "_fwd_mid_band_matrices_vhalo :149, "
                    "_transpose_band_matrices_vhalo :179)",
        "launches": spatial["launches"]["backward_vhalo"],
        "launches_parallel": par["launches"]["backward_vhalo"],
        "max_abs_err": halo_bwd_err,
        "ms": spatial["times"]["bwd_16k_b1"]["vhalo_ms"],
        "plain_ms": spatial["times"]["bwd_16k_b1"]["plain_ms"],
        "bound_ms": spatial["times"]["bwd_16k_b1"]["bound_ms"],
        "bound_by": spatial["times"]["bwd_16k_b1"]["bound_by"],
        "library_ms": None,
        "shape": spatial["times"]["bwd_16k_b1"]["shape"],
        "standard_ms": spatial["times"]["bwd_16k_b1"]["standard_ms"],
        "ms_4k_b4": spatial["times"]["bwd_4k_b4"]["vhalo_ms"],
        "plain_ms_4k_b4": spatial["times"]["bwd_4k_b4"]["plain_ms"],
        "bound_ms_4k_b4": spatial["times"]["bwd_4k_b4"]["bound_ms"],
        "step_ms": spatial["times"]["public"]["step_ms"],
        "step_trace_busy_ms": spatial["times"]["public"]["trace_busy_ms"],
        "step_trace_k3_ms": spatial["times"]["public"]["trace_k3_ms"],
        "spatial_vs_ssim": spatial["errs"],
    }, {
        "name": "ssim_fwd_relaxed",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "design": RELAXED_STREAM_DESIGN,
        "header": "ssim_tpu_torch/csrc/band_mma.cuh",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:118, ssim_tpu/ops/ssim_pallas.py:168 "
                    "(K1 mode h, mxu3x), ssim_tpu/ops/ssim_pallas.py:1409 (K2 relaxed)",
        "launches": relaxed["launches_fwd"],
        "launches_stream": relaxed["launches_stream"],
        "launches_by_call": relaxed["by_call"],
        "launches_cli": cli_launches.get("relaxed", 0),
        "launches_devicebench": tl["relaxed"],
        "max_abs_err": relaxed["err_fwd"],
        **{k: relaxed["times"]["kScore 4k_b4"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "standard_ms")},
        "library_ms": None,
        "relaxed_vs_standard_pixel": relaxed["d_std"],
        "times": {k: v for k, v in relaxed["times"].items()
                  if not k.startswith(("K3", "ssim_loss"))},
    }, {
        "name": "ssim_fwd_relaxed_components",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd.cu",
        "design": RELAXED_COMP_STREAM_DESIGN,
        "header": "ssim_tpu_torch/csrc/band_mma.cuh",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:1957 (K1 mode c), "
                    "ssim_tpu/ops/ssim_pallas.py:2066 (K1 mode d), relaxed (lane_mode "
                    "mxu3x, ssim_tpu/ops/ssim_pallas.py:118, :168)",
        "launches": (relaxed["launches_stream_by_mode"]["relaxed components"]
                     + relaxed["launches_stream_by_mode"]["relaxed pooled"]),
        "launches_by_mode": {k: v for k, v in relaxed["launches_stream_by_mode"].items()
                             if k in ("relaxed components", "relaxed pooled")},
        "max_abs_err": relaxed["err_fwd"],
        **{k: relaxed["times"]["kComponents f32 1080p_b4"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "stream_ms",
                     "tile_body_ms", "standard_ms")},
        "library_ms": None,
        "pooled_u8": relaxed["times"]["kPooled u8 1080p_b4"],
        "pooled_f32_scale1": relaxed["times"]["kPooled f32 4x540x960 (MS-SSIM scale 1)"],
    }, {
        "name": "ssim_fwd_relaxed_batch",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd_batch.cu",
        "design": RELAXED_BATCH_STREAM_DESIGN,
        "header": "ssim_tpu_torch/csrc/band_mma.cuh",
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710 (K1 mode e, colsum/pchunk, driven by "
                    "ssim_parts_pallas_bpacked :2334), relaxed (ssim_tpu/ops/ssim_pallas.py:"
                    "2284-2291, :118, :168)",
        "launches": relaxed["launches_stream_by_mode"]["relaxed batch"],
        "max_abs_err": relaxed["err_fwd"],
        **{k: relaxed["times"]["kBatch u8 64x64_b4096"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "stream_ms",
                     "tile_body_ms", "standard_ms")},
        "library_ms": None,
    }, {
        "name": "ssim_bwd_relaxed",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_bwd.cu",
        "header": "ssim_tpu_torch/csrc/band_mma.cuh",
        "replaces": "ssim_tpu/ops/ssim_grad.py:278 (relaxed: :324-328, :500-516, "
                    ":522-529, :563-567)",
        "design": RELAXED_BWD_STREAM_DESIGN,
        "launches": relaxed["launches_bwd"],
        "launches_devicebench": tl["backward_relaxed"],
        "max_abs_err": relaxed["err_bwd"],
        **{k: relaxed["times"]["K3 grad_1080_b4"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "standard_ms")},
        "library_ms": None,
        "ms_gmap": relaxed["times"]["K3 grad_1080_b4 g_map"]["ms"],
        "step_trace_busy_ms": relaxed["times"]["ssim_loss step"]["relaxed"]["trace_busy_ms"],
        "step_trace_k3_ms": relaxed["times"]["ssim_loss step"]["relaxed"]["trace_k3_ms"],
        "standard_ms_gmap": relaxed["times"]["K3 grad_1080_b4 g_map"]["standard_ms"],
    }, {
        "name": "ssim_fwd_stream_rt",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd_stream_rt.cu",
        "header": "ssim_tpu_torch/csrc/fwd_stream_kernel.cuh",
        "design": RT_STREAM_DESIGN,
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710, ssim_tpu/ops/ssim_pallas.py:1364 "
                    "(a custom window: radius 1-16 but 5)",
        "launches": radius["launches"],
        "launches_by_call": radius["calls"],
        "max_abs_err": radius["err"],
        **{k: radius["line"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "tile_body_ms",
                     "segment")},
        "radius": RT_LINE_RADIUS,
        "library_ms": None,
        "checked_launches": radius["checked"],
        "tile_body_checked_launches": radius["body_checked"],
        "tile_body_max_abs_err": radius["body_err"],
        "times": radius["times"],
    }, {
        "name": "ssim_fwd_batch_rt",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd_batch_rt.cu",
        "header": "ssim_tpu_torch/csrc/fwd_batch_kernel.cuh",
        "design": RT_BATCH_DESIGN,
        "replaces": "ssim_tpu/ops/ssim_pallas.py:710 (K1 mode e, colsum/pchunk, driven by "
                    "ssim_parts_pallas_bpacked :2334; relaxed :2284-2291), a custom window: "
                    "radius 1-16 but 5",
        "launches": radius["batch"]["launches"],
        "launches_by_call": radius["batch"]["calls"],
        "max_abs_err": max(radius["batch"]["err"], batch["err_rt"]),
        **{k: radius["batch"]["line"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "tile_body_ms",
                     "pack", "radius")},
        "library_ms": None,
        "loss": radius["batch"]["losses"],
        "times": radius["batch"]["times"],
    }, {
        "name": "ssim_fwd_stream_rt_relaxed",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_fwd_stream_rt_relaxed.cu",
        "header": "ssim_tpu_torch/csrc/fwd_stream_kernel.cuh",
        "design": RT_RELAXED_FWD_DESIGN,
        "replaces": "ssim_tpu/ops/ssim_pallas.py:168 (_make_hpass_mxu, exact=False), "
                    "ssim_tpu/ops/ssim_pallas.py:710, ssim_tpu/ops/ssim_pallas.py:1409 "
                    "(relaxed, a custom window: radius 1-16 but 5)",
        "launches": radius["relaxed"]["launches_fwd"],
        "launches_by_call": radius["relaxed"]["calls"],
        "max_abs_err": radius["relaxed"]["err"],
        **{k: radius["relaxed"]["fwd_line"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "tile_body_ms",
                     "segment", "radius")},
        "library_ms": None,
        "checked_launches": radius["relaxed"]["checked"]["stream"],
        "tile_body_checked_launches": radius["relaxed"]["checked"]["tile_body"],
        "tile_body_max_abs_err": radius["relaxed"]["body_err"],
        "times": {k: v for k, v in radius["relaxed"]["times"].items()
                  if not k.startswith("K3")},
    }, {
        "name": "ssim_bwd_relaxed_rt",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/ssim_bwd_relaxed_rt.cu",
        "header": "ssim_tpu_torch/csrc/bwd_relaxed_stream.cuh",
        "design": RT_RELAXED_BWD_DESIGN,
        "replaces": "ssim_tpu/ops/ssim_grad.py:278 (relaxed :324-328, :500-516; a custom "
                    "window: radius 1-16 but 5)",
        "launches": radius["relaxed"]["launches_bwd"],
        "max_abs_err": radius["relaxed"]["grad_err"],
        "max_abs_err_unit": "max|g|",
        **{k: radius["relaxed"]["bwd_line"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "strip", "radius")},
        "library_ms": None,
        "checked_launches": radius["relaxed"]["checked"]["k3"],
        "times": {k: v for k, v in radius["relaxed"]["times"].items() if k.startswith("K3")},
    }, {
        "name": "pad_align",
        "route": "cuda",
        "source": "ssim_tpu_torch/csrc/pad.cu",
        "replaces": "ssim_tpu/ops/pad.py:55",
        "launches": pad["launches"],
        "launches_devicebench": tl["pad"],
        "max_abs_err": pad["err"],
        **{k: pad["times"]["float32"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                     "out_shape", "device_ms")},
        "turns_ms": pad["times"]["float32"]["turns"],  # kernel, F.pad, F.pad, kernel
        "ms_u8": pad["times"]["uint8"]["ms"],  # the trace's
        "events_ms_u8": pad["times"]["uint8"]["events_ms"],
        "plain_ms_u8": pad["times"]["uint8"]["plain_ms"],
        "bound_ms_u8": pad["times"]["uint8"]["bound_ms"],
    }]}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trace-dir"]:
        sys.exit(trace_dir_main(sys.argv[2:]))
    sys.exit(main())
