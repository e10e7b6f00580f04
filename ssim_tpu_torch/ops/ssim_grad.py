"""Fused analytic SSIM backward: the hand-written CUDA kernel's wrapper and
its plain PyTorch twin.

Counterpart of `ssim_tpu/ops/ssim_grad.py` (`ssim_grad_pallas` over
`_grad_call`) in its scalar `w_s`, per-pixel `g_map`, `w_cs`,
`vhalo` / `vmask` (a row band of spatial sharding) and `relaxed` (the
accuracy="relaxed" tier: every band pass a bf16x3 band product on the
tensor cores, at W >= MXU_MIN_W) modes. For
L = sum_p (w_s + g_map(p)) * SSIM(p) + w_cs * sum_p cs(p), per image, it
returns (dL/da, dL/db). The kernel is `ssim_tpu_torch/csrc/ssim_bwd.cu`.
Its standard tier streams: one CUDA block per strip of STRIP_W output
columns and segment of rows (stream_segment picks the segment's length to
fill the card; stream_blocks lists the blocks), so the TPU's column
chunking at GRAD_MAX_W = 7680 lanes has no counterpart; in one pass at
radius 5 and STD_WINDOW_RADII (the weight maps' window in registers), in
two at every other radius (`csrc/bwd_std_rt.cuh`: the weight maps into a
scratch map on the mid grid, then the adjoints from it). The relaxed tier
streams rows too, at every radius 1 to MAX_FUSED_RADIUS (8 rows a step,
all sixteen band passes on the tensor cores), in strips of
relaxed_strip_w(radius) columns.

`ssim_grad_cuda` launches the kernel for CUDA tensors and runs the plain
twin `ssim_grad_plain` for CPU tensors. The twin is the same algebra in
PyTorch over whole images: the forward blurs recomputed on the image plus
an r margin, the weight maps of ssim_grad.py:535-560 zeroed by index
outside the image, then an explicit transposed clamped blur (zero-extended
symmetric pairs plus the clamp fold at the edge rows and columns), in the
kernel's order of operations. It is independent of autograd, serves the
CPU tests, and is what the kernel is held against on the card.

A non-finite input pixel makes NaN the gradients of every tile within 2r
of it (every gradient that depends on it, and so a superset of autograd's
NaN region, as in the JAX kernel), and never reaches another image. In the
vhalo mode that holds for the operand rows the kernel reads, too; an
operand at a flagged edge is not read, so it poisons nothing (the JAX
kernel poisons the edge blocks with any non-finite operand value there).
"""

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..windows import RADIUS, SIGMA, gaussian_taps
from . import ssim_cuda
from .ssim_cuda import (
    MAX_FUSED_RADIUS, MAX_SEG_TILES, STRIP_W, _pad_cols,
    _tile_reduce, band_bf16x3_plain, hpass4, relaxed_applies, splice_rows,
    stream_blocks, sym_blur,
)
from .ssim_torch import _pad_edge

#: The NaN tile of both tiers (default_tile; half as tall at radius 16): a
#: non-finite input poisons the gradients of the tiles within 2r of it.
TILE_H = 32
TILE_W = 64

#: The standard kernel's block is the forward streaming kernel's: a strip of
#: STRIP_W output columns (two NaN tiles) walking down a segment of at most
#: MAX_SEG_TILES NaN tiles' rows (ssim_bwd.cu kStripW, kMaxSegTiles), whose
#: blocks stream_blocks lists.

#: Kernel launches made by ssim_grad_cuda in this process (VHALO_LAUNCHES:
#: those with halo operands; RELAXED_LAUNCHES: the relaxed mode's, with or
#: without them). The wrapper adds one per launch to one of the three and
#: nowhere else, so a caller can show that a run went through the kernel
#: in that mode. Every launch counted is a streaming one: the standard
#: tier's one-pass stream (radius 5, ssim_bwd.cu, and STD_WINDOW_RADII,
#: ssim_bwd_rt.cu) or its two-pass stream (every other radius,
#: ssim_bwd_rt.cu), the relaxed stream (radius 5 compiled in, ssim_bwd.cu,
#: the others read at run time, ssim_bwd_relaxed_rt.cu).
LAUNCHES = 0
VHALO_LAUNCHES = 0
RELAXED_LAUNCHES = 0
#: Of the standard launches (LAUNCHES or VHALO_LAUNCHES), those of the
#: two-pass stream (std_two_pass).
TWO_PASS_LAUNCHES = 0


def grad_cuda_supported(h: int, w: int, radius: int = RADIUS) -> bool:
    """Whether ssim_grad_cuda takes an h x w image at this radius (else the
    caller differentiates ssim_parts_torch). The contract of the JAX
    package's grad_pallas_supported: w > radius, radius 1..16."""
    return w > radius and h >= 1 and 1 <= radius <= MAX_FUSED_RADIUS


def default_tile(radius: int) -> Tuple[int, int]:
    """The NaN tile at this radius, which also sets the streaming kernels'
    segments (whole tiles): TILE_H x TILE_W, 32x64 up to radius 15 and
    16x64 at radius 16."""
    return (TILE_H // 2 if radius == MAX_FUSED_RADIUS else TILE_H), TILE_W


#: The relaxed stream's strip at each radius 1-16 (bwd_relaxed_stream.cuh
#: kSW), measured on an H100 at grad_1080_b4 (`tools/bwd_times.py --relaxed
#: --strips`, PERF.md): 128 columns at radii 1-5 (0.30-0.34 ms, 2 blocks
#: per SM, against 0.48-0.59 ms at 64) and 12-15 (0.68-0.78 ms, one block of
#: 10 warps, against 1.04-1.20 ms at 64, one block of 6); one 64-column NaN
#: tile at 6-11 (0.60-0.68 ms, 2 blocks per SM, 2-4% faster than 128, one
#: block) and at 16, where a 128-column block's rings no longer fit.
RELAXED_STRIP_W = {r: STRIP_W if r <= 5 or 12 <= r <= 15 else TILE_W
                   for r in range(1, MAX_FUSED_RADIUS + 1)}


def relaxed_strip_w(radius: int) -> int:
    """The relaxed streaming kernel's strip columns at this radius
    (RELAXED_STRIP_W)."""
    return RELAXED_STRIP_W[radius]


def relaxed_smem_bytes(radius: int, strip_w: int) -> int:
    """Dynamic shared memory of one relaxed streaming block at this radius
    and strip (bwd_relaxed_stream.cuh rel_smem_bytes): the staged rows,
    later the vertical adjoints (8 rows of float2 {a, b}, or 4 planes x 8
    rows of f32, at the geometry's pitches); two rings of 8 + 2r rows of 4
    planes x {hi, lo} x 16 bf16 per warp; the folds' f32 sums (2 x 4
    planes per mid column); the band's fragments."""
    groups = 1 + (radius + 3) // 4
    kh = 2 if groups <= 3 else 3
    kv = (groups + 1) // 2
    warps = strip_w // 16 + kh - 1
    xv = max(8 * 8 * (strip_w + 32 * kh - 24), 16 * 8 * (strip_w + 16 * kh - 8))
    rings = 2 * warps * 4 * 2 * (8 + 2 * radius) * 16 * 2
    return xv + rings + 4 * 2 * 4 * 16 * warps + (16 * kh + 8 * kv) * 2 * 32


#: The radii at which ssim_bwd_rt.cu builds, and the wrapper routes, the
#: standard tier's one-pass stream with the weight maps' window in
#: registers (radius 5's design, bwd_std_stream.cuh; radius 5 itself is
#: ssim_bwd.cu's): measured faster there than the two-pass stream on an
#: H100 (`tools/bwd_times.py --radii ... --designs`, PERF.md §6), which
#: serves every other radius.
STD_WINDOW_RADII = (1, 2, 3, 4)


def std_two_pass(radius: int) -> bool:
    """Whether a standard launch at this radius runs the two-pass stream
    (pass A's weight maps through a scratch map on the mid grid, then pass
    B's adjoints): every radius but 5 and STD_WINDOW_RADII."""
    return radius != RADIUS and radius not in STD_WINDOW_RADII


#: Shared memory an SM of an H100 holds, and what the runtime reserves a
#: block (the occupancy models below).
SM_SMEM, BLOCK_RESERVED = 233472, 1024


def std_smem_bytes(radius: int, two_pass: bool = True) -> Tuple[int, ...]:
    """Dynamic shared memory a block of the standard stream takes at this
    radius: the two-pass stream's pass A and pass B (bwd_std_rt.cuh
    rt_smem_a / rt_smem_b, two rows a step: A two groups of two staged rows
    of STRIP_W + 2r float4 and a ring of 2r + 2 float4 rows of STRIP_W
    threads; B two groups of two vertical-adjoint rows and a ring of 2r + 2
    rows, float4 each, of STRIP_W + 2r threads), or (two_pass False) the
    one-pass stream's one block (bwd_std_stream.cuh
    stream_smem_floats: two staged rows over STRIP_W + 4r columns, two
    vertical-adjoint rows and the horizontal blurs' ring of 2r + 1 rows of
    its 160 threads, float4 each, and a ring of 2r + 3 rows of the strip's
    {a, b})."""
    if two_pass:
        nt = STRIP_W + 2 * radius
        return (16 * (4 * (STRIP_W + 2 * radius) + (2 * radius + 2) * STRIP_W),
                16 * (2 * radius + 6) * nt)
    threads = STRIP_W + 2 * MAX_FUSED_RADIUS
    return (4 * (8 * (STRIP_W + 4 * radius) + 8 * threads + 2 * (2 * radius + 3) * STRIP_W
                 + 4 * (2 * radius + 1) * threads),)


def std_blocks_per_sm(radius: int, two_pass: bool = True) -> int:
    """Blocks of the standard stream an H100's SM holds at this radius by
    its shared memory alone (SM_SMEM over each block's dynamic bytes and
    BLOCK_RESERVED; the two-pass stream has no static arrays), the fewer of
    the two passes'; the registers may cap it lower."""
    return min(SM_SMEM // (n + BLOCK_RESERVED) for n in std_smem_bytes(radius, two_pass))


def std_rt_scratch_bytes(bsz: int, h: int, w: int, radius: int) -> int:
    """Scratch of the two-pass stream (bwd_std_rt.cuh rt_map_bytes +
    rt_mask_bytes): pass A's weight maps, one float4 a position of the mid
    grid (h + 2r) x (w + 2r), then one word a NaN tile (default_tile)."""
    tile_h, tile_w = default_tile(radius)
    return (16 * bsz * (h + 2 * radius) * (w + 2 * radius)
            + 4 * bsz * -(-h // tile_h) * -(-w // tile_w))


def stream_segment(bsz: int, h: int, w: int, radius: int, resident: int,
                   strip_w: int = STRIP_W) -> int:
    """A streaming kernel's segment rows for (bsz, h, w) at this radius,
    with `resident` blocks on the card at once (the standard kernel's, or
    the relaxed one's, whose blocks advance 8 rows a step over the same
    rows) and strips of strip_w columns: ssim_cuda.stream_segment's model
    with the NaN tile's height, the 4r-row prologue and a last wave of at
    most a twentieth of the resident blocks running beside the others."""
    return ssim_cuda.stream_segment(bsz, h, w, default_tile(radius)[0], 4 * radius,
                                    resident, 1 / 20, strip_w)


def fold_coefficients(taps: np.ndarray) -> np.ndarray:
    """The clamp-to-edge adjoint's folded tap mass, as float32:
    cl[x] = sum_{k > r + x} t[k] for x < r (ssim_grad.py:239)."""
    r = len(taps) // 2
    return np.array(
        [sum(float(v) for v in taps[r + x + 1:]) for x in range(r)], np.float32
    )


@functools.lru_cache(maxsize=64)
def _c_window(key: bytes):
    """The f32 taps whose bytes are `key`, and their fold mass, as the C
    entry's ctypes float arrays, once per window."""
    taps = np.frombuffer(key, np.float32)
    return ((ctypes.c_float * len(taps))(*[float(v) for v in taps]),
            (ctypes.c_float * (len(taps) // 2))(
                *[float(v) for v in fold_coefficients(taps)]))


@functools.lru_cache(maxsize=64)
def _taps(radius: int, sigma: float) -> np.ndarray:
    return gaussian_taps(np.float32, radius, sigma)


@functools.lru_cache(maxsize=64)
def _resident(index: int, radius: int, gmap: bool, relaxed: bool = False,
              strip_w: int = STRIP_W, two_pass: Optional[bool] = None) -> int:
    """Streaming-kernel blocks that card `index` holds at once at this
    radius, the standard kernel's or (relaxed) the relaxed one's at a strip
    of strip_w columns: its SMs times the CUDA runtime's occupancy for the
    instantiation (ssim_bwd_stream_occupancy: at a standard radius other
    than 5 the design the launch routes there; two_pass pins one,
    ssim_bwd_std_rt_occupancy)."""
    from . import _build

    n = ctypes.c_int(0)
    lib = _build.load_library()
    with torch.cuda.device(index):
        if two_pass is None or relaxed or radius == RADIUS:
            err = lib.ssim_bwd_stream_occupancy(int(relaxed), radius, int(gmap), strip_w,
                                                ctypes.byref(n))
        else:
            err = lib.ssim_bwd_std_rt_occupancy(radius, int(gmap), int(two_pass),
                                                ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"ssim_bwd_stream_occupancy failed (cudaError {err}, "
                           f"{n.value} blocks per SM)")
    return torch.cuda.get_device_properties(index).multi_processor_count * n.value


def _adjoint(x: torch.Tensor, t, cl, dim: int, n: int, fold_lo: bool = True,
             fold_hi: bool = True, relaxed: bool = False, nudge=None) -> torch.Tensor:
    """Transpose of the clamped 1-D blur along `dim`: x holds the weights on
    the image plus an r margin that is zero outside the image (n + 2r
    entries); returns the n image positions. The plain part is the
    zero-extended symmetric blur (relaxed: band_bf16x3_plain); positions 0
    and n-1 add the folded clamp mass sum_{x<r} cl[x] * w(x) and
    sum_{x<r} cl[x] * w(n-1-x) in f32 (only where fold_lo / fold_hi: a
    band's edge without a neighbour). nudge: band_bf16x3_plain's."""
    r = len(t) // 2
    acc = band_bf16x3_plain(x, t, n, dim, nudge) if relaxed else sym_blur(x, t, dim, n)
    corr_lo = corr_hi = None
    for g in range(r):
        lo = cl[g] * x.narrow(dim, r + g, 1)
        hi = cl[g] * x.narrow(dim, n - 1 - g + r, 1)
        corr_lo = lo if corr_lo is None else corr_lo + lo
        corr_hi = hi if corr_hi is None else corr_hi + hi
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    zero = x.new_zeros(())
    if fold_lo:
        acc = acc + torch.where(pos == 0, corr_lo, zero)
    if fold_hi:
        acc = acc + torch.where(pos == n - 1, corr_hi, zero)
    return acc


def _weight_maps(u, v, ss, dd, coeff, w_cs, c1, c2):
    """W_u, W_v, W_ss, W_dd from the four blurred signals, in the order of
    ssim_grad.py:536-560 (and of ssim_bwd.cu)."""
    uv = u * v
    usq = u * u + v * v
    a1 = 2.0 * uv + c1
    a2 = 0.5 * (ss - dd) - 2.0 * uv + c2
    b1 = usq + c1
    b2 = 0.5 * (ss + dd) - usq + c2
    rb1 = torch.reciprocal(b1)
    rb2 = torch.reciprocal(b2)
    lum = a1 * rb1
    cs = a2 * rb2
    s_val = lum * cs
    half_rb2 = 0.5 * rb2
    d_ss_c = half_rb2 * (1.0 - cs)
    d_dd_c = -half_rb2 * (1.0 + cs)
    q = a2 - a1
    rb12 = rb1 * rb2
    drb = rb1 - rb2
    w_u = coeff * (2.0 * v * q * rb12 - 2.0 * u * s_val * drb) + w_cs * (
        (2.0 * u * cs - 2.0 * v) * rb2
    )
    w_v = coeff * (2.0 * u * q * rb12 - 2.0 * v * s_val * drb) + w_cs * (
        (2.0 * v * cs - 2.0 * u) * rb2
    )
    w_ss = (coeff * lum + w_cs) * d_ss_c
    w_dd = (coeff * lum + w_cs) * d_dd_c
    return w_u, w_v, w_ss, w_dd


def ssim_grad_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    w_s: torch.Tensor,
    w_cs: torch.Tensor,
    g_map: Optional[torch.Tensor],
    *,
    taps: np.ndarray,
    c1: float,
    c2: float,
    clip_bound: float,
    vhalo=None,
    vmask=(False, False),
    relaxed: bool = False,
    nudge=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin on (B, H, W) f32 tensors, on any device.
    w_s, w_cs: (B,) f32; g_map: (B, H, W) f32 or None. vhalo: four
    (B, 2r, W) f32 operands (a_top, a_bot, b_top, b_bot) spliced above and
    below the band (at a flagged edge of vmask, the band's edge row
    replicated instead), with the loss rows and the vertical clamp fold of
    the kernel's vhalo mode; no g_map with them. relaxed: the relaxed
    mode's, every band pass (stage 1's four horizontal and four vertical
    blurs, stage 2's four vertical and four horizontal adjoints) as
    band_bf16x3_plain, the clamp folds in f32; nudge (relaxed, checks only):
    each band pass's operand moved ssim_cuda.SPLIT_NUDGE_ULPS ulps before its split
    (band_bf16x3_plain). Returns (da, db)."""
    bsz, h, w = a.shape
    r = len(taps) // 2
    tile_h, tile_w = default_tile(r)
    t = [float(v) for v in taps]
    cl = [float(v) for v in fold_coefficients(taps)]
    is_top, is_bot = (True, True) if vhalo is None else (bool(f) for f in vmask)
    if vhalo is None:
        ae, be = _pad_edge(a, 2 * r), _pad_edge(b, 2 * r)
    else:
        at, ab, bt, bb = vhalo
        ae = _pad_cols(splice_rows(a, at, ab, is_top, is_bot), 2 * r)
        be = _pad_cols(splice_rows(b, bt, bb, is_top, is_bot), 2 * r)
    # Every value the kernel loads for a tile: the band and what it reads
    # above and below it, (B, H + 4r, W + 4r).
    bad_ext = ~(torch.isfinite(ae) & torch.isfinite(be))
    ae = torch.nan_to_num(ae, nan=0.0).clamp(-clip_bound, clip_bound)
    be = torch.nan_to_num(be, nan=0.0).clamp(-clip_bound, clip_bound)
    af = ae[:, 2 * r : 2 * r + h, 2 * r : 2 * r + w]
    bf = be[:, 2 * r : 2 * r + h, 2 * r : 2 * r + w]

    # Stage 1: the forward blurs on the mid grid (the image plus an r
    # margin), horizontal then vertical, from the 2r-padded input.
    if relaxed:
        s, dif = ae + be, ae - be
        u, v, s2, d2 = (
            band_bf16x3_plain(band_bf16x3_plain(x, t, w + 2 * r, nudge=nudge), t, h + 2 * r, 1,
                              nudge)
            for x in (ae, be, s * s, dif * dif)
        )
    else:
        planes = hpass4(ae, be, t, w + 2 * r)
        u, v, s2, d2 = (sym_blur(p, t, 1, h + 2 * r) for p in planes)

    w_s = w_s.reshape(bsz, 1, 1)
    w_cs = w_cs.reshape(bsz, 1, 1)
    coeff = w_s
    if g_map is not None:
        coeff = w_s + torch.nn.functional.pad(g_map, (r, r, r, r))
    maps = _weight_maps(u, v, s2, d2, coeff, w_cs, c1, c2)

    # Mid positions outside the image carry zero weight, by index (rows
    # above and below a band only at its flagged edges).
    gy = torch.arange(-r, h + r, device=a.device)
    gx = torch.arange(-r, w + r, device=a.device)
    rows_in = ~(((gy < 0) & is_top) | ((gy >= h) & is_bot))
    inside = rows_in[:, None] & ((gx >= 0) & (gx < w))[None, :]
    zero = a.new_zeros(())
    maps = [torch.where(inside, m, zero) for m in maps]

    # Stage 2: the transposed clamped blur, vertical then horizontal.
    tu, tv, tss, tdd = (
        _adjoint(_adjoint(m, t, cl, 1, h, is_top, is_bot, relaxed, nudge), t, cl, 2,
                 w, relaxed=relaxed, nudge=nudge)
        for m in maps
    )
    s = af + bf
    dif = af - bf
    da = tu + 2.0 * s * tss + 2.0 * dif * tdd
    db = tv + 2.0 * s * tss - 2.0 * dif * tdd

    # A tile is NaN when any value loaded within 2r of it is not finite.
    near = torch.nn.functional.max_pool2d(
        bad_ext.to(torch.float32)[:, None], 4 * r + 1, stride=1
    )[:, 0]
    tile_bad = _tile_reduce(near, tile_h, tile_w, lambda x: x.amax(dim=(2, 4))) > 0
    px_bad = tile_bad.repeat_interleave(tile_h, 1).repeat_interleave(
        tile_w, 2)[:, :h, :w]
    nan = torch.full_like(da, float("nan"))
    return torch.where(px_bad, nan, da), torch.where(px_bad, nan, db)


def split_sensitivity(a, b, w_s, w_cs, g_map, *, seed: int = 0, **kw):
    """The relaxed twin, ssim_grad_plain(relaxed=True, **kw), and s(p), its
    sensitivity to its bf16x3 split: the largest distance, entry by entry,
    of three nudged twins from it (every band pass's operand moved
    ssim_cuda.SPLIT_NUDGE_ULPS ulps up before its bf16 split, all down,
    and each element a random way from a generator seeded with seed). A
    kernel whose sums add in another order holds such operands ulps apart
    from the twin's, and where the split's low part then rounds the other
    way the gradient's cancellation amplifies a 2^-16 relative step: s(p)
    measures that at p. Used by the checks of the relaxed K3 against its
    twin, never on the main path. Returns ((da, db), (s_da, s_db)), NaN
    where the twin is."""
    want = ssim_grad_plain(a, b, w_s, w_cs, g_map, relaxed=True, **kw)
    gen = torch.Generator(device=a.device).manual_seed(seed)
    sens = [torch.zeros_like(x) for x in want]
    for nudge in ("up", "down", gen):
        moved = ssim_grad_plain(a, b, w_s, w_cs, g_map, relaxed=True, nudge=nudge, **kw)
        sens = [torch.fmax(s, (m - x).abs()) for s, m, x in zip(sens, moved, want)]
    return want, tuple(torch.where(x.isnan(), x, s) for s, x in zip(sens, want))


#: The relaxed K3 against its twin, entry by entry: RELAXED_GRAD_TWIN x
#: max|g| + RELAXED_GRAD_KAPPA x s(p), s(p) split_sensitivity's. Kernel and
#: twin add in other orders, so they hold a band pass's operand ulps apart;
#: where the split's low part then rounds the other way, a 2^-16 relative
#: step, the gradient's cancellation amplifies it, and s(p) is what that
#: step costs at p. Where the split is not sensitive (s(p) = 0) the bound
#: is RELAXED_GRAD_TWIN x max|g|. kappa = 4 is about twice the largest that
#: an H100 sweep of 300 seeds at radii 1, 3, 8 and 16, +- g_map, needed
#: (chip_smoke.py phase 15e: 1.77, at radius 1; PERF.md §6, P8).
RELAXED_GRAD_TWIN = 1e-4
RELAXED_GRAD_KAPPA = 4.0


def relaxed_grad_holds(k, p, scale, sens):
    """Whether the relaxed K3's output k holds to its twin's p, for the
    checks (never the main path): NaN exactly where p is, and every other
    entry within RELAXED_GRAD_TWIN x scale + RELAXED_GRAD_KAPPA x sens
    (split_sensitivity's s(p) at k's entries). Returns (holds, the
    per-entry bound)."""
    bound = RELAXED_GRAD_TWIN * scale + RELAXED_GRAD_KAPPA * sens
    if not torch.equal(k.isnan(), p.isnan()):
        return False, bound
    # NaN where both are: never above a bound.
    return not bool(((k - p).abs() > bound).any()), bound


def _launch(a, b, w_s, w_cs, g_map, *, taps, c1, c2, clip_bound, vhalo=None,
            vmask=(False, False), relaxed=False, segment=None, strip_w=None,
            two_pass=None):
    """Launch the CUDA kernel on (B, H, W) contiguous f32 tensors on one
    CUDA device; no synchronisation. segment: the streaming kernel's
    segment rows (stream_segment's choice if None); strip_w: the relaxed
    one's strip (relaxed_strip_w's if None); two_pass (standard, radius
    other than 5): the two-pass stream or the one-pass one where it is
    built (std_two_pass's choice if None)."""
    global LAUNCHES, VHALO_LAUNCHES, RELAXED_LAUNCHES, TWO_PASS_LAUNCHES
    from . import _build

    lib = _build.load_library()
    bsz, h, w = a.shape
    r = len(taps) // 2
    tile_h, tile_w = default_tile(r)
    sw = STRIP_W
    if relaxed:
        sw = strip_w or relaxed_strip_w(r)
    elif strip_w not in (None, STRIP_W):
        raise ValueError(f"the standard stream's strip is {STRIP_W} columns")
    two = not relaxed and (std_two_pass(r) if two_pass is None else two_pass)
    if two and r == RADIUS:
        raise ValueError(f"radius {RADIUS} has the one-pass stream only")
    if not relaxed and not two and r != RADIUS and r not in STD_WINDOW_RADII:
        raise ValueError(f"no one-pass stream is built at radius {r}")
    if segment is None:
        pin = () if two_pass is None or relaxed else (two,)
        segment = stream_segment(
            bsz, h, w, r, _resident(a.device.index, r, g_map is not None, relaxed, sw, *pin),
            sw)
    seg = segment
    if seg % tile_h or not tile_h <= seg <= MAX_SEG_TILES * tile_h:
        raise ValueError(f"segment {seg} is not 1-{MAX_SEG_TILES} tiles of "
                         f"{tile_h} rows")
    blocks = bsz * -(-h // seg) * -(-w // sw)
    if blocks > 0x7FFFFFFF:
        raise ValueError(f"{blocks} blocks exceed one launch's grid")
    taps_c, fold_c = _c_window(np.asarray(taps, np.float32).tobytes())
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    scratch = (torch.empty(std_rt_scratch_bytes(bsz, h, w, r), dtype=torch.uint8,
                           device=a.device) if two else None)
    with torch.cuda.device(a.device):
        err = lib.ssim_bwd_launch(
            int(relaxed), a.data_ptr(), b.data_ptr(), w_s.data_ptr(), w_cs.data_ptr(),
            None if g_map is None else g_map.data_ptr(),
            da.data_ptr(), db.data_ptr(),
            *((None,) * 4 if vhalo is None else (x.data_ptr() for x in vhalo)),
            int(vmask[0]), int(vmask[1]), bsz, h, w, r, tile_h, tile_w, seg, sw,
            None if scratch is None else scratch.data_ptr(),
            ctypes.cast(taps_c, ctypes.c_void_p),
            ctypes.cast(fold_c, ctypes.c_void_p), c1, c2, clip_bound,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ssim_bwd_launch{' (relaxed)' if relaxed else ''} failed with "
            f"CUDA error {err}")
    if relaxed:
        RELAXED_LAUNCHES += 1
    elif vhalo is None:
        LAUNCHES += 1
    else:
        VHALO_LAUNCHES += 1
    TWO_PASS_LAUNCHES += two
    return da, db


def _per_image(x, bsz: int, device, name: str) -> torch.Tensor:
    """A scalar or (B,) weight as a contiguous (B,) f32 tensor on device
    (a Python number is filled in on the device, with no host copy)."""
    if isinstance(x, (int, float, np.number)):
        return torch.full((bsz,), float(x), dtype=torch.float32, device=device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.dim() > 1 or (x.dim() == 1 and x.shape[0] not in (1, bsz)):
        raise ValueError(f"{name} must be a scalar or ({bsz},), got {tuple(x.shape)}")
    return x.reshape(-1).expand(bsz).contiguous()


def ssim_grad_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    w_s,
    w_cs,
    g_map: Optional[torch.Tensor] = None,
    *,
    data_range: float = 255.0,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
    vhalo=None,
    vmask=None,
    relaxed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel SSIM gradients: (dL/da, dL/db) for
    L = sum_p (w_s + g_map(p)) * SSIM(p) + w_cs * sum_p cs(p), per image.

    a, b: float32 (H, W) or (B, H, W) contiguous tensors on one device;
    w_s, w_cs: scalars or (B,) per-image weights (fold any 1/n in); g_map:
    optional per-pixel cotangent of the SSIM map, a's shape. The image must
    satisfy grad_cuda_supported. On a CUDA tensor the kernel is launched;
    on a CPU tensor the plain twin runs. Both use the tile
    default_tile(radius), which also sets how far a non-finite pixel
    poisons the gradients.

    vhalo / vmask (the sharded-training mode, parallel/spatial.py): a, b
    are one row band of a taller image; vhalo = (a_top, a_bot, b_top,
    b_bot), each (..., 2*radius, W) float32, holds the 2r rows above and
    below it, and vmask = (is_top, is_bot) (0/1 numbers, required) flags
    the band's rows 0 / H-1 as the image's own edges. There the kernel
    replicates the band's edge row in place of the operand (which it does
    not read, so raw ring outputs, even non-finite ones, may be passed),
    drops the loss rows beyond the edge and folds the clamp's tap mass onto
    the edge row. L is then w_s * the band's loss rows plus the
    neighbours' rows within r (summed over the bands, the global loss); the
    gradients are those of the band's own rows. Scalar cotangents only
    (g_map=None); bands of at least 2*radius rows.

    relaxed=True (accuracy="relaxed"): at W >= MXU_MIN_W every band pass
    runs as a bf16x3 band product on the tensor cores (RELAXED_LAUNCHES
    counts the launch of the relaxed stream), the gradient within ~1e-3 x
    max|g| of the standard tier's; below it the standard kernel runs, bit
    for bit (JAX use_mxu, ssim_grad.py:324). It combines with vhalo as in
    the JAX kernel.
    """
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(
            f"ssim_grad_cuda takes float32 pairs (u8 has no gradient), got "
            f"{a.dtype}/{b.dtype}"
        )
    if a.shape != b.shape or a.dim() not in (2, 3) or 0 in a.shape:
        raise ValueError(
            f"expected matching non-empty (H, W) or (B, H, W) tensors, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if g_map is not None and (g_map.shape != a.shape or g_map.dtype != torch.float32):
        raise ValueError(
            f"g_map must be float32 of the images' shape {tuple(a.shape)}, "
            f"got {g_map.dtype} {tuple(g_map.shape)}"
        )
    h, w = a.shape[-2], a.shape[-1]
    flags = (False, False)
    if vhalo is not None:
        if g_map is not None:
            raise ValueError(
                "vhalo mode takes scalar cotangents only (g_map=None): "
                "per-pixel cotangents for virtual loss rows would need "
                "their own halo exchange"
            )
        if vmask is None:
            raise ValueError("vhalo requires vmask=(is_top, is_bot)")
        vhalo = tuple(vhalo)
        want = tuple(a.shape[:-2]) + (2 * radius, w)
        if len(vhalo) != 4 or any(
            not isinstance(x, torch.Tensor) or tuple(x.shape) != want
            or x.dtype != torch.float32 or x.device != a.device
            or not x.is_contiguous() for x in vhalo
        ):
            raise ValueError(
                f"vhalo must be 4 contiguous float32 tensors (a_top, a_bot, "
                f"b_top, b_bot) of shape {want} on {a.device}, got "
                f"{[tuple(getattr(x, 'shape', ())) for x in vhalo]}"
            )
        if h < 2 * radius:
            raise ValueError(
                f"vhalo shards must be >= 2*radius = {2 * radius} rows "
                f"tall, got {h}"
            )
        flags = tuple(float(x) > 0 for x in vmask)
    elif vmask is not None:
        raise ValueError("vmask requires vhalo (it flags the halo operands)")
    if not grad_cuda_supported(h, w, radius):
        raise ValueError(
            f"ssim_grad_cuda needs w > radius, h >= 1, and radius in "
            f"1..{MAX_FUSED_RADIUS}; got {h}x{w} at radius {radius}"
        )
    taps = _taps(radius, float(sigma))
    c1 = float((k1 * data_range) ** 2)
    c2 = float((k2 * data_range) ** 2)
    if c1 * c2 < 9e-32:
        raise ValueError(
            f"k1/k2 too small for data_range {data_range}: c1*c2 = "
            f"{c1 * c2:g} degenerates in f32 (needs >= 9e-32)"
        )
    devices = {a.device, b.device} | ({g_map.device} if g_map is not None else set())
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    if not (a.is_contiguous() and b.is_contiguous()
            and (g_map is None or g_map.is_contiguous())):
        raise ValueError("the fused backward kernel takes contiguous tensors")
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
        g_map = None if g_map is None else g_map[None]
        vhalo = None if vhalo is None else tuple(x[None] for x in vhalo)
    bsz = a.shape[0]
    ws = _per_image(w_s, bsz, a.device, "w_s")
    wcs = _per_image(w_cs, bsz, a.device, "w_cs")
    kw = dict(taps=taps, c1=c1, c2=c2,
              clip_bound=max(131072.0, 4.0 * float(data_range)),
              relaxed=relaxed_applies(relaxed, w))
    if vhalo is not None:
        kw.update(vhalo=vhalo, vmask=flags)
    if a.device.type == "cuda":
        da, db = _launch(a, b, ws, wcs, g_map, **kw)
    elif a.device.type == "cpu":
        da, db = ssim_grad_plain(a, b, ws, wcs, g_map, **kw)
    else:
        raise ValueError(f"no fused backward kernel for device {a.device}")
    if squeeze:
        da, db = da[0], db[0]
    return da, db
