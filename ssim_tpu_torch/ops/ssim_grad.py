"""Fused analytic SSIM backward: the hand-written CUDA kernel's wrapper and
its plain PyTorch twin.

Counterpart of `ssim_tpu/ops/ssim_grad.py` (`ssim_grad_pallas` over
`_grad_call`) in its scalar `w_s`, per-pixel `g_map`, `w_cs` and
`vhalo` / `vmask` (a row band of spatial sharding) modes. For
L = sum_p (w_s + g_map(p)) * SSIM(p) + w_cs * sum_p cs(p), per image, it
returns (dL/da, dL/db). The kernel is `ssim_tpu_torch/csrc/ssim_bwd.cu`:
one 2-D grid of output tiles, one CUDA block per tile, so the TPU's column
chunking at GRAD_MAX_W = 7680 lanes has no counterpart.

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
from typing import Optional, Tuple

import numpy as np
import torch

from ..windows import RADIUS, SIGMA, gaussian_taps
from .ssim_cuda import (
    _MAX_DYNAMIC_SMEM, MAX_FUSED_RADIUS, _pad_cols, _tile_reduce, hpass4,
    splice_rows, sym_blur,
)
from .ssim_torch import _pad_edge

#: Default output tile; shrunk at large radii until the block's shared
#: memory fits (default_tile).
TILE_H = 32
TILE_W = 64

#: Kernel launches made by ssim_grad_cuda in this process (VHALO_LAUNCHES:
#: those with halo operands). The wrapper adds one per launch to one of the
#: two and nowhere else, so a caller can show that a run went through the
#: kernel in that mode.
LAUNCHES = 0
VHALO_LAUNCHES = 0


def grad_cuda_supported(h: int, w: int, radius: int = RADIUS) -> bool:
    """Whether ssim_grad_cuda takes an h x w image at this radius (else the
    caller differentiates ssim_parts_torch). The contract of the JAX
    package's grad_pallas_supported: w > radius, radius 1..16."""
    return w > radius and h >= 1 and 1 <= radius <= MAX_FUSED_RADIUS


def smem_bytes(tile_h: int, tile_w: int, radius: int) -> int:
    """Dynamic shared memory of one block (ssim_bwd.cu's region_x_floats +
    region_y_floats): the a/b halo tile with a 2r margin or, later, the
    four weight maps on the r-margin mid region; plus the four horizontally
    blurred planes, later the four vertical adjoints."""
    r = radius
    halo = 2 * (tile_h + 4 * r) * (tile_w + 4 * r)
    mid = 4 * (tile_h + 2 * r) * (tile_w + 2 * r)
    planes = 4 * (tile_h + 4 * r) * (tile_w + 2 * r)
    return 4 * (max(halo, mid) + planes)


def default_tile(radius: int) -> Tuple[int, int]:
    """TILE_H x TILE_W, with the height halved (down to 8) while the
    block's shared memory does not fit: 32x64 up to radius 15, 16x64 at
    radius 16."""
    tile_h = TILE_H
    while tile_h > 8 and smem_bytes(tile_h, TILE_W, radius) > _MAX_DYNAMIC_SMEM:
        tile_h //= 2
    return tile_h, TILE_W


def fold_coefficients(taps: np.ndarray) -> np.ndarray:
    """The clamp-to-edge adjoint's folded tap mass, as float32:
    cl[x] = sum_{k > r + x} t[k] for x < r (ssim_grad.py:239)."""
    r = len(taps) // 2
    return np.array(
        [sum(float(v) for v in taps[r + x + 1:]) for x in range(r)], np.float32
    )


def _adjoint(x: torch.Tensor, t, cl, dim: int, n: int, fold_lo: bool = True,
             fold_hi: bool = True) -> torch.Tensor:
    """Transpose of the clamped 1-D blur along `dim`: x holds the weights on
    the image plus an r margin that is zero outside the image (n + 2r
    entries); returns the n image positions. The plain part is the
    zero-extended symmetric blur; positions 0 and n-1 add the folded clamp
    mass sum_{x<r} cl[x] * w(x) and sum_{x<r} cl[x] * w(n-1-x) (only where
    fold_lo / fold_hi: a band's edge without a neighbour)."""
    r = len(t) // 2
    acc = sym_blur(x, t, dim, n)
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin on (B, H, W) f32 tensors, on any device.
    w_s, w_cs: (B,) f32; g_map: (B, H, W) f32 or None. vhalo: four
    (B, 2r, W) f32 operands (a_top, a_bot, b_top, b_bot) spliced above and
    below the band (at a flagged edge of vmask, the band's edge row
    replicated instead), with the loss rows and the vertical clamp fold of
    the kernel's vhalo mode; no g_map with them. Returns (da, db)."""
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
        _adjoint(_adjoint(m, t, cl, 1, h, is_top, is_bot), t, cl, 2, w)
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


def _launch(a, b, w_s, w_cs, g_map, *, taps, c1, c2, clip_bound, vhalo=None,
            vmask=(False, False)):
    """Launch the CUDA kernel on (B, H, W) contiguous f32 tensors on one
    CUDA device, with the tile default_tile(radius); no synchronisation."""
    global LAUNCHES, VHALO_LAUNCHES
    from . import _build

    lib = _build.load_library()
    bsz, h, w = a.shape
    r = len(taps) // 2
    tile_h, tile_w = default_tile(r)
    assert smem_bytes(tile_h, tile_w, r) <= _MAX_DYNAMIC_SMEM
    nty, ntx = -(-h // tile_h), -(-w // tile_w)
    if bsz * nty * ntx > 0x7FFFFFFF:
        raise ValueError(f"{bsz * nty * ntx} tiles exceed one launch's grid")
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    taps_c = (ctypes.c_float * len(taps))(*[float(v) for v in taps])
    fold_c = (ctypes.c_float * r)(*[float(v) for v in fold_coefficients(taps)])
    with torch.cuda.device(a.device):
        err = lib.ssim_bwd_launch(
            a.data_ptr(), b.data_ptr(), w_s.data_ptr(), w_cs.data_ptr(),
            None if g_map is None else g_map.data_ptr(),
            da.data_ptr(), db.data_ptr(),
            *((None,) * 4 if vhalo is None else (x.data_ptr() for x in vhalo)),
            int(vmask[0]), int(vmask[1]), bsz, h, w, r, tile_h, tile_w,
            ctypes.cast(taps_c, ctypes.c_void_p),
            ctypes.cast(fold_c, ctypes.c_void_p), c1, c2, clip_bound,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssim_bwd_launch failed with CUDA error {err}")
    if vhalo is None:
        LAUNCHES += 1
    else:
        VHALO_LAUNCHES += 1
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
    taps = gaussian_taps(np.float32, radius, sigma)
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
              clip_bound=max(131072.0, 4.0 * float(data_range)))
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
