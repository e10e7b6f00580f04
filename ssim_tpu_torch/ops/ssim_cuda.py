"""Fused SSIM forward: the hand-written CUDA kernel's wrapper and its
plain PyTorch twin.

Counterpart of `ssim_tpu/ops/ssim_pallas.py` (`ssim_parts_pallas` over
`_nopad_overlap_call` and `_chunked_overlap_call`, standard tier, with or
without the map). The kernel is `ssim_tpu_torch/csrc/ssim_fwd.cu`: one
2-D grid of TILE_H x TILE_W output tiles, one CUDA block per tile, that
covers every width, so the TPU's split at 16384 lanes has no counterpart.

`ssim_parts_cuda` launches the kernel for CUDA tensors and runs the plain
twin `ssim_parts_plain` for CPU tensors, the counterpart of "compiled on
TPU, interpreted elsewhere". The twin uses the same tile grid, the same
clamp-to-edge rule, the four blurred signals a, b, (a+b)^2, (a-b)^2 with
the kernel's order of operations, the float sanitise and per-tile NaN
poison, and one sum(ssim - 1) + n_valid partial per tile. It is what the
CPU tests run and what the kernel is held against on the card.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..windows import RADIUS, SIGMA, gaussian_taps
from .ssim_torch import _pad_edge

#: Largest window radius the kernel serves (its taps live in a 33-float
#: array); larger radii route to ssim_parts_torch.
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

#: Kernel launches made by ssim_parts_cuda in this process. The wrapper
#: adds one per launch and nowhere else, so a caller can show that a run
#: went through the kernel.
LAUNCHES = 0


def smem_bytes(tile_h: int, tile_w: int, radius: int) -> int:
    """Dynamic shared memory of one block: the a and b halo tiles plus
    four horizontally blurred planes."""
    hr = tile_h + 2 * radius
    return 4 * (2 * hr * (tile_w + 2 * radius) + 4 * hr * tile_w)


def tile_grid(h: int, w: int, tile_h: int = TILE_H, tile_w: int = TILE_W):
    """(rows of tiles, columns of tiles) covering an h x w image."""
    return -(-h // tile_h), -(-w // tile_w)


def _tile_reduce(x: torch.Tensor, tile_h: int, tile_w: int, op) -> torch.Tensor:
    """Zero-pad (B, H, W) to whole tiles and reduce each tile with `op`
    over dims (2, 4) of (B, nty, tile_h, ntx, tile_w)."""
    bsz, h, w = x.shape
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    x = torch.nn.functional.pad(x, (0, ntx * tile_w - w, 0, nty * tile_h - h))
    return op(x.reshape(bsz, nty, tile_h, ntx, tile_w))


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
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's plain twin on (B, H, W) u8 or f32 tensors, on any
    device. Returns (partials (B, nty*ntx) f32, map (B, H, W) f32 or None)."""
    float_mode = a.dtype == torch.float32
    bsz, h, w = a.shape
    r = len(taps) // 2
    t = [float(v) for v in taps]
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    if float_mode:
        bad = ~(torch.isfinite(af) & torch.isfinite(bf))
        af = torch.nan_to_num(af, nan=0.0).clamp(-clip_bound, clip_bound)
        bf = torch.nan_to_num(bf, nan=0.0).clamp(-clip_bound, clip_bound)
    ap = _pad_edge(af, r)
    bp = _pad_edge(bf, r)

    # Horizontal pass over all H + 2r rows, four signals at once.
    def cols(x, k):
        return x[..., k : k + w]

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
    planes = (
        ma + t[r] * ac, mb + t[r] * bc,
        ss + t[r] * (sc * sc), dd + t[r] * (dc * dc),
    )

    # Vertical pass.
    def vpass(p):
        acc = None
        for d in range(r, 0, -1):
            term = t[r - d] * (p[:, r - d : r - d + h] + p[:, r + d : r + d + h])
            acc = term if acc is None else acc + term
        return acc + t[r] * p[:, r : r + h]

    mu_a, mu_b, s_ss, s_dd = (vpass(p) for p in planes)
    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_ab_x4 = (s_ss - s_dd) - 4.0 * mu_ab
    sigma_sum_x2 = (s_ss + s_dd) - 2.0 * (mu_a2 + mu_b2)
    num = (2.0 * mu_ab + c1) * (0.5 * sigma_ab_x4 + c2)
    den = (mu_a2 + mu_b2 + c1) * (0.5 * sigma_sum_x2 + c2)
    ssim = num / den

    if float_mode:
        # A tile with a non-finite pixel of its own is NaN, map and partial.
        tile_bad = _tile_reduce(bad.to(torch.float32), tile_h, tile_w,
                                lambda x: x.amax(dim=(2, 4))) > 0
        px_bad = tile_bad.repeat_interleave(tile_h, 1).repeat_interleave(
            tile_w, 2)[:, :h, :w]
        ssim = torch.where(px_bad, torch.full_like(ssim, float("nan")), ssim)

    sums = _tile_reduce(ssim - 1.0, tile_h, tile_w, lambda x: x.sum(dim=(2, 4)))
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    vrows = [min(tile_h, h - i * tile_h) for i in range(nty)]
    vcols = [min(tile_w, w - j * tile_w) for j in range(ntx)]
    n_valid = torch.tensor(np.outer(vrows, vcols), dtype=torch.float32,
                           device=a.device)
    partials = (sums + n_valid).reshape(bsz, nty * ntx)
    return partials, (ssim if with_map else None)


def _launch(a, b, *, with_map, taps, c1, c2, clip_bound, tile_h, tile_w):
    """Launch the CUDA kernel on (B, H, W) contiguous tensors on one
    CUDA device; no synchronisation."""
    global LAUNCHES
    from . import _build

    lib = _build.load_library()
    bsz, h, w = a.shape
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    if bsz * nty * ntx > 0x7FFFFFFF:
        raise ValueError(f"{bsz * nty * ntx} tiles exceed one launch's grid")
    partials = torch.empty((bsz, nty * ntx), dtype=torch.float32, device=a.device)
    ssim_map = (
        torch.empty((bsz, h, w), dtype=torch.float32, device=a.device)
        if with_map else None
    )
    r = len(taps) // 2
    taps_c = (ctypes.c_float * len(taps))(*[float(v) for v in taps])
    with torch.cuda.device(a.device):
        err = lib.ssim_fwd_launch(
            int(a.dtype == torch.float32), a.data_ptr(), b.data_ptr(),
            partials.data_ptr(),
            None if ssim_map is None else ssim_map.data_ptr(),
            bsz, h, w, r, tile_h, tile_w,
            ctypes.cast(taps_c, ctypes.c_void_p), c1, c2, clip_bound,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssim_fwd_launch failed with CUDA error {err}")
    LAUNCHES += 1
    return partials, ssim_map


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
    tile_h: Optional[int] = None,
    tile_w: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused-kernel SSIM. a, b: (H, W) or (B, H, W) contiguous tensors,
    uint8 (or, with allow_float=True, float32 in [0, data_range]).

    Returns (partials, map or None): partials is (..., K) f32 per-tile
    sums of per-pixel SSIM over valid pixels, K = ceil(H/tile_h) *
    ceil(W/tile_w) (finalize with engine.finalize_mean); map is
    (..., H, W) f32. On a CUDA tensor the kernel is launched; on a CPU
    tensor the plain twin runs. tile_h / tile_w pin the tile (defaults
    TILE_H x TILE_W).

    Float inputs are sanitised (NaN -> 0, clip to +-max(131072,
    4*data_range)); a tile whose own pixels include a NaN or inf gets a
    NaN partial and NaN map values, so an invalid input shows in its own
    image's score and no other's.
    """
    if not 1 <= radius <= MAX_FUSED_RADIUS:
        raise ValueError(
            f"the fused kernel serves radius 1..{MAX_FUSED_RADIUS}; got "
            f"{radius} — use ssim_parts_torch for larger windows"
        )
    if data_range < 1e-6:
        raise ValueError(f"data_range {data_range} too small (must be >= 1e-6)")
    float_ok = (
        allow_float and a.dtype == torch.float32 and b.dtype == torch.float32
    )
    if not float_ok and (a.dtype != torch.uint8 or b.dtype != torch.uint8):
        raise ValueError(
            f"the fused kernel is specialized to uint8 inputs; got "
            f"{a.dtype}/{b.dtype} — use allow_float=True for float32 "
            f"images or ssim_parts_torch for wider integer dtypes"
        )
    taps = gaussian_taps(np.float32, radius, sigma)
    c1 = float((k1 * data_range) ** 2)
    c2 = float((k2 * data_range) ** 2)
    if c1 * c2 < 9e-32:
        raise ValueError(
            f"k1/k2 too small for data_range {data_range}: c1*c2 = "
            f"{c1 * c2:g} degenerates in f32 (needs >= 9e-32)"
        )
    tile_h = TILE_H if tile_h is None else int(tile_h)
    tile_w = TILE_W if tile_w is None else int(tile_w)
    if tile_w not in _TILE_WIDTHS or not 1 <= tile_h <= _MAX_TILE_H:
        raise ValueError(
            f"tile {tile_h}x{tile_w}: tile_w must be one of {_TILE_WIDTHS} "
            f"and tile_h in 1..{_MAX_TILE_H}"
        )
    if smem_bytes(tile_h, tile_w, radius) > _MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"tile {tile_h}x{tile_w} at radius {radius} needs "
            f"{smem_bytes(tile_h, tile_w, radius)} bytes of shared memory "
            f"(at most {_MAX_DYNAMIC_SMEM})"
        )
    if a.shape != b.shape or a.dim() not in (2, 3) or 0 in a.shape:
        raise ValueError(
            f"expected matching non-empty (H, W) or (B, H, W) tensors, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.device != b.device:
        raise ValueError(f"inputs on different devices: {a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the fused kernel takes contiguous tensors")
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    clip_bound = max(131072.0, 4.0 * float(data_range))
    kw = dict(with_map=with_map, taps=taps, c1=c1, c2=c2,
              clip_bound=clip_bound, tile_h=tile_h, tile_w=tile_w)
    if a.device.type == "cuda":
        partials, ssim_map = _launch(a, b, **kw)
    elif a.device.type == "cpu":
        partials, ssim_map = ssim_parts_plain(a, b, **kw)
    else:
        raise ValueError(f"no fused kernel for device {a.device}")
    if squeeze:
        partials = partials[0]
        ssim_map = None if ssim_map is None else ssim_map[0]
    return partials, ssim_map
