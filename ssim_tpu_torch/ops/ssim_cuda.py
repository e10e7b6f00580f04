"""Fused SSIM forward: the hand-written CUDA kernel's wrappers and their
plain PyTorch twins.

Counterpart of `ssim_tpu/ops/ssim_pallas.py` over `_nopad_overlap_call`
and `_chunked_overlap_call`, in four of their modes:

- standard tier, with or without the map: `ssim_parts_cuda`
  (`ssim_parts_pallas`), twin `ssim_parts_plain`;
- precise tier (precision="f64"), with or without the map:
  `ssim_parts_cuda(precise=True)` (`ssim_parts_pallas(precise=True)`),
  twin `ssim_parts_precise_plain`: the standard f32 blurs, the SSIM
  formula in native fp64 where the TPU kernel compensates it in df32, and
  one fp64 partial per tile where the TPU kernel writes two f32 ones;
- MS-SSIM components, per-tile [sum cs, sum ssim]:
  `ssim_components_cuda` (`ssim_components_pallas`), twin
  `ssim_components_plain`;
- components plus the 2x2-mean images of the next pyramid scale:
  `ssim_components_pooled_cuda` (`ssim_components_pooled_pallas`), twin
  `ssim_components_pooled_plain`.

The kernel is `ssim_tpu_torch/csrc/ssim_fwd.cu`: one 2-D grid of TILE_H x
TILE_W output tiles, one CUDA block per tile, that covers every width, so
the TPU's split at 16384 lanes and `pooled_components_ok`'s VMEM limits
have no counterpart.

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
#: tier, with or without the map; PRECISE_LAUNCHES: the precise tier),
#: ssim_components_cuda and ssim_components_pooled_cuda, one counter per
#: mode. Each is added to in one place, per launch, and nowhere else, so
#: a caller can show which modes a run went through.
LAUNCHES = 0
PRECISE_LAUNCHES = 0
COMPONENTS_LAUNCHES = 0
POOLED_LAUNCHES = 0


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


def _blurs_plain(a, b, taps, clip_bound):
    """The four blurred signals mu_a, mu_b, s_ss, s_dd of (B, H, W) u8 or
    f32 inputs in the kernel's order of operations, and for f32 the mask
    of non-finite input pixels (None for u8)."""
    h, w = a.shape[-2], a.shape[-1]
    r = len(taps) // 2
    t = [float(v) for v in taps]
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    bad = None
    if a.dtype == torch.float32:
        bad = ~(torch.isfinite(af) & torch.isfinite(bf))
        af = torch.nan_to_num(af, nan=0.0).clamp(-clip_bound, clip_bound)
        bf = torch.nan_to_num(bf, nan=0.0).clamp(-clip_bound, clip_bound)
    # Horizontal pass over all H + 2r rows, then the vertical pass.
    planes = hpass4(_pad_edge(af, r), _pad_edge(bf, r), t, w)
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


def _ssim_map_plain(a, b, dtype, taps, c1, c2, clip_bound, tile_h, tile_w):
    """Per-pixel SSIM of the standard and precise modes: the f32 blurs,
    then the formula of _ssim_from_blurs in `dtype` (f32, or f64 on the
    widened blurs), with NaN over the tiles of non-finite inputs."""
    blurs, bad = _blurs_plain(a, b, taps, clip_bound)
    mu_a2, mu_b2, mu_ab, sigma_ab_x4, sigma_sum_x2 = _sigmas(
        *(x.to(dtype) for x in blurs))
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
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The standard mode's plain twin on (B, H, W) u8 or f32 tensors, on
    any device. Returns (partials (B, nty*ntx) f32, map (B, H, W) f32 or
    None)."""
    ssim = _ssim_map_plain(a, b, torch.float32, taps, c1, c2, clip_bound,
                           tile_h, tile_w)
    partials = _tile_partials(ssim, tile_h, tile_w)
    return partials, (ssim if with_map else None)


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
    any device: the standard mode's f32 blurs widened to f64, the SSIM
    formula in f64 in the kernel's order, the per-tile NaN poison, and f64
    tile sums over the same grid. Returns (partials (B, nty*ntx) f64,
    map (B, H, W) f32, the f64 values rounded, or None)."""
    ssim = _ssim_map_plain(a, b, torch.float64, taps, c1, c2, clip_bound,
                           tile_h, tile_w)
    partials = _tile_partials(ssim, tile_h, tile_w)
    return partials, (ssim.to(torch.float32) if with_map else None)


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
) -> torch.Tensor:
    """The components mode's plain twin on (B, H, W) u8 or f32 tensors, on
    any device: lum and cs from the four blurs (_l_cs_from_blurs), ssim =
    lum * cs. Returns (B, nty*ntx, 2) f32 per-tile [sum(cs - 1) + n_valid,
    sum(ssim - 1) + n_valid]; a tile with a non-finite input pixel of its
    own has NaN in both."""
    blurs, bad = _blurs_plain(a, b, taps, clip_bound)
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
_MODES = ("score", "map", "components", "pooled", "precise", "precise_map")


def _launch(a, b, *, mode, taps, c1, c2, clip_bound, tile_h, tile_w):
    """Launch the CUDA kernel in `mode` (one of _MODES) on (B, H, W)
    contiguous tensors on one CUDA device; no synchronisation. Returns
    the mode's outputs: (partials, map or None) (partials f64 in the
    precise modes), (B, K, 2) partials, or (partials, pooled_a,
    pooled_b)."""
    global LAUNCHES, PRECISE_LAUNCHES, COMPONENTS_LAUNCHES, POOLED_LAUNCHES
    from . import _build

    lib = _build.load_library()
    bsz, h, w = a.shape
    nty, ntx = tile_grid(h, w, tile_h, tile_w)
    if bsz * nty * ntx > 0x7FFFFFFF:
        raise ValueError(f"{bsz * nty * ntx} tiles exceed one launch's grid")
    comp = mode in ("components", "pooled")
    precise = mode in ("precise", "precise_map")
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=a.device)
    if comp:
        partials = new(bsz, nty * ntx, 2)
    else:
        partials = torch.empty((bsz, nty * ntx), device=a.device,
                               dtype=torch.float64 if precise else torch.float32)
    ssim_map = new(bsz, h, w) if mode in ("map", "precise_map") else None
    pooled = (new(bsz, h // 2, w // 2), new(bsz, h // 2, w // 2)) \
        if mode == "pooled" else (None, None)
    ptr = lambda x: None if x is None else x.data_ptr()
    r = len(taps) // 2
    taps_c = (ctypes.c_float * len(taps))(*[float(v) for v in taps])
    with torch.cuda.device(a.device):
        err = lib.ssim_fwd_launch(
            _MODES.index(mode), int(a.dtype == torch.float32), a.data_ptr(),
            b.data_ptr(), partials.data_ptr(), ptr(ssim_map), ptr(pooled[0]),
            ptr(pooled[1]), bsz, h, w, r, tile_h, tile_w,
            ctypes.cast(taps_c, ctypes.c_void_p), c1, c2, clip_bound,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssim_fwd kernel ({mode}) failed with CUDA error {err}")
    if mode == "pooled":
        POOLED_LAUNCHES += 1
        return partials, pooled[0], pooled[1]
    if comp:
        COMPONENTS_LAUNCHES += 1
        return partials
    if precise:
        PRECISE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return partials, ssim_map


def _prepare(a, b, *, data_range, radius, sigma, k1, k2, tile_h, tile_w):
    """Check what every mode of the kernel needs of its arguments (dtypes
    are each wrapper's own check) and return the launch's keyword
    arguments: taps, c1, c2, clip_bound, tile_h, tile_w."""
    if not 1 <= radius <= MAX_FUSED_RADIUS:
        raise ValueError(
            f"the fused kernel serves radius 1..{MAX_FUSED_RADIUS}; got "
            f"{radius} — use ssim_parts_torch for larger windows"
        )
    if data_range < 1e-6:
        raise ValueError(f"data_range {data_range} too small (must be >= 1e-6)")
    taps = gaussian_taps(np.float32, radius, sigma)
    c1 = float((k1 * data_range) ** 2)
    c2 = float((k2 * data_range) ** 2)
    if c1 * c2 < 9e-32:
        raise ValueError(
            f"k1/k2 too small for data_range {data_range}: c1*c2 = "
            f"{c1 * c2:g} degenerates in f32 (needs >= 9e-32)"
        )
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
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused kernel for device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the fused kernel takes contiguous tensors")
    return dict(taps=taps, c1=c1, c2=c2,
                clip_bound=max(131072.0, 4.0 * float(data_range)),
                tile_h=tile_h, tile_w=tile_w)


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
    RMGR_SSIM_USE_DOUBLE build): the same f32 blurs, the SSIM formula and
    the tile sums in native fp64, and partials (..., K) f64, one per tile.
    The JAX kernel's precise mode writes 2K f32 partials (df32 hi, lo +
    e); engine.finalize_mean sums either in f64, so the score is the same
    quantity. The map is the f32 rounding of the fp64 values.

    Float inputs are sanitised (NaN -> 0, clip to +-max(131072,
    4*data_range)); a tile whose own pixels include a NaN or inf gets a
    NaN partial and NaN map values, so an invalid input shows in its own
    image's score and no other's.
    """
    float_ok = (
        allow_float and a.dtype == torch.float32 and b.dtype == torch.float32
    )
    if not float_ok and (a.dtype != torch.uint8 or b.dtype != torch.uint8):
        raise ValueError(
            f"the fused kernel is specialized to uint8 inputs; got "
            f"{a.dtype}/{b.dtype} — use allow_float=True for float32 "
            f"images or ssim_parts_torch for wider integer dtypes"
        )
    kw = _prepare(a, b, data_range=data_range, radius=radius, sigma=sigma,
                  k1=k1, k2=k2,
                  tile_h=TILE_H if tile_h is None else int(tile_h),
                  tile_w=TILE_W if tile_w is None else int(tile_w))
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    if a.device.type == "cuda":
        if precise:
            mode = "precise_map" if with_map else "precise"
        else:
            mode = "map" if with_map else "score"
        partials, ssim_map = _launch(a, b, mode=mode, **kw)
    else:
        plain = ssim_parts_precise_plain if precise else ssim_parts_plain
        partials, ssim_map = plain(a, b, with_map=with_map, **kw)
    if squeeze:
        partials = partials[0]
        ssim_map = None if ssim_map is None else ssim_map[0]
    return partials, ssim_map


def _components_args(a, b, data_range, radius, sigma, k1, k2):
    if a.dtype != b.dtype or a.dtype not in (torch.uint8, torch.float32):
        raise ValueError(
            f"the components kernel takes uint8 or float32 pairs, got "
            f"{a.dtype}/{b.dtype}"
        )
    return _prepare(a, b, data_range=data_range, radius=radius, sigma=sigma,
                    k1=k1, k2=k2, tile_h=TILE_H, tile_w=TILE_W)


def ssim_components_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    data_range: float = 255.0,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Fused-kernel MS-SSIM components. a, b: (H, W) or (B, H, W)
    contiguous uint8 or float32 pairs (float32 as sanitised and poisoned as
    in ssim_parts_cuda).

    Returns (..., K, 2) f32 per-tile sums, [..., 0] of cs and [..., 1] of
    ssim = lum * cs, each as sum(x - 1) + n_valid over the tile's valid
    pixels; means follow by summing over K and dividing by H*W. On a CUDA
    tensor the kernel is launched; on a CPU tensor the plain twin runs.
    """
    kw = _components_args(a, b, data_range, radius, sigma, k1, k2)
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ssim_components_cuda fused with the MS-SSIM pyramid's 2x2-mean
    downsample of the inputs: one launch returns the per-tile [cs, ssim]
    sums and the pooled next-scale images. a, b as in
    ssim_components_cuda, with H, W >= 2.

    Returns (parts (..., K, 2), pooled_a, pooled_b), the pooled images f32
    (..., H//2, W//2): (a[2i, 2j] + a[2i+1, 2j]) + (a[2i, 2j+1] +
    a[2i+1, 2j+1]), times 0.25, from the raw inputs (a NaN reaches its own
    pooled pixel), with an odd last row or column dropped. Exact for uint8.
    """
    kw = _components_args(a, b, data_range, radius, sigma, k1, k2)
    if a.shape[-2] < 2 or a.shape[-1] < 2:
        raise ValueError(f"pooling needs H, W >= 2, got {tuple(a.shape)}")
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    if a.device.type == "cuda":
        out = _launch(a, b, mode="pooled", **kw)
    else:
        out = ssim_components_pooled_plain(a, b, **kw)
    return tuple(x[0] for x in out) if squeeze else out
