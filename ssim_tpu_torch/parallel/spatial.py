"""Spatial sharding: one large image split by rows over a mesh axis.

Counterpart of `ssim_tpu/parallel/spatial.py` on torch.distributed, with
its names and keywords. Each rank is given the whole (H, W) image (or
(B, H, W) batch), as the JAX functions take a global array; it pads the
rows as the JAX layer does, takes its own row band, and returns the global
outputs gathered over the axis, so every rank's result is the JAX
function's.

Each input may instead be a `DTensor` whose rows the axis splits: each
process's own rows, as the JAX multi-process callers pass
`make_array_from_process_local_data(NamedSharding(mesh, P(axis, None)),
...)`. Where its local rows are exactly the band a rank takes (H divisible
by the axis, bands of at least the rows the function needs; for a batch,
images split over `batch_axis` or, without one, replicated), they are the
band, with no gather; any other layout is gathered first. Either way the
result is the whole-tensor call's, and a gradient reaches the DTensor as
one (its local block the band's gradient).

The r rows above and below a band come from the neighbouring ranks: one
stacked point-to-point exchange each way around the axis' ring
(`torch.distributed.batch_isend_irecv`, the counterpart of `ppermute`).
The kernel route hands them to the forward kernel's row modes
(`ssim_rows_cuda(vhalo=..., vmask=...)`, with or without the map) or
to the backward kernel's halo mode (`ssim_grad_cuda(vhalo=..., vmask=...)`)
as operands, raw: at the image's own top and bottom the kernels replicate
the band's edge row themselves, gated on the (is_top, is_bot) flags. The
plain route (`impl="torch"`, dtypes other than u8 / f32 pairs, radius >
16) builds the edge replicas here and runs `ops/ssim_torch.ssim_from_padded`
per band, differentiably: the exchange's backward sends each halo's
cotangent back to the rank it came from (the adjoint of the ring shift).

On one rank the ring is a send to itself: the band's own last and first
rows are passed as the operands, with no collective, and both flags are
set, so the kernels replace them, as the JAX ring of one device does.

Heights that do not divide the axis (or bands thinner than the radius) are
padded with edge-replicated rows, which are what the clamp-to-edge border
reads, and the outputs are sliced back.

Autograd convention: a loss computed from these functions is the same on
every rank (it is all-reduced or gathered), and each rank runs its
backward with the same cotangent. The all-reduce's backward is the
identity, a gather's backward keeps this rank's block, and taking a band
of a global tensor gathers every rank's band gradient, so every rank ends
with the gradient of the global tensor.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..dispatch import Implementation, select_impl
from ..engine import validate_window
from ..ops.ssim_cuda import MAX_FUSED_RADIUS, _pad_cols, ssim_rows_cuda
from ..ops.ssim_grad import grad_cuda_supported, ssim_grad_cuda
from ..ops.ssim_torch import ssim_from_padded
from ..windows import RADIUS
from .mesh import MeshAxis, dtensor_layout, gather, mesh_device


def _as_tensor(x, device) -> torch.Tensor:
    """x as a tensor on the mesh's device; a DTensor stays as it is."""
    if isinstance(x, DTensor):
        return x
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


def _group_rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


def _ring(to_next: torch.Tensor, to_prev: torch.Tensor, group):
    """Send to_next to the next rank of the group's ring and to_prev to the
    previous one, in one batch; returns (from_prev, from_next), what the
    previous rank sent down and the next rank sent up."""
    n = dist.get_world_size(group)
    k = _group_rank(group)
    ranks = dist.get_process_group_ranks(group)
    prev, nxt = ranks[(k - 1) % n], ranks[(k + 1) % n]
    to_next, to_prev = to_next.contiguous(), to_prev.contiguous()
    from_prev, from_next = torch.empty_like(to_next), torch.empty_like(to_prev)
    ops = [
        dist.P2POp(dist.isend, to_next, nxt, group, 0),
        dist.P2POp(dist.irecv, from_prev, prev, group, 0),
        dist.P2POp(dist.isend, to_prev, prev, group, 1),
        dist.P2POp(dist.irecv, from_next, nxt, group, 1),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


class _RingShift(torch.autograd.Function):
    """_ring with its adjoint: each received block's cotangent goes back
    to the rank that sent it."""

    @staticmethod
    def forward(ctx, to_next, to_prev, group):
        ctx.group = group
        return _ring(to_next, to_prev, group)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # g_prev belongs to the previous rank's to_next, g_next to the next
        # rank's to_prev; what comes back is ours.
        back_prev, back_next = _ring(g_next, g_prev, ctx.group)
        return back_next, back_prev, None


class _Gather(torch.autograd.Function):
    """gather whose backward keeps this rank's block of the (replicated)
    cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.k, ctx.size, ctx.dim = _group_rank(group), x.shape[dim], dim
        return gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.k * ctx.size, ctx.size), None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the groups' ranks; the backward is the identity (the
    loss is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone()
        for group in groups:
            if dist.get_world_size(group) > 1:
                dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _block(x: torch.Tensor, space: MeshAxis, batch: Optional[MeshAxis]) -> torch.Tensor:
    """This rank's rows of x along `space` (and images along `batch`)."""
    hs = x.shape[-2] // space.n
    x = x.narrow(-2, space.k * hs, hs)
    if batch is not None:
        bd = x.shape[0] // batch.n
        x = x.narrow(0, batch.k * bd, bd)
    return x.contiguous()


class _Band(torch.autograd.Function):
    """_block whose backward gathers every rank's band gradient, so each
    rank holds the gradient of the whole tensor."""

    @staticmethod
    def forward(ctx, x, space, batch):
        ctx.space, ctx.batch = space, batch
        return _block(x, space, batch)

    @staticmethod
    def backward(ctx, g):
        g = gather(g, ctx.space.group, -2)
        if ctx.batch is not None:
            g = gather(g, ctx.batch.group, 0)
        return g, None, None


def _band(x, mesh, space: MeshAxis, data: Optional[MeshAxis], band_h: int) -> torch.Tensor:
    """This rank's band of x: band_h rows of x padded with edge rows to
    band_h * space.n (and its block of images along `data`). A DTensor
    whose rows `space` splits into bands of exactly band_h rows (and its
    images `data` splits, or nothing else splits it) gives its local block
    with no gather; any other DTensor is gathered first. A whole tensor is
    cut by _Band (whose backward gathers every rank's band gradient)."""
    if isinstance(x, DTensor):
        layout = dtensor_layout(x, mesh)
        want = {space.name: x.dim() - 2}
        if data is not None:
            want[data.name] = 0
        if layout == want and x.shape[-2] == band_h * space.n:
            return x.to_local().contiguous()
        x = x.to_local()
        for axis, dim in layout.items():
            x = _Gather.apply(x, mesh.get_group(axis), dim)
    x = _pad_rows_to(x, band_h * space.n)
    return _Band.apply(x, space, data)


def _edge_replica(x: torch.Tensor, row: int, radius: int) -> torch.Tensor:
    """Row `row` of x replicated `radius` times along -2 (the clamp-to-edge
    halo for the plain route, which has no in-kernel substitution)."""
    return x.narrow(-2, row % x.shape[-2], 1).expand(
        *x.shape[:-2], radius, x.shape[-1])


def _exchange_halo_rows_pair(
    xa: torch.Tensor, xb: torch.Tensor, group, radius: int,
    edge_replicas: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The `radius` rows above and below this rank's band of an image
    PAIR, as (a_top, a_bot, b_top, b_bot) of shape (..., radius, W): the
    kernels' vhalo operands. top is the previous rank's last rows, bot the
    next rank's first rows; both images ride one stacked send each way.

    edge_replicas=False returns the raw ring outputs (at the image's first
    and last band, the other end's rows, which the kernels replace on their
    vmask flags; contiguous, as the kernels take them). With
    edge_replicas=True those are replaced here by the band's own edge row
    replicated (clamp-to-edge), for the plain route. On a one-rank axis
    the ring is a send to itself, made with no collective.
    """
    n = dist.get_world_size(group)
    send_down = torch.stack([xa[..., -radius:, :], xb[..., -radius:, :]])
    send_up = torch.stack([xa[..., :radius, :], xb[..., :radius, :]])
    if n == 1:
        tops, bots = send_down, send_up
    else:
        tops, bots = _RingShift.apply(send_down, send_up, group)
    if edge_replicas:
        k = _group_rank(group)
        pair = torch.stack([xa, xb])
        if k == 0:
            tops = _edge_replica(pair, 0, radius)
        if k == n - 1:
            bots = _edge_replica(pair, -1, radius)
    return tops[0], bots[0], tops[1], bots[1]


def _vmask_flags(group) -> Tuple[float, float]:
    """(is_top, is_bot), 0 or 1: whether this rank's band holds the image's
    first / last row (the kernels' vmask)."""
    k = _group_rank(group)
    return float(k == 0), float(k == dist.get_world_size(group) - 1)


def _pad_rows_to(x: torch.Tensor, h_pad: int) -> torch.Tensor:
    """Edge-replicate bottom rows up to h_pad: what the clamp-to-edge
    border reads, so the valid rows' values are unchanged."""
    h = x.shape[-2]
    if h_pad == h:
        return x
    rows = torch.arange(h_pad, device=x.device).clamp_(max=h - 1)
    return x.index_select(-2, rows)


def _plain_band(xa, xb, group, radius, with_map, win):
    """The plain route on one band: f32, halos with edge replicas,
    horizontal edge pads, ssim_from_padded. Returns (rows, map or None)."""
    af, bf = xa.to(torch.float32), xb.to(torch.float32)
    at, ab, bt, bb = _exchange_halo_rows_pair(af, bf, group, radius)
    ap = _pad_cols(torch.cat([at, af, ab], dim=-2), radius)
    bp = _pad_cols(torch.cat([bt, bf, bb], dim=-2), radius)
    return ssim_from_padded(ap, bp, with_map=with_map, radius=radius, **win)


def ssim_spatial_sharded(
    a,
    b,
    mesh,
    *,
    axis: str = "space",
    with_map: bool = False,
    data_range: float = 255.0,
    radius: int = RADIUS,
    impl="auto",
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """SSIM of one (H, W) pair with rows sharded over `axis`.

    a, b: the whole image on every rank (tensors or arrays; moved to the
    mesh's device). Any H >= 1 works: the rows are padded internally and
    the outputs sliced back. Returns (row_sums (H,) f32, map (H, W) f32 or
    None), the same on every rank.

    impl: "auto"/"cuda" (the forward kernel's row modes with halo operands
    for u8 or f32 pairs at radius <= 16, the plain route otherwise) or
    "torch". radius also sets the halo depth, so any radius works.
    """
    validate_window(radius, sigma, k1, k2, data_range)
    radius = int(radius)
    device = mesh_device(mesh)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(
            f"ssim_spatial_sharded takes one (H, W) pair, got "
            f"{tuple(a.shape)} vs {tuple(b.shape)}"
        )
    space = MeshAxis(mesh, axis)
    h = a.shape[-2]
    impl = select_impl("auto" if impl is None else impl)
    float_pair = a.dtype == torch.float32 and b.dtype == torch.float32
    use_kernel = (
        impl == Implementation.CUDA
        and ((a.dtype == torch.uint8 and b.dtype == torch.uint8) or float_pair)
        and radius <= MAX_FUSED_RADIUS
    )
    win = dict(data_range=data_range, sigma=sigma, k1=k1, k2=k2)

    # Every band at least `radius` rows tall, so one neighbour's rows
    # make the whole halo.
    shard_h = max(-(-h // space.n), radius)
    a_s = _band(a, mesh, space, None, shard_h)
    b_s = _band(b, mesh, space, None, shard_h)
    if use_kernel:
        vh = _exchange_halo_rows_pair(a_s, b_s, space.group, radius,
                                      edge_replicas=False)
        # Score only: the row mode, no map written; with the map, its
        # row sums come from the same launch (the map is never summed).
        rows, ssim_map = ssim_rows_cuda(
            a_s, b_s, with_map=with_map, allow_float=float_pair,
            radius=radius, vhalo=vh, vmask=_vmask_flags(space.group), **win,
        )
    else:
        rows, ssim_map = _plain_band(a_s, b_s, space.group, radius, with_map, win)
    rows = _Gather.apply(rows, space.group, -1)[:h]
    if not with_map:
        return rows, None
    return rows, _Gather.apply(ssim_map, space.group, -2)[:h]


class _SpatialMean(torch.autograd.Function):
    """mean_ssim_spatial's kernel route: forward fwd(a, b), backward
    bwd(a, b, g), the sharded backward kernel."""

    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        ctx.save_for_backward(a, b)
        ctx.bwd = bwd
        return fwd(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = ctx.bwd(a, b, g)
        return da, db, None, None


def mean_ssim_spatial(
    a,
    b,
    mesh,
    *,
    axis: str = "space",
    batch_axis: Optional[str] = None,
    data_range: float = 255.0,
    impl="auto",
    radius: int = RADIUS,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Differentiable mean SSIM of a row-sharded (H, W) pair, or of a
    (B, H, W) batch, optionally batch-sharded over a second mesh axis (the
    2-D data x space composition): the spatial-sharding training surface.
    Returns a 0-d f32 tensor, the same on every rank.

    Forward: the forward kernel's row mode per band, and an all-reduce.
    Backward for f32 pairs: the sharded backward kernel
    (ssim_grad_spatial_sharded) where the geometry allows it (H divisible
    by the axis, bands >= 2*radius rows, w > radius, radius <= 16);
    otherwise a single pair takes autograd through the plain route, and a
    batch raises (as in the JAX package).
    """
    validate_window(radius, sigma, k1, k2, data_range)
    radius = int(radius)
    device = mesh_device(mesh)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    if a.dim() not in (2, 3) or a.shape != b.shape:
        raise ValueError(
            f"mean_ssim_spatial takes one (H, W) pair or a (B, H, W) "
            f"batch, got {tuple(a.shape)} vs {tuple(b.shape)}"
        )
    if batch_axis is not None and a.dim() != 3:
        raise ValueError("batch_axis requires (B, H, W) inputs")
    h, w = a.shape[-2], a.shape[-1]
    batch = 1 if a.dim() == 2 else a.shape[0]
    n = batch * h * w
    space = MeshAxis(mesh, axis)
    float_pair = a.dtype == torch.float32 and b.dtype == torch.float32
    grad_ok = (
        float_pair
        and grad_cuda_supported(h, w, radius)
        and h % space.n == 0
        and h // space.n >= 2 * radius
    )
    win = dict(data_range=data_range, sigma=sigma, k1=k1, k2=k2)

    use_kernel = (
        select_impl("auto" if impl is None else impl) == Implementation.CUDA
        and radius <= MAX_FUSED_RADIUS
    )
    data = None
    if a.dim() == 2:
        if not grad_ok:
            # The kernels have no autograd of their own: float pairs the
            # sharded backward cannot take ride the plain route, which
            # autograd differentiates; u8 pairs (no gradient) keep impl.
            rows, _ = ssim_spatial_sharded(
                a, b, mesh, axis=axis, impl="torch" if float_pair else impl,
                radius=radius, **win)
            return (rows.to(torch.float64).sum() / n).to(torch.float32)
        fp = True
    else:
        if h % space.n != 0 or h // space.n < radius:
            raise ValueError(
                f"batched mean_ssim_spatial needs H={h} divisible by the "
                f"{axis!r} axis ({space.n}) with shards >= {radius} rows"
            )
        if a.dtype == torch.uint8 and b.dtype == torch.uint8:
            fp = False
        elif float_pair:
            fp = True
        else:
            raise ValueError(
                f"batched mean_ssim_spatial takes uint8 or float32 pairs, "
                f"got {a.dtype}/{b.dtype}"
            )
        data = None if batch_axis is None else MeshAxis(mesh, batch_axis)
        if data is not None and batch % data.n:
            raise ValueError(
                f"B={batch} must divide the {batch_axis!r} axis ({data.n})"
            )
        if fp and use_kernel and not grad_ok:
            raise ValueError(
                f"batched differentiable mean_ssim_spatial needs shards "
                f">= {2 * radius} rows and w > {radius} (got {h}x{w} over "
                f"{space.n} shards); use fewer shards"
            )
    groups = [space.group] + ([] if data is None else [data.group])
    a_s = _band(a, mesh, space, data, h // space.n)
    b_s = _band(b, mesh, space, data, h // space.n)

    def fwd_mean(xa_s, xb_s):
        if use_kernel:
            vh = _exchange_halo_rows_pair(xa_s, xb_s, space.group, radius,
                                          edge_replicas=False)
            rows, _ = ssim_rows_cuda(
                xa_s, xb_s, allow_float=fp, radius=radius,
                vhalo=vh, vmask=_vmask_flags(space.group), **win,
            )
        else:
            rows, _ = _plain_band(xa_s, xb_s, space.group, radius, False, win)
        total = _AllReduceSum.apply(rows.to(torch.float64).sum(), groups)
        return (total / n).to(torch.float32)

    if a.dim() == 3 and not (fp and use_kernel):
        # u8 has no gradient; the plain route is differentiable as it is.
        return fwd_mean(a_s, b_s)

    def bwd(xa_s, xb_s, g):
        return _grad_bands(xa_s, xb_s, space, g.to(torch.float32) / n, radius, win)

    # On the bands: each band's gradient goes back through _band (gathered
    # for a whole tensor, as the DTensor's local block for a DTensor).
    return _SpatialMean.apply(a_s, b_s, fwd_mean, bwd)


def ssim_grad_spatial_sharded(
    a,
    b,
    mesh,
    *,
    axis: str = "space",
    batch_axis: Optional[str] = None,
    w_s=1.0,
    data_range: float = 255.0,
    radius: int = RADIUS,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/da, dL/db) for L = w_s * sum_p SSIM(p) of one row-sharded
    float32 (H, W) pair, or a (B, H, W) batch (`batch_axis` optionally
    shards B over a second mesh axis): the backward kernel's halo mode on
    each band, with the 2*radius neighbour rows each side exchanged over
    the ring. Returns the whole gradients, the same on every rank.

    Each band's gradients are exact: its rows' gradients sum weight-map
    rows within r of them, which need blurred rows within r more, so 2r
    true neighbour rows make them; the neighbours' loss rows within r are
    counted in the band's kernel call and each band keeps only its own
    rows; at the image's own edges the kernel drops the loss rows beyond
    the edge and folds the clamp's tap mass onto the edge row (see
    ssim_grad_cuda). Requirements: float32, H divisible by the axis, bands
    >= 2*radius rows, w > radius, radius <= 16, w_s a scalar (a number or
    0-d tensor, e.g. a loss cotangent over the pixel count).
    """
    validate_window(radius, sigma, k1, k2, data_range)
    radius = int(radius)
    device = mesh_device(mesh)
    a, b = _as_tensor(a, device), _as_tensor(b, device)
    if a.dim() not in (2, 3) or a.shape != b.shape:
        raise ValueError(
            f"ssim_grad_spatial_sharded takes one (H, W) pair or a "
            f"(B, H, W) batch, got {tuple(a.shape)} vs {tuple(b.shape)}"
        )
    if batch_axis is not None and a.dim() != 3:
        raise ValueError("batch_axis requires (B, H, W) inputs")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(
            f"float32 pairs required (u8 has no gradient), got "
            f"{a.dtype}/{b.dtype}"
        )
    space = MeshAxis(mesh, axis)
    h, w = a.shape[-2], a.shape[-1]
    if not grad_cuda_supported(h, w, radius):
        raise ValueError(
            f"the fused backward needs w > radius and radius <= "
            f"{MAX_FUSED_RADIUS}; got {h}x{w} at radius {radius}"
        )
    m = 2 * radius
    if h % space.n != 0 or h // space.n < m:
        raise ValueError(
            f"H={h} must divide the {axis!r} axis ({space.n}) with shards "
            f">= {m} rows tall; use fewer shards or the single-device kernel"
        )
    w_arr = torch.as_tensor(w_s, dtype=torch.float32, device=device)
    if w_arr.dim() != 0:
        raise ValueError(
            "w_s must be a scalar (per-image weights would need their own "
            f"sharding), got shape {tuple(w_arr.shape)}"
        )
    data = None if batch_axis is None else MeshAxis(mesh, batch_axis)
    if data is not None and a.shape[0] % data.n:
        raise ValueError(f"B={a.shape[0]} must divide the {batch_axis!r} axis ({data.n})")
    with torch.no_grad():
        a_s = _band(a, mesh, space, data, h // space.n)
        b_s = _band(b, mesh, space, data, h // space.n)
        da, db = _grad_bands(a_s, b_s, space, w_arr, radius,
                             dict(data_range=data_range, sigma=sigma, k1=k1, k2=k2))
        out = []
        for g in (da, db):
            g = gather(g, space.group, -2)
            out.append(g if data is None else gather(g, data.group, 0))
    return out[0], out[1]


def _grad_bands(a_s, b_s, space: MeshAxis, w_arr, radius: int, win):
    """The backward kernel's halo mode on this rank's bands, with the
    2*radius neighbour rows each side exchanged over the ring: the bands'
    gradients (see ssim_grad_spatial_sharded)."""
    m = 2 * radius
    vh = _exchange_halo_rows_pair(a_s, b_s, space.group, m, edge_replicas=False)
    return ssim_grad_cuda(a_s, b_s, w_arr, 0.0, radius=radius, vhalo=vh,
                          vmask=_vmask_flags(space.group), **win)
