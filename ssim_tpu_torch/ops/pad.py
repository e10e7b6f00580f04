"""Edge-pad-and-align: the hand-written CUDA kernel's wrapper and its plain
PyTorch twin.

Counterpart of `ssim_tpu/ops/pad.py`. Pads (B, H, W) into (B, hp, wp) of
the same dtype with image pixel (0, 0) at (ROW_OFF, COL_OFF) and every
cell outside the image an edge replica (clamp to edge). As in the JAX
package, no SSIM path calls it: the forward and backward kernels read raw
images through clamped indices.

- `pad_align_cuda` (`pad_align_pallas`) launches the kernel,
  `ssim_tpu_torch/csrc/pad.cu`;
- `pad_align_plain` is its twin, and the counterpart of `pad_align_xla`
  too: an index gather with clamped row and column indices, which serves
  every dtype on every device and copies each element's bits as they are;
- `pad_align` (the JAX dispatch) sends a CUDA tensor to the kernel and a
  CPU tensor to the twin, the counterpart of "compiled on TPU, interpreted
  elsewhere"; any other device raises. It never gives way to the twin on a
  CUDA tensor: if the kernel does not build or launch, it raises.

What does not carry over is TPU machinery: `pad_supported`, `tile_h`,
`interpret`, the (8, 128) DMA alignment (H % 8 == 0, W % 128 == 0,
H >= tile_h, hp % tile_h == 0) and the `wp >= W + COL_OFF + RADIUS` slack
that the TPU's SSIM kernels once needed. The Hopper kernel serves every
layout that fits, hp >= H + ROW_OFF and wp >= W + COL_OFF, where the JAX
package sent the rest to jnp.pad, and any dtype of 1, 2, 4 or 8 bytes.
"""

import torch

#: Padded-layout offsets of image pixel (0, 0) (the JAX package's, copied:
#: they are the layout's contract).
ROW_OFF = 8
COL_OFF = 128

#: Kernel launches made in this process by pad_align_cuda, added to in one
#: place, per launch, and nowhere else.
PAD_LAUNCHES = 0

#: The signed integer type of each itemsize the kernel takes: the twin
#: gathers through it, so it copies bits for every dtype on every device.
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _check(x, hp, wp):
    """The layout's checks; returns (B, H, W, hp, wp) as ints."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (B, H, W) tensor, got {tuple(x.shape)}")
    bsz, h, w = x.shape
    hp, wp = int(hp), int(wp)
    if hp < h + ROW_OFF or wp < w + COL_OFF:
        raise ValueError(
            f"padded layout ({hp}, {wp}) does not fit a ({h}, {w}) image at "
            f"offset ({ROW_OFF}, {COL_OFF}): needs hp >= {h + ROW_OFF} and "
            f"wp >= {w + COL_OFF}"
        )
    return bsz, h, w, hp, wp


def pad_align_plain(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """The kernel's twin: (B, H, W) -> (B, hp, wp), image at (ROW_OFF,
    COL_OFF), out-of-image cells edge replicas: an index gather with
    clamped row and column indices. Any dtype and device; takes any strides;
    the output is contiguous. Dtypes of 1, 2, 4 or 8 bytes are gathered as
    integers of that size, so their bits pass through as the kernel's do."""
    _, h, w, hp, wp = _check(x, hp, wp)
    dev = x.device
    rows = (torch.arange(hp, device=dev) - ROW_OFF).clamp_(0, h - 1)
    cols = (torch.arange(wp, device=dev) - COL_OFF).clamp_(0, w - 1)
    bits = _BITS.get(x.element_size())
    src = x if bits is None else x.view(bits)
    out = src.index_select(1, rows).index_select(2, cols)
    return out if bits is None else out.view(x.dtype)


def pad_align_cuda(x: torch.Tensor, *, hp: int, wp: int) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor: (B, H, W) -> (B, hp, wp) of the
    same dtype (itemsize 1, 2, 4 or 8 bytes; the bits are copied, so NaN
    payloads and -0.0 pass through). A non-contiguous input is made
    contiguous first (one copy). No synchronisation. Raises if the kernel
    does not build or launch."""
    global PAD_LAUNCHES
    from . import _build

    bsz, h, w, hp, wp = _check(x, hp, wp)
    if x.device.type != "cuda":
        raise ValueError(f"pad_align_cuda takes a CUDA tensor, got one on {x.device}")
    if x.element_size() not in _BITS:
        raise ValueError(f"the pad kernel takes 1, 2, 4 or 8-byte elements, got {x.dtype}")
    if max(bsz, h, w, hp, wp) > 0x7FFFFFFF:
        raise ValueError(f"({bsz}, {h}, {w}) -> ({hp}, {wp}) exceeds the kernel's "
                         f"32-bit dimensions")
    x = x.contiguous()
    lib = _build.load_library()
    out = torch.empty((bsz, hp, wp), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pad_align_launch(
            x.data_ptr(), out.data_ptr(), x.element_size(), bsz, h, w, hp, wp,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pad_align kernel failed with CUDA error {err}")
    PAD_LAUNCHES += 1
    return out


def pad_align(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Edge-pad (B, H, W) -> (B, hp, wp): the kernel on a CUDA tensor, the
    plain twin on a CPU tensor (each checks its arguments); any other
    device raises."""
    if x.device.type == "cuda":
        return pad_align_cuda(x, hp=hp, wp=wp)
    if x.device.type == "cpu":
        return pad_align_plain(x, hp, wp)
    raise ValueError(f"no pad kernel for device {x.device}")
