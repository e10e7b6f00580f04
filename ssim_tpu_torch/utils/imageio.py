"""Image I/O and channel policies.

Counterpart of `ssim_tpu/utils/imageio.py`, kept as a copy (NumPy and
`struct` only; PIL imported lazily), with one difference: the formats
that the port and its CLI write are decoded here, not by PIL.

- `load_image` returns the array the JAX function returns through PIL.
  Binary PGM / PPM (P5 / P6, every maxval, scaled and clipped to uint8 as
  PIL and the JAX function together do) and uncompressed 8-bit gray or RGB
  TGA (what `_save_tga` writes, top down or bottom up) are decoded here,
  whether or not pillow is installed; every other file goes to PIL, and
  raises UnsupportedError naming pillow where it is not installed.
- BT.601 luminance with the reference CLI's fixed-point arithmetic:
  y = (r*19595 + g*38470 + b*7471 + 32768) >> 16.
- SSIM-map export as PNG / BMP / TGA (u8 quantization clamp(v, 0) * 255,
  truncated) or PFM (raw float32, bottom-up, little-endian scale -1.0).
  `.pfm` and `.tga` never need PIL; `.png` and `.bmp` raise without it.
"""

import os
import struct
from typing import Optional

import numpy as np

from ..errors import UnsupportedError


def _pil_image(what: str):
    """PIL.Image; UnsupportedError naming pillow, for `what`, where pillow
    is not installed."""
    try:
        from PIL import Image
    except ImportError:
        raise UnsupportedError(
            f"{what} needs pillow, which is not installed; without it only "
            f"binary PGM/PPM and uncompressed TGA images load"
        ) from None
    return Image


def load_image(path: str, channels: Optional[int] = None) -> np.ndarray:
    """Load an image as uint8 (H, W) or (H, W, C), like stbi_load with
    desired_channels=0 (the native channel count, no alpha premultiply)."""
    arr = _decode(path)
    if arr is None:
        arr = np.asarray(_pil_image(f"reading {path!r}").open(path))
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if channels is not None:
        if channels == 1 and arr.ndim == 3:
            arr = luminance_bt601(arr)
        elif channels == 3 and arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
    return arr


def _decode(path: str) -> Optional[np.ndarray]:
    """The array of a binary PGM / PPM or an uncompressed 8-bit gray or
    RGB TGA file, decoded here; None for any other file."""
    with open(path, "rb") as f:
        head = f.read(18)
        if head[:2] in (b"P5", b"P6") and head[2:3].isspace():
            decode = _decode_pnm
        elif os.path.splitext(path)[1].lower() == ".tga" and _tga_bands(head):
            decode = _decode_tga
        else:
            return None
        f.seek(0)
        return decode(f.read(), path)


def _pnm_tokens(data: bytes, count: int):
    """The first `count` header tokens of a PNM file and the offset just
    past the one whitespace byte that ends the last, skipping '#'
    comments as PIL's reader does."""
    tokens, pos = [], 2
    while len(tokens) < count:
        token = b""
        while pos < len(data):
            c = data[pos:pos + 1]
            pos += 1
            if c.isspace():
                if token:
                    break
            elif c == b"#":
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
            else:
                token += c
        if not token:
            raise ValueError("reached the end of the file while reading the PNM header")
        tokens.append(int(token))
    return tokens, pos


def _decode_pnm(data: bytes, path: str) -> np.ndarray:
    """P5 / P6 as PIL decodes them (then clipped to uint8 by load_image):
    maxval 255 raw; gray maxval 65535 raw 16-bit; any other maxval scaled
    by round(v / maxval * out_max) with Python's rounding, out_max 65535
    for gray above 255 (PIL's mode I) and 255 otherwise."""
    (w, h, maxval), pos = _pnm_tokens(data, 3)
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: maxval must be greater than 0 and less than 65536")
    bands = 1 if data[:2] == b"P5" else 3
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    count = w * h * bands
    if len(data) - pos < count * np.dtype(dtype).itemsize:
        raise OSError(f"{path}: image file is truncated")
    raw = np.frombuffer(data, dtype=dtype, count=count, offset=pos)
    raw = raw.reshape((h, w) if bands == 1 else (h, w, 3))
    if maxval == 255:
        return raw
    if bands == 1 and maxval == 65535:
        return raw.astype(np.int32)
    out_max = 65535 if bands == 1 and maxval > 255 else 255
    scaled = np.minimum(out_max, np.round(raw.astype(np.float64) / maxval * out_max))
    return scaled.astype(np.int32 if out_max == 65535 else np.uint8)


def _tga_bands(head: bytes) -> Optional[int]:
    """1 or 3 for the header of an uncompressed TGA without a colour map,
    gray (type 3, 8 bits) or RGB (type 2, 24 bits), stored left to right;
    None for any other TGA, which PIL reads."""
    if len(head) < 18:
        return None
    cmap, imgtype, depth, flags = head[1], head[2], head[16], head[17]
    w, h = struct.unpack_from("<HH", head, 12)
    if cmap != 0 or flags & 0x10 or w == 0 or h == 0:
        return None
    return {(3, 8): 1, (2, 24): 3}.get((imgtype, depth))


def _decode_tga(data: bytes, path: str) -> np.ndarray:
    """A TGA that `_tga_bands` takes (stored BGR, top down or bottom up),
    as PIL decodes it."""
    bands = _tga_bands(data)
    w, h = struct.unpack_from("<HH", data, 12)
    flags = data[17]
    offset = 18 + data[0]
    count = w * h * bands
    if len(data) < offset + count:
        raise OSError(f"{path}: image file is truncated")
    arr = np.frombuffer(data, np.uint8, count=count, offset=offset)
    arr = arr.reshape((h, w) if bands == 1 else (h, w, 3))
    if bands == 3:
        arr = arr[:, :, ::-1]  # BGR -> RGB
    if not flags & 0x20:  # stored bottom up
        arr = arr[::-1]
    return np.ascontiguousarray(arr)


def luminance_bt601(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luminance, bit-exact with the reference CLI's fixed-point
    conversion."""
    if rgb.ndim != 3 or rgb.shape[2] < 3:
        raise ValueError(f"need (H, W, >=3) RGB, got {rgb.shape}")
    r = rgb[:, :, 0].astype(np.uint32)
    g = rgb[:, :, 1].astype(np.uint32)
    b = rgb[:, :, 2].astype(np.uint32)
    y = (r * 19595 + g * 38470 + b * 7471 + 32768) // 65536
    return y.astype(np.uint8)


def quantize_map(ssim_map: np.ndarray) -> np.ndarray:
    """u8 quantization of an SSIM map: clamp negatives to 0, scale by 255,
    TRUNCATE (not round), as the reference CLI's
    static_cast<uint8_t>(max(0, v) * 255)."""
    return np.minimum(np.maximum(ssim_map, 0.0) * 255.0, 255.0).astype(np.uint8)


def _save_pfm(path: str, data: np.ndarray) -> None:
    """PFM float dump: bottom-up rows, little-endian (scale -1.0)."""
    data = np.asarray(data, dtype="<f4")
    if data.ndim == 2:
        header = b"Pf\n"
        h, w = data.shape
    elif data.ndim == 3 and data.shape[2] == 3:
        header = b"PF\n"
        h, w = data.shape[:2]
    else:
        raise ValueError(f"PFM supports 1 or 3 channels, got shape {data.shape}")
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(data[::-1]).tobytes())


def load_pfm(path: str) -> np.ndarray:
    """Read back a PFM written by `_save_pfm` (or the reference CLI)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"Pf", b"PF"):
            raise ValueError(f"not a PFM file: {magic!r}")
        w, h = (int(v) for v in f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if magic == b"PF" else 1)
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(count * 4), dtype=dtype)
    shape = (h, w, 3) if magic == b"PF" else (h, w)
    return data.reshape(shape)[::-1].copy()


def _save_tga(path: str, gray_or_rgb: np.ndarray) -> None:
    """Minimal uncompressed TGA writer (u8 gray or RGB), top-left origin."""
    arr = np.asarray(gray_or_rgb, dtype=np.uint8)
    if arr.ndim == 2:
        h, w = arr.shape
        imgtype, depth = 3, 8  # grayscale
        payload = arr
    else:
        h, w, c = arr.shape
        if c != 3:
            raise ValueError("TGA writer supports gray or RGB")
        imgtype, depth = 2, 24
        payload = arr[:, :, ::-1]  # BGR
    header = struct.pack(
        "<BBBHHBHHHHBB", 0, 0, imgtype, 0, 0, 0, 0, 0, w, h, depth, 0x20
    )  # 0x20: top-left origin
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(payload).tobytes())


def save_map(path: str, ssim_map: np.ndarray) -> None:
    """Export an SSIM map, format chosen by extension: .pfm = raw float;
    .png / .bmp / .tga = u8 quantized."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        _save_pfm(path, ssim_map)
        return
    q = quantize_map(ssim_map)
    if ext == ".tga":
        _save_tga(path, q)
        return
    if ext in (".png", ".bmp"):
        Image = _pil_image(f"writing a {ext} map")
        if q.ndim == 3 and q.shape[2] == 2:
            img = Image.fromarray(q, mode="LA")  # gray+alpha maps
        else:
            img = Image.fromarray(q)
        img.save(path)
        return
    raise ValueError(f"unsupported map format {ext!r} (png/bmp/tga/pfm)")
