"""The port's user surface against the JAX package's: the CLI
(`ssim_tpu_torch.cli` against `ssim_tpu.cli`, every case of
tests/test_cli.py), the channel policies (`multichannel`) and image I/O
(`utils.imageio`, with and without pillow).

Both CLIs run in this process on the same files; the port's with
device="cpu", where its default route is the fused kernel's plain twin.
Tolerances: printed values within 1e-4 of the JAX CLI's (both round to
"% 7.4f", so two scores a few 1e-7 apart can print one last digit
apart); channel scores within 2e-6 of the JAX XLA path and of the f64
oracle (tests/torch_port_util.py); maps within 1e-3 per pixel; quantized
maps within one level.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import ORACLE_GLOBAL, ORACLE_PIXEL, assert_close

import ssim_tpu
from ssim_tpu import cli as jax_cli
from ssim_tpu.multichannel import compute_ssim_channels as jax_channels
from ssim_tpu.utils import imageio as jax_io
from ssim_tpu_torch import cli, reference
from ssim_tpu_torch.errors import UnsupportedError
from ssim_tpu_torch.multichannel import compute_ssim_channels
from ssim_tpu_torch.utils import imageio

PRINTED = 1e-4


def _pair(rng, shape, sd=10):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.normal(0, sd, shape).astype(np.int32)
    return a, np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def _write(tmp_path, a, b, stem=""):
    pa, pb = str(tmp_path / f"{stem}a.png"), str(tmp_path / f"{stem}b.png")
    Image.fromarray(a).save(pa)
    Image.fromarray(b).save(pb)
    return pa, pb


@pytest.fixture()
def image_pair(tmp_path, rng):
    a, b = _pair(rng, (48, 64, 3))
    pa, pb = _write(tmp_path, a, b)
    return a, b, pa, pb


@pytest.fixture()
def gray_pair(tmp_path, rng):
    a, b = _pair(rng, (24, 32), sd=12)
    pa, pb = _write(tmp_path, a, b, stem="g")
    return a, b, pa, pb


def run_both(capsys, port_args, jax_args=None):
    """Both CLIs on the same arguments: ((rc, out, err) of the port's,
    (rc, out, err) of the JAX one)."""
    rc = cli.main(list(port_args), device="cpu")
    out = capsys.readouterr()
    jrc = jax_cli.main(list(port_args if jax_args is None else jax_args))
    jout = capsys.readouterr()
    return (rc, out.out, out.err), (jrc, jout.out, jout.err)


def _values(out):
    """Each printed line as (label, value)."""
    rows = []
    for line in out.strip().splitlines():
        label, _, value = line.rpartition(":")
        rows.append((label, float(value)))
    return rows


def assert_same_output(port, jax):
    (rc, out, _), (jrc, jout, _) = port, jax
    assert rc == jrc == 0, (port, jax)
    got, want = _values(out), _values(jout)
    assert [label for label, _ in got] == [label for label, _ in want], (out, jout)
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= PRINTED, (out, jout)
    return got


def test_help(capsys):
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "Usage: ssim-tpu-torch" in out and "-y" in out
    assert "auto/torch/cuda/reference/host" in out


# tests/test_cli.py's output cases, and the port's own implementations; the
# JAX CLI runs the same options with --impl=xla where the port names another
# implementation.
_OUTPUT_CASES = {
    "per_channel": ([], "rgb", 4),
    "single_channel": (["-2"], "rgb", 1),
    "luminance": (["-y"], "rgb", 1),
    "grayscale_channel_and_average": ([], "gray", 2),
    "luminance_gray_falls_back_to_channel_0": (["-y"], "gray", 1),
    "window_flags": (["-0", "--radius=3", "--sigma=2.0", "--k1=0.02", "--k2=0.05"],
                     "rgb", 1),
    "relaxed": (["-y", "--relaxed"], "rgb", 1),
    "downsample": (["--downsample=2"], "rgb", 4),
    "impl_torch": (["--impl=torch"], "rgb", 4),
    "impl_reference": (["--impl=reference", "-1"], "rgb", 1),
    "impl_host": (["--impl=host", "-y"], "rgb", 1),
}


@pytest.mark.parametrize("case", sorted(_OUTPUT_CASES))
def test_cli_output_matches_jax(case, image_pair, gray_pair, capsys):
    opts, kind, nlines = _OUTPUT_CASES[case]
    _, _, pa, pb = image_pair if kind == "rgb" else gray_pair
    jax_opts = [o if not o.startswith("--impl=") else "--impl=xla" for o in opts]
    got = assert_same_output(*run_both(capsys, opts + [pa, pb], jax_opts + [pa, pb]))
    assert len(got) == nlines
    if nlines > 1:
        assert got[0][0] == "Channel 0" and got[-1][0] == "Average  "


def test_multichannel_batched_equals_serial(rng):
    """The batched channel stack equals per-channel serial calls, and the
    JAX package's channel scores. A stack of small images takes the batch
    route (one partial pair per image) and a single image the tile grid,
    so the two sum their f32 pixels in another order: within the port's
    f32 tolerance, 2e-7 (the JAX test allows 1e-8 between its own two)."""
    import ssim_tpu_torch

    a, b = _pair(rng, (32, 40, 3))
    res = compute_ssim_channels(a, b, device="cpu")
    want = jax_channels(a, b, impl="xla")
    serial = [ssim_tpu_torch.compute_ssim(a[:, :, c], b[:, :, c], device="cpu")
              for c in range(3)]
    assert_close(res.per_channel, serial, 32 * 40)
    assert_close(res.per_channel, want.per_channel, 32 * 40)
    assert res.average == pytest.approx(np.mean(res.per_channel), abs=1e-12)


_POLICIES = [dict(), dict(channel=1), dict(luminance=True), dict(channel=0, with_map=True),
             dict(luminance=True, with_map=True), dict(with_map=True)]


@pytest.mark.parametrize("channels,policy", [
    (c, p) for c in (1, 2, 3, 4) for p in _POLICIES if p.get("channel", 0) < c
])
def test_compute_ssim_channels_matches_jax_and_oracle(rng, policy, channels):
    """Every channel policy (per channel, channel=k, luminance and its
    fallback to channel 0 below three channels) against the JAX XLA path
    and the f64 oracle: scores within 2e-6, maps within 1e-3 per pixel."""
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    a, b = _pair(rng, shape)
    got = compute_ssim_channels(a, b, device="cpu", **policy)
    want = jax_channels(a, b, impl="xla", **policy)
    npix = 37 * 53
    assert len(got.per_channel) == len(want.per_channel)
    assert_close(got.per_channel, want.per_channel, npix, got.maps, want.maps,
                 base=ORACLE_GLOBAL, pixel=ORACLE_PIXEL)
    if policy.get("luminance") and channels >= 3:
        planes = [(imageio.luminance_bt601(a), imageio.luminance_bt601(b))]
    elif a.ndim == 2:
        planes = [(a, b)]
    elif policy.get("luminance"):
        planes = [(a[:, :, 0], b[:, :, 0])]
    elif "channel" in policy:
        planes = [(a[:, :, policy["channel"]], b[:, :, policy["channel"]])]
    else:
        planes = [(a[:, :, c], b[:, :, c]) for c in range(channels)]
    for i, (x, y) in enumerate(planes):
        g, m = reference.compute_ssim(x, y, with_map=True)
        assert_close(got.per_channel[i], g, npix,
                     None if got.maps is None else got.maps[i],
                     None if got.maps is None else m,
                     base=ORACLE_GLOBAL, pixel=ORACLE_PIXEL)
    assert got.average == pytest.approx(np.mean(got.per_channel), abs=1e-12)


def test_read_only_images_are_copied(rng):
    """PIL's arrays are read-only: the engine copies one before a CPU
    tensor would share memory that torch assumes writable."""
    from ssim_tpu_torch import engine

    a = rng.integers(0, 256, (8, 9), dtype=np.uint8)
    a.flags.writeable = False
    t = engine._as_tensor(a, torch.device("cpu"))
    t += 1
    assert not np.shares_memory(t.numpy(), a)
    assert int(a[0, 0]) != int(t[0, 0])


def test_luminance_bt601_is_bit_exact(rng):
    rgb = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    rgb[0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [1, 2, 3]]
    np.testing.assert_array_equal(imageio.luminance_bt601(rgb),
                                  jax_io.luminance_bt601(rgb))
    with pytest.raises(ValueError):
        imageio.luminance_bt601(rgb[:, :, :2])


_REJECTIONS = {
    # name: (args, text in the port's stderr, the JAX CLI's rc)
    "no_args": ([], "Usage", 1),
    "channel_out_of_range": (["-3", "{a}", "{b}"], "only", 1),
    "dimension_mismatch": (["{a}", "{c}"], "same dimensions", 1),
    "channel_count_mismatch": (["{a}", "{g}"], "same number of channels", 1),
    "window_flags_bad_value": (["--sigma=abc", "{a}", "{b}"], "Bad --sigma value", 1),
    "window_flags_invalid_param": (["--radius=0", "{a}", "{b}"], "radius", 1),
    "window_flags_reject_ms_radius": (["--ms", "--radius=3", "{a}", "{b}"], "--ms", 1),
    "ms_rejects_map": (["--ms", "{a}", "{b}", "{m}"], "per-pixel map", 1),
    "ms_rejects_downsample": (["--ms", "--downsample", "{a}", "{b}"], "--downsample", 1),
    "bad_downsample": (["--downsample=x", "{a}", "{b}"], "Bad --downsample value", 1),
    "bad_batch": (["--dir", "--batch=0", "{d}", "{d}"], "Bad --batch value", 1),
    "batch_outside_dir": (["--batch=4", "{a}", "{b}"], "--batch", 1),
    "dir_rejects_ms": (["--dir", "--ms", "{d}", "{d}"], "--dir", 1),
    "dir_takes_two": (["--dir", "{d}", "{d}", "{m}"], "exactly two", 1),
    "unknown_option": (["--bogus", "{a}", "{b}"], "Unknown option", 1),
    "missing_file": (["{a}", "{m}"], "", 1),
    "unsupported_map_format": (["{a}", "{b}", "{x}"], "unsupported map format", 1),
    # The JAX implementation names are unknown to the port.
    "impl_xla": (["--impl=xla", "{a}", "{b}"], "unknown implementation 'xla'", 0),
    "impl_pallas": (["--impl=pallas", "{a}", "{b}"], "unknown implementation", 0),
    "impl_host_custom_window": (["--impl=host", "--sigma=2.0", "{a}", "{b}"],
                                "impl='host'", 1),
    "impl_host_downsample": (["--impl=host", "--downsample=2", "{a}", "{b}"],
                             "impl='host'", 1),
}


@pytest.mark.parametrize("case", sorted(_REJECTIONS))
def test_cli_rejections_match_jax(case, tmp_path, rng, capsys):
    """Each rejection exits 1 with its message, as the JAX CLI does (the
    JAX CLI runs the JAX implementation names)."""
    a, b = _pair(rng, (20, 24, 3))
    pa, pb = _write(tmp_path, a, b)
    c = rng.integers(0, 256, (20, 25, 3), dtype=np.uint8)
    g = rng.integers(0, 256, (20, 24), dtype=np.uint8)
    Image.fromarray(c).save(tmp_path / "c.png")
    Image.fromarray(g).save(tmp_path / "g.png")
    names = dict(a=pa, b=pb, c=str(tmp_path / "c.png"), g=str(tmp_path / "g.png"),
                 d=str(tmp_path), m=str(tmp_path / "missing.pfm"),
                 x=str(tmp_path / "map.xyz"))
    args, text, jax_rc = _REJECTIONS[case]
    args = [s.format(**names) for s in args]
    (rc, out, err), (jrc, _, jerr) = run_both(capsys, args)
    assert rc == 1 and jrc == jax_rc, (err, jerr)
    assert text in err
    if jax_rc == 1:
        if case != "unsupported_map_format":  # fails after printing the scores
            assert out == ""
        if not case.startswith(("impl_host", "missing", "no_args")):
            assert err == jerr


@pytest.mark.parametrize("ext", ["pfm", "tga", "png", "bmp"])
@pytest.mark.parametrize("opts", [["-y"], []], ids=["luminance", "per_channel"])
def test_map_export_matches_jax(image_pair, tmp_path, capsys, ext, opts):
    """Map export (tests/test_cli.py's PFM and interleaved PNG cases, and
    TGA / BMP): the PFM within 1e-3 per pixel of the JAX CLI's and of the
    oracle's map, the u8 maps within one level; the same shape, one plane
    per channel, interleaved."""
    a, b, pa, pb = image_pair
    mp, mj = str(tmp_path / f"map.{ext}"), str(tmp_path / f"map_jax.{ext}")
    assert_same_output(*run_both(capsys, opts + [pa, pb, mp],
                                 opts + ["--impl=xla", pa, pb, mj]))
    want_shape = (48, 64) if opts else (48, 64, 3)
    if ext == "pfm":
        got, want = imageio.load_pfm(mp), jax_io.load_pfm(mj)
        assert got.shape == want.shape == want_shape
        assert np.abs(got - want).max() <= ORACLE_PIXEL
        if opts:
            _, m = reference.compute_ssim(imageio.luminance_bt601(a),
                                          imageio.luminance_bt601(b), with_map=True)
            assert np.abs(got - m).max() <= ORACLE_PIXEL
        return
    got = np.asarray(Image.open(mp)).astype(np.int32)
    want = np.asarray(Image.open(mj)).astype(np.int32)
    assert got.shape == want.shape == want_shape
    assert np.abs(got - want).max() <= 1


def test_luminance_map_is_quantized_luminance_map(image_pair, tmp_path, capsys):
    """-y maps the luminance plane, which is the JAX package's byte for
    byte: the exported TGA is quantize_map of the PFM's map."""
    _, _, pa, pb = image_pair
    assert cli.main(["-y", pa, pb, str(tmp_path / "m.pfm")], device="cpu") == 0
    assert cli.main(["-y", pa, pb, str(tmp_path / "m.tga")], device="cpu") == 0
    capsys.readouterr()
    m = imageio.load_pfm(str(tmp_path / "m.pfm"))
    q = imageio.load_image(str(tmp_path / "m.tga"))
    np.testing.assert_array_equal(q, imageio.quantize_map(m))


def test_quantize_map_truncates_like_reference():
    """u8 map export truncates (static_cast), never rounds."""
    m = np.array([-0.5, 0.0, 0.00392, 0.0039215, 0.9999, 1.0], np.float32)
    q = imageio.quantize_map(m)
    np.testing.assert_array_equal(q, [0, 0, 0, 0, 254, 255])
    np.testing.assert_array_equal(q, jax_io.quantize_map(m))


def test_pfm_and_tga_writers_match_jax(rng, tmp_path):
    """The writers are the JAX package's byte for byte, and load_pfm reads
    both layouts back."""
    for data in (rng.random((9, 13)).astype(np.float32),
                 rng.random((9, 13, 3)).astype(np.float32)):
        imageio._save_pfm(str(tmp_path / "p.pfm"), data)
        jax_io._save_pfm(str(tmp_path / "j.pfm"), data)
        assert (tmp_path / "p.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
        np.testing.assert_array_equal(imageio.load_pfm(str(tmp_path / "p.pfm")), data)
    for data in (rng.integers(0, 256, (9, 13), dtype=np.uint8),
                 rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)):
        imageio._save_tga(str(tmp_path / "p.tga"), data)
        jax_io._save_tga(str(tmp_path / "j.tga"), data)
        assert (tmp_path / "p.tga").read_bytes() == (tmp_path / "j.tga").read_bytes()


def test_pnm_image_loading(tmp_path, rng):
    """Binary PNM (P5 / P6) loads, as it does through stb_image."""
    gray = rng.integers(0, 256, (12, 16), dtype=np.uint8)
    rgbi = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    p5 = tmp_path / "g.pgm"
    p5.write_bytes(b"P5\n16 12\n255\n" + gray.tobytes())
    p6 = tmp_path / "c.ppm"
    p6.write_bytes(b"P6\n16 12\n255\n" + rgbi.tobytes())
    np.testing.assert_array_equal(imageio.load_image(str(p5)), gray)
    np.testing.assert_array_equal(imageio.load_image(str(p6)), rgbi)


def _pnm(magic, w, h, maxval, values, comment=False):
    header = magic + b"\n" + (b"# a comment\n" if comment else b"")
    header += f"{w} {h}\n".encode() + (b"# depth\n" if comment else b"")
    header += f"{maxval}\n".encode()
    dtype = np.uint8 if maxval < 256 else ">u2"
    return header + np.asarray(values).astype(dtype).tobytes()


def _tga(imgtype, depth, flags, pixels, id_field=b""):
    import struct

    h, w = pixels.shape[:2]
    header = struct.pack("<BBBHHBHHHHBB", len(id_field), 0, imgtype, 0, 0, 0, 0, 0,
                         w, h, depth, flags)
    return header + id_field + np.ascontiguousarray(pixels).tobytes()


def _reader_cases(rng):
    h, w = 11, 14
    g8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
    c8 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return {
        "p5_255.pgm": _pnm(b"P5", w, h, 255, g8),
        "p5_100_comments.pgm": _pnm(b"P5", w, h, 100, g8 % 101, comment=True),
        "p5_1.pgm": _pnm(b"P5", w, h, 1, g8 % 2),
        "p5_1000.pgm": _pnm(b"P5", w, h, 1000, rng.integers(0, 1001, (h, w))),
        "p5_65535.pgm": _pnm(b"P5", w, h, 65535, rng.integers(0, 65536, (h, w))),
        "p5_300_small_values.pgm": _pnm(b"P5", w, h, 300, rng.integers(0, 2, (h, w))),
        "p6_255.ppm": _pnm(b"P6", w, h, 255, c8),
        "p6_200.ppm": _pnm(b"P6", w, h, 200, c8 % 201),
        "p6_1000.ppm": _pnm(b"P6", w, h, 1000, rng.integers(0, 1001, (h, w, 3))),
        "p6_65535.ppm": _pnm(b"P6", w, h, 65535, rng.integers(0, 65536, (h, w, 3))),
        "gray_top.tga": _tga(3, 8, 0x20, g8),
        "gray_bottom.tga": _tga(3, 8, 0x00, g8),
        "rgb_top.tga": _tga(2, 24, 0x20, c8),
        "rgb_bottom_id.tga": _tga(2, 24, 0x00, c8, id_field=b"ssim"),
        "rgb_pil.tga": None,  # written by PIL
    }


def test_reader_without_pil_equals_pil(tmp_path, rng, monkeypatch):
    """With PIL hidden, load_image decodes PGM / PPM (every maxval) and
    uncompressed gray and RGB TGA (top down, bottom up, with an ID field,
    and as PIL writes it) to the arrays the JAX load_image returns through
    PIL."""
    cases = _reader_cases(rng)
    want = {}
    for name, data in cases.items():
        if data is None:
            Image.fromarray(rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)).save(
                tmp_path / name)
        else:
            (tmp_path / name).write_bytes(data)
        for channels in (None, 1, 3):
            want[name, channels] = jax_io.load_image(str(tmp_path / name), channels)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        from PIL import Image as _  # noqa: F401
    for name, channels in want:
        got = imageio.load_image(str(tmp_path / name), channels)
        assert got.dtype == want[name, channels].dtype == np.uint8, name
        np.testing.assert_array_equal(got, want[name, channels], err_msg=name)


def test_reader_decodes_pnm_and_tga_itself_where_pil_imports(tmp_path, rng,
                                                             monkeypatch):
    """With pillow installed, binary PGM / PPM and uncompressed gray / RGB
    TGA are still decoded by the port (PIL's open made to raise), to the
    JAX load_image's arrays; a PNG, a JPEG and an RLE TGA go to PIL and
    give the JAX arrays too."""
    cases = _reader_cases(rng)
    img = rng.integers(0, 256, (16, 12, 3), dtype=np.uint8)
    to_pil = {"x.png": {}, "x.jpg": {}, "rle.tga": {"compression": "tga_rle"}}
    for name, data in cases.items():
        if data is None:
            Image.fromarray(img).save(tmp_path / name)
        else:
            (tmp_path / name).write_bytes(data)
    for name, options in to_pil.items():
        Image.fromarray(img).save(tmp_path / name, **options)
    want = {name: jax_io.load_image(str(tmp_path / name)) for name in {**cases, **to_pil}}
    opened = []
    real_open = Image.open

    def spy_open(path, *args, **kw):
        opened.append(os.path.basename(str(path)))
        return real_open(path, *args, **kw)

    monkeypatch.setattr(Image, "open", spy_open)
    for name in {**cases, **to_pil}:
        got = imageio.load_image(str(tmp_path / name))
        assert got.dtype == np.uint8, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert sorted(opened) == sorted(to_pil)


def test_reader_without_pil_rejects_what_it_cannot_read(tmp_path, rng, monkeypatch):
    """Without PIL a JPEG, a PNG, an RLE, RGBA or right-to-left TGA and a
    truncated file raise, the unsupported ones with an error naming
    pillow; .png / .bmp maps cannot be written, .pfm / .tga maps can."""
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "x.jpg")
    Image.fromarray(img).save(tmp_path / "x.png")
    (tmp_path / "rle.tga").write_bytes(_tga(10, 24, 0x20, img))
    (tmp_path / "rgba.tga").write_bytes(_tga(2, 32, 0x20, np.dstack([img, img[:, :, :1]])))
    (tmp_path / "rtl.tga").write_bytes(_tga(2, 24, 0x30, img))
    (tmp_path / "short.ppm").write_bytes(_pnm(b"P6", 16, 16, 255, img)[:-5])
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name in ("x.jpg", "x.png", "rle.tga", "rgba.tga", "rtl.tga"):
        with pytest.raises(UnsupportedError, match="pillow"):
            imageio.load_image(str(tmp_path / name))
    with pytest.raises(OSError, match="truncated"):
        imageio.load_image(str(tmp_path / "short.ppm"))
    m = rng.random((16, 16)).astype(np.float32)
    for ext in ("png", "bmp"):
        with pytest.raises(UnsupportedError, match="pillow"):
            imageio.save_map(str(tmp_path / f"m.{ext}"), m)
    imageio.save_map(str(tmp_path / "m.pfm"), m)
    imageio.save_map(str(tmp_path / "m.tga"), m)
    np.testing.assert_array_equal(imageio.load_pfm(str(tmp_path / "m.pfm")), m)
    np.testing.assert_array_equal(imageio.load_image(str(tmp_path / "m.tga")),
                                  imageio.quantize_map(m))


def test_cli_without_pil_matches_jax(tmp_path, rng, capsys, monkeypatch):
    """The port's CLI with PIL hidden, on PPM inputs with a TGA map, prints
    what the JAX CLI prints through PIL, and writes the same map."""
    a, b = _pair(rng, (40, 56, 3))
    pa, pb = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    (tmp_path / "a.ppm").write_bytes(_pnm(b"P6", 56, 40, 255, a))
    (tmp_path / "b.ppm").write_bytes(_pnm(b"P6", 56, 40, 255, b))
    jax = jax_cli.main(["--impl=xla", pa, pb, str(tmp_path / "j.tga")])
    jout = capsys.readouterr()
    monkeypatch.setitem(sys.modules, "PIL", None)
    rc = cli.main([pa, pb, str(tmp_path / "p.tga")], device="cpu")
    out = capsys.readouterr()
    assert_same_output((rc, out.out, out.err), (jax, jout.out, jout.err))
    got = imageio.load_image(str(tmp_path / "p.tga")).astype(np.int32)
    want = imageio.load_image(str(tmp_path / "j.tga")).astype(np.int32)
    assert got.shape == (40, 56, 3) and np.abs(got - want).max() <= 1


def test_cli_relaxed_ms(tmp_path, rng, capsys):
    """--relaxed combines with --ms; 176 x 200 is the smallest image with
    five scales (11 * 2^4 rows). Both CLIs within the printed tolerance,
    and within 1e-3 of the standard MS-SSIM (the JAX test's bound)."""
    a = rng.integers(0, 256, (176, 200), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-10, 10, a.shape),
                0, 255).astype(np.uint8)
    pa, pb = _write(tmp_path, a, b)
    for opts in (["--ms"], ["--relaxed", "--ms"], ["--ms", "-y", "--sigma=1.2"]):
        got = assert_same_output(*run_both(capsys, opts + [pa, pb]))
        want = ssim_tpu.compute_ms_ssim(a, b, impl="xla")
        if "--sigma=1.2" not in opts:
            assert got[0][1] == pytest.approx(want, abs=1e-3)


def test_cli_dir_mode(tmp_path, rng, capsys):
    """--dir batch-evaluates two directories of same-named images, one
    'name: score' line per pair, as the JAX CLI does; option conflicts and
    empty intersections are rejected."""
    da, db = tmp_path / "a", tmp_path / "b"
    da.mkdir(), db.mkdir()
    truths = {}
    for i in range(3):
        img_a, img_b = _pair(rng, (40, 56, 3), sd=7)
        name = f"img{i}.png"
        Image.fromarray(img_a).save(da / name)
        Image.fromarray(img_b).save(db / name)
        truths[name] = reference.compute_ssim(jax_io.luminance_bt601(img_a),
                                              jax_io.luminance_bt601(img_b))[0]
    got = assert_same_output(*run_both(capsys, ["--dir", "--batch=2", str(da), str(db)]))
    assert [name for name, _ in got] == sorted(truths)
    for name, score in got:
        assert score == pytest.approx(truths[name], abs=PRINTED)

    (rc, _, err), (jrc, _, jerr) = run_both(capsys, ["--dir", "--ms", str(da), str(db)])
    assert rc == jrc == 1 and "--dir" in err and err == jerr
    empty = tmp_path / "empty"
    empty.mkdir()
    (rc, _, err), (jrc, _, jerr) = run_both(capsys, ["--dir", str(da), str(empty)])
    assert rc == jrc == 1 and "no same-named" in err and err == jerr


def test_default_impl_without_gpu_exits_1(image_pair, tmp_path, capsys):
    """With no GPU the default implementation prints the engine's
    UnsupportedError and exits 1 (single pair, --ms and --dir); only
    --impl=host and --impl=reference run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    _, _, pa, pb = image_pair
    big = np.full((176, 200), 128, np.uint8)
    pm, _ = _write(tmp_path, big, big, stem="ms")
    for args in ([pa, pb], ["--ms", pm, pm], ["--impl=torch", pa, pb],
                 ["--dir", str(tmp_path), str(tmp_path)]):
        assert cli.main(args) == 1
        captured = capsys.readouterr()
        assert captured.out == ""
        assert 'no GPU is available; pass device="cpu"' in captured.err
    for impl in ("host", "reference"):
        assert cli.main([f"--impl={impl}", pa, pb]) == 0
        assert len(capsys.readouterr().out.splitlines()) == 4


def test_module_runs_as_a_script(image_pair):
    """`python -m ssim_tpu_torch.cli` exits with main's code (here the
    reference implementation, which needs no GPU)."""
    import subprocess

    _, _, pa, pb = image_pair
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "ssim_tpu_torch.cli", "--impl=reference", "-y", pa, pb],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == 1 and 0.9 < float(out.stdout) <= 1.0
