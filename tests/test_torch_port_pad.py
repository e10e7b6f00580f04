"""The port's edge-pad-and-align op against the JAX package's, on the same
NumPy inputs.

`ssim_tpu_torch.ops.pad.pad_align` on a CPU tensor runs the kernel's
plain twin; the JAX package's `pad_align_pallas` (K4) runs in interpret
mode at the layouts its DMA kernel takes, and `pad_align_xla`
(`jnp.pad(mode="edge")`) and `np.pad(mode="edge")` stand for it at the
others. tests/test_torch_port_cuda.py holds the kernel against the twin on
a card.

Every comparison is exact and on raw bytes, so NaN payloads, -0.0 and
+-inf count: the op moves bits and computes nothing.
"""

import numpy as np
import pytest
import torch

from ssim_tpu.ops.pad import pad_align_pallas, pad_align_xla

from ssim_tpu_torch.ops import pad as port_pad
from ssim_tpu_torch.ops.pad import COL_OFF, ROW_OFF, pad_align, pad_align_cuda


def _truth(x, hp, wp):
    return np.pad(
        x,
        ((0, 0), (ROW_OFF, hp - x.shape[1] - ROW_OFF),
         (COL_OFF, wp - x.shape[2] - COL_OFF)),
        mode="edge",
    )


def _port(x, hp, wp):
    return pad_align(torch.from_numpy(x), hp, wp).numpy()


def _same_bytes(got, want):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _jax_pallas(x, hp, wp):
    return np.asarray(pad_align_pallas(x, hp=hp, wp=wp, interpret=True))


def _specials(x):
    """Plant NaN (quiet, and one with a payload), -0.0 and +-inf at the
    image's corners and edges, where the pad replicates them."""
    bsz, h, w = x.shape
    payload = np.array([0x7FC0ABCD], dtype=np.uint32).view(np.float32)[0]
    x[:, 0, 0] = np.nan
    x[:, 0, w - 1] = -0.0
    x[:, h - 1, 0] = np.inf
    x[:, h - 1, w - 1] = payload
    x[:, h // 2, 0] = -np.inf
    x[:, 0, w // 2] = -0.0
    x[:, h // 2, w - 1] = np.nan
    x[:, h - 1, w // 3] = payload
    return x


@pytest.mark.parametrize(
    "shape,hp,wp",
    [
        ((2, 64, 128), 96, 384),
        ((1, 1080, 1920), 1120, 2176),
        ((3, 40, 256), 96, 512),
        ((1, 88, 128), 96, 384),
        ((1, 32, 128), 96, 384),
    ],
)
def test_u8_matches_pallas(shape, hp, wp):
    """The geometries of tests/test_pad.py::test_pad_pallas_matches_jnp."""
    x = np.random.default_rng(0x9A).integers(0, 256, shape, dtype=np.uint8)
    got = _port(x, hp, wp)
    _same_bytes(got, _jax_pallas(x, hp, wp))
    _same_bytes(got, _truth(x, hp, wp))


@pytest.mark.parametrize("seed", range(8))
def test_u8_fuzz_matches_pallas(seed):
    """The eight geometries of tests/test_pad.py::test_pad_fuzz."""
    r = np.random.default_rng(500 + seed)
    h = int(r.integers(4, 40)) * 8
    w = int(r.integers(1, 18)) * 128
    if h < 32:
        h = 32
    hp = ((h + ROW_OFF + 31) // 32 + int(r.integers(0, 3))) * 32
    wp = ((w + COL_OFF + 5 + 127) // 128 + int(r.integers(0, 3))) * 128
    x = r.integers(0, 256, (2, h, w), dtype=np.uint8)
    _same_bytes(_port(x, hp, wp), _jax_pallas(x, hp, wp))


@pytest.mark.parametrize("shape,hp,wp", [((2, 64, 128), 96, 384),
                                         ((1, 40, 256), 64, 512)])
def test_f32_specials_match_pallas(shape, hp, wp):
    rng = np.random.default_rng(0x9B)
    x = _specials(rng.standard_normal(shape).astype(np.float32))
    got = _port(x, hp, wp)
    _same_bytes(got, _jax_pallas(x, hp, wp))
    _same_bytes(got, _truth(x, hp, wp))
    assert np.isnan(got).any() and np.signbit(got[got == 0]).any()


@pytest.mark.parametrize("shape,hp,wp", [((2, 32, 128), 64, 384),
                                         ((1, 48, 384), 64, 640)])
def test_u16_matches_pallas(shape, hp, wp):
    x = np.random.default_rng(0x9C).integers(0, 65536, shape, dtype=np.uint16)
    _same_bytes(_port(x, hp, wp), _jax_pallas(x, hp, wp))


@pytest.mark.parametrize(
    "shape,hp,wp",
    [
        ((1, 37, 200), 96, 512),  # tests/test_pad.py::test_pad_dispatch_fallback
        ((2, 1, 300), 9, 450),  # H = 1
        ((2, 20, 1), 40, 129),  # W = 1
        ((1, 24, 77), 50, 77 + COL_OFF),  # wp = W + COL_OFF exactly
        ((3, 13, 130), 13 + ROW_OFF, 300),  # hp = H + ROW_OFF exactly
    ],
)
def test_unaligned_layouts_match_xla(shape, hp, wp):
    """Layouts the JAX DMA kernel does not take: its dispatch sends them to
    pad_align_xla; the port's one kernel serves them all."""
    x = np.random.default_rng(0x9D).integers(0, 256, shape, dtype=np.uint8)
    got = _port(x, hp, wp)
    _same_bytes(got, np.asarray(pad_align_xla(x, hp, wp)))
    _same_bytes(got, _truth(x, hp, wp))


def test_f64_matches_numpy():
    """JAX casts f64 to f32 here; the port keeps f64, so np.pad is the
    reference."""
    x = _specials(np.random.default_rng(0x9E).standard_normal((2, 19, 45)))
    x[0, 5, 5] = np.finfo(np.float64).tiny / 4  # a subnormal
    got = _port(x, 40, 200)
    assert got.dtype == np.float64
    _same_bytes(got, _truth(x, 40, 200))


def test_non_contiguous_input():
    x = np.random.default_rng(0x9F).integers(0, 256, (2, 30, 20), dtype=np.uint8)
    xt = torch.from_numpy(x).transpose(1, 2)
    assert not xt.is_contiguous()
    _same_bytes(pad_align(xt, 40, 200).numpy(),
                _truth(np.ascontiguousarray(x.transpose(0, 2, 1)), 40, 200))


@pytest.mark.parametrize(
    "shape,hp,wp,what",
    [
        ((1, 37, 200), 37 + ROW_OFF - 1, 512, "does not fit"),
        ((1, 37, 200), 96, 200 + COL_OFF - 1, "does not fit"),
        ((37, 200), 96, 512, "non-empty"),
        ((1, 0, 200), 96, 512, "non-empty"),
    ],
)
def test_rejects(shape, hp, wp, what):
    x = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match=what):
        pad_align(x, hp, wp)


def test_cpu_tensor_launches_nothing():
    """A CPU tensor runs the twin; the kernel's wrapper refuses it."""
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    before = port_pad.PAD_LAUNCHES
    pad_align(x, 16, 136)
    assert port_pad.PAD_LAUNCHES == before == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        pad_align_cuda(x, hp=16, wp=136)
    assert port_pad.PAD_LAUNCHES == 0
