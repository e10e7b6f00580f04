"""The port's directory loader (`ssim_tpu_torch.utils.dataset`) against the
JAX package's (`ssim_tpu.utils.dataset`): every case of
tests/test_dataset.py on the same files, the port's scores with
device="cpu". Decoded arrays and batches must be equal; scores within the
port's tolerance of the JAX XLA path's (tests/torch_port_util.py)."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from torch_port_util import ORACLE_GLOBAL, assert_close

from ssim_tpu import cli as jax_cli
from ssim_tpu.utils import dataset as jax_dataset
from ssim_tpu.utils import luminance_bt601
from ssim_tpu_torch import cli, reference
from ssim_tpu_torch.utils import dataset
from ssim_tpu_torch.utils.dataset import (
    batched_pairs,
    evaluate_directory,
    load_pairs,
    stream_batched_pairs,
)


@pytest.fixture()
def pair_dirs(tmp_path, rng):
    da, db = tmp_path / "a", tmp_path / "b"
    da.mkdir(), db.mkdir()
    shapes = [(40, 56), (40, 56), (40, 56), (64, 48)]
    for i, shape in enumerate(shapes):
        img_a = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        noise = rng.normal(0, 10, img_a.shape).astype(np.int32)
        img_b = np.clip(img_a.astype(np.int32) + noise, 0, 255).astype(np.uint8)
        name = f"img{i}.png"
        Image.fromarray(img_a).save(da / name)
        Image.fromarray(img_b).save(db / name)
    return str(da), str(db), [f"img{i}.png" for i in range(len(shapes))]


def _pairs(da, db, names):
    return [(os.path.join(da, n), os.path.join(db, n)) for n in names]


def _assert_same_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("policy", ["luminance", "channel:0", "channel:1", "channel:2"])
def test_load_pairs_policies(pair_dirs, policy):
    da, db, names = pair_dirs
    pairs = _pairs(da, db, names[:1])
    got = load_pairs(pairs, channel_policy=policy)
    (name, a, b), = got
    assert a.ndim == 2 and a.dtype == np.uint8 and name == "img0.png"
    _assert_same_items(got, jax_dataset.load_pairs(pairs, channel_policy=policy))


def test_load_pairs_bogus_policy(pair_dirs):
    da, db, names = pair_dirs
    pairs = _pairs(da, db, names[:1])
    with pytest.raises(ValueError):
        load_pairs(pairs, channel_policy="bogus")
    with pytest.raises(ValueError):
        jax_dataset.load_pairs(pairs, channel_policy="bogus")


def test_batched_groups_by_shape(pair_dirs):
    da, db, names = pair_dirs
    pairs = _pairs(da, db, names)
    batches = list(batched_pairs(pairs, batch_size=2))
    # 3 images at (40, 56) -> batches of 2 + 1; 1 image at (64, 48) -> 1.
    sizes = sorted(a.shape[0] for _, a, _ in batches)
    assert sizes == [1, 1, 2]
    for _, a, b in batches:
        assert a.shape == b.shape and a.ndim == 3
    _assert_same_items(batches, list(jax_dataset.batched_pairs(pairs, batch_size=2)))


def test_stream_matches_eager(pair_dirs):
    """stream_batched_pairs yields the same batches as batched_pairs (and
    as the JAX stream, in its order), from a generator input and with
    bounded prefetch; a decode failure surfaces as an exception."""
    da, db, names = pair_dirs
    pairs = _pairs(da, db, names)
    eager = {
        tuple(n): (a.copy(), b.copy()) for n, a, b in batched_pairs(pairs, batch_size=2)
    }
    streamed = list(stream_batched_pairs(iter(pairs), batch_size=2, prefetch=1))
    assert {tuple(n) for n, _, _ in streamed} == set(eager)
    for n, a, b in streamed:
        ea, eb = eager[tuple(n)]
        np.testing.assert_array_equal(a, ea)
        np.testing.assert_array_equal(b, eb)
    _assert_same_items(streamed, list(jax_dataset.stream_batched_pairs(
        iter(pairs), batch_size=2, prefetch=1)))

    bad = pairs + [(os.path.join(da, "missing.png"), os.path.join(db, "missing.png"))]
    with pytest.raises(Exception):
        list(stream_batched_pairs(bad, batch_size=2))


@pytest.mark.parametrize("impl", ["auto", "torch", "host", "reference"])
def test_evaluate_directory(pair_dirs, impl):
    """The port's scores within its tolerance of the JAX XLA path's (the
    host backend and the oracle: within 2e-6 of it), sorted by name."""
    da, db, names = pair_dirs
    got = evaluate_directory(da, db, batch_size=2, impl=impl, device="cpu")
    want = jax_dataset.evaluate_directory(da, db, batch_size=2, impl="xla")
    assert [n for n, _ in got] == [n for n, _ in want] == sorted(names)
    base = ORACLE_GLOBAL if impl in ("host", "reference") else 2e-7
    for (name, score), (_, jscore) in zip(got, want):
        img = Image.open(os.path.join(da, name))
        assert_close(score, jscore, img.size[0] * img.size[1], base=base)


def test_evaluate_directory_tga_without_pil(tmp_path, rng, monkeypatch):
    """--dir's file filter is the JAX one letter for letter, so without
    pillow it reads .tga pairs (decoded by the port itself) and skips what
    it does not list; scores equal the oracle's on the luminance."""
    from ssim_tpu_torch.utils.imageio import _save_tga

    da, db = tmp_path / "a", tmp_path / "b"
    da.mkdir(), db.mkdir()
    truths = {}
    for i in range(5):
        a = rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
        b = np.clip(a.astype(np.int32) + rng.integers(-9, 9, a.shape), 0, 255)
        b = b.astype(np.uint8)
        name = f"f{i}.TGA" if i == 4 else f"f{i}.tga"
        _save_tga(str(da / name), a)
        _save_tga(str(db / name), b)
        truths[name] = reference.compute_ssim(luminance_bt601(a), luminance_bt601(b))[0]
    (da / "x.ppm").write_bytes(b"P5\n1 1\n255\n\0")  # not in the filter
    (db / "x.ppm").write_bytes(b"P5\n1 1\n255\n\0")
    want = jax_dataset.evaluate_directory(str(da), str(db), batch_size=2, impl="xla")
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = evaluate_directory(str(da), str(db), batch_size=2, device="cpu")
    assert [n for n, _ in got] == [n for n, _ in want] == sorted(truths)
    for (name, score), (_, jscore) in zip(got, want):
        assert_close(score, jscore, 30 * 44)
        assert_close(score, truths[name], 30 * 44, base=ORACLE_GLOBAL)


def test_stream_bounded_on_heterogeneous_shapes(tmp_path, rng):
    """Every pair a unique resolution: partial groups flush early (bounded
    memory), every pair comes out exactly once, and the batches are the
    JAX stream's, in its order."""
    da, db = tmp_path / "ha", tmp_path / "hb"
    da.mkdir(), db.mkdir()
    n = 12
    pairs = []
    for i in range(n):
        shape = (24 + 2 * i, 30 + 2 * i)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        name = f"u{i}.png"
        Image.fromarray(img).save(da / name)
        Image.fromarray(img).save(db / name)
        pairs.append((str(da / name), str(db / name)))

    out = []
    batch_size = 2
    got = list(stream_batched_pairs(pairs, batch_size=batch_size))
    for names, a, b in got:
        out.extend(names)
        assert a.shape[0] == len(names) <= batch_size
    assert sorted(out) == sorted(f"u{i}.png" for i in range(n))
    assert n > dataset._MAX_BUFFERED_FACTOR * batch_size
    assert dataset._MAX_BUFFERED_FACTOR == jax_dataset._MAX_BUFFERED_FACTOR
    _assert_same_items(got, list(jax_dataset.stream_batched_pairs(
        pairs, batch_size=batch_size)))


def test_channel_policy_out_of_range(tmp_path, rng):
    """channel:N beyond the image's channels errors like the single-pair
    CLI does, on grayscale images too; channel:0 on grayscale is fine."""
    gray = rng.integers(0, 256, (20, 20), dtype=np.uint8)
    p = tmp_path / "gray.png"
    Image.fromarray(gray).save(p)
    for mod in (dataset, jax_dataset):
        with pytest.raises(ValueError, match="channel 2"):
            mod.load_pairs([(str(p), str(p))], channel_policy="channel:2")
    (_, a, _), = load_pairs([(str(p), str(p))], channel_policy="channel:0")
    assert a.ndim == 2
    np.testing.assert_array_equal(a, gray)


@pytest.mark.parametrize("opts", [["-y", "-2"], ["-2"], ["-0", "--batch=3"],
                                  ["--impl=host"]])
def test_cli_dir_matches_jax(pair_dirs, capsys, opts):
    """--dir prints the JAX CLI's lines (-y wins over -#, as in single-pair
    mode), each value within the printed tolerance."""
    da, db, names = pair_dirs
    rc = cli.main(opts + ["--dir", da, db], device="cpu")
    out = capsys.readouterr().out
    jopts = [o if not o.startswith("--impl=") else "--impl=xla" for o in opts]
    jrc = jax_cli.main(jopts + ["--dir", da, db])
    jout = capsys.readouterr().out
    assert rc == jrc == 0
    got = [line.split(":") for line in out.strip().splitlines()]
    want = [line.split(":") for line in jout.strip().splitlines()]
    assert [n for n, _ in got] == [n for n, _ in want] == sorted(names)
    for (_, g), (_, w) in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-4


def test_cli_batch_outside_dir_rejected(pair_dirs, capsys):
    da, db, _ = pair_dirs
    a = os.path.join(da, "img0.png")
    b = os.path.join(db, "img0.png")
    assert cli.main(["--batch=4", a, b], device="cpu") == 1
    err = capsys.readouterr().err
    assert jax_cli.main(["--batch=4", a, b]) == 1
    assert "--batch" in err and err == capsys.readouterr().err
