"""The backward kernel's relaxed streaming kernels (csrc/bwd_relaxed_stream.cuh:
ssim_bwd_relaxed_stream_kernel, radius 5 compiled in, and
ssim_bwd_relaxed_rt_kernel, the other radii read at run time), as far as
the CPU can
hold it: the radii and strips it serves (ops.ssim_grad.relaxed_strip_w),
what the wrapper passes the C entry and counts (a stand-in library), the
segment it picks, and the kernel's own source built for the host by g++
(tests/fwd_stream_emu: one std::thread per CUDA thread, std::barrier for
__syncthreads and __syncwarp, host models of mma.sync, ldmatrix and
stmatrix) against the relaxed twin, ssim_grad_plain(relaxed=True), within
the card tests' tolerance, NaN tiles exactly. The kernel itself runs only
on a card: tests/test_torch_port_cuda.py holds it there
(test_relaxed_backward_*). The twin is held against the JAX package's
relaxed gradient in tests/test_torch_port_relaxed.py.
"""

import contextlib
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from test_torch_port_fwd_stream import _host_shared

from ssim_tpu_torch.ops import _build, ssim_grad
from ssim_tpu_torch.windows import RADIUS, gaussian_taps

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fwd_stream_emu")

#: The card tests' tolerances: kernel against its relaxed twin
#: (ssim_grad.RELAXED_GRAD_TWIN; per entry also kappa times the twin's
#: sensitivity to its bf16x3 split, ssim_grad.relaxed_grad_holds), and the
#: relaxed gradient against the standard one (chip_smoke.py
#: RELAXED_GRAD_STD), each times max|g|.
_GRAD_TWIN, _GRAD_STD = ssim_grad.RELAXED_GRAD_TWIN, 1e-3


def test_relaxed_stream_applies_at_radius_5_only():
    """The relaxed backward's stream rule, once radius 5's alone, now its
    one design: every radius the fused kernel serves (1-16; radius 5,
    windows.RADIUS, compiled in, the others read at run time) takes the
    64-wide NaN tile (default_tile) and a strip from the measured table
    (relaxed_strip_w): 128 columns at radii 1-5 and 12-15, one 64-column
    NaN tile at 6-11 and 16, the H100 sweep's choice; radius 0 and 17 are
    not served."""
    assert RADIUS == 5
    assert ssim_grad.default_tile(RADIUS) == (ssim_grad.TILE_H, ssim_grad.TILE_W)
    assert sorted(ssim_grad.RELAXED_STRIP_W) == list(range(1, 17))
    for radius in range(0, 18):
        served = 1 <= radius <= 16
        assert ssim_grad.grad_cuda_supported(64, 1920, radius) == served
        if served:
            assert ssim_grad.default_tile(radius)[1] == ssim_grad.TILE_W
            want_w = 128 if radius <= 5 or 12 <= radius <= 15 else 64
            assert ssim_grad.relaxed_strip_w(radius) == want_w
            assert want_w % ssim_grad.default_tile(radius)[1] == 0
    assert ssim_grad.relaxed_strip_w(RADIUS) == ssim_grad.STRIP_W


class _FakeLib:
    """A stand-in for the kernels' library: records ssim_bwd_launch's
    arguments and succeeds."""

    def __init__(self):
        self.calls = []

    def ssim_bwd_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """_launch on CPU tensors against _FakeLib, the card's occupancy and
    streams stubbed: 2 relaxed (4 standard) streaming blocks on each of
    an H100's 132 SMs."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ssim_grad, "_resident",
                        lambda index, radius, gmap, relaxed=False, strip_w=128:
                        132 * (2 if relaxed else 4))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("radius", [4, 5, 16])
@pytest.mark.parametrize("relaxed", [False, True])
def test_launch_routes_and_counts(fake_launch, radius, relaxed):
    """What the wrapper hands the C entry, and what it counts, per launch:
    a relaxed launch at every radius passes a segment (stream_segment's,
    at the relaxed occupancy and relaxed_strip_w's strip) and its strip,
    and adds one to RELAXED_LAUNCHES; a
    standard launch passes the standard occupancy's segment and the
    128-column strip and adds to LAUNCHES only. A pinned segment reaches
    the entry as it is."""
    bsz, h, w = 4, 1080, 1920
    a = torch.zeros((bsz, h, w))
    taps = gaussian_taps(np.float32, radius, 1.5)
    kw = dict(taps=taps, c1=1e-4, c2=9e-4, clip_bound=131072.0, relaxed=relaxed)
    before = (ssim_grad.LAUNCHES, ssim_grad.RELAXED_LAUNCHES, ssim_grad.VHALO_LAUNCHES)
    ssim_grad._launch(a, a, torch.ones(bsz), torch.zeros(bsz), None, **kw)
    ssim_grad._launch(a, a, torch.ones(bsz), torch.zeros(bsz), None, segment=64, **kw)
    after = (ssim_grad.LAUNCHES, ssim_grad.RELAXED_LAUNCHES, ssim_grad.VHALO_LAUNCHES)
    want = (0 if relaxed else 2, 2 if relaxed else 0, 0)
    assert tuple(x - y for x, y in zip(after, before)) == want
    (first, pinned) = fake_launch.calls
    assert first[0] == int(relaxed) and pinned[0] == int(relaxed)
    tile_h, tile_w = ssim_grad.default_tile(radius)
    assert first[17:20] == (radius, tile_h, tile_w)
    seg, strip = first[20], first[21]
    assert strip == pinned[21] == (ssim_grad.relaxed_strip_w(radius) if relaxed else 128)
    resident = 132 * (2 if relaxed else 4)
    assert seg == ssim_grad.stream_segment(bsz, h, w, radius, resident, strip)
    assert seg % tile_h == 0 and pinned[20] == 64


def test_launch_rejects_a_segment_off_the_tiles(fake_launch):
    """The relaxed streaming launch takes whole NaN tiles, 1 to
    MAX_SEG_TILES of them, as the standard one."""
    a = torch.zeros((1, 600, 600))
    kw = dict(taps=gaussian_taps(np.float32, 5, 1.5), c1=1e-4, c2=9e-4,
              clip_bound=131072.0, relaxed=True)
    for seg in (48, 16, 32 * (ssim_grad.MAX_SEG_TILES + 1)):
        with pytest.raises(ValueError):
            ssim_grad._launch(a, a, torch.ones(1), torch.zeros(1), None, segment=seg, **kw)
    assert not fake_launch.calls


#: Relaxed streaming blocks an H100 holds at once: 2 per SM (~108 KB of
#: shared memory a block) on each of its 132 SMs.
H100_RELAXED_RESIDENT = 132 * 2


@pytest.mark.parametrize("shape,fill", [((4, 1080, 1920), 0.95), ((4, 2160, 3840), 0.9),
                                        ((1, 8640, 15360), 0.95), ((4, 540, 960), 0.7)])
def test_relaxed_segment_fills_the_card(shape, fill):
    """The segment the relaxed launches get at the H100's relaxed
    occupancy (the shared model with its 4r-row prologue): whole NaN
    tiles, 1 to MAX_SEG_TILES of them, ending less than a tile past the
    image, and blocks that fill the slots of the waves they take (a last
    wave of a twentieth runs beside the others): at least 90-95% at the
    main-path shapes, 70% at MS-SSIM's scale 1 (192 blocks, one wave, at
    3 tiles a segment)."""
    bsz, h, w = shape
    seg = ssim_grad.stream_segment(bsz, h, w, 5, H100_RELAXED_RESIDENT)
    tile_h = ssim_grad.TILE_H
    assert seg % tile_h == 0 and tile_h <= seg <= ssim_grad.MAX_SEG_TILES * tile_h
    assert seg < h + tile_h
    blocks = bsz * -(-h // seg) * -(-w // ssim_grad.STRIP_W)
    full, rest = divmod(blocks, H100_RELAXED_RESIDENT)
    waves = full + (rest > H100_RELAXED_RESIDENT / 20 or full == 0)
    assert blocks / (waves * H100_RELAXED_RESIDENT) >= fill, (shape, seg)


#: The kernels' dynamic shared memory, as each declares it, and the
#: harness's stand-in (emu_threads.h emu_dynamic_shared: the arena's
#: dynamic part, NaN at each block's start).
_REL_DYN = ("extern __shared__ __align__(16) unsigned char rel_smem[];",
            "unsigned char* rel_smem = emu_dynamic_shared();")
_STD_DYN = ("extern __shared__ float4 stream_smem[];",
            "float4* stream_smem = reinterpret_cast<float4*>(emu_dynamic_shared());")
_RT_DYN = ("extern __shared__ float4 bwd_rt_smem[];",
           "float4* bwd_rt_smem = reinterpret_cast<float4*>(emu_dynamic_shared());")


def _build_bwd_emulator(out, harness="bwd_harness.cpp", edit=None, flags=()):
    """Build a backward harness into directory `out`: bwd_harness.cpp (the
    relaxed stream) or bwd_std_harness.cpp (the standard tier's streams,
    the one-pass ssim_bwd_stream_kernel and the two-pass one). The kernels'
    source is copied there first: csrc/bwd_common.cuh,
    csrc/bwd_relaxed_stream.cuh, csrc/bwd_std_stream.cuh and
    csrc/bwd_std_rt.cuh, each without its host code, and the relaxed
    kernels' body, csrc/bwd_relaxed_stream_body.cuh, each __shared__ array
    a piece of the harness's arena (NaN at each block's start, as CUDA
    leaves shared memory uninitialised); edit(name, text) may change each
    text first, flags are added to g++'s command line
    (tests/test_torch_port_racecheck.py: -fsanitize=thread). Its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    edit = edit or (lambda name, text: text)
    for name, host, dyn in (
            ("bwd_common.cuh", "// Host code from here", None),
            ("bwd_relaxed_stream.cuh", "// Launchers from here", None),
            ("bwd_relaxed_stream_body.cuh", None, _REL_DYN),
            ("bwd_std_stream.cuh", "// Launchers from here", _STD_DYN),
            ("bwd_std_rt.cuh", "// Launchers from here", _RT_DYN)):
        src = open(os.path.join(_build.CSRC_DIR, name)).read()
        body = src[:src.index(host)] + "}  // namespace\n" if host else src
        if dyn:
            assert body.count(dyn[0]) >= 1
            body = body.replace(dyn[0], dyn[1])
        (out / name).write_text(_host_shared(edit(name, body)))
    exe = out / harness.replace(".cpp", "")
    # band_mma.cuh: the emulator's (host models of mma, ldmatrix and
    # stmatrix), which includes the kernels' own from csrc, next on the path.
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
                    "-pthread", "-I", str(out), "-I", EMU_DIR, "-I", _build.CSRC_DIR,
                    *flags, "-o", str(exe), os.path.join(EMU_DIR, harness)],
                   check=True, capture_output=True, timeout=600)
    return exe


@pytest.fixture(scope="module")
def bwd_emulator(tmp_path_factory):
    """The relaxed streaming kernels' source built for the host
    (_build_bwd_emulator); its path."""
    return _build_bwd_emulator(tmp_path_factory.mktemp("bwd_stream_emu"))


@pytest.fixture(scope="module")
def bwd_std_emulator(tmp_path_factory):
    """The standard tier's streaming kernel's source built for the host
    (_build_bwd_emulator, bwd_std_harness.cpp); its path."""
    return _build_bwd_emulator(tmp_path_factory.mktemp("bwd_std_emu"), "bwd_std_harness.cpp")


_TAPS = gaussian_taps(np.float32, 5, 1.5)
_KW = dict(taps=_TAPS, c1=1e-4, c2=9e-4, clip_bound=131072.0)


def _window(radius):
    """The taps at radius (fwd_times.RADIUS_SIGMA's sigma; radius 5 the
    default window)."""
    from ssim_tpu_torch.tools.fwd_times import RADIUS_SIGMA

    return _TAPS if radius == 5 else gaussian_taps(np.float32, radius, RADIUS_SIGMA[radius])


def _emulate(exe, a, b, w_s, w_cs, g_map, seg, vhalo=None, vmask=(0, 0), radius=5,
             strip_w=None, two_pass=None, dump=None):
    """A host build of a backward stream on NumPy (B, H, W) f32 inputs
    (data range 1) at radius (its taps _window's) and a strip of strip_w
    columns (relaxed_strip_w's if None), the NaN tile default_tile's: (da,
    db), NaN where it wrote nothing. two_pass (the standard harness only):
    the two-pass stream or the one-pass one; dump: a path the two-pass
    stream's scratch (tile mask, weight maps) is written to."""
    bsz, h, w = a.shape
    taps = _window(radius)
    head = np.array([bsz, h, w, ssim_grad.default_tile(radius)[0], seg, g_map is not None,
                     vhalo is not None, *vmask, radius,
                     strip_w or ssim_grad.relaxed_strip_w(radius),
                     *(() if two_pass is None else (two_pass,))], np.int32)
    consts = np.array([_KW["c1"], _KW["c2"], _KW["clip_bound"]], np.float32)
    parts = [head, taps, ssim_grad.fold_coefficients(taps), consts, a, b, w_s, w_cs]
    parts += ([g_map] if g_map is not None else []) + list(vhalo or ())
    path_in, path_out = f"{exe}.{os.getpid()}.in", f"{exe}.{os.getpid()}.out"
    with open(path_in, "wb") as f:
        for x in parts:
            f.write(np.ascontiguousarray(x).tobytes())
    subprocess.run([str(exe), path_in, path_out, *([str(dump)] if dump else [])], check=True,
                   timeout=600)
    raw = np.fromfile(path_out, np.float32)
    n = a.size
    return (torch.from_numpy(raw[:n].reshape(a.shape).copy()),
            torch.from_numpy(raw[n:].reshape(a.shape).copy()))


def _hold(exe, a, b, seg, g_map=None, vhalo=None, vmask=(0, 0), seed=0, radius=5,
          strip_w=None):
    """The host build against the relaxed twin on the same inputs: NaN
    exactly where the twin's is, within the derived bound elsewhere
    (ssim_grad.relaxed_grad_holds), and different from the standard twin
    but within _GRAD_STD * max|g|."""
    rng = np.random.default_rng(seed)
    bsz, h, w = a.shape
    w_s = (rng.random(bsz) / (h * w)).astype(np.float32)
    w_cs = (0.3 * rng.random(bsz) / (h * w)).astype(np.float32)
    got = _emulate(exe, a, b, w_s, w_cs, g_map, seg, vhalo, vmask, radius, strip_w)
    t = torch.from_numpy
    kw = dict(_KW, taps=_window(radius))
    if vhalo is not None:
        kw.update(vhalo=tuple(t(x) for x in vhalo), vmask=vmask)
    g = None if g_map is None else t(g_map)
    want, sens = ssim_grad.split_sensitivity(t(a), t(b), t(w_s), t(w_cs), g, **kw)
    std = ssim_grad.ssim_grad_plain(t(a), t(b), t(w_s), t(w_cs), g, **kw)
    fin = [~x.isnan() for x in std]
    scale = max(float(x[f].abs().max()) for x, f in zip(std, fin) if f.any())
    for k, p, sp, s, f in zip(got, want, sens, std, fin):
        assert ssim_grad.relaxed_grad_holds(k, p, scale, sp)[0]
        if f.any():
            assert 0 < (k[f] - s[f]).abs().max().item() <= _GRAD_STD * scale
    return got


def _pair(rng, shape):
    a = rng.random(shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)


#: (shape, segment, g_map): ragged last strips (W not a multiple of 128;
#: 3 and 12 columns past the first strip) and last segments (H not a
#: multiple of the segment), B = 2, segments of 1 and 2 tiles.
_CASES = {
    "B = 2, ragged strip and segment": ((2, 70, 200), 32, False),
    "g_map, 2 tiles a segment": ((1, 75, 140), 64, True),
    "g_map, B = 2": ((2, 40, 131), 32, True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_relaxed_stream_source_matches_twin_on_the_host(bwd_emulator, case):
    shape, seg, with_g = _CASES[case]
    rng = np.random.default_rng(0xB5 + len(case))
    a, b = _pair(rng, shape)
    g_map = rng.normal(0, 1e-5, shape).astype(np.float32) if with_g else None
    got = _hold(bwd_emulator, a, b, seg, g_map, seed=len(case))
    assert all(torch.isfinite(x).all() for x in got)


def test_relaxed_stream_source_one_row_on_the_host(bwd_emulator):
    """H = 1, where both vertical folds land on the one row: the kernel's
    source is as close to the f64 standard gradient as the relaxed twin is
    (a one-row image cancels in the weight maps, so kernel and twin each
    lie up to ~8e-5 x max|g| from it, in different roundings, and may
    differ from each other by about that), within the tier's 1e-3 x
    max|g|, and NaN nowhere."""
    rng = np.random.default_rng(0xB8)
    a, b = _pair(rng, (2, 1, 260))
    w_s = np.full(2, 1 / 260, np.float32)
    w_cs = np.full(2, 0.3 / 260, np.float32)
    da, db = _emulate(bwd_emulator, a, b, w_s, w_cs, None, 32)
    t = torch.from_numpy
    want = ssim_grad.ssim_grad_plain(t(a), t(b), t(w_s), t(w_cs), None, relaxed=True, **_KW)
    f64 = ssim_grad.ssim_grad_plain(t(a).double(), t(b).double(), t(w_s).double(),
                                    t(w_cs).double(), None, **_KW)
    scale = max(float(x.abs().max()) for x in f64)
    for k, p, d in zip((da, db), want, f64):
        assert torch.isfinite(k).all()
        e_kernel = (k.double() - d).abs().max().item()
        e_twin = (p.double() - d).abs().max().item()
        assert e_kernel <= max(2 * e_twin, _GRAD_TWIN * scale)
        assert e_kernel <= _GRAD_STD * scale


@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_relaxed_stream_source_with_halo_operands_on_the_host(bwd_emulator, flags):
    """A band of 37 rows (a segment of 32 and a ragged one of 5) of a
    taller image, its 2r rows above and below as operands, each flag pair:
    under a set flag the band's edge row is replicated, the loss rows
    beyond the edge are dropped and the clamp folds onto the edge row; an
    operand under a set flag is never read (NaN-filled here)."""
    rng = np.random.default_rng(0xB6 + 2 * flags[0] + flags[1])
    a, b = _pair(rng, (1, 97, 150))
    lo, hi = 30, 67

    def ring(x):
        top = np.full_like(x[:, :10], np.nan) if flags[0] else x[:, lo - 10:lo]
        bot = np.full_like(x[:, :10], np.nan) if flags[1] else x[:, hi:hi + 10]
        return np.ascontiguousarray(top), np.ascontiguousarray(bot)

    (a_top, a_bot), (b_top, b_bot) = ring(a), ring(b)
    got = _hold(bwd_emulator, np.ascontiguousarray(a[:, lo:hi]),
                np.ascontiguousarray(b[:, lo:hi]), 32, vhalo=(a_top, a_bot, b_top, b_bot),
                vmask=flags, seed=3)
    assert all(torch.isfinite(x).all() for x in got)


def test_relaxed_stream_source_nonfinite_on_boundaries_on_the_host(bwd_emulator):
    """Non-finite inputs on a segment's first and last rows, a strip's last
    and first columns, 2r rows above a segment and the image's last pixel:
    NaN over exactly the twin's 32 x 64 tiles (those within 2r), nowhere
    else, and in no other image."""
    rng = np.random.default_rng(0xB7)
    a, b = _pair(rng, (3, 70, 260))
    a[0, 32, 50] = np.nan
    a[0, 31, 200] = np.inf
    b[1, 22, 127] = -np.inf
    a[1, 60, 128] = np.nan
    b[1, 69, 259] = np.nan
    got = _hold(bwd_emulator, a, b, 32)
    assert got[0][0].isnan().any() and got[0][1].isnan().any()
    assert not got[0][1].isnan().all() and torch.isfinite(got[0][2]).all()


#: The runtime-radius instantiations' cases (the k-step edges: radii 4/5,
#: 8/9, 12/13, and 1 and 16; the strip each instantiation has): (radius, strip, shape, segment,
#: g_map, planted non-finite pixels (image, y, x)). Ragged strips, B = 2,
#: segments of one and two tiles, the 16 x 64 NaN tile at radius 16, radius
#: 5 through the runtime-radius kernel at the 64-column strip.
_RT_CASES = {
    "r1 strip 128, g_map": (1, 128, (1, 20, 140), 32, True, ()),
    "r4 strip 128, NaN": (4, 128, (2, 37, 130), 32, False, ((1, 20, 127),)),
    "r5 strip 64": (5, 64, (1, 30, 130), 32, False, ()),
    "r6 strip 64": (6, 64, (1, 26, 70), 32, False, ()),
    "r8 strip 64, g_map": (8, 64, (1, 40, 70), 32, True, ()),
    "r9 strip 64, NaN on a strip boundary": (9, 64, (1, 40, 130), 32, False, ((0, 33, 64),)),
    "r12 strip 128": (12, 128, (1, 33, 140), 32, False, ()),
    "r11 strip 64, two segments": (11, 64, (1, 40, 70), 32, False, ()),
    "r13 strip 128, two segments": (13, 128, (1, 40, 140), 32, False, ()),
    "r16 strip 64, g_map": (16, 64, (1, 20, 70), 16, True, ()),
}


@pytest.mark.parametrize("case", list(_RT_CASES))
def test_relaxed_runtime_radius_source_matches_twin_on_the_host(bwd_emulator, case):
    """The runtime-radius relaxed stream (kR = 0: the radius read at run
    time, kG = rel_groups(r) of 8-row groups a vertical pass reads, 128- or
    64-column strips), built for the host, against the relaxed twin at each
    k-step edge: within 1e-4 x max|g|, different from the standard twin
    and within 1e-3 x max|g| of it, NaN over exactly the twin's tiles; its
    outputs and shared memory start as NaN."""
    radius, strip, shape, seg, with_g, planted = _RT_CASES[case]
    rng = np.random.default_rng(0xBA + radius)
    a, b = _pair(rng, shape)
    for img, y, x in planted:
        a[img, y, x] = np.nan
    g_map = rng.normal(0, 1e-5, shape).astype(np.float32) if with_g else None
    da, db = _hold(bwd_emulator, a, b, seg, g_map, seed=radius, radius=radius, strip_w=strip)
    assert all(bool(x.isnan().any()) == bool(planted) for x in (da, db))


@pytest.mark.parametrize("radius,strip,flags", [(3, 128, (1, 0)), (13, 64, (0, 1))])
def test_relaxed_runtime_radius_source_with_halo_operands_on_the_host(bwd_emulator, radius,
                                                                      strip, flags):
    """The runtime-radius relaxed stream with halo operands of 2r rows: a
    band of 2r + 4 rows of a taller image, the operands read where a flag
    is clear and never read (NaN-filled) where it is set."""
    rng = np.random.default_rng(0xBB + radius)
    a, b = _pair(rng, (1, 6 * radius + 30, 70))
    lo, hi = 2 * radius + 3, 4 * radius + 7

    def ring(x):
        top = np.full_like(x[:, :2 * radius], np.nan) if flags[0] else x[:, lo - 2 * radius:lo]
        bot = np.full_like(x[:, :2 * radius], np.nan) if flags[1] else x[:, hi:hi + 2 * radius]
        return np.ascontiguousarray(top), np.ascontiguousarray(bot)

    (a_top, a_bot), (b_top, b_bot) = ring(a), ring(b)
    got = _hold(bwd_emulator, np.ascontiguousarray(a[:, lo:hi]),
                np.ascontiguousarray(b[:, lo:hi]), 32, vhalo=(a_top, a_bot, b_top, b_bot),
                vmask=flags, seed=radius, radius=radius, strip_w=strip)
    assert all(torch.isfinite(x).all() for x in got)


def test_relaxed_runtime_radius_source_one_row_on_the_host(bwd_emulator):
    """H = 1 at radius 9 (three horizontal k-steps, two vertical ones):
    both vertical folds land on the one row; within 1e-3 x max|g| of the
    f64 standard gradient, as close as the relaxed twin within 1e-4 x
    max|g|, and NaN nowhere."""
    rng = np.random.default_rng(0xBC)
    a, b = _pair(rng, (2, 1, 100))
    w_s = np.full(2, 1 / 100, np.float32)
    w_cs = np.full(2, 0.3 / 100, np.float32)
    da, db = _emulate(bwd_emulator, a, b, w_s, w_cs, None, 32, radius=9)
    t = torch.from_numpy
    kw = dict(_KW, taps=_window(9))
    want = ssim_grad.ssim_grad_plain(t(a), t(b), t(w_s), t(w_cs), None, relaxed=True, **kw)
    f64 = ssim_grad.ssim_grad_plain(t(a).double(), t(b).double(), t(w_s).double(),
                                    t(w_cs).double(), None, **kw)
    scale = max(float(x.abs().max()) for x in f64)
    for k, p, d in zip((da, db), want, f64):
        assert torch.isfinite(k).all()
        e_kernel = (k.double() - d).abs().max().item()
        e_twin = (p.double() - d).abs().max().item()
        assert e_kernel <= max(2 * e_twin, _GRAD_TWIN * scale)
        assert e_kernel <= _GRAD_STD * scale


#: The standard tier's bound against its twin (chip_smoke.py's backward
#: checks): 1e-6 x max(1, max|g|); NaN over exactly the twin's tiles.
_STD_TWIN = 1e-6


def _hold_std(exe, a, b, seg, g_map=None, vhalo=None, vmask=(0, 0), seed=0, radius=5,
              two_pass=None):
    """The host build of the standard tier's stream (the routed one at this
    radius, ssim_grad.std_two_pass, or the one two_pass names) against
    ssim_grad_plain on the same inputs: NaN exactly where the twin's is,
    within _STD_TWIN x max(1, max|g|) elsewhere. Returns (da, db)."""
    rng = np.random.default_rng(seed)
    bsz, h, w = a.shape
    w_s = (rng.random(bsz) / (h * w)).astype(np.float32)
    w_cs = (0.3 * rng.random(bsz) / (h * w)).astype(np.float32)
    two = ssim_grad.std_two_pass(radius) if two_pass is None else two_pass
    got = _emulate(exe, a, b, w_s, w_cs, g_map, seg, vhalo, vmask, radius, ssim_grad.STRIP_W,
                   int(two))
    t = torch.from_numpy
    kw = dict(_KW, taps=_window(radius))
    if vhalo is not None:
        kw.update(vhalo=tuple(t(x) for x in vhalo), vmask=vmask)
    g = None if g_map is None else t(g_map)
    want = ssim_grad.ssim_grad_plain(t(a), t(b), t(w_s), t(w_cs), g, **kw)
    fin = [~x.isnan() for x in want]
    scale = max([1.0] + [float(x[f].abs().max()) for x, f in zip(want, fin) if f.any()])
    for k, p, f in zip(got, want, fin):
        assert torch.equal(k.isnan(), p.isnan())
        if f.any():
            assert (k[f] - p[f]).abs().max().item() <= _STD_TWIN * scale
    return got


def _halo_band(rng, shape, lo, hi, radius, flags):
    """A band [lo, hi) of a random pair and its halo operands of 2r rows
    (NaN-filled under a set flag: never read): (a, b, vhalo)."""
    a, b = _pair(rng, shape)

    def ring(x):
        top = (np.full_like(x[:, :2 * radius], np.nan) if flags[0]
               else x[:, lo - 2 * radius:lo])
        bot = (np.full_like(x[:, :2 * radius], np.nan) if flags[1]
               else x[:, hi:hi + 2 * radius])
        return np.ascontiguousarray(top), np.ascontiguousarray(bot)

    (a_top, a_bot), (b_top, b_bot) = ring(a), ring(b)
    return (np.ascontiguousarray(a[:, lo:hi]), np.ascontiguousarray(b[:, lo:hi]),
            (a_top, a_bot, b_top, b_bot))


#: The standard tier's cases: (radius, shape, segment, g_map, planted
#: non-finite pixels (image, y, x, value)). Radius 5 runs the
#: register-window instantiation, the others the runtime-radius one (kR =
#: 0); ragged strips and segments, B = 2 and 3, segments of 1 and 2 tiles,
#: the 16 x 64 NaN tile at radius 16, non-finite inputs on a segment's first
#: and last rows, a strip's last and first columns, 2r rows above a segment
#: and the image's last pixel.
_STD_CASES = {
    "r5 B = 2, ragged strip and segment": (5, (2, 70, 200), 32, False, ()),
    "r5 g_map, 2 tiles a segment": (5, (1, 75, 140), 64, True, ()),
    "r5 non-finite on boundaries": (5, (3, 70, 260), 32, False,
                                    ((0, 32, 50, np.nan), (0, 31, 200, np.inf),
                                     (1, 22, 127, -np.inf), (1, 60, 128, np.nan),
                                     (1, 69, 259, np.nan))),
    "r3 g_map, NaN in row 0": (3, (1, 40, 140), 32, True, ((0, 0, 70, np.nan),)),
    "r16 ragged, 16-row tiles": (16, (2, 37, 150), 16, False, ()),
    "r1 g_map, W < a strip": (1, (1, 33, 60), 32, True, ()),
}


@pytest.mark.parametrize("case", list(_STD_CASES))
def test_standard_stream_source_matches_twin_on_the_host(bwd_std_emulator, case):
    """The standard tier's backward stream (ssim_bwd_stream_kernel: at radius
    5 the weight maps' window in registers, elsewhere the runtime-radius
    instantiation with both windows as rings), built for the host, against
    ssim_grad_plain: within 1e-6 x max(1, max|g|), the card's bound, NaN
    over exactly the twin's tiles (only where a non-finite input lies), with
    and without g_map."""
    radius, shape, seg, with_g, planted = _STD_CASES[case]
    rng = np.random.default_rng(0xC0 + len(case))
    a, b = _pair(rng, shape)
    for img, y, x, v in planted:
        a[img, y, x] = v
    g_map = rng.normal(0, 1e-5, shape).astype(np.float32) if with_g else None
    da, db = _hold_std(bwd_std_emulator, a, b, seg, g_map, seed=len(case), radius=radius)
    assert all(bool(x.isnan().any()) == bool(planted) for x in (da, db))
    if planted:
        assert not da.isnan().all()


@pytest.mark.parametrize("radius,flags", [(5, (0, 0)), (5, (1, 0)), (5, (0, 1)), (5, (1, 1)),
                                          (3, (1, 0)), (16, (0, 1))])
def test_standard_stream_source_with_halo_operands_on_the_host(bwd_std_emulator, radius,
                                                               flags):
    """The standard tier's stream with halo operands of 2r rows, each flag
    pair at radius 5 and two at runtime radii: a band of 2r + 27 rows of a
    taller image (a segment of 32 and a ragged one), the operands read
    where a flag is clear and never read (NaN-filled) where it is set."""
    rng = np.random.default_rng(0xC8 + 2 * flags[0] + flags[1] + radius)
    lo = 2 * radius + 3
    a, b, vhalo = _halo_band(rng, (1, 6 * radius + 60, 150), lo, lo + 2 * radius + 27,
                             radius, flags)
    got = _hold_std(bwd_std_emulator, a, b, 32 if radius < 16 else 16, vhalo=vhalo,
                    vmask=flags, seed=radius, radius=radius)
    assert all(torch.isfinite(x).all() for x in got)


def test_split_sensitivity_covers_a_nudged_twin_and_not_a_moved_entry():
    """ssim_grad.split_sensitivity at radius 1 (P8's radius): s(p) is the
    largest distance of three nudged twins (every band pass's operand
    SPLIT_NUDGE_ULPS ulps up, down, or each element a random way) from the
    twin, NaN where the
    twin is, zero nowhere it matters to the bound's tests; so a twin nudged
    up holds the derived bound (kappa >= 1), and the twin with one
    well-conditioned entry (the smallest s(p) among those with |g| over
    half of max|g|) moved by 3e-4 x max|g| fails it, as the card's negative
    control (chip_smoke.py relaxed_grad_sweep) must."""
    from ssim_tpu_torch.ops import ssim_cuda

    x = torch.tensor([1.5, -3.5, 0.375])  # inside their binades: one ulp each way alike
    ulp = torch.nextafter(x.abs(), torch.tensor(float("inf"))) - x.abs()
    n = ssim_cuda.SPLIT_NUDGE_ULPS
    assert torch.equal(ssim_cuda._nudged(x, "up") - x, n * ulp)
    assert torch.equal(x - ssim_cuda._nudged(x, "down"), n * ulp)
    moved = ssim_cuda._nudged(x, torch.Generator().manual_seed(0)) - x
    assert torch.equal(moved.abs(), n * ulp)
    rng = np.random.default_rng(0xBD)
    a, b = _pair(rng, (2, 40, 140))
    a[1, 20, 70] = np.nan
    w_s = (rng.random(2) / (40 * 140)).astype(np.float32)
    w_cs = (0.3 * rng.random(2) / (40 * 140)).astype(np.float32)
    t = torch.from_numpy
    args = (t(a), t(b), t(w_s), t(w_cs), None)
    kw = dict(_KW, taps=_window(1))
    want, sens = ssim_grad.split_sensitivity(*args, **kw)
    twin = ssim_grad.ssim_grad_plain(*args, relaxed=True, **kw)
    up = ssim_grad.ssim_grad_plain(*args, relaxed=True, nudge="up", **kw)
    std = ssim_grad.ssim_grad_plain(*args, **kw)
    scale = max(float(x[~x.isnan()].abs().max()) for x in std)
    assert ssim_grad.RELAXED_GRAD_KAPPA >= 1
    for w_, tw, u, s in zip(want, twin, up, sens):
        assert torch.equal(w_.nan_to_num(), tw.nan_to_num()) and torch.equal(s.isnan(),
                                                                              w_.isnan())
        fin = ~w_.isnan()
        assert (s[fin] >= 0).all() and (s[fin] > 0).any()
        assert ((u - w_).abs()[fin] <= s[fin]).all()
        assert ssim_grad.relaxed_grad_holds(u, w_, scale, s)[0]
        big = w_.abs().nan_to_num(0.0) > 0.5 * scale
        idx = torch.where(big, s.nan_to_num(float("inf")), float("inf")).argmin()
        moved = w_.clone()
        moved.view(-1)[idx] += 3e-4 * scale
        assert not ssim_grad.relaxed_grad_holds(moved, w_, scale, s)[0]


@pytest.mark.parametrize("radius", [1, 8])
def test_twin_without_its_low_parts_fails_the_derived_bound(monkeypatch, radius):
    """A lower-precision control of the derived bound, as phase 15e's on the
    card (chip_smoke.py hi_parts_only): the relaxed twin with every band
    pass's bf16 low parts dropped, one bf16 product instead of three, put
    in the kernel's place, fails ssim_grad.relaxed_grad_holds on each image
    and output, at radius 1 (where s(p) is largest) and 8."""
    from ssim_tpu_torch.ops import ssim_cuda

    rng = np.random.default_rng(0xBE + radius)
    a, b = _pair(rng, (2, 48, 150))
    a[1, 24, 70] = np.nan
    w_s = (rng.random(2) / (48 * 150)).astype(np.float32)
    w_cs = (0.3 * rng.random(2) / (48 * 150)).astype(np.float32)
    t = torch.from_numpy
    args = (t(a), t(b), t(w_s), t(w_cs), t(rng.normal(0, 1e-6, a.shape).astype(np.float32)))
    kw = dict(_KW, taps=_window(radius))
    want, sens = ssim_grad.split_sensitivity(*args, **kw)
    std = ssim_grad.ssim_grad_plain(*args, **kw)
    split = ssim_cuda._bf16_split
    monkeypatch.setattr(ssim_cuda, "_bf16_split",
                        lambda x: (split(x)[0], torch.zeros_like(x)))
    lower = ssim_grad.ssim_grad_plain(*args, relaxed=True, **kw)
    for j in range(2):
        scale = max(float(x[j].nan_to_num(0.0).abs().max()) for x in std)
        for low, p, sp in zip(lower, want, sens):
            assert ssim_grad.relaxed_grad_holds(low[j], p[j], scale, sp[j])[0] is False
