"""A race check of every streaming kernel's source on the CPU: the host
harnesses of tests/fwd_stream_emu (one std::thread per CUDA thread, a
std::barrier for __syncthreads and __syncwarp) built with
-fsanitize=thread and run under ThreadSanitizer, which halts on the first
data race it sees (exit 66, its report in a log file that the failure
shows). A race between a block's threads is one on the card too: CUDA's
memory model orders two threads' shared-memory accesses only through a
barrier (or the warp's own __syncwarp), so a read that races a write may
see either value, or neither, on the card, whatever the harness's schedule
gave. A report is a fault of the kernel's source to repair there, never to
suppress: this file has no suppression list.

Every case runs a family's instantiation at a size the sanitizer takes in a
second or so (one or two strips, two or three segments, a ragged width of
63 as in P6, ROADMAP Queue 3, and in f32 one NaN pixel, the NaN-mask path
that P5 raced on) and holds its outputs against the twins at the emulator
tests' tolerances (tests/test_torch_port_fwd_stream.py,
tests/test_torch_port_bwd_stream.py). A file's builds (a harness and a
control, whose source lacks one barrier and must give a report) run at the
same time. This file checks the forward streams; the backward ones are
tests/test_torch_port_racecheck_bwd.py's.
"""

import concurrent.futures
import contextlib
import glob
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_port_fwd_stream import (_RELAXED_GLOBAL, _RELAXED_PIXEL, _build_emulator,
                                        _emu_pair, _emulate_batch, _hold_components,
                                        _hold_emulated, _hold_precise, _hold_relaxed)

from ssim_tpu_torch.ops import ssim_cuda
from ssim_tpu_torch.tools.fwd_times import RADIUS_SIGMA
from ssim_tpu_torch.windows import gaussian_taps

TSAN_FLAGS = ("-fsanitize=thread", "-g")
#: The harness's exit code when ThreadSanitizer reports a race.
RACE_EXIT = 66

#: The control: (source, a barrier the kernel needs, the text without it):
#: the forward stream's prologue barrier (stage(0)'s writes, then step 0's
#: reads of the same staged row).
_FWD_CONTROL = ("fwd_stream_kernel.cuh", "  if (n > kLead) fetch(kLead);\n  __syncthreads();\n",
                "  if (n > kLead) fetch(kLead);\n")


def without(control):
    """An edit hook for the builders that removes the control's barrier."""
    name, old, new = control

    def edit(fname, text):
        if fname == name:
            assert text.count(old) == 1, control
            return text.replace(old, new)
        return text

    return edit


def _sanitizer_missing(tmp):
    """Why a -fsanitize=thread program cannot be built or run here, or None."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "needs g++ to build the kernels' sources for the host"
    src, exe = tmp / "probe.cpp", tmp / "probe"
    src.write_text("#include <thread>\nint main() { std::thread([] {}).join(); }\n")
    built = subprocess.run([gxx, "-std=c++20", "-pthread", *TSAN_FLAGS, "-o", str(exe),
                            str(src)], capture_output=True, text=True, timeout=120)
    if built.returncode:
        return "g++ cannot link -fsanitize=thread: " + built.stderr.strip()[-300:]
    ran = subprocess.run([str(exe)], capture_output=True, text=True, timeout=60)
    if ran.returncode:
        return "a -fsanitize=thread program does not run here: " + ran.stderr.strip()[-300:]
    return None


def build_all(tmp_path_factory, jobs):
    """Each job(directory) of jobs (name -> builder), all at the same time,
    each in a directory of its own, once the sanitizer is found to work
    here (else the test skips with the reason): name -> its harness's
    path."""
    reason = _sanitizer_missing(tmp_path_factory.mktemp("tsan_probe"))
    if reason:
        pytest.skip(reason)
    dirs = {name: tmp_path_factory.mktemp(name) for name in jobs}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job, dirs[name]) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    """The forward streams' harness built with ThreadSanitizer ("fwd") and
    its control ("fwd_control"); name -> path."""
    return build_all(tmp_path_factory, {
        "fwd": lambda out: _build_emulator(out, flags=TSAN_FLAGS),
        "fwd_control": lambda out: _build_emulator(out, without(_FWD_CONTROL), TSAN_FLAGS),
    })


def reports(log):
    return "".join(open(p).read() for p in sorted(glob.glob(f"{log}.*")))


@pytest.fixture
def sanitizer(monkeypatch, tmp_path):
    """The harnesses' ThreadSanitizer options for this test (halt on the
    first report, exit RACE_EXIT, the report in a log file here) and the
    log's path prefix."""
    log = tmp_path / "tsan"
    monkeypatch.setenv("TSAN_OPTIONS", f"halt_on_error=1 exitcode={RACE_EXIT} log_path={log}")
    return log


@contextlib.contextmanager
def race_free(log):
    """Fails with the sanitizer's report if a harness run inside gave one."""
    try:
        yield
    except subprocess.CalledProcessError as e:
        pytest.fail(f"the harness exited {e.returncode}:\n{reports(log)[:8000]}")
    assert not reports(log), reports(log)[:8000]


def _sigma(radius):
    return 1.5 if radius == 5 else RADIUS_SIGMA[radius]


def _ids(cases):
    return [" ".join(str(x) if not isinstance(x, bool) else ("f32" if x else "u8")
                     for x in case) for case in cases]


#: The forward stream's geometry: 63 columns (one ragged strip), 24 rows in
#: segments of 16 (two, the last ragged), 8 x 32 tiles (TH even, as kPooled
#: takes); in f32 one NaN pixel in the second segment.
_FWD_SHAPE, _FWD_TILE, _FWD_SEG, _FWD_NAN = (1, 24, 63), (8, 32), 16, (0, 17, 30)
_FWD_TIERS = ("standard", "halo", "precise", "components", "relaxed", "relaxed components")
#: (radius, tier, f32): every tier in u8 and f32 at radius 5, the main path's;
#: at runtime radii 1, 8 and 16 the standard, precise and relaxed tiers,
#: each in one of the two, in turns (the relaxed k-step groups: 2 at 1 and
#: 8, 3 at 16), and the components modes once in each tier.
_RT_TIERS = ("standard", "precise", "relaxed")
_FWD_CASES = ([(5, tier, f32) for tier in _FWD_TIERS for f32 in (False, True)] +
              [(r, tier, (i + r) % 2 == 1) for r in (1, 8, 16)
               for i, tier in enumerate(_RT_TIERS)] +
              [(8, "components", True), (16, "relaxed components", False)])


@pytest.mark.parametrize("radius,tier,f32", _FWD_CASES, ids=_ids(_FWD_CASES))
def test_forward_stream_source_has_no_race(harnesses, sanitizer, radius, tier, f32):
    """ssim_fwd_stream_kernel at radius 5 (the register-window
    instantiations) in every mode: kScore, kMap, kRowsum and kRowsumMap,
    the row modes with halo operands (flags (1, 0) in u8, (0, 1) in f32),
    kPrecise and kPreciseMap, kComponents and kPooled, and the relaxed
    kScore, kMap, kComponents and kPooled; at runtime radii 1, 8 and 16 (kR
    = 0; relaxed with kSplit = ksteps(r)) the standard, precise and
    relaxed tiers' score and map modes (the standard tier's row modes too),
    and kComponents and kPooled, standard at 8 and relaxed at 16. No
    report, and the twins' results. The relaxed radius-5 cases failed on
    the source before its staged rows' pitch was widened: a band product's
    last line read 6 columns into the next staged row's slot while step (d)
    staged that row."""
    rng = np.random.default_rng(0x7A50 + 16 * radius + 2 * _FWD_TIERS.index(tier) + f32)
    a, b = _emu_pair(rng, _FWD_SHAPE, f32)
    if f32:
        a[_FWD_NAN] = np.nan
    exe, sigma = harnesses["fwd"], _sigma(radius)
    args = (exe, a, b, _FWD_TILE, _FWD_SEG)
    with race_free(sanitizer):
        if tier == "standard":
            _hold_emulated(*args, radius=radius, sigma=sigma)
        elif tier == "halo":
            flags = (0, 1) if f32 else (1, 0)
            full_a, full_b = _emu_pair(rng, (1, 24 + 2 * radius + 6, 63), f32)
            lo, hi = radius + 3, radius + 27
            full_a[:, lo:hi], full_b[:, lo:hi] = a, b
            vhalo = []
            for x in (full_a, full_b):
                top = x[:, -radius:] if flags[0] else x[:, lo - radius:lo]
                bot = x[:, :radius] if flags[1] else x[:, hi:hi + radius]
                vhalo += [np.ascontiguousarray(top), np.ascontiguousarray(bot)]
            _hold_emulated(*args, vhalo=(vhalo[0], vhalo[1], vhalo[2], vhalo[3]), vmask=flags,
                           radius=radius, sigma=sigma)
        elif tier == "precise":
            _hold_precise(*args, radius=radius, sigma=sigma)
        elif tier == "relaxed":
            _hold_relaxed(*args, radius=radius, sigma=sigma)
        else:
            _hold_components(*args, radius=radius, sigma=sigma, relaxed=tier.startswith("rel"))


#: The packed batch stream: W = 47, three images a packed row, so that the
#: 141 packed columns straddle two strips and the middle image both; 4
#: images (a short last packed row) of 12 rows in segments of 8 (the second
#: pass); in f32 one NaN pixel in image 1.
_BATCH_SHAPE, _BATCH_PACK, _BATCH_NAN = (4, 12, 47), (3, 8), (1, 9, 40)
_BATCH_MODES = ("kBatch", "kBatchPrecise", "relaxed kBatch")
#: (mode, radius, f32): each mode in u8 and f32 at radius 5, in one of the
#: two at radius 8.
_BATCH_CASES = ([(mode, 5, f32) for mode in _BATCH_MODES for f32 in (False, True)] +
                [(mode, 8, i % 2 == 0) for i, mode in enumerate(_BATCH_MODES)])


@pytest.mark.parametrize("mode,radius,f32", _BATCH_CASES, ids=_ids(_BATCH_CASES))
def test_batch_stream_source_has_no_race(harnesses, sanitizer, mode, radius, f32):
    """ssim_fwd_batch_stream_kernel and batch_pieces_reduce_kernel in
    kBatch, kBatchPrecise and the relaxed kBatch, at radius 5 (the
    register-window instantiations) and radius 8 (the runtime-radius ones),
    at a width whose strips straddle images: no report, and
    ssim_parts_batch_plain's per-image scores (within 2e-7, precise 1e-12
    relative, relaxed 2e-6), counts exact, NaN in exactly the image that
    holds one. The relaxed radius-5 cases failed on the source before its
    staged rows' pitch was widened: a sweep's eighth line (past the lines
    that hold outputs) read 16 columns into the next staged row's slot
    while the push staged that row."""
    precise, relaxed = mode == "kBatchPrecise", mode.startswith("relaxed")
    rng = np.random.default_rng(0x7B50 + radius + 2 * f32 + 4 * len(mode))
    a, b = _emu_pair(rng, _BATCH_SHAPE, f32)
    if f32:
        a[_BATCH_NAN] = np.nan
    bsz, h, w = _BATCH_SHAPE
    with race_free(sanitizer):
        got = _emulate_batch(harnesses["fwd"], a, b, precise, _BATCH_PACK, relaxed, radius,
                             _sigma(radius))
    dr = 1.0 if f32 else 255.0
    want = ssim_cuda.ssim_parts_batch_plain(
        torch.from_numpy(a), torch.from_numpy(b), precise, relaxed=relaxed,
        taps=gaussian_taps(np.float64 if precise else np.float32, radius, _sigma(radius)),
        c1=(0.01 * dr) ** 2, c2=(0.03 * dr) ** 2, clip_bound=max(131072.0, 4.0 * dr))
    assert got.dtype == want.dtype
    assert torch.equal(got[:, 1], want[:, 1]) and (got[:, 1] == h * w).all()
    assert torch.isnan(got[:, 0]).nonzero().flatten().tolist() == ([1] if f32 else [])
    gk, gp = got[:, 0].double().numpy() / (h * w), want[:, 0].double().numpy() / (h * w)
    ok = np.isfinite(gp)
    err = np.abs(gk[ok] - gp[ok]) / (np.abs(gp[ok]) if precise else 1.0)
    tol = (1e-12 if precise else
           max(_RELAXED_GLOBAL, 2 * _RELAXED_PIXEL / (h * w) ** 0.5) if relaxed else 2e-7)
    assert err.max() <= tol, (mode, err.max())


def test_forward_control_without_a_barrier_gives_a_report(harnesses, sanitizer):
    """The checker sees a race: the forward harness built without the
    stream's prologue barrier halts with ThreadSanitizer's data-race
    report."""
    a, b = _emu_pair(np.random.default_rng(0x7E50), _FWD_SHAPE, False)
    with pytest.raises(subprocess.CalledProcessError) as run:
        _hold_emulated(harnesses["fwd_control"], a, b, _FWD_TILE, _FWD_SEG)
    assert run.value.returncode == RACE_EXIT
    assert "ThreadSanitizer: data race" in reports(sanitizer)
