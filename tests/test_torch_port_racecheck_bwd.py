"""The race check (tests/test_torch_port_racecheck.py) of the backward
streams' sources: the relaxed K3 (bwd_relaxed_stream.cuh) and the standard
K3 (the one-pass ssim_bwd_stream_kernel in bwd_std_stream.cuh, the
two-pass stream of every other radius in bwd_std_rt.cuh), their host
harnesses (tests/fwd_stream_emu/bwd_harness.cpp, bwd_std_harness.cpp)
built with -fsanitize=thread and run under ThreadSanitizer, held to their
twins at the emulator tests' tolerances (tests/test_torch_port_bwd_stream.py);
and two controls, the standard harness without P5's barrier and without
the two-pass stream's pass-A step barrier, which must each give a report.
"""

import subprocess

import numpy as np
import pytest

from test_torch_port_bwd_stream import _build_bwd_emulator, _halo_band, _hold, _hold_std, _pair
from test_torch_port_racecheck import (RACE_EXIT, TSAN_FLAGS, _ids, build_all, race_free,
                                       reports, sanitizer, without)

#: The control: (source, a barrier the kernel needs, the text without it):
#: the standard backward stream's barrier after thread 0 clears the NaN
#: tile mask (P5's repair: without it, a non-finite pixel in a block's first
#: staged row ORs into the mask while thread 0 clears it).
_STD_CONTROL = ("bwd_std_stream.cuh",
                "  if (tid == 0) s_bad = 0u;\n"
                "  // Before the prologue's stage(0), which may mark tiles in s_bad.\n"
                "  __syncthreads();\n",
                "  if (tid == 0) s_bad = 0u;\n")
#: The two-pass stream's control: pass A without the barrier that ends each
#: step (the next input row's staging, then the next step's reads of it by
#: the neighbouring columns' threads).
_RT_CONTROL = ("bwd_std_rt.cuh",
               "    if constexpr (kGmap) gload(j + 1);\n    __syncthreads();\n",
               "    if constexpr (kGmap) gload(j + 1);\n")


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    """The backward harnesses built with ThreadSanitizer: the relaxed
    stream's ("bwd"), the standard one's ("std") and its two controls
    ("std_control", "rt_control"); name -> path."""
    std = "bwd_std_harness.cpp"
    return build_all(tmp_path_factory, {
        "bwd": lambda out: _build_bwd_emulator(out, flags=TSAN_FLAGS),
        "std": lambda out: _build_bwd_emulator(out, std, flags=TSAN_FLAGS),
        "std_control": lambda out: _build_bwd_emulator(out, std, without(_STD_CONTROL),
                                                       TSAN_FLAGS),
        "rt_control": lambda out: _build_bwd_emulator(out, std, without(_RT_CONTROL),
                                                      TSAN_FLAGS),
    })


#: The backward streams' variants: plain with a NaN pixel in the first
#: segment, g_map, and halo operands under two flag pairs.
_BWD_VARIANTS = ("NaN", "g_map", "halo (1, 0)", "halo (0, 1)")


def _bwd_case(exe, hold, variant, radius, seed, **kw):
    """One backward stream run under the sanitizer, held to its twin by hold
    (_hold: the relaxed one, _hold_std: the standard one): 60 columns (one
    strip, one NaN tile wide), 40 rows in segments of one NaN tile (16 rows
    at radius 16, else 32): two segments, the second ragged."""
    rng = np.random.default_rng(seed)
    seg = 16 if radius == 16 else 32
    if variant.startswith("halo"):
        flags = (int(variant[6]), int(variant[9]))
        lo = 2 * radius + 3
        a, b, vhalo = _halo_band(rng, (1, 4 * radius + 46, 60), lo, lo + 40, radius, flags)
        return hold(exe, a, b, seg, vhalo=vhalo, vmask=flags, seed=seed, radius=radius, **kw)
    a, b = _pair(rng, (1, 40, 60))
    if variant == "NaN":
        a[0, 5, 59] = np.nan  # the first segment's NaN tile, not the second's
    g_map = rng.normal(0, 1e-5, a.shape).astype(np.float32) if variant == "g_map" else None
    return hold(exe, a, b, seg, g_map, seed=seed, radius=radius, **kw)


#: (radius, strip, variant): a NaN, g_map and halo operands at radius 5; g_map
#: at runtime radius 3 (128-column strips), halo operands at 9 (64).
_RELAXED_BWD_CASES = [(5, 128, "NaN"), (5, 128, "g_map"), (5, 128, "halo (1, 0)"),
                      (3, 128, "g_map"), (9, 64, "halo (0, 1)")]


@pytest.mark.parametrize("radius,strip,variant", _RELAXED_BWD_CASES,
                         ids=_ids(_RELAXED_BWD_CASES))
def test_relaxed_backward_stream_source_has_no_race(harnesses, sanitizer, radius, strip,
                                                    variant):
    """The relaxed K3 (bwd_relaxed_stream.cuh) at radius 5 (the
    instantiation with the radius compiled in) and at runtime radii 3 (128
    columns a strip) and 9 (64), ± g_map and with halo operands: no report,
    and the relaxed twin within its bound, NaN tiles exactly."""
    with race_free(sanitizer):
        _bwd_case(harnesses["bwd"], _hold, variant, radius, 0x7C50 + radius, strip_w=strip)


@pytest.mark.parametrize("variant", _BWD_VARIANTS)
@pytest.mark.parametrize("radius", [5, 3])
def test_standard_backward_stream_source_has_no_race(harnesses, sanitizer, radius, variant):
    """The standard K3 at radius 5 (ssim_bwd_stream_kernel, the weight maps'
    window in registers) and at runtime radius 3 (the design routed there,
    ssim_grad.std_two_pass), ± g_map and with halo operands: no report, and
    ssim_grad_plain within 1e-6 x max(1, max|g|), NaN tiles exactly."""
    with race_free(sanitizer):
        _bwd_case(harnesses["std"], _hold_std, variant, radius, 0x7D50 + radius)


#: (radius, variant): the two-pass stream at radii 3 (pinned: the one-pass
#: stream is routed there), 8 and 16, with g_map, a NaN in the first
#: segment and halo operands.
_RT_CASES = [(3, "g_map"), (8, "NaN"), (8, "halo (0, 1)"), (16, "g_map"), (16, "halo (1, 0)")]


@pytest.mark.parametrize("radius,variant", _RT_CASES, ids=_ids(_RT_CASES))
def test_two_pass_backward_stream_source_has_no_race(harnesses, sanitizer, radius, variant):
    """The standard K3's two-pass stream (bwd_std_rt.cuh: pass A, then pass B
    from its scratch map) at radii 3, 8 and 16, with a NaN, g_map and halo
    operands: no report, and ssim_grad_plain within 1e-6 x max(1, max|g|),
    NaN tiles exactly."""
    with race_free(sanitizer):
        _bwd_case(harnesses["std"], _hold_std, variant, radius, 0x7D60 + radius,
                  two_pass=True)


def test_two_pass_control_without_a_barrier_gives_a_report(harnesses, sanitizer):
    """The checker sees the two-pass stream's races: its harness built
    without pass A's step barrier halts with ThreadSanitizer's data-race
    report at radius 3."""
    rng = np.random.default_rng(0x7E52)
    a, b = _pair(rng, (1, 40, 60))
    with pytest.raises(subprocess.CalledProcessError) as run:
        _hold_std(harnesses["rt_control"], a, b, 32, radius=3, two_pass=True)
    assert run.value.returncode == RACE_EXIT
    assert "ThreadSanitizer: data race" in reports(sanitizer)


def test_standard_control_without_a_barrier_gives_a_report(harnesses, sanitizer):
    """The checker sees a race: the standard backward harness built without
    the barrier after the NaN tile mask's clearing, on a pair with a
    non-finite pixel in its first staged row, halts with ThreadSanitizer's
    data-race report."""
    rng = np.random.default_rng(0x7E51)
    a, b = _pair(rng, (1, 40, 60))
    a[0, 0, 10] = np.nan
    with pytest.raises(subprocess.CalledProcessError) as run:
        _hold_std(harnesses["std_control"], a, b, 32)
    assert run.value.returncode == RACE_EXIT
    assert "ThreadSanitizer: data race" in reports(sanitizer)
