"""The port's profiling hooks (`ssim_tpu_torch.utils.profiling`, on
torch.profiler): tests/test_profiling.py's cases, on the CPU."""

import json
import os

import pytest

from conftest import random_pair

import ssim_tpu_torch
from ssim_tpu_torch.utils import profiling


def test_trace_writes_profile(tmp_path, rng):
    a, b = random_pair(rng, 48, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("ssim-under-trace"):
            ssim_tpu_torch.compute_ssim(a, b, device="cpu")
    found = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(found) == 1, os.listdir(tmp_path)
    with open(tmp_path / found[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ssim-under-trace" for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with profiling.trace(str(tmp_path / "new")):
            raise RuntimeError("inside the trace")
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "new"))


def test_timer(rng):
    a, b = random_pair(rng, 32, 32)
    with profiling.Timer() as t:
        ssim_tpu_torch.compute_ssim(a, b, device="cpu")
    assert t.elapsed is not None and t.elapsed > 0
