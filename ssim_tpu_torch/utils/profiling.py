"""Profiling and tracing hooks.

Counterpart of `ssim_tpu/utils/profiling.py` on torch.profiler:

- `trace(log_dir)` records the enclosed block (host, and the card where
  CUDA is available) and writes it into `log_dir` as a Chrome trace
  (`*.pt.trace.json`, which chrome://tracing, Perfetto and TensorBoard's
  profiler plugin read);
- `annotate` names a region in that timeline (an alias of
  torch.profiler.record_function);
- `Timer` measures wall-clock time, and synchronises the current CUDA
  device on exit where one is in use, so the time covers the work the
  block queued there.
"""

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a trace of the enclosed block into `log_dir`:

        with ssim_tpu_torch.utils.profiling.trace("/tmp/ssim-trace"):
            compute_ssim(a, b)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))


#: Named region in the trace timeline, with the same context-manager call
#: syntax as the JAX package's `annotate`.
annotate = torch.profiler.record_function


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class Timer:
    """Wall-clock timer for quick measurements without a full trace. On
    exit it synchronises the current CUDA device if this process uses
    one, so queued kernels are inside the time."""

    def __init__(self):
        self.elapsed: Optional[float] = None

    def __enter__(self):
        if _cuda_in_use():
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _cuda_in_use():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        return False
