"""Steady-state device throughput measurement.

Counterpart of `ssim_tpu/testing/devicebench.py`: the method behind the
report's device columns (`report.py`) and behind a benchmark of the port.
It computes what the JAX loop computes and keeps its statistics; only the
loop itself is built for this card.

What one iteration does, as in the JAX loop: add 1 in place to
`a[0, 0, 0]`, in the input's dtype (uint8 wraps mod 256), run the call,
and add the sum of its partials (and `map[0, 0, 0]` with the map) to an
f32 accumulator. The change makes every iteration different work and the
accumulator depends on every call, so no iteration can be dropped.

On a CUDA device the loop runs on the device, in a CUDA graph:

- one iteration runs eagerly first, outside capture: it builds the
  kernel library, makes each kernel's first launch (which sets its
  shared-memory limit) and caches the occupancy queries that pick a
  launch's segment;
- one iteration (the change, the call and the accumulation) is then
  captured with `torch.cuda.graph` on static input and accumulator
  tensors, once per input shape and dtype (`Runner.capture`; a runner is
  one impl with its options, so the cache is per impl, shape, dtype and
  options, as the JAX package caches its jit);
- `run(a, b, iters)` copies a and b into the static tensors, replays the
  graph `iters` times and reads the accumulator back with one
  synchronize. CUDA events around the replays time them.

Why not the JAX method as it is: there the loop is a `lax.fori_loop`
inside one jit because the TPU is reached over RPC, and the loop pays the
host's round trip once per measurement. Here the host is local, but each
eager call does host work (argument checks, routing, the ctypes launch)
on the order of a kernel's own time at the shapes measured, so an eager
loop would time the host. A replayed graph launches the captured kernels
with none of that work, which is what the on-device loop does on the TPU.
The graph replays the kernels that the capture saw: the routing chosen
for that shape, the segment picked for that card.

On the CPU (`device="cpu"`, what the tests use) the same iteration runs
eagerly, timed with `time.perf_counter`. A CUDA measurement on a machine
without a GPU raises UnsupportedError; it never moves to the CPU.

Throughput comes from the delta between a long and a short loop
(cancelling the fixed cost of the input copy and the read-back), min of 3
per length, the median of reps, as in the JAX module.

`spatial` runs `mean_ssim_spatial` over a ("space",) mesh of the caller's
process group. On one rank its all-reduce is skipped and its halo
exchange is a copy, so the graph holds only kernels; on more ranks the
graph holds the NCCL collectives (PyTorch captures them), which no run of
this repository has measured yet.
"""

import time
from typing import Optional

import numpy as np
import torch

from ..errors import UnsupportedError

#: The runner's implementations, and the JAX runner's names for them:
#: cuda (pallas), torch (xla), auto (auto), grad (grad), msssim (msssim),
#: spatial (spatial).
IMPLS = ("cuda", "torch", "auto", "grad", "msssim", "spatial")


def _device(device) -> torch.device:
    """The measurement's device; cuda without a GPU raises."""
    from ..engine import resolve_device

    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise UnsupportedError(f"devicebench runs on cuda or cpu, not {dev}")
    return dev


def _parts_fn(impl, with_map, precise, relaxed, kw, device):
    """The call one iteration makes: (a, b) -> (partials, map or None),
    the JAX runner's branches (ssim_tpu/testing/devicebench.py:44-95)."""
    if impl == "grad":
        from ..ops.ssim_grad import ssim_grad_cuda

        def parts(a, b):
            da, db = ssim_grad_cuda(a, b, 1.0, 0.0, data_range=255.0,
                                    relaxed=relaxed, **kw)
            return da[..., 0, 0] + db[..., 0, 0], None
    elif impl == "msssim":
        from ..models.msssim import ms_ssim

        acc = "relaxed" if relaxed else "standard"

        def parts(a, b):
            return ms_ssim(a, b, data_range=255.0, accuracy=acc), None
    elif impl == "auto":
        # The full routing policy, the batch route for small images included.
        from ..ops.routing import ssim_parts_auto

        def parts(a, b):
            return ssim_parts_auto(a, b, with_map=with_map, precise=precise,
                                   relaxed=relaxed, **kw)
    elif impl == "spatial":
        import torch.distributed as dist

        from ..parallel import make_mesh, mean_ssim_spatial

        if not (dist.is_available() and dist.is_initialized()):
            raise UnsupportedError(
                "impl='spatial' runs over the caller's process group and none "
                "is initialised: call ssim_tpu_torch.parallel.multihost."
                "initialize (or torch.distributed.init_process_group) first")
        mesh = make_mesh((dist.get_world_size(),), ("space",), device_type=device.type)

        def parts(a, b):
            return mean_ssim_spatial(a, b, mesh, **kw), None
    elif impl == "cuda":
        from ..ops.ssim_cuda import ssim_parts_cuda

        def parts(a, b):
            return ssim_parts_cuda(a, b, with_map=with_map, precise=precise,
                                   relaxed=relaxed, **kw)
    elif impl == "torch":
        from ..ops.ssim_torch import ssim_parts_torch

        def parts(a, b):
            return ssim_parts_torch(a, b, with_map=with_map)
    else:
        raise UnsupportedError(f"unknown devicebench impl {impl!r}; one of {IMPLS}")
    return parts


class _State:
    """One loop's tensors: the carried input `a`, `b`, the f32 accumulator."""

    def __init__(self, a, b):
        self.a, self.b = a, b
        self.acc = torch.zeros((), dtype=torch.float32, device=a.device)


class Runner:
    """One impl's benchmark loop: `runner(a, b, iters)` -> the accumulator
    as a float. On CUDA the iterations are replays of a CUDA graph of one
    iteration (`capture`); on the CPU they run eagerly. `eager` runs the
    same iterations eagerly on either device."""

    def __init__(self, parts, device: torch.device):
        self._parts = parts
        self.device = device
        self.graph = device.type == "cuda"
        self._graphs = {}

    def _step(self, st: _State) -> None:
        st.a[0, 0, 0] += 1
        partials, m = self._parts(st.a, st.b)
        st.acc += partials.sum().to(torch.float32)
        if m is not None:
            st.acc += m[0, 0, 0]

    def _inputs(self, a, b):
        a = torch.as_tensor(a).to(self.device).contiguous()
        b = torch.as_tensor(b).to(self.device).contiguous()
        if a.dim() != 3 or a.shape != b.shape:
            raise ValueError(f"devicebench takes a (B, H, W) pair, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        return a, b

    def capture(self, a, b):
        """The CUDA graph of one iteration on inputs of a's and b's shape
        and dtype, and its static state: made at the first call for that
        shape (one eager iteration on a side stream first, then the
        capture), cached after."""
        return self._capture(*self._inputs(a, b))

    def _capture(self, a, b):
        key = (tuple(a.shape), a.dtype, b.dtype)
        if key not in self._graphs:
            st = _State(a.clone(), b.clone())
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._step(st)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._step(st)
            self._graphs[key] = (graph, st)
        return self._graphs[key]

    def eager(self, a, b, iters: int) -> float:
        """The loop run eagerly on the runner's device."""
        return self._timed_eager(a, b, iters)[0]

    def _timed_eager(self, a, b, iters: int):
        """(the loop's value, its seconds by time.perf_counter), run
        eagerly: the CPU's measurement."""
        a, b = self._inputs(a, b)
        st = _State(a.clone(), b)
        t0 = time.perf_counter()
        for _ in range(iters):
            self._step(st)
        value = float(st.acc)
        return value, time.perf_counter() - t0

    def timed(self, a, b, iters: int):
        """(the loop's value, its seconds): on CUDA `iters` replays of the
        graph between two CUDA events, on the CPU _timed_eager."""
        if not self.graph:
            return self._timed_eager(a, b, iters)
        a, b = self._inputs(a, b)
        graph, st = self._capture(a, b)
        st.a.copy_(a)
        st.b.copy_(b)
        st.acc.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        end.synchronize()
        return float(st.acc), start.elapsed_time(end) / 1e3

    def __call__(self, a, b, iters: int) -> float:
        return self.timed(a, b, iters)[0]


def make_runner(impl: str, with_map: bool, precise: bool = False,
                relaxed: bool = False, call_kwargs: Optional[dict] = None, *,
                device="cuda") -> Runner:
    """The benchmark loop of one implementation: run(a, b, iters) -> the
    f32 accumulator as a float (a Runner).

    impl: one of IMPLS. "cuda" is the fused kernel (`ssim_parts_cuda`),
    "torch" the plain path (`ssim_parts_torch`), "auto" the routing
    policy (`ssim_parts_auto`: the batch route for small images), "grad"
    the fused backward kernel on f32 pairs (`ssim_grad_cuda`, summing
    da[..., 0, 0] + db[..., 0, 0]), "msssim" the 5-scale pyramid
    (`ms_ssim`) and "spatial" `mean_ssim_spatial` over a ("space",) mesh
    of the caller's process group (UnsupportedError where none is
    initialised; it never starts one). precise: the precise tier (cuda,
    auto). relaxed: the relaxed tier (cuda, auto, grad, msssim).
    call_kwargs: extra keywords of the underlying call (cuda, auto, grad,
    spatial), as in the JAX runner. device: "cuda" (a graph loop) or "cpu"
    (an eager loop)."""
    dev = _device(device)
    parts = _parts_fn(impl, with_map, precise, relaxed, dict(call_kwargs or {}), dev)
    return Runner(parts, dev)


def device_throughput(
    impl: str = "cuda",
    with_map: bool = False,
    batch: int = 8,
    h: int = 1080,
    w: int = 1920,
    iters: int = 256,
    reps: int = 3,
    precise: bool = False,
    relaxed: bool = False,
    seed: int = 7,
    call_kwargs: Optional[dict] = None,
    float_input: bool = False,
    *,
    device="cuda",
) -> float:
    """Median-of-reps steady-state throughput in Mpix/s (the JAX
    function's defaults and method, ssim_tpu/testing/devicebench.py:
    116-177): the inputs from np.random.default_rng(seed) as JAX makes
    them, f32 for grad or float_input; warm-up runs at both loop lengths;
    short = max(1, iters // 8), long = iters; min of 3 per length; a rep
    whose delta is at most 1% of the long loop's time is dropped; raises
    RuntimeError when every rep is dropped."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (batch, h, w), dtype=np.uint8)
    noise = rng.normal(0, 8, a.shape).astype(np.int16)
    b = np.clip(a.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    # grad is float-only (u8 has no gradient); float_input measures the
    # sanitised f32 kernel path (pair with call_kwargs allow_float).
    if impl == "grad" or float_input:
        a = a.astype(np.float32)
        b = b.astype(np.float32)
    a_dev = torch.from_numpy(a).to(dev)
    b_dev = torch.from_numpy(b).to(dev)
    run = make_runner(impl, with_map, precise=precise, relaxed=relaxed,
                      call_kwargs=call_kwargs, device=dev)

    def timed(it):
        v, seconds = run.timed(a_dev, b_dev, it)
        if not np.isfinite(v):
            raise RuntimeError(f"devicebench {impl}: the loop's sum is {v}")
        return seconds

    short, long_ = max(1, iters // 8), iters
    for it in (short, long_):  # warm-up (and, on CUDA, the capture)
        timed(it)

    samples = []
    for _ in range(reps):
        ts = min(timed(short) for _ in range(3))
        tl = min(timed(long_) for _ in range(3))
        dt = tl - ts
        if dt <= 0.01 * tl:
            continue  # noise swamped this delta; try another rep
        samples.append(batch * h * w * (long_ - short) / dt / 1e6)
    if not samples:
        raise RuntimeError("unstable measurement: every delta was noise-dominated")
    return float(np.median(samples))
