"""Build and load the port's native libraries, bound with ctypes: the CUDA
kernels (nvcc into a plain C shared library) and the host backend (g++).

No counterpart in the JAX package: there Mosaic compiles the Pallas
kernels at trace time. Here `nvcc` compiles `ssim_tpu_torch/csrc/*.cu`
(which include the shared `*.cuh` headers) for `sm_90a` at first use, one
process per `.cu` file, all started together,
and links them into one library in `ssim_tpu_torch/_build/`, keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing runs at import time: this
module is imported on machines without `nvcc` or a GPU, and only
`load_library` needs them.

The host backend (`ops/host.py`) is `csrc/host/ssim_host.cpp`, built by
`build_host` with the JAX package's `native/Makefile` flags into the
same directory, keyed by a hash of its source, compiler and flags, the
compiler's version and the CPU target that `-march=native` selects.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: No --use_fast_math: it flushes subnormals and approximates division.
#: --fmad=false keeps every multiply and add rounded on its own, as the
#: plain twin's PyTorch operations round them, so the kernel's per-pixel
#: values can be held against the twin's bit for bit (built both ways, the
#: kernel ran no faster with fused multiply-adds on an H100).
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def sources():
    """The kernel sources, sorted, as absolute paths: the translation
    units (`.cu`) and the headers they include (`.cuh`). All are hashed
    into the library's name, so an edited header rebuilds."""
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def translation_units():
    """The sources nvcc compiles, one object each: the `.cu` files only (a
    header is compiled as part of each file that includes it)."""
    return [src for src in sources() if src.endswith(".cu")]


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "source at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libssim_kernels_{_digest()}.so")


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails; return their outputs joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}"
            )
    return "".join(outs)


def build() -> str:
    """Compile the sources unless this digest is already built; returns
    the library's path. The compiler's output (ptxas register and
    shared-memory report) is kept beside it as `<lib>.log`."""
    out = library_path()
    if os.path.isfile(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Objects go to a private directory and the library is linked there
    # and renamed: concurrent builds never load a half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        units = translation_units()
        objs = [os.path.join(work, os.path.basename(src) + ".o")
                for src in units]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                        for src, obj in zip(units, objs)])
        tmp = os.path.join(work, "lib.so")
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            d = ctypes.c_double
            # partials is untyped: f32 in the standard, components,
            # batch and row modes, f64 in the precise modes. c1 and c2
            # are doubles, so the precise formula sees them unrounded.
            # Both entries take the relaxed flag, four halo-operand
            # pointers (NULL without them) and the is_top / is_bot flags;
            # the forward's seg (after groups) picks the streaming kernel.
            lib.ssim_fwd_launch.argtypes = [
                i, i, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                i, i, i, i, i, p, d, d, f, p,
            ]
            lib.ssim_fwd_launch.restype = i
            # The batch modes' packed stream: precise, relaxed, is_float, a,
            # b, partials, pieces (or NULL), B, H, W, k, segment rows, r,
            # taps, c1, c2, clip_bound, stream.
            lib.ssim_fwd_batch_launch.argtypes = [
                i, i, i, p, p, p, p, i, i, i, i, i, i, p, d, d, f, p,
            ]
            lib.ssim_fwd_batch_launch.restype = i
            # precise, relaxed, is_float, r, W, k, out: blocks per SM of the
            # batch stream at radius r for W-wide images packed k to a row.
            lib.ssim_fwd_batch_occupancy.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
            lib.ssim_fwd_batch_occupancy.restype = i
            # mode, relaxed, is_float, r, out: blocks per SM of the
            # streaming forward at radius r.
            lib.ssim_fwd_stream_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
            lib.ssim_fwd_stream_occupancy.restype = i
            # The backward entry takes the NaN tile (TH, TW), the
            # streaming kernels' segment rows S and strip columns SW, and
            # the scratch of the standard two-pass stream (or NULL).
            lib.ssim_bwd_launch.argtypes = [
                i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                p, p, p, f, f, f, p,
            ]
            lib.ssim_bwd_launch.restype = i
            # relaxed, r, gmap, strip columns, out: blocks per SM of the
            # streaming kernel, the standard one or the relaxed one.
            lib.ssim_bwd_stream_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
            lib.ssim_bwd_stream_occupancy.restype = i
            # r, gmap, two_pass, out: blocks per SM of the standard stream
            # at a radius other than 5, the two-pass one or the one-pass one.
            lib.ssim_bwd_std_rt_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
            lib.ssim_bwd_std_rt_occupancy.restype = i
            # x, out, itemsize, B, H, W, hp, wp, stream.
            lib.pad_align_launch.argtypes = [p, p, i, i, i, i, i, i, p]
            lib.pad_align_launch.restype = i
            _lib = lib
        return _lib


HOST_SOURCE = os.path.join(CSRC_DIR, "host", "ssim_host.cpp")
#: The compiler and flags of `native/Makefile`: g++ from PATH (not $CXX,
#: which may name a compiler without OpenMP).
HOST_CXX = "g++"
HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17", "-shared")


def _host_target() -> bytes:
    """The compiler's version and the target that HOST_FLAGS select on
    this machine (what -march=native resolves to, each ISA extension on or
    off), so that a build directory carried to another CPU or compiler is
    not loaded there; empty where the compiler does not run."""
    out = b""
    for args in (["--version"], [*HOST_FLAGS, "-Q", "--help=target"]):
        try:
            out += subprocess.run([HOST_CXX, *args], stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, timeout=60).stdout
        except (OSError, subprocess.TimeoutExpired):
            pass
    return out


def host_library_path() -> str:
    h = hashlib.sha256(" ".join((HOST_CXX,) + HOST_FLAGS).encode())
    h.update(_host_target())
    with open(HOST_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libssim_host_{h.hexdigest()[:16]}.so")


def build_host() -> str:
    """Compile the host backend unless this digest is already built;
    returns the library's path. Raises RuntimeError with the compiler's
    message when the build fails."""
    out = host_library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, "lib.so")
        cmd = [HOST_CXX, *HOST_FLAGS, "-o", tmp, HOST_SOURCE]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from None
        if proc.returncode != 0:
            raise RuntimeError(
                f"{HOST_CXX} failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    return out
