"""Compares two builds of the port's kernels, function by function, in SASS.

    python -m ssim_tpu_torch.tools.sass_diff LIB_A LIB_B [--lines N]

LIB_A and LIB_B are shared libraries that `ssim_tpu_torch.ops._build`
built, for example this checkout's and another's:

    python -c "from ssim_tpu_torch.ops import _build; print(_build.build())"
    cd /path/to/other && python -c "from ssim_tpu_torch.ops import _build; print(_build.build())"

Runs `cuobjdump -sass` on both (on a machine with the CUDA toolkit), splits
each into its kernels, keeps each instruction's text (not its address or
encoding) and drops the per-file hash of the anonymous namespace from the
kernels' names (and the row stream's radius argument at 5, `kR =
kStreamR` of `ssim_fwd_stream_kernel<T, mode, split, kR>` and its
`StreamTaps<P, kR>`, so that a build from before that argument existed
compares kernel by kernel; between two later builds the rewrite changes
nothing), then prints the kernels found in only one build and those
whose instructions differ (with --lines N, the first N lines of each
one's unified diff), and one JSON line {"equal": n, "differ": [...],
"only_a": [...], "only_b": [...]}. Exit status 0 either way.
"""

import difflib
import json
import os
import re
import subprocess
import sys

#: The anonymous namespace's mangled name: a length, then
#: _GLOBAL__N__<hash>_<len>_<file>_<hash>.
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_[0-9a-f]{8}")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
#: The row stream's register-window radius as a template argument, in the
#: kernel's name and in its StreamTaps parameter (by value or as a
#: reference to the template argument), for builds from before it.
_RADIUS_ARG = ((re.compile(r"(22ssim_fwd_stream_kernelI\w(?:Li\d+E){2})Li5EE"), r"\1E"),
               (re.compile(r"(10StreamTapsIS\w*?_)(?:XT2_E|Li5E)"), r"\1"))


def cuobjdump():
    """cuobjdump beside nvcc (CUDA_HOME, /usr/local/cuda or PATH)."""
    from ..ops import _build

    return os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")


def kernels(lib):
    """{normalised kernel name: [instruction text, ...]} of a library."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = _ANON.sub("N_", line.split("Function : ", 1)[1].strip())
            for pattern, repl in _RADIUS_ARG:
                name = pattern.sub(repl, name)
            funcs[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                funcs[name].append(m.group(1))
    return funcs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    lines = 0
    if len(argv) == 4 and argv[2] == "--lines":
        lines, argv = int(argv[3]), argv[:2]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = kernels(argv[0]), kernels(argv[1])
    differ = sorted(n for n in a.keys() & b.keys() if a[n] != b[n])
    only_a, only_b = sorted(a.keys() - b.keys()), sorted(b.keys() - a.keys())
    for title, names in (("differ", differ), ("only in A", only_a), ("only in B", only_b)):
        for n in names:
            print(f"{title}: {n}")
            if title == "differ" and lines:
                diff = list(difflib.unified_diff(a[n], b[n], lineterm="", n=1))
                print(f"  {len(a[n])} / {len(b[n])} instructions")
                for d in diff[2:2 + lines]:
                    print(f"  {d}")
    equal = len(a.keys() & b.keys()) - len(differ)
    print(f"{equal} kernels equal, {len(differ)} differ, {len(only_a)} only in A, "
          f"{len(only_b)} only in B")
    print(json.dumps({"equal": equal, "differ": differ, "only_a": only_a,
                      "only_b": only_b}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
