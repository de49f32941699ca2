"""Build and load the hand-written CUDA kernels in `csrc/`.

Each library of `LIBRARIES` compiles one `csrc/*.cu` source, with its own
extra nvcc flags, into a shared library with a plain C interface, loaded
with ctypes (no PyTorch headers, so a build takes seconds). Builds happen
at first use, never at import, into `build/` beside this package (listed in
.gitignore); the library name carries a hash of the source and the nvcc
flags, its own included, so an edited source or a change of flags never
loads a stale build. nvcc's messages, with ptxas's report of every
kernel's registers and spills (`-Xptxas -v`), are kept beside the library
(`log_path`). A failed build prints them and raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# ptxas's resource report, into the build's log; it changes no code
LOG_FLAGS = ("-Xptxas", "-v")
# {library: (source in csrc/, its extra nvcc flags)}. The probe's instances
# of ar_cluster.cu (its ablations and timer) build from the production
# source into a library of their own, so the production library keeps its
# instances and its build time.
LIBRARIES = {
    "ar_generate": ("ar_generate.cu", ()),
    "ar_cluster": ("ar_cluster.cu", ()),
    "ar_cluster_probe": ("ar_cluster.cu", ("-DAR_CLUSTER_PROBE",)),
    "ar_probe": ("ar_probe.cu", ()),
    "ring_probe": ("ring_probe.cu", ()),
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    source, flags = LIBRARIES[name]
    h = hashlib.sha1((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """nvcc's output for the current build of library `name`."""
    return _lib_path(name).with_suffix(".log")


def start(names=None) -> dict:
    """Start one nvcc for each named library (default: every one of
    `LIBRARIES`) that has no current build, all at once, and return the
    builds for `finish`."""
    if names is None:
        names = sorted(LIBRARIES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for n in names:
        path, proc, cmd = _lib_path(n), None, None
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            source, flags = LIBRARIES[n]
            cmd = [_nvcc(), *NVCC_FLAGS, *flags, *LOG_FLAGS, "-o", str(tmp),
                   str(CSRC / source)]
            with open(tmp.with_suffix(".log"), "w") as log:
                proc = subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT)
        started[n] = (path, proc, cmd)
    return started


def finish(started: dict) -> dict[str, Path]:
    """Wait for the builds `start` began. Returns {name: library path};
    each build's messages go to its `log_path`, and a failed build prints
    them to stderr and raises CalledProcessError (after every nvcc has
    ended)."""
    failed = None
    for path, proc, cmd in started.values():
        if proc is None:
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        code = proc.wait()
        if code == 0:
            os.replace(tmp, path)
            os.replace(tmp.with_suffix(".log"), path.with_suffix(".log"))
            continue
        sys.stderr.write(tmp.with_suffix(".log").read_text())
        if failed is None:
            failed = subprocess.CalledProcessError(code, cmd)
    if failed is not None:
        raise failed
    return {n: path for n, (path, _, _) in started.items()}


def build(names=None) -> dict[str, Path]:
    """Compile the named libraries (default: every one) that have no
    current build, one nvcc per library, all started together, and wait
    for them (`start`, then `finish`)."""
    return finish(start(names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (of `LIBRARIES`), built first if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
