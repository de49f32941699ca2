"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain
C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). Builds happen at first use, never at import, into `build/` beside
this package (listed in .gitignore); the library name carries a hash of the
source and the nvcc flags, so an edited source or a change of flags never
loads a stale build. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: every `csrc/*.cu`) that have no
    current build. Returns {name: library path}; nvcc's messages go to
    stderr, and a failed build raises CalledProcessError."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    for n, path in paths.items():
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                            str(CSRC / f"{n}.cu")], check=True)
            os.replace(tmp, path)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
