"""Build and load the package's CUDA sources (``csrc/``) at first use.

Each library is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` alone for ``sm_90a`` into ``freddie_tpu_torch/build/`` and loaded
with ``ctypes`` -- seconds per build, against minutes for an extension
that includes PyTorch's headers. The output name carries a hash of the
sources, so an edited kernel is never served from a stale library, and
the compiler writes to a per-process temporary that is renamed into
place, so concurrent processes never load a half-written file. A failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float  # nvcc wall time; 0.0 when an existing build was loaded
    log: str  # nvcc's output (ptxas register/shared-memory report)


_loaded: dict[str, Built] = {}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def load_library(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu`` as a shared library."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    sources = [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n{log}"
            )
        os.replace(tmp, lib_path)
    built = Built(ctypes.CDLL(lib_path), lib_path, seconds, log)
    _loaded[name] = built
    return built
