"""Build and load the package's native code at first use: the CUDA sources
(``csrc/``) and the C/C++ engines (``native/``, ``load_native``).

Each CUDA library is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` alone for ``sm_90a`` into ``freddie_tpu_torch/build/`` and loaded
with ``ctypes`` -- seconds per build, against minutes for an extension
that includes PyTorch's headers. The output name carries a hash of the
sources, so an edited kernel is never served from a stale library, and
the compiler writes to a temporary of its own process and thread
(``private_tmp``) that is renamed into place, so concurrent processes and
threads never load a half-written file nor rename each other's. A failed
build raises with the compiler's output. Each build or load is a
``build.<engine>`` span (``utils.metrics.span``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
# The C/C++ engines' sources and libraries; read at call time.
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
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


def private_tmp(path: str) -> str:
    """A temporary name beside ``path`` that no other process, and no
    other thread of this one, writes."""
    return f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"


def _compile(cmd: list[str], out: str) -> subprocess.CompletedProcess:
    """Runs the compiler command ``cmd`` with ``-o`` a private temporary,
    renamed to ``out`` where it succeeds."""
    tmp = private_tmp(out)
    try:
        proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc


def import_extension(path: str):
    """The Python extension module at ``path``, named by its file's stem."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(os.path.basename(path).split(".")[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_native(engine: str, lib: str, srcs: list[str], cmd: list[str], load,
                deps: tuple = (), libs: tuple = ()):
    """``load(path)`` of ``native/<lib>``, built first where it is missing
    or older than its sources ``native/<srcs>`` or ``native/<deps>``: the
    compiler command ``cmd``, the sources, then ``libs``. Raises where the
    build or the load fails (the engines' loaders then fall back)."""
    from ..utils.metrics import span

    with span("build." + engine):
        srcs = [os.path.join(NATIVE_DIR, s) for s in srcs]
        path = os.path.join(NATIVE_DIR, lib)
        newest = max(os.path.getmtime(p)
                     for p in srcs + [os.path.join(NATIVE_DIR, d) for d in deps])
        if not os.path.exists(path) or os.path.getmtime(path) < newest:
            proc = _compile([*cmd, *srcs, *libs], path)
            if proc.returncode != 0:
                raise RuntimeError(f"{cmd[0]} failed building {lib}:\n{proc.stderr}")
        return load(path)


def load_library(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu`` as a shared library."""
    if name in _loaded:
        return _loaded[name]
    from ..utils.metrics import span

    with span("build." + name):
        built = _load_library(name)
    _loaded[name] = built
    return built


def _load_library(name: str) -> Built:
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
        t0 = time.perf_counter()
        proc = _compile([find_nvcc(), *NVCC_FLAGS, src], lib_path)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n{log}"
            )
    return Built(ctypes.CDLL(lib_path), lib_path, seconds, log)
