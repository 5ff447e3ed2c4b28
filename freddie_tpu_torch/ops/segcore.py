"""Loader for the consolidated native segment host engine (native/segcore.cpp).

The C++ engine replaces the per-tint Python hot path of the segment stage
(parse -> splice signal -> coverage -> genotype -> polyA -> TSV format)
with three C calls per tint; the Python implementations in io.tsv,
stages.segment, ops.coverage and ops.polya remain the semantic oracles and
transparent fallbacks (tests/test_segcore.py compares whole-stage outputs
byte-for-byte). Set FREDDIE_SEGCORE=0 to force the Python path.
"""

from __future__ import annotations

import os

_mod = None
_failed = False


def load_segcore():
    """Build/load the segcore extension on first use; None when disabled or
    no toolchain is available (callers fall back to the Python path)."""
    global _mod, _failed
    if _mod is not None or _failed:
        return _mod
    if os.environ.get("FREDDIE_SEGCORE") == "0":
        _failed = True
        return None
    try:
        import importlib.util
        import subprocess
        import sysconfig

        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        src = os.path.join(root, "native", "segcore.cpp")
        lib = os.path.join(root, "native", "segcore.so")
        if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
            inc = sysconfig.get_paths()["include"]
            # Compile to a per-pid temp and os.replace (atomic on POSIX):
            # concurrent processes (multi-host pipelines, the scaling
            # bench) must never dlopen a half-written .so.
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{inc}",
                 "-o", tmp, src],
                check=True, capture_output=True,
            )
            os.replace(tmp, lib)
        spec = importlib.util.spec_from_file_location("segcore", lib)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    except Exception:
        _failed = True
        _mod = None
    return _mod
