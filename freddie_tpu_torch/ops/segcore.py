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
        import sysconfig

        from ._build import import_extension, load_native

        inc = sysconfig.get_paths()["include"]
        _mod = load_native("segcore", "segcore.so", ["segcore.cpp"],
                           ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{inc}"],
                           import_extension)
    except Exception:
        _failed = True
        _mod = None
    return _mod
