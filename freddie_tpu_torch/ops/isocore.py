"""Loader for the native isoforms engine (native/isocore.cpp).

The C++ engine runs a whole tint (cluster-TSV parse -> consensus ->
boundary correction -> GTF records) in one call; the Python
implementation in stages.isoforms remains the semantic oracle and
transparent per-tint fallback (tests/test_isocore.py pins byte parity).
Set FREDDIE_ISOCORE=0 to force the Python path.
"""

from __future__ import annotations

import os

_mod = None
_failed = False


def load_isocore():
    """Build/load the isocore extension on first use; None when disabled
    or no toolchain is available (callers fall back to the Python path)."""
    global _mod, _failed
    if _mod is not None or _failed:
        return _mod
    if os.environ.get("FREDDIE_ISOCORE") == "0":
        _failed = True
        return None
    try:
        import sysconfig

        from ._build import import_extension, load_native

        inc = sysconfig.get_paths()["include"]
        _mod = load_native("isocore", "isocore.so", ["isocore.cpp"],
                           ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{inc}"],
                           import_extension)
    except Exception:
        _failed = True
        _mod = None
    return _mod


def tint_gtf_native(cluster_tsv: str, split_tsv: str, cfg):
    """One tint's GTF records via the native engine, in the
    tint_isoforms return shape [((chrom, start0), text), ...]; None when
    unavailable/disabled. Raises on parse/invariant failures (callers
    fall back to the Python path)."""
    if os.environ.get("FREDDIE_ISOCORE") == "0":
        return None
    eng = load_isocore()
    if eng is None:
        return None
    recs = eng.tint_gtf(
        cluster_tsv, split_tsv, float(cfg.majority_threshold),
        int(cfg.correction_window),
    )
    return [((chrom, start0), text) for chrom, start0, text in recs]
