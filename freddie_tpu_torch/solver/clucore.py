"""Loader for the consolidated native cluster engine (native/clucore.cpp).

The C++ engine runs a whole tint (parse -> preprocess -> partition ->
round loop -> cluster TSV) against the in-process solve_round core; the
Python implementations in io.tsv, stages.cluster and solver.two_phase
remain the semantic oracles and transparent fallbacks
(tests/test_clucore.py compares whole-stage outputs byte-for-byte).
Set FREDDIE_CLUCORE=0 to force the Python path.
"""

from __future__ import annotations

import os

_mod = None
_failed = False

# Sources compiled together so the engine shares the exact solver twins.
_SOURCES = ["clucore.cpp", "bnb_solver.cpp", "segenum.cpp", "round_solver.cpp"]


def load_clucore():
    """Build/load the clucore extension on first use; None when disabled
    or no toolchain is available (callers fall back to the Python path)."""
    global _mod, _failed
    if _mod is not None or _failed:
        return _mod
    if os.environ.get("FREDDIE_CLUCORE") == "0":
        _failed = True
        return None
    try:
        import sysconfig

        from ..ops._build import import_extension, load_native

        inc = sysconfig.get_paths()["include"]
        _mod = load_native("clucore", "clucore.so", _SOURCES,
                           ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{inc}"],
                           import_extension)
    except Exception:
        _failed = True
        _mod = None
    return _mod


def cluster_tint_native(in_path: str, cfg) -> bytes | None:
    """Run one tint through the native engine; None when unavailable,
    disabled, or the tint needs a Python escalation rung. Raises on
    parse/invariant failures (callers fall back to the Python path)."""
    if os.environ.get("FREDDIE_CLUCORE") == "0":
        return None
    eng = load_clucore()
    if eng is None:
        return None
    model = {"constant": 0, "exons": 1, "introns": 2}.get(cfg.recycle_model)
    if model is None:
        return None  # 'relative' raises in the Python path (dead code)
    # Same exact-decimal epsilon scaling as ClusterInstance.__post_init__.
    for sc in (10, 100, 1000, 10_000, 100_000):
        if abs(cfg.epsilon * sc - round(cfg.epsilon * sc)) < 1e-9:
            eps_scale = sc
            break
    else:
        return None
    eps_scaled = int(round(cfg.epsilon * eps_scale))
    from .segenum import BOUNDS_DEVICE_MIN, CLOSURE_CAP, CLOSURE_MAX_SEGS
    from .two_phase import NODE_BUDGET

    return eng.cluster_tint(
        in_path, model, eps_scale, eps_scaled, int(cfg.gap_offset),
        int(cfg.max_rounds), int(cfg.min_isoform_size), int(cfg.max_ilp),
        float(cfg.timeout) * 60.0, NODE_BUDGET, CLOSURE_MAX_SEGS,
        CLOSURE_CAP, BOUNDS_DEVICE_MIN,
    )
