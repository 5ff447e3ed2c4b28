"""Loader for the native float-surface twin (native/floatsig.c).

The C module replicates the scipy calls of ops/signal.py bit-for-bit
(correlate1d's symmetric inner loop, _local_maxima_1d plateau handling,
_select_by_peak_distance) and returns None from refine() when two peak
priorities tie exactly -- the only case where numpy's argsort order is
observable -- so the caller falls back to scipy for that interval
(content-only dispatch). Set FREDDIE_FLOATSIG=0 to force the scipy path.

The Gaussian kernel weights are computed HERE with the exact numpy
expression scipy's _gaussian_kernel1d uses (arange -> exp -> normalize),
so the C side never evaluates exp() and cannot diverge from scipy's
kernel in the last ulp.
"""

from __future__ import annotations

import os

import numpy as np

_mod = None
_failed = False


_kernel_cache: dict[tuple[float, float], bytes] = {}


def gaussian_kernel(sigma: float, truncate: float) -> bytes:
    """scipy.ndimage._filters._gaussian_kernel1d(sigma, 0, lw) as raw
    float64 bytes, computed with the same numpy operations (bit-identical
    by construction); the [::-1] reversal scipy applies before correlate1d
    is a bitwise no-op on this exactly-symmetric kernel. Cached per
    (sigma, truncate) -- one or two kernels per run."""
    key = (float(sigma), float(truncate))
    got = _kernel_cache.get(key)
    if got is None:
        sd = float(sigma)
        lw = int(truncate * sd + 0.5)
        sigma2 = sigma * sigma
        x = np.arange(-lw, lw + 1)
        phi_x = np.exp(-0.5 / sigma2 * x ** 2)
        phi_x = phi_x / phi_x.sum()
        got = _kernel_cache[key] = phi_x.tobytes()
    return got


def load_floatsig():
    """Build/load the floatsig extension on first use; None when disabled
    or no toolchain is available (callers fall back to scipy)."""
    global _mod, _failed
    if _mod is not None or _failed:
        return _mod
    if os.environ.get("FREDDIE_FLOATSIG") == "0":
        _failed = True
        return None
    try:
        import importlib.util
        import subprocess
        import sysconfig

        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        src = os.path.join(root, "native", "floatsig.c")
        lib = os.path.join(root, "native", "floatsig.so")
        if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
            inc = sysconfig.get_paths()["include"]
            # -ffp-contract=off: no FMA contraction may alter the float
            # sums vs scipy's binaries. Per-pid temp + atomic os.replace.
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(
                ["gcc", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                 f"-I{inc}", "-o", tmp, src],
                check=True, capture_output=True,
            )
            os.replace(tmp, lib)
        spec = importlib.util.spec_from_file_location("floatsig", lib)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    except Exception:
        _failed = True
        _mod = None
    return _mod
