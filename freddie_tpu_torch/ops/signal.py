"""Splice-signal smoothing, peak candidates, and segmentation refinement.

Host-side float path. Smoothing and peak detection use scipy (the same
library the reference calls at py/freddie_segment.py:755,615-621,249-266),
so plateau handling and float rounding are bit-identical to the reference.
This phase is deliberately host-only: the signals are short (tint
intervals), the cost is a tiny fraction of the stage, and the candidate
set feeds the padded shapes of the device DP -- producing it on host keeps
the float surface byte-identical without a device round trip.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import find_peaks


def smooth_signal(y_raw: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian smoothing of the raw splice signal (truncate=4.0, reflect)."""
    return gaussian_filter1d(y_raw, sigma, truncate=4.0)


def candidates_from_peaks(y: np.ndarray) -> list[int]:
    """Peak locations plus both endpoints (py/freddie_segment.py:615-621)."""
    c, _ = find_peaks(y)
    c = list(c)
    c.append(0)
    c.append(len(y) - 1)
    return sorted(set(c))


def smooth_and_candidates(
    y_raws: list[np.ndarray], sigma: float
) -> tuple[list[np.ndarray], list[list[int]]]:
    """smooth_signal + candidates_from_peaks for every interval of a tint
    in one native call (native/floatsig.c, bit-exact twin of the scipy
    path -- tests/test_floatsig.py fuzzes both against each other).
    Transparent scipy fallback; FREDDIE_FLOATSIG=0 forces it."""
    from .floatsig import gaussian_kernel, load_floatsig

    eng = None if os.environ.get("FREDDIE_FLOATSIG") == "0" else load_floatsig()
    if eng is not None and all(len(y) > 0 for y in y_raws):
        try:
            sm_bytes, cand_lists = eng.surface(
                [np.ascontiguousarray(y, dtype=np.float64) for y in y_raws],
                gaussian_kernel(sigma, 4.0),
            )
            smoothed = [np.frombuffer(b, dtype=np.float64) for b in sm_bytes]
            return smoothed, cand_lists
        except Exception:
            pass
    smoothed = [smooth_signal(y, sigma) for y in y_raws]
    return smoothed, [candidates_from_peaks(y) for y in smoothed]


def variance_threshold(smoothed: list[np.ndarray], variance_factor: float) -> float:
    """mean + k*std over the nonzero smoothed signal across all intervals
    (py/freddie_segment.py:757-759). An all-zero signal (nonspliced-only
    tints with ignore_ends) yields NaN, like the reference; every
    `signal > NaN` comparison is then False, so no candidate is fixed --
    the errstate only silences the cosmetic warning.

    The masked concatenate produces the same values in the same order as
    the reference's per-element list comprehension, so mean/std (numpy
    pairwise sums over an identical array) are bit-identical -- at numpy
    speed instead of a Python loop over every signal position."""
    if smoothed:
        vals = np.concatenate([y[y > 0] for y in smoothed])
    else:
        vals = np.array([], dtype=np.float64)
    import warnings

    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return vals.mean() + variance_factor * vals.std()


def break_large_problems(
    candidate_y_idxs: list[int],
    fixed_c_idxs: set[int],
    y: np.ndarray,
    max_problem_size: int,
    window: int = 5,
) -> set[int]:
    """Insert fixed breakpoints so no DP problem exceeds max_problem_size.

    For each oversized run between fixed candidates, anchors are placed at
    evenly spaced positions and snapped to the highest-signal candidate in
    [anchor-window, anchor+window) (py/freddie_segment.py:623-645; note the
    half-open window of the reference's range())."""
    from math import ceil

    pairs = sorted(fixed_c_idxs)
    for c_idx_s, c_idx_e in zip(pairs[:-1], pairs[1:]):
        problem_size = c_idx_e - c_idx_s + 1
        if problem_size <= max_problem_size:
            continue
        n_new = ceil(problem_size / max_problem_size)
        step = problem_size / n_new
        for i in range(1, n_new):
            mid = int(c_idx_s + i * step)
            best_v = float("-inf")
            best_c = None
            for c_idx in range(mid - window, mid + window):
                v = y[candidate_y_idxs[c_idx]]
                if v > best_v:
                    best_v = v
                    best_c = c_idx
            assert best_v > 0
            fixed_c_idxs.add(best_c)
    return fixed_c_idxs


def refine_segmentation(
    y_raw: np.ndarray,
    y_idxs: list[int],
    sigma: float,
    skip: int = 20,
    min_internal_splice: int = 20,
) -> list[int]:
    """Recover intra-segment splice sites the DP smoothed over
    (py/freddie_segment.py:249-266). Dispatches to the native twin
    (native/floatsig.c), which handles every segment whose peak
    priorities are all distinct and DEFERS exact-tie segments (common on
    integer-valued signals: identical isolated patterns smooth to equal
    peaks) back here with its smoothed signal -- the distance selection
    then runs with numpy's own argsort, whose tie order is the only
    unreproducible operation. The result is bit-exact vs the scipy body
    below in every case; the consumer sorts the merged list, so the
    deferred segments' append order is immaterial."""
    from .floatsig import gaussian_kernel, load_floatsig

    eng = None if os.environ.get("FREDDIE_FLOATSIG") == "0" else load_floatsig()
    if eng is not None:
        try:
            refine, ties = eng.refine(
                np.ascontiguousarray(y_raw, dtype=np.float64),
                [int(v) for v in y_idxs],
                gaussian_kernel(sigma, 1.0),
                float(sigma), int(skip), float(min_internal_splice),
            )
        except Exception:
            return refine_segmentation_scipy(y_raw, y_idxs, sigma, skip,
                                             min_internal_splice)
        for s, g_b, peaks in ties:
            g = np.frombuffer(g_b, dtype=np.float64)
            pk = np.asarray(peaks, dtype=np.intp)
            keep = _select_by_peak_distance(pk, g[pk], float(skip))
            for i in pk[keep]:
                lo = int(round(i - sigma))
                hi = int(round(i + sigma + 1))
                if sum(g[lo:hi].tolist()) < min_internal_splice:
                    continue
                refine.append(int(i) + s)
        return refine
    return refine_segmentation_scipy(y_raw, y_idxs, sigma, skip,
                                     min_internal_splice)


def _select_by_peak_distance(
    peaks: np.ndarray, priority: np.ndarray, distance: float
) -> np.ndarray:
    """scipy.signal._peak_finding_utils._select_by_peak_distance, mirrored
    statement for statement -- including `np.argsort(priority)` itself, so
    exact-priority ties resolve in the identical (numpy introsort/SIMD)
    order scipy would use."""
    import math

    n = len(peaks)
    distance_ = math.ceil(distance)
    keep = np.ones(n, dtype=bool)
    priority_to_position = np.argsort(priority)
    for i in range(n - 1, -1, -1):
        j = priority_to_position[i]
        if not keep[j]:
            continue
        k = j - 1
        while 0 <= k and peaks[j] - peaks[k] < distance_:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < n and peaks[k] - peaks[j] < distance_:
            keep[k] = False
            k += 1
    return keep


def refine_segmentation_scipy(
    y_raw: np.ndarray,
    y_idxs: list[int],
    sigma: float,
    skip: int = 20,
    min_internal_splice: int = 20,
) -> list[int]:
    """Scipy oracle for refine_segmentation: inside every final segment
    longer than 2*skip, zero the skip-margins, re-smooth with a tight
    kernel (truncate=1.0, constant padding) and keep peaks (min
    distance=skip) whose +-sigma local mass reaches min_internal_splice."""
    refine: list[int] = []
    for s, e in zip(y_idxs[:-1], y_idxs[1:]):
        if e - s <= 2 * skip:
            continue
        vals = np.array(y_raw[s:e], dtype=np.float64)
        vals[:skip] = 0.0
        vals[len(vals) - skip :] = 0.0
        if vals.sum() < min_internal_splice:
            continue
        g = gaussian_filter1d(vals, sigma, mode="constant", cval=0.0, truncate=1.0)
        for i in find_peaks(g, distance=skip)[0]:
            lo = int(round(i - sigma))
            hi = int(round(i + sigma + 1))
            # Left-to-right float sum, matching the reference's built-in sum()
            # over the slice (np.sum's pairwise order could differ in the
            # last ulp against the exact-integer threshold).
            if sum(g[lo:hi].tolist()) < min_internal_splice:
                continue
            refine.append(int(i) + s)
    return refine
