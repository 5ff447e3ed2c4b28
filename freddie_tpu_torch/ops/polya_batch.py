"""Batched polyA-run scoring on PyTorch.

Port of ``freddie_tpu/ops/polya_batch.py``. The reference scores each
soft-clip window with the Kadane recurrence s_i = max(0, s_{i-1} + m_i)
(match +1, mismatch -2), splits the scores into maximal positive runs and
keeps the run of highest purity among those of length >= 20 and purity
>= 0.85 (py/freddie_segment.py:352-367, 402-449).

The JAX module runs the recurrence as ``jax.lax.associative_scan``s,
which stable torch does not have. This module builds the same answer on
the closed form that the JAX module's numpy twin (``_scan_np``) already
proves, in whole-tensor ops with no Python loop over columns and no
device-to-host sync inside the scan:

- P_i = 3*cnt_i - 2*(i+1), the prefix sums of m with padding counted as
  a mismatch (it can only shrink a run toward its in-window best), and
  s = P - cummin([0, P]);
- a run starts where s > 0 and the previous column is not; runs are
  numbered by a cumsum of the starts over the flattened batch (a
  positive column 0 always starts a run, so no run straddles two rows);
- a run's best column is the max of the key s*(L+1) + col (highest score,
  ties to the latest column), taken with ``scatter_reduce("amax")`` over
  run ids, in place of ``np.maximum.reduceat``;
- the gates length >= 20 and 20*cnt >= 17*length are exact integers, and
  each row's winner is the highest purity with the earliest run winning
  ties, compared in float64 as the host scorer compares them (never
  float32: its ordering proof in the JAX module holds only for L <= 2048).

The bucketing (``_L_BUCKETS``, ``_pad_rows``, ``_MAX_ROWS``), the window
cap ``MAX_WINDOW`` and the bit-packed transfer are the JAX module's.
Results equal the per-window host scorer (``ops.polya``) on every window.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from .segdp import _Launch

# Windows longer than this score on the host (the vectorised numpy scan):
# long soft-clips are rare, and the device scan's exactness proof needs
# L <= 2048.
MAX_WINDOW = 256


def _scan_np(match: np.ndarray, lens: np.ndarray):
    """Numpy twin of _scan_batch for arbitrary window lengths (also the
    whole-batch path on a CPU device): fully vectorized, no Python loop
    over columns.

    The Kadane recurrence s_i = max(0, s_{i-1} + m_i) has the closed form
    s_i = P_i - min(0, P_0, ..., P_i) with P the prefix sums of m (the
    best suffix sum ending at i, empty suffix allowed), so the score
    matrix is one cumsum + one cummin. Runs (maximal s>0 stretches) are
    reduced with np.maximum.reduceat over the flattened matrix: gaps
    between runs carry key -1 (< every in-run key), so segments from one
    run start to the next are equivalent to exact run extents, and no
    segment straddles rows because a positive score at column 0 is
    always flagged as a run start (prev_pos there is defined False).
    Purity comparisons run in float64, exactly like the per-window host
    scorer (ops.polya.longest_poly_runs + max by purity with the
    earliest-closed run winning ties); returns the same
    (found, first, length, cnt) contract as the device scan."""
    B0, L = match.shape
    valid0 = np.arange(L, dtype=np.int32)[None, :] < lens[:, None]
    best_first = np.zeros(B0, np.int64)
    best_len = np.zeros(B0, np.int64)
    best_cnt = np.zeros(B0, np.int64)

    # Exact pre-filter: a qualifying run needs length >= 20 and
    # 20*cnt >= 17*length => cnt >= 17 matches, so rows with a shorter
    # window or fewer total matches can never produce one. Noisy
    # soft-clip windows are mostly junk, so this removes the bulk of the
    # batch before the multi-pass scan arithmetic.
    active = np.flatnonzero(
        (lens >= 20) & ((match & valid0).sum(axis=1) >= 17)
    )
    if active.size == 0:
        return np.zeros(B0, bool), best_first, best_len, best_cnt
    match = match[active] & valid0[active]
    B = len(active)

    # With padding masked to mismatch, every score step is m_i = 3*match-2
    # (padding scores decay like mismatches: runs can only shrink toward
    # their in-window best, never start or improve past `lens`, so
    # results are unchanged), and the prefix sums come straight from the
    # match-count prefix: P_i = 3*cnt_i - 2*(i+1). |P| <= 2L and
    # key <= L*(L+1), so everything fits int32.
    assert L < 32768
    cnt_prefix = np.cumsum(match, axis=1, dtype=np.int32)
    P = 3 * cnt_prefix - np.arange(2, 2 * L + 2, 2, dtype=np.int32)[None, :]

    prefmin = np.minimum.accumulate(
        np.concatenate([np.zeros((B, 1), np.int32), P], axis=1), axis=1
    )
    s = P - prefmin[:, 1:]

    pos = s > 0
    prev_pos = np.zeros_like(pos)
    prev_pos[:, 1:] = pos[:, :-1]
    start = pos & ~prev_pos
    starts_flat = np.flatnonzero(start.ravel())
    if starts_flat.size == 0:
        return np.zeros(B0, bool), best_first, best_len, best_cnt

    # Per-run best position: key = s*(L+1)+col (max s, ties -> latest col,
    # the reference's max(zip(S, i))); -1 outside runs.
    cols = np.arange(L, dtype=np.int32)[None, :]
    key = np.where(pos, s * np.int32(L + 1) + cols, np.int32(-1)).ravel()
    runbest = np.maximum.reduceat(key, starts_flat)

    run_row = starts_flat // L
    first = starts_flat % L
    best_col = runbest % (L + 1)
    length = best_col + 1 - first
    cnt = cnt_prefix[run_row, best_col] - np.where(
        first > 0, cnt_prefix[run_row, np.maximum(first - 1, 0)], 0
    )
    ok = (length >= 20) & (20 * cnt >= 17 * length)
    purity = np.where(ok, cnt / np.maximum(length, 1), -1.0)

    # Per-row winner: max purity, earliest run on ties (runs are in
    # ascending (row, first) order, so "first run attaining the row max"
    # reproduces the sequential strict-> update).
    grp_starts = np.flatnonzero(np.concatenate([[True], np.diff(run_row) != 0]))
    pmax = np.maximum.reduceat(purity, grp_starts)
    run_idx = np.arange(len(run_row), dtype=np.int64)
    grp_of_run = np.cumsum(np.concatenate([[True], np.diff(run_row) != 0])) - 1
    is_win = purity == pmax[grp_of_run]
    winner = np.minimum.reduceat(
        np.where(is_win, run_idx, len(run_row)), grp_starts
    )
    grp_row = run_row[grp_starts]
    grp_found = pmax > -1.0
    w = winner[grp_found]
    rows_found = active[grp_row[grp_found]]  # back to pre-filter rows
    found = np.zeros(B0, bool)
    found[rows_found] = True
    best_first[rows_found] = first[w]
    best_len[rows_found] = length[w]
    best_cnt[rows_found] = cnt[w]
    return found, best_first, best_len, best_cnt


_L_BUCKETS = (64, MAX_WINDOW)
_MAX_ROWS = 8192  # rows per scan: bounds the scan's temporaries; callers chunk


def _pad_rows(b: int) -> int:
    """Round the batch dim to a coarse bucket so the shape set stays tiny
    across calls (the scan itself is cheap, so padding waste is the
    right trade; the buckets are the JAX module's). Callers chunk at
    _MAX_ROWS, so the full shape set is {1024, 8192} x _L_BUCKETS."""
    for p in (1024, _MAX_ROWS):
        if b <= p:
            return p
    raise AssertionError(f"chunk rows {b} > {_MAX_ROWS}")

# Calls of the torch scan (``_scan_batch``), on any device: a run reads it
# to show that the batched route ran.
SCANS = 0


def _scan_batch_packed(packed: torch.Tensor, lens: torch.Tensor):
    """``packed`` (B, L//8) uint8, np.packbits of the match mask (big bit
    order), ``lens`` (B,) window lengths: unpack on the device, then scan."""
    B, L8 = packed.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    match = ((packed[:, :, None] >> shifts) & 1).reshape(B, L8 * 8) != 0
    valid = torch.arange(L8 * 8, device=packed.device)[None, :] < lens[:, None]
    return _scan_batch(match, valid)


def _scan_batch(match: torch.Tensor, valid: torch.Tensor):
    """For (B, L) bool ``match``/``valid`` masks (L >= 1), each window's
    best run under the reference's rules: (found, first, length, cnt), (B,)
    int64 each, zero where nothing was found. Same contract as the JAX
    module's ``_scan_batch`` and ``_scan_np``."""
    global SCANS
    SCANS += 1
    B, L = match.shape
    dev = match.device
    cols = torch.arange(L, dtype=torch.int64, device=dev)
    cnt = torch.cumsum((match & valid).to(torch.int64), dim=1)  # matches in [0, i]
    P = 3 * cnt - 2 * (cols + 1)
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    s = P - torch.cummin(torch.cat([zero, P], dim=1), dim=1).values[:, 1:]

    pos = s > 0
    before = torch.zeros_like(pos)
    before[:, 1:] = pos[:, :-1]
    after = torch.zeros_like(pos)
    after[:, :-1] = pos[:, 1:]
    start = pos & ~before
    end = pos & ~after

    # Run ids over the flattened batch; columns outside runs fall in the
    # slot of the run before them (or slot 0) with a neutral value.
    slot = (torch.cumsum(start.reshape(-1).to(torch.int64), 0) - 1).clamp_min(0)
    key = torch.where(pos, s * (L + 1) + cols, -1).reshape(-1)
    run_key = torch.full((B * L,), -1, dtype=torch.int64, device=dev)
    run_key.scatter_reduce_(0, slot, key, "amax")
    run_first = torch.zeros((B * L,), dtype=torch.int64, device=dev)
    run_first.scatter_reduce_(0, slot, torch.where(start, cols, 0).reshape(-1), "amax")

    # Every run's candidate sits at its last column.
    first = run_first[slot].reshape(B, L)
    best_col = (run_key[slot].reshape(B, L) % (L + 1)).clamp(0, L - 1)
    length = best_col + 1 - first
    before_first = cnt.gather(1, (first - 1).clamp_min(0))
    n_match = cnt.gather(1, best_col) - torch.where(first > 0, before_first, 0)
    cand = end & (length >= 20) & (20 * n_match >= 17 * length)
    purity = torch.where(
        cand, n_match.to(torch.float64) / length.clamp_min(1).to(torch.float64), -1.0
    )
    pmax = purity.amax(dim=1)
    found = pmax > 0
    win = torch.where(purity == pmax[:, None], cols, L - 1).amin(dim=1, keepdim=True)

    def take(a):
        return torch.where(found, a.gather(1, win)[:, 0], 0)

    return found.to(torch.int64), take(first), take(length), take(n_match)


def best_poly_batch(windows: list[str], chars: list[str], device="cuda"):
    """For each (window, target char) pair, the reference's best run or
    None: a list of (first, length, count_of_char) tuples.

    Windows longer than MAX_WINDOW go to the host scorer. The rest are
    bucketed by padded length (``_L_BUCKETS``) in chunks of at most
    ``_MAX_ROWS`` rows: on a CUDA device every chunk's scan is enqueued
    before the first readback; on the CPU they take the host scorer,
    unless FREDDIE_POLYA_DEVICE is set, which runs the torch scan there
    (the plain version the tests hold the JAX scan against)."""
    from .polya import _load_ctok

    dev = resolve_device(device)
    ctok = _load_ctok()
    if ctok is not None and not hasattr(ctok, "best_run"):
        ctok = None
    n = len(windows)
    results: list[tuple[int, int, int] | None] = [None] * n

    def keep(rows, found, first, length, cnt):
        for r, i in enumerate(rows):
            if found[r]:
                results[i] = (int(first[r]), int(length[r]), int(cnt[r]))

    def match_grid(rows, L, B):
        """The rows' windows as a (B, L) bool grid of target-char matches
        (rows past ``len(rows)`` empty) and their lengths."""
        lens = np.zeros(B, dtype=np.int32)
        lens[: len(rows)] = [len(windows[i]) for i in rows]
        grid = np.zeros((B, L), dtype=np.uint8)
        grid[np.arange(L, dtype=np.int32)[None, :] < lens[:, None]] = np.frombuffer(
            "".join(windows[i] for i in rows).encode(), dtype=np.uint8
        )
        target = np.zeros((B, 1), dtype=np.uint8)
        target[: len(rows), 0] = [ord(chars[i]) for i in rows]
        return grid == target, lens

    def host_score(rows):
        """The C Kadane scorer when built, else ``_scan_np`` over
        length-sorted chunks; the same results either way."""
        if ctok is not None:
            for i in rows:
                r = ctok.best_run(windows[i], 0, len(windows[i]), 0, chars[i])
                if r is not None:
                    results[i] = r
            return
        rows = sorted(rows, key=lambda i: len(windows[i]))
        for lo in range(0, len(rows), 1024):
            chunk = rows[lo : lo + 1024]
            match, lens = match_grid(chunk, max(len(windows[i]) for i in chunk), len(chunk))
            keep(chunk, *_scan_np(match, lens))

    host_score([i for i in range(n) if len(windows[i]) > MAX_WINDOW])
    buckets: dict[int, list[int]] = {}
    for i in range(n):
        lw = len(windows[i])
        if 0 < lw <= MAX_WINDOW:
            buckets.setdefault(next(e for e in _L_BUCKETS if lw <= e), []).append(i)
    if dev.type == "cpu" and not os.environ.get("FREDDIE_POLYA_DEVICE"):
        for _L, rows in sorted(buckets.items()):
            host_score(rows)
        return results

    pending = []
    for L, rows_all in sorted(buckets.items()):
        for lo in range(0, len(rows_all), _MAX_ROWS):
            rows = rows_all[lo : lo + _MAX_ROWS]
            match, lens = match_grid(rows, L, _pad_rows(len(rows)))
            packed = np.packbits(match, axis=1)
            out = _scan_batch_packed(torch.from_numpy(packed).to(dev),
                                     torch.from_numpy(lens).to(dev))
            pending.append((rows, _Launch(torch.stack(out))))
    for rows, launch in pending:
        keep(rows, *np.asarray(launch))
    return results


def annotate_gaps_and_polya_batch(items: list[tuple], device="cuda") -> list[list[str]]:
    """Batched ``ops.polya.annotate_gaps_and_polya`` over many reads:
    ``items`` are (data, segs, intervals, seq, strand) tuples; returns each
    read's sorted token list.

    Every read's scans (start and end window, A and T) go to one
    ``best_poly_batch`` call on ``device``. A beats T on equal purity, in
    the host's float64 arithmetic, and the tokens come from the shared
    ``emit_tokens``, so the output is byte-identical to the host path."""
    from .polya import _REV_COMP, clip_context, emit_tokens, poly_window

    ctxs: list[tuple | None] = []
    slots: list[dict | None] = []
    windows: list[str] = []
    chars: list[str] = []
    for data, segs, intervals, seq, strand in items:
        ctx = clip_context(data, segs, intervals, seq)
        ctxs.append(ctx)
        if ctx is None:
            slots.append(None)
            continue
        q_ssc, q_esc, _runs = ctx
        reqs: dict[str, tuple[int, int] | None] = {}
        for side, (lo, hi) in (("s", (0, q_ssc)), ("e", (q_esc, len(seq)))):
            if hi - lo < 20:
                reqs[side] = None  # no run of length >= 20 fits
                continue
            # The A and T scans share one window; only the char differs.
            w, c_a = poly_window(seq, lo, hi, strand, "A")
            reqs[side] = (len(windows), len(windows) + 1)
            windows += [w, w]
            chars += [c_a, _REV_COMP[c_a]]
        slots.append(reqs)

    results = best_poly_batch(windows, chars, device)

    def select(req):
        if req is None:
            return None
        best, best_p = None, -1.0
        for char, ridx in zip(("A", "T"), req):
            r = results[ridx]
            if r is not None and r[2] / r[1] > best_p:  # strict: A wins ties
                best_p = r[2] / r[1]
                best = (r[0], r[1], char)
        return best

    out: list[list[str]] = []
    for (_data, segs, intervals, seq, _strand), ctx, reqs in zip(items, ctxs, slots):
        if ctx is None:
            out.append([])
            continue
        q_ssc, q_esc, runs = ctx
        out.append(emit_tokens(q_ssc, q_esc, runs, select(reqs["s"]), select(reqs["e"]),
                               segs, intervals, len(seq)))
    return out
