"""Cumulative coverage of read representatives over candidate segments.

Port of ``freddie_tpu/ops/coverage.py``. ``cumulative_coverage`` is the
host version (numpy, as it is there): for candidate breakpoint indices
``cands`` (y-space, sorted, within one tint interval),

    C[c, r] = number of bases of read-rep r lying before candidate c
              (counting each aligned interval inclusively on both ends),

so C[j] - C[i] is the coverage of rep r strictly between candidates i and
j; shapes are (n_cands + 1, n_reps), row 0 the coverage before the first
candidate.

``build_coverage_device`` builds C on the device in plain PyTorch. The DP
kernels consume C only through differences C[k] - C[p], and C has the
closed form

    C[c, r] = sum over intervals i of rep r of
              max(0, min(ye_i, cands[c] - 1) - ys_i + 1)

(proof in the JAX module), so a problem's C is built on the device from
its (I, 3) interval list: a clamp, then an integer scatter-add over the
rep index. Exact, and order-independent even with atomics. JAX computes
it in XLA, not in a Pallas kernel, so plain PyTorch is its port.
"""

from __future__ import annotations

import numpy as np
import torch


def cumulative_coverage(
    starts: np.ndarray,  # (n_iv,) read-rep interval starts, y-space
    ends: np.ndarray,  # (n_iv,) read-rep interval ends, y-space (inclusive span s..e)
    reps: np.ndarray,  # (n_iv,) read-rep index of each interval
    n_reps: int,
    cands: np.ndarray,  # (P,) sorted candidate y indices
    validate: bool = False,
) -> np.ndarray:
    P = len(cands)
    C = np.zeros((P + 1, n_reps), dtype=np.int64)
    if len(starts) == 0:
        return C
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    reps = np.asarray(reps, dtype=np.int64)
    cands = np.asarray(cands, dtype=np.int64)

    s_idx = np.searchsorted(cands, starts, side="right")
    e_idx = np.searchsorted(cands, ends, side="right")
    same = s_idx == e_idx
    m = ~same

    # Head/tail pieces of intervals spanning >= 2 candidate segments, and
    # whole inclusive lengths of intervals inside one segment. All three
    # scatters go through one bincount over flattened (row, rep) indices
    # (much faster than np.add.at); float64 weights are exact for integer
    # sums below 2^53, far above any real coverage total.
    head = cands[s_idx[m]] - starts[m]
    tail = ends[m] - cands[e_idx[m] - 1] + 1
    if validate:
        assert np.all(head > 0) and np.all(tail > 0)
    size = (P + 1) * n_reps
    idx_all = np.concatenate(
        [s_idx[same] * n_reps + reps[same],
         s_idx[m] * n_reps + reps[m],
         e_idx[m] * n_reps + reps[m]]
    )
    w_all = np.concatenate([ends[same] - starts[same] + 1, head, tail])
    C += np.bincount(idx_all, weights=w_all, minlength=size).astype(
        np.int64
    ).reshape(P + 1, n_reps)

    # Full middle segments: candidate gaps times the span count, built with a
    # difference array over rows (+1 at the first full row, -1 past the last).
    n_m = int(m.sum())
    span_idx = np.concatenate(
        [(s_idx[m] + 1) * n_reps + reps[m], e_idx[m] * n_reps + reps[m]]
    )
    span_w = np.concatenate([np.ones(n_m), -np.ones(n_m)])
    span = np.bincount(span_idx, weights=span_w, minlength=size).astype(
        np.int64
    ).reshape(P + 1, n_reps)
    span = np.cumsum(span, axis=0)
    gaps = np.zeros(P + 1, dtype=np.int64)
    gaps[1:P] = cands[1:] - cands[:-1]
    C += span * gaps[:, None]

    if validate:
        total = int((ends - starts + 1).sum())
        assert C.sum() == total, (C.sum(), total)
    np.cumsum(C, axis=0, out=C)
    return C


def build_coverage_device(iv: torch.Tensor, y: torch.Tensor, n_reps: int) -> torch.Tensor:
    """C (B, P, R) int32 on iv's device from interval lists.

    iv: (B, I, 3) int32 [ys, ye, rep], padding rows carry rep == n_reps
    (they land in a dropped row); y: (B, P) int32 candidate positions.
    Value-compatible with cumulative_coverage up to a per-(problem, rep)
    additive constant that cancels in every kernel."""
    B, I, _ = iv.shape
    P = y.shape[1]
    ys, ye, rep = iv[..., 0], iv[..., 1], iv[..., 2]  # (B, I)
    ov = (
        torch.minimum(ye[:, :, None], y[:, None, :] - 1) - ys[:, :, None] + 1
    ).clamp_min(0)  # (B, I, P)
    seg = torch.zeros((B, n_reps + 1, P), dtype=ov.dtype, device=iv.device)
    seg.scatter_add_(1, rep.long()[:, :, None].expand(B, I, P), ov)
    return seg[:, :n_reps, :].transpose(1, 2).contiguous().to(torch.int32)
