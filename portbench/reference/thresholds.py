"""The coverage thresholds as the original freddie states them, in float64.

py/freddie_segment.py:277-286 tabulates a logistic ramp of the high
threshold by segment length, rounded to two decimals; a segment of
length L (``y[j] - y[i] + 1``) with coverage c reads "yes" where
``c / L > h`` and "no" where ``c / L < 1 - h``, with ``h = table[L]``
below the table's length and the rate beyond it. Everything here is
float64, as the original computes it: the program's scaled-integer
compare must reach the same decisions. In float32 (the control) a ratio
that lands exactly on 1 - h can read otherwise: fl32(1 - fl32(0.9)) lies
above fl32(0.1), where float64's 1 - 0.9 lies below 0.1.
"""

from __future__ import annotations

from math import exp

import torch


def smooth_threshold_table(threshold: float) -> list[float]:
    """Entry x is the high threshold for a segment of length x, rounded to
    two decimals; the table stops once x*(threshold - y) < 0.5 (x > 5)."""
    vals: list[float] = []
    while True:
        x = len(vals)
        y = threshold / (1 + ((threshold - 0.5) / 0.5) * exp(-0.05 * x))
        if x > 5 and x * (threshold - y) < 0.5:
            break
        vals.append(round(y, 2))
    return vals


def high_threshold(seg_len: torch.Tensor, rate: float, dtype=torch.float64) -> torch.Tensor:
    """h for every entry of ``seg_len`` (negative lengths read 0)."""
    table = torch.tensor(smooth_threshold_table(rate) + [rate], dtype=dtype,
                         device=seg_len.device)
    return table[seg_len.clamp(0, len(table) - 1)]


def verdicts(cov: torch.Tensor, seg_len: torch.Tensor, rate: float, dtype=torch.float64):
    """(yes, no) masks of coverage ``cov`` over segments of ``seg_len``
    (broadcast): the ratio, h and 1 - h all in ``dtype``, float64 as the
    original computes them (float32 is the control)."""
    h = high_threshold(seg_len, rate, dtype)
    ratio = cov.to(dtype) / seg_len.clamp_min(1).to(dtype)
    return ratio > h, ratio < 1.0 - h
