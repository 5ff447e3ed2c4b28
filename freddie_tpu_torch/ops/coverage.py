"""Cumulative coverage built on the device (plain PyTorch).

Port of ``freddie_tpu/ops/coverage.py:build_coverage_device``. The DP
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

import torch


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
