"""The least time one H100 could take for one DP call.

Frozen copy of ``freddie_tpu_torch/bench/common.py:bound_ms``, taking the
call's shapes and its ``n_cand`` in place of the tensors: the larger of
the call's bytes (C, y, W, n_cand read once; K, best_j, best_k and the
chains written once, all 4-byte words) over the memory rate and its
operations over the dense int8 tensor-core rate. The operations are those
the batch's data needs: per problem with n candidates, the C(n, 3) live
triples j < k < k_ of the pair contraction, 2R multiply-adds each.
"""

from __future__ import annotations

import numpy as np

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def bound_ms(B: int, P: int, R: int, n_cand: np.ndarray) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations") for one call on a (B, P, R)
    batch whose problems have ``n_cand`` candidates each."""
    read = 4 * (B * P * R + B * P + B * R + B)
    written = 4 * (B * P * P + 2 * B + B * (P + 2))
    n = np.asarray(n_cand, dtype=np.float64)
    ops = float((n * (n - 1) * (n - 2) / 6).sum()) * 2 * R * 2
    by_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT8_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")
