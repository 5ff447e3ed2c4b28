"""Brute-force enumeration oracle for the cluster objective (tests only).

Enumerates every subset of reads, applies the exact constraints, and
returns the optimal objective value. Exponential; use only for small N.
"""

from __future__ import annotations

import numpy as np

from .exact import ClusterInstance


def brute_force_optimum(inst: ClusterInstance) -> float:
    rows = inst.rows
    N = len(rows)
    seg_len = inst.seg_len.astype(np.int64)
    sc, eps, off = inst.eps_scale, inst.eps_scaled, inst.offset
    incomp = [(a, b) for a, b in inst.incomp]
    best = None
    for bits in range(1 << N):
        S = [i for i in range(N) if bits >> i & 1]
        if any(a in S and b in S for a, b in incomp):
            continue
        E = np.zeros(len(seg_len), dtype=bool)
        for i in S:
            E |= rows[i].exons
        ok = True
        for i in S:
            for mask, l in rows[i].gaps:
                G = int(seg_len[mask & E].sum())
                if not (
                    (sc - eps) * G <= sc * (l + off)
                    and sc * (l - off) <= (sc + eps) * G
                ):
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            continue
        obj = sum(
            int(np.count_nonzero(rows[i].corr & E)) if i in S else rows[i].garbage
            for i in range(N)
        )
        if best is None or obj < best:
            best = obj
    return float(best)
