"""LP-relaxation lower bound for the cluster-assignment problem.

Linear relaxation of the reference ILP (py/freddie_cluster.py:347-572,
K=2) solved with scipy's HiGHS. Used only to *prove* an incumbent optimal
when the branch-and-bound's deterministic node budget runs out: a valid
lower bound can only terminate the search with the incumbent it already
holds, never change which optimum is returned, so determinism is
preserved.

Relaxation (variables in [0,1]):
    a_i          read i assigned to the isoform
    E_j          isoform contains informative segment j
    x_{ij}       correction paid (i assigned AND E_j), for corr_i[j]=1
minimize   sum x_{ij} + sum_i g_i (1 - a_i)
subject to
    x_{ij} >= a_i + E_j - 1
    E_j    >= a_i                      for I_i[j] = 1  (E is the union)
    (1-eps) G_i(E) - off - (1-a_i) M <= l_i            per gap of read i
    (1+eps) G_i(E) + off + (1-a_i) M >= l_i
    a_{i1} + a_{i2} <= 1                               incompatible pairs
with G_i(E) = sum seg_len[j] E_j over the gap's window. Dropping the
E <= sum a_i I upper side only enlarges the feasible set (still a valid
lower bound).
"""

from __future__ import annotations

import numpy as np

from .exact import ClusterInstance


def lp_lower_bound(inst: ClusterInstance) -> float | None:
    """LP lower bound on the instance optimum, or None if unavailable."""
    try:
        from scipy.optimize import linprog
        from scipy.sparse import lil_matrix
    except ImportError:
        return None

    rows = inst.rows
    N = len(rows)
    M = len(inst.seg_len)
    if N == 0:
        return 0.0
    seg_len = inst.seg_len.astype(np.float64)
    eps = inst.epsilon
    off = float(inst.offset)
    big_m = float(seg_len.sum() + 1) * (1 + eps) + 2 * off + max(
        (l for r in rows for _m, l in r.gaps), default=0
    )

    # Variable layout: a_0..a_{N-1}, E_0..E_{M-1}, then x_{ij} pairs.
    xs = []  # (i, j)
    for i, r in enumerate(rows):
        for j in np.flatnonzero(r.corr):
            xs.append((i, int(j)))
    n_var = N + M + len(xs)
    c = np.zeros(n_var)
    g_total = 0.0
    for i, r in enumerate(rows):
        c[i] = -r.garbage  # minimize g_i(1-a_i) = const - g_i a_i
        g_total += r.garbage
    c[N + M :] = 1.0

    A = lil_matrix((0, n_var))
    b: list[float] = []
    rows_A: list[dict[int, float]] = []

    def add(coeffs: dict[int, float], ub: float):
        rows_A.append(coeffs)
        b.append(ub)

    # x_ij >= a_i + E_j - 1  ->  a_i + E_j - x_ij <= 1
    for k, (i, j) in enumerate(xs):
        add({i: 1.0, N + j: 1.0, N + M + k: -1.0}, 1.0)
    # E_j >= a_i for I_i[j]=1  ->  a_i - E_j <= 0
    for i, r in enumerate(rows):
        for j in np.flatnonzero(r.exons):
            add({i: 1.0, N + int(j): -1.0}, 0.0)
    # gaps
    for i, r in enumerate(rows):
        for mask, l in r.gaps:
            idx = np.flatnonzero(mask)
            # (1-eps) G - big_m a_i <= l + off - big_m  is wrong sign; use:
            # (1-eps)G - off - (1-a_i)M <= l  ->  (1-eps)G + M a_i <= l + off + M
            co = {N + int(j): (1 - eps) * seg_len[j] for j in idx}
            co[i] = co.get(i, 0.0) + big_m
            add(co, l + off + big_m)
            # l <= (1+eps)G + off + (1-a_i)M -> -(1+eps)G + M a_i <= off + M - l
            co = {N + int(j): -(1 + eps) * seg_len[j] for j in idx}
            co[i] = co.get(i, 0.0) + big_m
            add(co, off + big_m - l)
    # incompatibilities
    for i1, i2 in inst.incomp:
        add({i1: 1.0, i2: 1.0}, 1.0)

    if rows_A:
        A = lil_matrix((len(rows_A), n_var))
        for r_idx, coeffs in enumerate(rows_A):
            for v, coef in coeffs.items():
                A[r_idx, v] = coef
        A_ub = A.tocsr()
        b_ub = np.array(b)
    else:
        A_ub = None
        b_ub = None

    try:
        res = linprog(
            c,
            A_ub=A_ub,
            b_ub=b_ub,
            bounds=[(0.0, 1.0)] * n_var,
            method="highs",
        )
    except Exception:
        return None
    if not res.success:
        return None
    return float(res.fun + g_total)
