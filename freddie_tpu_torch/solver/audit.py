"""Optimum-uniqueness audit for cluster ILP instances.

PARITY.md deviation 1 notes that when an instance has several equally
optimal (isoform, assignment) pairs, this solver's canonical choice may
legitimately differ from Gurobi's unspecified tie-break. This module
measures how often that situation actually occurs: `audit_instance`
decides whether a solved instance's optimum is unique by enumerating
candidate structures (like solver.segenum) and counting optimal
conflict-free covering assignments (capped at 2).

Counting argument: a candidate read with strictly positive profit and no
conflict inside the candidate set is in EVERY optimal assignment for
that structure (adding it raises profit, cannot break the union == E
coverage since candidate exon sets are subsets of E, and conflicts with
nothing), so such reads are fixed and the tie count comes from a DFS
over the residue (zero/negative-profit or conflicted candidates) that
continues through equal-gain branches.

Used by tools/audit_tiebreak.py; results are recorded in PARITY.md.
"""

from __future__ import annotations

import time

import numpy as np

from .exact import ClusterInstance
from .segenum import MAX_SEGS, _popcount_u64
from .two_phase import solve_two_phase


class _Unknown(Exception):
    pass


def audit_instance(
    inst: ClusterInstance,
    deadline_s: float = 30.0,
    node_cap: int = 2_000_000,
    device="cuda",
) -> str:
    """Classify an instance: 'unique' | 'nonunique' | 'unknown'.

    'nonunique' means at least two distinct (structure, assignment) pairs
    attain the optimal objective -- the regime where Gurobi's result
    could differ from ours with both being correct. ``device`` ('cuda'
    or 'cpu') is where the solver's and the audit's bounds run."""
    from .segenum import (
        CLOSURE_CAP,
        CLOSURE_MAX_SEGS,
        WIDE_MAX_SEGS,
        optimistic_device,
    )

    Mi = len(inst.seg_len)
    N = len(inst.rows)
    if N == 0:
        return "unique"
    # The audit's own enumeration machinery is single-word (u64 numpy
    # masks); it declines past 64 segments even though the production
    # closure escalation now runs to CLOSURE_MAX_SEGS=128 (two words).
    if Mi > min(CLOSURE_MAX_SEGS, 64):
        return "unknown-mi"
    res = solve_two_phase(inst, deadline_s, device)
    if res.status != "OPTIMAL":
        return "unknown-timeout"
    best_cost = float(res.objective)
    if res.isoform is not None:
        E_star = sum(1 << b for b in range(Mi) if res.isoform[b])
    else:
        E_star = 0
    S_star = frozenset(res.assigned)
    t_end = time.monotonic() + deadline_s

    def to_int(vec):
        bits = 0
        for b in np.flatnonzero(np.asarray(vec, bool)):
            bits |= 1 << int(b)
        return bits

    I_int = np.array([to_int(r.exons) for r in inst.rows], dtype=np.uint64)
    C_int = np.array([to_int(r.corr) for r in inst.rows], dtype=np.uint64)
    g = np.array([r.garbage for r in inst.rows], dtype=np.float64)
    g_total = float(g.sum())
    sc, eps, off = inst.eps_scale, inst.eps_scaled, inst.offset
    seg_len = inst.seg_len.astype(np.int64)
    gap_read, gap_mask_l, gap_len_l = [], [], []
    for i, r in enumerate(inst.rows):
        for mask, l in r.gaps:
            gap_read.append(i)
            gap_mask_l.append(to_int(mask))
            gap_len_l.append(int(l))
    gap_read_a = np.array(gap_read, dtype=np.int64)
    gap_masks = np.array(gap_mask_l, dtype=np.uint64)
    gap_lens = np.array(gap_len_l, dtype=np.int64)
    n_gaps = len(gap_read)

    conflict = np.zeros((N, N), dtype=bool)
    for a, b in inst.incomp:
        conflict[a, b] = True
        conflict[b, a] = True

    def opt_block(E_blk):
        E_blk = np.asarray(E_blk, dtype=np.uint64)
        subset_ok = (I_int[:, None] & ~E_blk[None, :]) == 0
        d = g[:, None] - _popcount_u64(C_int[:, None] & E_blk[None, :])
        pos = np.where(subset_ok & (d > 0), d, 0.0).sum(axis=0)
        return g_total - pos

    if Mi > MAX_SEGS:
        # Candidate set 1: the union closure of the reads' I-masks --
        # exactly the coverable structures (solve_segment_enum_closure's
        # equivalence argument), COMPLETE for uniqueness counting at any
        # Mi. When the closure overflows its cap and Mi permits, fall
        # back to the device bound filter over all 2^Mi masks (every mask
        # achieving the optimum has optimistic <= best_cost).
        closure = {0}
        for m in sorted({to_int(r.exons) for r in inst.rows}):
            closure |= {e | m for e in closure}
            if len(closure) > CLOSURE_CAP:
                closure = None
                break
        if closure is not None:
            masks = np.array(sorted(closure), dtype=np.uint64)
            opt_of = np.empty(len(masks), dtype=np.float64)
            for lo in range(0, len(masks), 1 << 12):
                opt_of[lo : lo + (1 << 12)] = opt_block(masks[lo : lo + (1 << 12)])
            keep = opt_of <= best_cost + 1e-9
            masks, opt_of = masks[keep], opt_of[keep]
            perm = np.lexsort((masks, opt_of))
            order = masks[perm]
            optimistic = {int(E): float(o) for E, o in zip(masks, opt_of)}
        elif Mi <= WIDE_MAX_SEGS:
            opt_all = optimistic_device(inst, 1 << Mi, device)
            passing = np.flatnonzero(opt_all <= best_cost + 1e-9)
            if len(passing) > 500_000:
                return "unknown-timeout"
            order = passing[np.lexsort((passing, opt_all[passing]))]
            optimistic = {int(E): float(opt_all[E]) for E in passing}
        else:
            return "unknown-timeout"
    else:
        n_masks = 1 << Mi
        opt_all = np.empty(n_masks, dtype=np.float64)
        for lo in range(0, n_masks, 1 << 12):
            E_blk = np.arange(lo, min(lo + (1 << 12), n_masks), dtype=np.uint64)
            opt_all[lo : lo + len(E_blk)] = opt_block(E_blk)
        E_all = np.arange(n_masks, dtype=np.uint64)
        order = E_all[np.lexsort((E_all, opt_all))]
        optimistic = {int(E): float(o) for E, o in zip(E_all, opt_all)}
    nodes = [0]

    def count_optimal(E: int):
        """(max_gain, count<=2, one_assignment) over candidate subsets
        covering E without conflicts; (-inf, 0, None) when infeasible."""
        ok = (I_int & ~np.uint64(E)) == 0
        if n_gaps:
            gm = gap_masks & np.uint64(E)
            G = np.zeros(n_gaps, dtype=np.int64)
            for b in range(Mi):
                if (E >> b) & 1:
                    G += ((gm >> np.uint64(b)) & 1).astype(np.int64) * seg_len[b]
            gok = ((sc - eps) * G <= sc * (gap_lens + off)) & (
                sc * (gap_lens - off) <= (sc + eps) * G
            )
            if not gok.all():
                bad = np.bincount(gap_read_a[~gok], minlength=N) > 0
                ok &= ~bad
        cand = np.flatnonzero(ok)
        if E and not len(cand):
            return -np.inf, 0, None
        d = g[cand] - _popcount_u64(C_int[cand] & np.uint64(E))
        conf_sub = conflict[np.ix_(cand, cand)]
        has_conf = conf_sub.any(axis=1)
        forced = ~has_conf & (d > 0)  # strict: ties go to the DFS
        base_gain = float(d[forced].sum())
        base_union = 0
        for v in I_int[cand[forced]]:
            base_union |= int(v)
        rest = np.flatnonzero(~forced)
        perm = rest[np.lexsort((cand[rest], -d[rest]))]
        rd = d[perm].tolist()
        rI = [int(v) for v in I_int[cand[perm]]]
        rconf = [frozenset(np.flatnonzero(row)) for row in
                 conf_sub[np.ix_(perm, perm)]]
        n_sub = len(perm)
        suff_pos = [0.0] * (n_sub + 1)
        suff_union = [0] * (n_sub + 1)
        for p in range(n_sub - 1, -1, -1):
            suff_pos[p] = suff_pos[p + 1] + max(rd[p], 0.0)
            suff_union[p] = suff_union[p + 1] | rI[p]

        state = dict(best=-np.inf, count=0, sol=None)
        chosen: list[int] = []

        def rec(p, gain, union, chosen_set):
            nodes[0] += 1
            if nodes[0] > node_cap or time.monotonic() > t_end:
                raise _Unknown()
            if (union | suff_union[p]) & E != E:
                return
            # equality continues: equal-gain leaves are the ties we count
            if gain + suff_pos[p] < state["best"]:
                return
            if p == n_sub:
                if union != E:
                    return
                if gain > state["best"]:
                    state["best"] = gain
                    state["count"] = 1
                    state["sol"] = list(chosen)
                elif gain == state["best"]:
                    state["count"] = min(state["count"] + 1, 2)
                return
            if not (rconf[p] & chosen_set):
                chosen.append(p)
                chosen_set.add(p)
                rec(p + 1, gain + rd[p], union | rI[p], chosen_set)
                chosen_set.remove(p)
                chosen.pop()
            rec(p + 1, gain, union, chosen_set)

        rec(0, base_gain, base_union, set())
        if state["sol"] is None:
            return -np.inf, 0, None
        assigned = sorted(
            [int(cand[perm[p]]) for p in state["sol"]]
            + [int(v) for v in cand[forced]]
        )
        return state["best"], state["count"], assigned

    try:
        for E in order:
            E = int(E)
            if optimistic[E] > best_cost:
                break
            if time.monotonic() > t_end:
                raise _Unknown()
            gain, count, assigned = count_optimal(E)
            if assigned is None:
                continue
            cost = g_total - gain
            assert cost >= best_cost - 1e-9, (cost, best_cost)
            if abs(cost - best_cost) > 1e-9:
                continue
            if E != E_star:
                return "nonunique"
            if count >= 2:
                return "nonunique"
            if frozenset(assigned) != S_star:
                # A different optimal assignment than the canonical one.
                return "nonunique"
    except _Unknown:
        return "unknown-timeout"
    return "unique"
