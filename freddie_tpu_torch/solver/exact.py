"""Deterministic exact solver for the one-isoform-per-round assignment.

Problem (the reference ILP 'isoforms_v8_20210209' at
py/freddie_cluster.py:362-572, specialized to its pinned K=2):

  choose S, a subset of the remaining read-reps ("assign to the isoform";
  the rest go to garbage), minimizing

      sum_{i in S} |corr_i AND E(S)|  +  sum_{i not in S} garbage_i

  where over the informative segments
      E(S)[j]  = OR_{i in S} exons_i[j]            (E2I = max of E2IR)
      corr_i[j]= 1 iff segment j lies between read i's first/last covered
                 segment and reads as 0 (correctable; the C matrix)
  subject to
      - incompatible pairs not both in S (py/freddie_cluster.py:499-511);
      - for each i in S and each recorded unaligned gap (j1, j2, l):
            (1-eps)*G - offset <= l <= (1+eps)*G + offset,
        G = sum of seg_len[j] for informative j strictly between j1 and j2
        with E(S)[j] = 1 (py/freddie_cluster.py:453-497).

Algorithm: depth-first branch and bound over reads (assign-first), with

  - admissible lower bound: corrections are monotone in E, so
      LB = garbage(rejected) + corr(chosen | E_cur)
           + sum_undecided min(corr_i(E_cur), garbage_i);
  - interval pruning of gap constraints using E_cur (lower bound on G's
    support) and E_possible = E_cur | OR(undecided exons) (upper bound);
  - epsilon comparisons in scaled integers (exact, no float boundaries);
  - deterministic order (reads sorted by descending garbage cost, then
    index) and strict-improvement incumbent updates, so the returned
    optimum is unique and platform-independent.

The search runs on the host (instances are small and branchy after the
reference's partitioning caps them at <=1000 unique reads); the heavy
per-instance precomputation (correction counts, exon sums) is vectorized
numpy. A time budget mirrors Gurobi's TimeLimit: on expiry the solver
reports TIMEOUT and the caller falls back like the reference does on a
non-OPTIMAL status (py/freddie_cluster.py:750-751).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class ReadRow:
    """One remaining read-rep, restricted to informative segments."""

    exons: np.ndarray  # (Mi,) bool  -- I row over informative segs
    corr: np.ndarray  # (Mi,) bool  -- C row over informative segs
    garbage: float  # garbage cost
    gaps: list  # [(lo_mask, l)] -- per gap: bool mask over informative segs
    #                 of positions strictly inside (j1, j2), plus observed l


@dataclass
class ClusterInstance:
    # Lazily materialized when flat arrays are supplied instead (see the
    # property below the class): the consolidated native round solver
    # consumes the flat arrays directly, so the production path never
    # pays for per-row Python objects; Python twins/audits materialize
    # identical rows on first access.
    rows: "list[ReadRow] | None"
    seg_len: np.ndarray  # (Mi,) int -- lengths of informative segments
    incomp: "np.ndarray | list[tuple[int, int]]"  # (K, 2) index pairs into rows
    epsilon: float = 0.2
    offset: int = 20
    # Optional (N, Mi) bool matrices whose rows ARE rows[i].exons/.corr
    # (build_instance supplies them); the packers use them to avoid
    # re-stacking per-row views. Pure mechanics -- same values.
    exons_mat: "np.ndarray | None" = None
    corr_mat: "np.ndarray | None" = None
    # Optional flat-array form (build_instance supplies it) consumed by
    # the consolidated native round solver (native/round_solver.cpp) so
    # the hot path never touches the per-row Python objects. Gap windows
    # are contiguous informative-column ranges [lo, hi) in row-major
    # (read 0's gaps first) order; garbage_arr mirrors rows[i].garbage.
    garbage_arr: "np.ndarray | None" = None  # (N,) float64
    gap_counts: "np.ndarray | None" = None  # (N,) int32
    gap_lo: "np.ndarray | None" = None  # (G,) int32
    gap_hi: "np.ndarray | None" = None  # (G,) int32
    gap_len_arr: "np.ndarray | None" = None  # (G,) int64

    def __post_init__(self):
        # Scale epsilon to exact integers: (1±eps)·G ≶ l ± offset becomes
        # (SC ∓ eps_sc)·G ≶ SC·(l ± offset).
        for sc in (10, 100, 1000, 10_000, 100_000):
            if abs(self.epsilon * sc - round(self.epsilon * sc)) < 1e-9:
                self.eps_scale = sc
                break
        else:
            raise ValueError(f"epsilon={self.epsilon} not an exact decimal")
        self.eps_scaled = int(round(self.epsilon * self.eps_scale))

    def _materialize_rows(self) -> "list[ReadRow]":
        """Rows from the flat arrays -- value-identical to what
        stages/cluster.build_instance used to construct eagerly (same
        views into exons_mat/corr_mat, same contiguous gap masks)."""
        N, Mi = self.exons_mat.shape
        cols = np.arange(Mi, dtype=np.int64)[None, :]
        masks = (cols >= self.gap_lo[:, None]) & (cols < self.gap_hi[:, None])
        rows: list[ReadRow] = []
        g = 0
        for k in range(N):
            gaps = [
                (masks[g + t], int(self.gap_len_arr[g + t]))
                for t in range(int(self.gap_counts[k]))
            ]
            g += int(self.gap_counts[k])
            rows.append(
                ReadRow(
                    exons=self.exons_mat[k],
                    corr=self.corr_mat[k],
                    garbage=float(self.garbage_arr[k]),
                    gaps=gaps,
                )
            )
        return rows


def _rows_get(self):
    store = self.__dict__.get("_rows_store")
    if store is None:
        # Legacy pickles (pre-lazy instances) carry 'rows' directly in
        # __dict__ -- unpickling bypasses the property setter.
        store = self.__dict__.get("rows")
    if store is None:
        store = self._materialize_rows()
    self.__dict__["_rows_store"] = store
    return store


def _rows_set(self, v):
    self.__dict__["_rows_store"] = v


# The dataclass-generated __init__ assigns through this property, so
# ClusterInstance(rows=None, ...) defers materialization until a Python
# twin (or audit/log) first touches .rows; ClusterInstance(rows=[...])
# behaves exactly as before.
ClusterInstance.rows = property(_rows_get, _rows_set)


@dataclass
class SolveResult:
    status: str  # 'OPTIMAL' | 'TIMEOUT' | 'BUDGET' (node budget hit)
    objective: float
    assigned: list[int]  # indices into rows, ascending
    isoform: np.ndarray | None  # (Mi,) bool -- E over informative segs
    nodes: int = 0


def _gap_ok_interval(lo: int, hi: int, l: int, off: int, sc: int, eps: int) -> bool:
    """Is there any G in [lo, hi] satisfying (1-e)G-off <= l <= (1+e)G+off?
    Both sides are monotone in G: feasible iff
      (1-e)*lo - off <= l   and   l <= (1+e)*hi + off."""
    return (sc - eps) * lo <= sc * (l + off) and sc * (l - off) <= (sc + eps) * hi


def solve_exact(
    inst: ClusterInstance, deadline_s: float = 60.0, node_budget: int = 0
) -> SolveResult:
    """Exact B&B solve. With node_budget > 0 the search stops
    deterministically after that many nodes and reports status 'BUDGET'
    with the incumbent found so far (used by the LP-assisted two-phase
    solve in solver.two_phase)."""
    rows = inst.rows
    N = len(rows)
    if N == 0:
        return SolveResult("OPTIMAL", 0.0, [], None)
    Mi = len(inst.seg_len)
    seg_len = inst.seg_len.astype(np.int64)

    # Deterministic processing order: heaviest garbage first, then index.
    order = sorted(range(N), key=lambda i: (-rows[i].garbage, i))
    if inst.exons_mat is not None:
        exons = inst.exons_mat[order].astype(bool)  # (N, Mi)
        corr = inst.corr_mat[order].astype(bool)
    else:
        exons = np.stack([rows[i].exons for i in order]).astype(bool)  # (N, Mi)
        corr = np.stack([rows[i].corr for i in order]).astype(bool)
    garbage = np.array([rows[i].garbage for i in order], dtype=np.float64)
    # Suffix-OR of exons: E_possible additions from positions >= p.
    suffix_or = np.zeros((N + 1, Mi), dtype=bool)
    for p in range(N - 1, -1, -1):
        suffix_or[p] = suffix_or[p + 1] | exons[p]
    # Conflicts in order-space.
    pos_of = {o: p for p, o in enumerate(order)}
    conflict: list[set[int]] = [set() for _ in range(N)]
    for a, b in inst.incomp:
        conflict[pos_of[a]].add(pos_of[b])
        conflict[pos_of[b]].add(pos_of[a])
    gaps_of = [rows[o].gaps for o in order]
    # Positions whose conflicts could still matter ahead: a conflict with
    # an already-rejected read never constrains the future.
    has_forward_conflict = [
        any(q > p for q in conflict[p]) for p in range(N)
    ]
    # Greedy clique cover of the conflict graph (DFS-position order,
    # first-fit): members of one clique mutually conflict, so any feasible
    # completion assigns at most ONE read per clique. The lower bound can
    # therefore grant at most the best single saving per clique instead of
    # every read's saving -- strictly tighter on dense conflict graphs,
    # still admissible (each assigned read's true saving garbage - corr(E_final)
    # never exceeds its current saving, corrections being monotone in E),
    # so under strict incumbent updates the canonical optimum is unchanged.
    # Conflict-free reads form singleton cliques (identical to the old
    # per-read min(corr, garbage) bound). Mirrors native/bnb_solver.cpp:
    # the construction and the bound arithmetic (exact multiples of 0.5 in
    # double) are bit-identical, keeping the twins' node paths equal.
    conflict_bits = [0] * N
    for p in range(N):
        for q in conflict[p]:
            conflict_bits[p] |= 1 << q
    clique_id = np.zeros(N, dtype=np.int64)
    clique_members: list[int] = []  # bitset per clique
    for p in range(N):
        cb = conflict_bits[p]
        for k, members in enumerate(clique_members):
            if members & ~cb == 0:  # p conflicts with every member
                clique_id[p] = k
                clique_members[k] = members | (1 << p)
                break
        else:
            clique_id[p] = len(clique_members)
            clique_members.append(1 << p)
    n_cliques = len(clique_members)
    suffix_garbage = np.zeros(N + 1, dtype=np.float64)
    for p in range(N - 1, -1, -1):
        suffix_garbage[p] = suffix_garbage[p + 1] + garbage[p]

    sc, eps, off = inst.eps_scale, inst.eps_scaled, inst.offset

    best_obj = float(garbage.sum())  # S = empty is always feasible
    best_set: list[int] = []
    best_E = np.zeros(Mi, dtype=bool)
    t0 = time.monotonic()
    nodes = 0
    timed_out = False
    budget_out = False

    # DFS stack entries: (p, E_cur, chosen, rejected_cost)
    # Implemented recursively with explicit stack to avoid recursion limits.
    # chosen is shared via a path list + depth markers.
    chosen: list[int] = []
    # excluded[q] = how many chosen positions conflict with q.
    excluded = np.zeros(N, dtype=np.int32)
    conflict_list = [sorted(conflict[p]) for p in range(N)]

    def corr_cost(i_pos: int, E: np.ndarray) -> int:
        return int(np.count_nonzero(corr[i_pos] & E))

    def gaps_feasible(i_pos: int, E_lo: np.ndarray, E_hi: np.ndarray) -> bool:
        for mask, l in gaps_of[i_pos]:
            lo = int(seg_len[mask & E_lo].sum())
            hi = int(seg_len[mask & E_hi].sum())
            if not _gap_ok_interval(lo, hi, l, off, sc, eps):
                return False
        return True

    def gaps_always_feasible(i_pos: int, E_lo: np.ndarray, E_hi: np.ndarray) -> bool:
        """Gaps of i satisfied for EVERY final E between E_lo and E_hi:
        both constraint sides must hold at their worst extreme."""
        for mask, l in gaps_of[i_pos]:
            lo = int(seg_len[mask & E_lo].sum())
            hi = int(seg_len[mask & E_hi].sum())
            if not ((sc - eps) * hi <= sc * (l + off) and sc * (l - off) <= (sc + eps) * lo):
                return False
        return True

    def recurse(p: int, E_cur: np.ndarray, rejected_cost: float):
        nonlocal best_obj, best_set, best_E, nodes, timed_out, budget_out
        if timed_out or budget_out:
            return
        nodes += 1
        if node_budget and nodes > node_budget:
            budget_out = True
            return
        if nodes % 4096 == 0 and time.monotonic() - t0 > deadline_s:
            timed_out = True
            return
        if p == N:
            # Exact feasibility re-check of all gaps at the leaf.
            obj = rejected_cost + sum(corr_cost(q, E_cur) for q in chosen)
            if obj < best_obj:
                for q in chosen:
                    if not gaps_feasible(q, E_cur, E_cur):
                        return
                best_obj = obj
                best_set = list(chosen)
                best_E = E_cur.copy()
            return
        # Lower bound with current E (corrections only grow with E):
        # every undecided read is charged its garbage, minus at most one
        # saving per conflict clique (see the clique-cover construction
        # above). Undecided reads conflicting with a chosen one MUST be
        # rejected in every completion (saving 0; their clique-mates with
        # a chosen member are likewise excluded). Admissible, so the
        # canonical first-found optimum is unchanged (mirrors
        # native/bnb_solver.cpp).
        cost_chosen = sum(corr_cost(q, E_cur) for q in chosen)
        und_corr = np.count_nonzero(corr[p:] & E_cur, axis=1).astype(np.float64)
        saving = np.where(
            excluded[p:] > 0,
            0.0,
            garbage[p:] - np.minimum(und_corr, garbage[p:]),
        )
        cmax = np.zeros(n_cliques, dtype=np.float64)
        np.maximum.at(cmax, clique_id[p:], saving)
        lb = rejected_cost + cost_chosen + suffix_garbage[p] - cmax.sum()
        if lb >= best_obj:
            return
        E_possible = E_cur | suffix_or[p]
        # Prune: every chosen read's gaps must stay interval-feasible.
        for q in chosen:
            if not gaps_feasible(q, E_cur, E_possible):
                return

        conflicted = excluded[p] > 0

        # Dominance: when assigning p cannot hurt -- it adds no exons
        # (E unchanged), its cost never exceeds its garbage under any
        # final E, it constrains nobody (no forward conflicts), and its
        # gaps hold for every reachable E -- the assign branch's optimum
        # is at least as good as the reject branch's (any reject
        # completion plus p is feasible and no costlier), and assign-first
        # DFS reaches it first: skip the reject branch. Result-identical
        # to the full search.
        if (
            not conflicted
            and not has_forward_conflict[p]
            and not np.any(exons[p] & ~E_cur)
            and corr_cost(p, E_possible) <= garbage[p]
            and gaps_always_feasible(p, E_cur, E_possible)
        ):
            chosen.append(p)
            excluded[conflict_list[p]] += 1
            recurse(p + 1, E_cur, rejected_cost)
            excluded[conflict_list[p]] -= 1
            chosen.pop()
            return

        # Branch 1: assign p (if compatible and its gaps can be satisfied).
        if not conflicted:
            E_new = E_cur | exons[p]
            if gaps_feasible(p, E_new, E_possible):
                chosen.append(p)
                excluded[conflict_list[p]] += 1
                recurse(p + 1, E_new, rejected_cost)
                excluded[conflict_list[p]] -= 1
                chosen.pop()
        # Branch 2: reject p.
        recurse(p + 1, E_cur, rejected_cost + garbage[p])

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, N * 4 + 1000))
    try:
        recurse(0, np.zeros(Mi, dtype=bool), 0.0)
    finally:
        sys.setrecursionlimit(old_limit)

    if timed_out:
        return SolveResult("TIMEOUT", best_obj, [], None, nodes)
    assigned = sorted(order[p] for p in best_set)
    status = "BUDGET" if budget_out else "OPTIMAL"
    return SolveResult(status, best_obj, assigned, best_E, nodes)
