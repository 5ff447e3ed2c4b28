"""Exact solver by enumeration over isoform structures (small instances).

Port of ``freddie_tpu/solver/segenum.py``: the host twin (the
per-structure scan, the canonical replay, the full enumeration below
MAX_SEGS) is that module's numpy code as it is, and its header explains
the method. The two escalations above MAX_SEGS evaluate their optimistic
bounds on a torch device:

- ``solve_segment_enum_closure`` (Mi <= CLOSURE_MAX_SEGS): enumerates the
  OR-closure of the reads' distinct I-masks; its bounds go to the device
  once N x |closure| crosses BOUNDS_DEVICE_MIN;
- ``solve_segment_enum_wide`` (MAX_SEGS < Mi <= WIDE_MAX_SEGS, used when
  the closure overflows its cap): every mask's bound on the device, then
  the canonical replay over the survivors.

Both replay through the C++ core's solve_segenum_list when available,
with the Python ``_replay`` as the bit-equal fallback. The gates are this
module's own constants, read at call time.

Exactness: every bound is g_total minus a sum of positive profits, each
a multiple of 0.5, with every partial sum far below 2^23, so f32 holds
each value exactly whatever the summation order, block size or device;
the values -- and therefore the canonical visit order -- equal the host
``_PerStructure.optimistic_block`` bit for bit.
"""

from __future__ import annotations

import time

import numpy as np

from .exact import ClusterInstance, SolveResult
from .native import solve_segenum_list_native

MAX_SEGS = 20  # full-enumeration twins: 2^20 masks at most
WIDE_MAX_SEGS = 26  # device-assisted bound-filtered enumeration ceiling
WIDE_CANDIDATE_CAP = 200_000  # filtered-mask budget for the wide path
# Union-closure enumeration ceiling. Masks are (W,) uint64 word arrays
# (W = 2 past 64 segments; the native twins run unsigned __int128), so
# the rung covers every Mi the reference's pipeline can produce in
# practice -- profiled 300k-read corpora put the escalating tail at
# Mi ~ 75 with closures of ~3e4 masks, which previously fell through to
# the unbudgeted full read-DFS (round-3 profile: ~13 s of 42 s solve).
# History: 64 (u64 masks) until round 3's two-word generalization.
CLOSURE_MAX_SEGS = 128
CLOSURE_CAP = 100_000  # closure-size budget for the closure path
# Above this many (reads x closure masks) the bound evaluation goes to
# batched matrix products on the solver's device (identical exact values
# on any device, so the gate stays content-only). The value is the JAX
# package's; its crossover has not been measured on a GPU.
BOUNDS_DEVICE_MIN = 20_000_000


class _DfsTimeout(Exception):
    """Raised inside a per-structure conflict DFS past its deadline."""




def solve_segment_enum(inst: ClusterInstance, deadline_s: float = 60.0) -> SolveResult | None:
    """Exact solve via structure enumeration; None iff Mi > MAX_SEGS.

    The decline decision is purely instance content (Mi), identical for
    both engines; the C++ core is preferred for speed, with this Python
    implementation as the bit-equal reference definition and fallback."""
    if len(inst.seg_len) > MAX_SEGS:
        return None
    from .native import solve_segenum_native

    native = solve_segenum_native(inst, deadline_s)
    if native is not None:
        return native
    return _solve_segment_enum_py(inst, deadline_s)


def _granularity(inst: ClusterInstance) -> float:
    """Spacing of distinct objective values (two_phase._objective_granularity's
    twin): corrections are integers and garbage costs integral ('constant')
    or half-integral ('exons'/'introns'), so costs are multiples of this.
    Used to convert a feasible incumbent cost c into the DFS floor gain
    g_total - c - gran: with costs on the gran grid, "gain > floor" admits
    exactly the assignments with cost <= c."""
    if all(float(r.garbage).is_integer() for r in inst.rows):
        return 1.0
    return 0.5


def _popcount_u64(x: np.ndarray) -> np.ndarray:
    """Exact per-element popcount (numpy 2.0 hardware popcount)."""
    return np.bitwise_count(np.asarray(x, dtype=np.uint64)).astype(np.int64)


class _PerStructure:
    """Per-instance state + the per-structure optimal-assignment scan
    shared by the full enumeration and the wide (bound-filtered) path.
    Semantics and tie-breaks mirror native/segenum.cpp exactly."""

    def __init__(self, inst: ClusterInstance):
        Mi = len(inst.seg_len)
        N = len(inst.rows)
        self.Mi, self.N = Mi, N
        # Mask word count: 1 for Mi <= 64 (the historical representation,
        # all values identical to the old 1-word arrays), 2 up to 128.
        W = max((Mi + 63) // 64, 1)
        self.W = W

        def masks_of(vecs: list) -> np.ndarray:
            """Stack of bool vectors -> (n, W) little-endian uint64 words."""
            n = len(vecs)
            padded = np.zeros((n, W * 64), dtype=bool)
            if n and Mi:
                padded[:, :Mi] = np.asarray(vecs, dtype=bool)
            return (
                np.packbits(padded, axis=1, bitorder="little")
                .view(np.uint64)
                .reshape(n, W)
            )

        if inst.exons_mat is not None:
            self.I_int = masks_of(inst.exons_mat)
            self.C_int = masks_of(inst.corr_mat)
        else:
            self.I_int = masks_of([r.exons for r in inst.rows])
            self.C_int = masks_of([r.corr for r in inst.rows])
        self.g = np.array([r.garbage for r in inst.rows], dtype=np.float64)
        self.g_total = float(self.g.sum())
        self.sc, self.eps, self.off = inst.eps_scale, inst.eps_scaled, inst.offset
        self.seg_len = inst.seg_len.astype(np.int64)
        gap_read, gap_mask_l, gap_len_l = [], [], []
        for i, r in enumerate(inst.rows):
            for mask, l in r.gaps:
                gap_read.append(i)
                gap_mask_l.append(mask)
                gap_len_l.append(int(l))
        self.gap_read = np.array(gap_read, dtype=np.int64)
        self.gap_masks = masks_of(gap_mask_l)
        self.gap_lens = np.array(gap_len_l, dtype=np.int64)
        self.n_gaps = len(gap_read)
        self.conflict = np.zeros((N, N), dtype=bool)
        inc = np.asarray(inst.incomp, dtype=np.int64).reshape(-1, 2)
        self.conflict[inc[:, 0], inc[:, 1]] = True
        self.conflict[inc[:, 1], inc[:, 0]] = True
        self.any_conflict = bool(len(inc))

    def _global_cliques(self) -> np.ndarray:
        """Greedy first-fit clique cover of the conflict graph in read
        order (twin of the identical construction in native/segenum.cpp's
        run_enum); cached. Only built when conflicts exist."""
        got = getattr(self, "_gclique", None)
        if got is not None:
            return got
        N = self.N
        clique_of = np.zeros(N, dtype=np.int64)
        members: list[np.ndarray] = []
        for i in range(N):
            crow = self.conflict[i]
            placed = -1
            for k, m in enumerate(members):
                if not (m & ~crow).any():
                    placed = k
                    break
            if placed < 0:
                placed = len(members)
                members.append(np.zeros(N, dtype=bool))
            clique_of[i] = placed
            members[placed][i] = True
        self._gclique = clique_of
        return clique_of

    def _words_of_int(self, E: int) -> np.ndarray:
        """Python int mask -> (W,) little-endian uint64 words."""
        return np.array(
            [(E >> (64 * w)) & 0xFFFFFFFFFFFFFFFF for w in range(self.W)],
            dtype=np.uint64,
        )

    @staticmethod
    def _int_of_row(row) -> int:
        """(W,) uint64 words -> Python int mask (word-agnostic)."""
        m = 0
        for w, v in enumerate(np.atleast_1d(row)):
            m |= int(v) << (64 * w)
        return m

    def optimistic_block(self, E_blk: np.ndarray) -> np.ndarray:
        """Lower bound per structure: all positive-profit subset-compatible
        reads assigned, ignoring gap windows, conflicts and coverage
        (dropping the gap filter only loosens it). E_blk: (K,) uint64 for
        1-word instances, or (K, W) word rows."""
        E_blk = np.asarray(E_blk, dtype=np.uint64)
        if E_blk.ndim == 1:
            E_blk = E_blk[:, None]
        subset_ok = ((self.I_int[:, None, :] & ~E_blk[None, :, :]) == 0).all(
            axis=2
        )
        d = self.g[:, None] - _popcount_u64(
            self.C_int[:, None, :] & E_blk[None, :, :]
        ).sum(axis=2)
        pos_gain = np.where(subset_ok & (d > 0), d, 0.0).sum(axis=0)
        return self.g_total - pos_gain

    def best_for(self, E: int, t_end: float | None = None,
                 floor_gain: float | None = None):
        """(cost, sorted assigned read list) of the optimal conflict-free
        covering assignment for structure E, or (None, None) when E is
        uncoverable -- or, with `floor_gain`, when no assignment beats
        that gain (the replay seeds it with its running incumbent: only
        strictly better assignments can update the outer incumbent, so
        pruning at-or-below the floor is a valid bound under strict
        updates and the canonical result is unchanged). Candidate order,
        free-assignment and DFS tie-breaks are identical to the C++
        core's per-E scan.

        Raises _DfsTimeout past t_end: one structure's conflict DFS can
        blow up exponentially under dense incompatibilities, so (like the
        C++ core) the wall check lives inside the recursion, not only in
        the caller's per-mask loop."""
        Ew = self._words_of_int(int(E))
        ok = ((self.I_int & ~Ew[None, :]) == 0).all(axis=1)  # subset-compat.
        if self.n_gaps:
            gm = self.gap_masks & Ew[None, :]
            G = np.zeros(self.n_gaps, dtype=np.int64)
            for b in range(self.Mi):
                if (E >> b) & 1:
                    G += (
                        (gm[:, b >> 6] >> np.uint64(b & 63)) & 1
                    ).astype(np.int64) * self.seg_len[b]
            gok = ((self.sc - self.eps) * G <= self.sc * (self.gap_lens + self.off)) & (
                self.sc * (self.gap_lens - self.off) <= (self.sc + self.eps) * G
            )
            if not gok.all():
                bad = np.bincount(self.gap_read[~gok], minlength=self.N) > 0
                ok &= ~bad
        cand = np.flatnonzero(ok)
        if E and not len(cand):
            return None, None
        # coverage requirement: union of chosen I must equal E
        d = self.g[cand] - _popcount_u64(self.C_int[cand] & Ew[None, :]).sum(axis=1)
        if self.any_conflict and floor_gain is not None and len(cand):
            # Fused tight-bound early skip (twin of native/segenum.cpp's
            # run_enum): at most one positive profit per global conflict
            # clique among the (already gap-filtered) candidates is an
            # admissible gain bound; at-or-below the floor, no assignment
            # here can strictly improve (same argument as the DFS floor),
            # so the conflict setup and the DFS are skipped.
            pos = d > 0
            if pos.any():
                cl = self._global_cliques()[cand[pos]]
                cmax = np.zeros(int(cl.max()) + 1, dtype=np.float64)
                np.maximum.at(cmax, cl, d[pos])
                gain_bound = float(cmax.sum())
            else:
                gain_bound = 0.0
            if gain_bound <= floor_gain:
                return None, None
        # order candidates by descending profit, then index (deterministic)
        perm = np.lexsort((cand, -d))
        sub_order = cand[perm]
        sub_delta_all = d[perm]
        if self.any_conflict and len(sub_order):
            conf_sub = self.conflict[np.ix_(sub_order, sub_order)]
            has_conf = conf_sub.any(axis=1)
        else:
            conf_sub = None
            has_conf = np.zeros(len(sub_order), dtype=bool)
        # Candidates with no conflicts inside this E's candidate set and
        # non-negative profit are always in the (first-found) optimum:
        # assigning them cannot hurt coverage, profit, or anybody else.
        free = ~has_conf & (sub_delta_all >= 0)
        base_gain = float(sub_delta_all[free].sum())
        base_union = 0
        for v in self.I_int[sub_order[free]]:
            base_union |= self._int_of_row(v)
        rest = np.flatnonzero(~free)
        rest_order = sub_order[rest]
        sub_delta = sub_delta_all[rest].tolist()
        sub_I = [self._int_of_row(v) for v in self.I_int[rest_order]]
        n_sub = len(rest_order)
        if conf_sub is not None and n_sub:
            conf_rest = conf_sub[np.ix_(rest, rest)]
            sub_conf = [frozenset(np.flatnonzero(row)) for row in conf_rest]
        else:
            empty = frozenset()
            sub_conf = [empty] * n_sub
        best_gain = -np.inf if floor_gain is None else float(floor_gain)
        best_sub: list[int] | None = None
        chosen: list[int] = []
        nodes = 0
        dplus = [max(d, 0.0) for d in sub_delta]
        # Dominance obligations: rejected FREE positions with delta > 0
        # must eventually conflict with a chosen position -- otherwise
        # every completion below keeps them free and is strictly
        # improvable by adding them (subset-compatible and gap-feasible
        # by candidacy, conflict-free by excluded == 0, coverage only
        # grows within E), so the subtree holds no optimum and pruning
        # it cannot change the canonical first-found optimum. Twin of
        # the identical rule in native/segenum.cpp's rec.
        oblig: list[int] = []
        excluded_bits = 0  # int bitmask of positions with excluded > 0
        # excluded[q] = how many chosen positions conflict with q. The
        # conflict-aware prune grants at most ONE positive profit per
        # conflict clique among the non-excluded remaining positions
        # (clique members mutually conflict, so any extension assigns at
        # most one of them): a valid upper bound, and a valid bound under
        # strict incumbent updates cannot cut the first-in-DFS-order
        # optimum before it is found -- the canonical result is
        # unchanged, only the node count (mirrors native/segenum.cpp).
        excluded = [0] * n_sub
        # Greedy first-fit clique cover in DFS (profit) order; conflict-
        # free positions land in singleton cliques, where the bound
        # degenerates to the plain positive-profit suffix sum.
        conf_bits = [0] * n_sub
        for p in range(n_sub):
            for q in sub_conf[p]:
                conf_bits[p] |= 1 << int(q)
        clique_of = [0] * n_sub
        clique_members: list[int] = []
        for p in range(n_sub):
            cb = conf_bits[p]
            for k in range(len(clique_members)):
                if clique_members[k] & ~cb == 0:
                    clique_of[p] = k
                    clique_members[k] |= 1 << p
                    break
            else:
                clique_of[p] = len(clique_members)
                clique_members.append(1 << p)
        n_cliques = len(clique_members)
        clique_max = [0.0] * n_cliques
        clique_epoch = [-1] * n_cliques

        def rec(p: int, gain: float, union: int):
            nonlocal best_gain, best_sub, nodes, excluded_bits
            nodes += 1
            if t_end is not None and (nodes & 0xFFFF) == 0:
                import time

                if time.monotonic() > t_end:
                    raise _DfsTimeout
            # One pass over the remaining positions feeds both prunes:
            # the per-clique best remaining profit (bound, accumulated
            # incrementally under per-node epoch stamps) and the union of
            # still-assignable positions (coverage; tighter than a static
            # suffix union).
            total_max = 0.0
            epoch = nodes
            avail_uni = 0
            for q in range(p, n_sub):
                if not excluded[q]:
                    avail_uni |= sub_I[q]
                    k = clique_of[q]
                    prev = clique_max[k] if clique_epoch[k] == epoch else 0.0
                    if dplus[q] > prev:
                        total_max += dplus[q] - prev
                        clique_max[k] = dplus[q]
                        clique_epoch[k] = epoch
            if (union | avail_uni) & E != E:
                return
            if gain + total_max <= best_gain:
                return
            # Dominance prune: an unsatisfied obligation with no
            # choosable remaining neighbor kills the subtree (within a
            # subtree, excluded counts are monotone non-decreasing, so
            # currently-barred neighbors stay barred below).
            suffix = -1 << p
            for q in oblig:
                if excluded[q]:
                    continue  # satisfied: a chosen neighbor exists
                if not (conf_bits[q] & ~excluded_bits & suffix):
                    return
            if p == n_sub:
                if union == E and gain > best_gain:
                    best_gain = gain
                    best_sub = list(chosen)
                return
            # assign p if conflict-free
            if not excluded[p]:
                chosen.append(p)
                for q in sub_conf[p]:
                    excluded[q] += 1
                    if excluded[q] == 1:
                        excluded_bits |= 1 << int(q)
                rec(p + 1, gain + sub_delta[p], union | sub_I[p])
                for q in sub_conf[p]:
                    excluded[q] -= 1
                    if excluded[q] == 0:
                        excluded_bits &= ~(1 << int(q))
                chosen.pop()
                if sub_delta[p] > 0:
                    # Reject branch of a free positive-profit position:
                    # record the obligation for the prune above.
                    oblig.append(p)
                    rec(p + 1, gain, union)
                    oblig.pop()
                    return
            rec(p + 1, gain, union)

        # E == 0 is NOT special: reads with no exons can profitably join
        # an empty-structure isoform (union stays 0 == E).
        rec(0, base_gain, base_union)
        if best_sub is None:
            return None, None
        assigned = sorted(
            [int(rest_order[p]) for p in best_sub]
            + [int(v) for v in sub_order[free]]
        )
        return self.g_total - best_gain, assigned


def _replay(ctx: _PerStructure, order, optimistic, t_end,
            seed_gain: float | None = None) -> SolveResult:
    """The canonical incumbent loop over structures in (ascending
    optimistic, mask) order; shared by the full and wide paths.
    seed_gain is an external DFS floor derived from a feasible incumbent
    (see run_enum's argument in native/segenum.cpp: it admits exactly the
    assignments at-or-below that incumbent's cost, so the canonical
    result is unchanged)."""
    import time

    best_cost = ctx.g_total  # E = 0, S = empty
    best_E = 0
    best_S: list[int] = []
    ext = -np.inf if seed_gain is None else float(seed_gain)
    timed_out = False
    for E in order:
        E = int(E)
        opt = optimistic[E]
        if opt >= best_cost:
            # ascending visit order: no later E can strictly improve.
            break
        if time.monotonic() > t_end:
            timed_out = True
            break
        try:
            cost, assigned = ctx.best_for(
                E, t_end, floor_gain=max(ctx.g_total - best_cost, ext)
            )
        except _DfsTimeout:
            timed_out = True
            break
        if assigned is None:
            continue
        if cost < best_cost:
            best_cost = cost
            best_E = E
            best_S = assigned
    if timed_out:
        return SolveResult("TIMEOUT", best_cost, [], None, 0)
    iso = np.array([(best_E >> b) & 1 for b in range(ctx.Mi)], dtype=bool)
    return SolveResult("OPTIMAL", best_cost, best_S, iso, 0)


def _solve_segment_enum_py(inst: ClusterInstance, deadline_s: float = 60.0) -> SolveResult | None:
    """Pure-Python structure enumeration (the canonical definition)."""
    import time

    Mi = len(inst.seg_len)
    N = len(inst.rows)
    if Mi > MAX_SEGS:
        return None
    if N == 0:
        return SolveResult("OPTIMAL", 0.0, [], None)
    t_end = time.monotonic() + deadline_s
    ctx = _PerStructure(inst)
    n_masks = 1 << Mi
    optimistic = np.empty(n_masks, dtype=np.float64)
    block = 1 << 12
    for lo in range(0, n_masks, block):
        E_blk = np.arange(lo, min(lo + block, n_masks), dtype=np.uint32)
        optimistic[lo : lo + len(E_blk)] = ctx.optimistic_block(E_blk)
    E_all = np.arange(n_masks, dtype=np.uint32)
    order = np.lexsort((E_all, optimistic))
    return _replay(ctx, order, optimistic, t_end)



# Wall seconds spent in device bound evaluation (transfers included).
DEVICE_SECONDS = [0.0]

# Budget for the (reads x masks) temporaries of one bound block, at about
# 48 bytes per element (int64 bit tests, f32 profits, bool gates).
_BLOCK_BYTES = 512 << 20
_BYTES_PER_ELEMENT = 48


def _block(n_rows: int, n_masks: int) -> int:
    return max(1, min(n_masks, _BLOCK_BYTES // (_BYTES_PER_ELEMENT * max(n_rows, 1))))


def _popcount(x):
    """SWAR popcount of int64 values below 2^32 (Mi <= 26 here); stable
    torch has no popcount and no reliable uint32 bitwise ops on CUDA."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _mask_ints(vecs, Mi: int) -> np.ndarray:
    """(N, Mi) bool rows -> (N,) int64 bitmasks, bit b = segment b."""
    mat = np.asarray(vecs, dtype=bool).reshape(-1, Mi).astype(np.int64)
    return (mat << np.arange(Mi, dtype=np.int64)).sum(axis=1)


def optimistic_device(inst: ClusterInstance, n_masks: int, device) -> np.ndarray:
    """Per-mask optimistic bounds for the masks 0..n_masks-1: for each E,
    g_total - sum_i [I_i subset of E and d_i > 0] d_i with
    d_i = g_i - popcount(C_i & E). Counterpart of ``freddie_tpu``'s
    ``_optimistic_device``; evaluated on ``device`` in blocks of masks."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    Mi = len(inst.seg_len)
    rows = inst.rows
    I_int = _mask_ints([r.exons for r in rows], Mi)
    C_int = _mask_ints([r.corr for r in rows], Mi)
    g = np.array([r.garbage for r in rows], dtype=np.float32)
    g_total = float(g.sum())
    t0 = time.perf_counter()
    I = torch.from_numpy(I_int).to(dev)[:, None]
    C = torch.from_numpy(C_int).to(dev)[:, None]
    gv = torch.from_numpy(g).to(dev)[:, None]
    out = torch.empty(n_masks, dtype=torch.float32, device=dev)
    bs = _block(len(rows), n_masks)
    for lo in range(0, n_masks, bs):
        hi = min(lo + bs, n_masks)
        E = torch.arange(lo, hi, dtype=torch.int64, device=dev)[None, :]
        subset_ok = (I & ~E) == 0
        d = gv - _popcount(C & E).to(torch.float32)
        pos = torch.where(subset_ok & (d > 0), d, 0.0).sum(dim=0)
        out[lo:hi] = g_total - pos
    res = out.cpu().numpy().astype(np.float64)
    DEVICE_SECONDS[0] += time.perf_counter() - t0
    return res


def optimistic_masks_device(ctx: _PerStructure, masks: np.ndarray, device) -> np.ndarray:
    """Per-mask optimistic bounds for an explicit (K,) or (K, W) word-row
    mask list through two 0/1 (N, Mi) x (Mi, K) matrix products -- the
    device form of ``ctx.optimistic_block`` and the counterpart of
    ``freddie_tpu``'s ``_optimistic_masks_device``. 0/1 operands are exact
    in f32 and TF32 alike and the integer sums stay far below 2^24, so
    the values do not depend on ``allow_tf32``. Falls back to the host
    loop when the magnitude guard fails."""
    N, Mi = ctx.N, ctx.Mi
    if ctx.g_total >= 2**22 or N == 0:  # exactness guard (never in practice)
        out = np.empty(len(masks), dtype=np.float64)
        for lo in range(0, len(masks), 1 << 12):
            out[lo : lo + (1 << 12)] = ctx.optimistic_block(masks[lo : lo + (1 << 12)])
        return out
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)

    def bits_of(words: np.ndarray) -> np.ndarray:
        """(K, W) uint64 word rows -> (K, Mi) 0/1 f32."""
        words = np.asarray(words, dtype=np.uint64)
        if words.ndim == 1:
            words = words[:, None]
        b = np.arange(Mi, dtype=np.int64)
        return (
            (words[:, b >> 6] >> (b & 63).astype(np.uint64)[None, :]) & 1
        ).astype(np.float32)

    t0 = time.perf_counter()
    I_f = torch.from_numpy(bits_of(ctx.I_int)).to(dev)
    C_f = torch.from_numpy(bits_of(ctx.C_int)).to(dev)
    E_f = torch.from_numpy(bits_of(masks)).to(dev)
    g = torch.from_numpy(ctx.g.astype(np.float32)).to(dev)
    tot = I_f.sum(dim=1, keepdim=True)  # popcount(I)
    g_total = g.sum()
    K = E_f.shape[0]
    out = torch.empty(K, dtype=torch.float32, device=dev)
    bs = _block(N, K)
    for lo in range(0, K, bs):
        Et = E_f[lo : lo + bs].T
        subset_ok = (I_f @ Et) == tot  # I subset of E <=> |I & E| == |I|
        d = g[:, None] - C_f @ Et
        out[lo : lo + bs] = g_total - torch.where(subset_ok & (d > 0), d, 0.0).sum(dim=0)
    res = out.cpu().numpy().astype(np.float64)
    DEVICE_SECONDS[0] += time.perf_counter() - t0
    return res


def solve_segment_enum_wide(
    inst: ClusterInstance,
    incumbent_cost: float,
    deadline_s: float = 60.0,
    device="cuda",
) -> SolveResult | None:
    """Bound-filtered structure enumeration for MAX_SEGS < Mi <=
    WIDE_MAX_SEGS, with the bounds on ``device``; None when Mi is out of
    range or the filtered set exceeds WIDE_CANDIDATE_CAP. The body of
    ``freddie_tpu``'s ``solve_segment_enum_wide`` (equivalence argument
    there), with the bound call swapped."""
    Mi = len(inst.seg_len)
    N = len(inst.rows)
    if not (MAX_SEGS < Mi <= WIDE_MAX_SEGS):
        return None
    if N == 0:
        return SolveResult("OPTIMAL", 0.0, [], None)
    t_end = time.monotonic() + deadline_s
    n_masks = 1 << Mi
    optimistic = optimistic_device(inst, n_masks, device)
    passing = np.flatnonzero(optimistic <= incumbent_cost + 1e-9)
    if len(passing) > WIDE_CANDIDATE_CAP:
        return None
    order = passing[np.lexsort((passing, optimistic[passing]))]
    seed_gain = None
    if np.isfinite(incumbent_cost):
        g_total = float(sum(r.garbage for r in inst.rows))
        seed_gain = g_total - incumbent_cost - _granularity(inst)
    native = solve_segenum_list_native(
        inst, order, optimistic[order], max(t_end - time.monotonic(), 0.001),
        seed_gain=seed_gain,
    )
    if native is not None:
        return native
    ctx = _PerStructure(inst)
    opt_map = {int(E): float(optimistic[E]) for E in passing}
    return _replay(ctx, order, opt_map, t_end, seed_gain=seed_gain)


def solve_segment_enum_closure(
    inst: ClusterInstance,
    deadline_s: float = 60.0,
    incumbent_cost: float | None = None,
    device="cuda",
) -> SolveResult | None:
    """Union-closure structure enumeration for Mi <= CLOSURE_MAX_SEGS;
    None when Mi is out of range or the closure exceeds CLOSURE_CAP. The
    body of ``freddie_tpu``'s ``solve_segment_enum_closure`` (equivalence
    argument there); its bounds go to ``device`` when N x |closure| >=
    BOUNDS_DEVICE_MIN, to the host loop below."""
    Mi = len(inst.seg_len)
    N = len(inst.rows)
    if not (1 <= Mi <= CLOSURE_MAX_SEGS):
        return None
    if N == 0:
        return SolveResult("OPTIMAL", 0.0, [], None)
    t_end = time.monotonic() + deadline_s

    ctx = _PerStructure(inst)  # also supplies the packed I-masks
    if ctx.W == 1:
        closure = np.zeros(1, dtype=np.uint64)  # the empty union
        for m in np.unique(ctx.I_int[:, 0]):
            # closure is OR-closed over the masks processed so far, so a
            # mask already in it contributes nothing new (e|m stays inside).
            pos = int(np.searchsorted(closure, m))
            if pos < len(closure) and closure[pos] == m:
                continue
            closure = np.unique(np.concatenate([closure, closure | m]))
            if len(closure) > CLOSURE_CAP:
                return None
        mask_ints = closure.tolist()  # ascending
        masks_w = closure[:, None]  # (K, 1)
    else:
        # Multi-word build on Python ints, in the same ascending order.
        cset = {0}
        distinct = sorted({ctx._int_of_row(r) for r in ctx.I_int})
        for m in distinct:
            if m in cset:
                continue
            cset |= {e | m for e in cset}
            if len(cset) > CLOSURE_CAP:
                return None
        mask_ints = sorted(cset)
        masks_w = np.array(
            [[(m >> (64 * w)) & 0xFFFFFFFFFFFFFFFF for w in range(ctx.W)]
             for m in mask_ints],
            dtype=np.uint64,
        ).reshape(len(mask_ints), ctx.W)
    if N * len(mask_ints) >= BOUNDS_DEVICE_MIN:
        optimistic = optimistic_masks_device(ctx, masks_w, device)
    else:
        optimistic = np.empty(len(mask_ints), dtype=np.float64)
        block = 1 << 12
        for lo in range(0, len(mask_ints), block):
            optimistic[lo : lo + block] = ctx.optimistic_block(masks_w[lo : lo + block])
    seed_gain = None
    if incumbent_cost is not None:
        keep = optimistic <= incumbent_cost + 1e-9
        mask_ints = [m for m, k in zip(mask_ints, keep) if k]
        masks_w = masks_w[keep]
        optimistic = optimistic[keep]
        seed_gain = ctx.g_total - incumbent_cost - _granularity(inst)
    # Canonical (ascending optimistic, mask) order: mask_ints is already
    # mask-ascending, so a stable sort on optimistic alone gives it.
    perm = np.argsort(optimistic, kind="stable")
    order_ints = [mask_ints[p] for p in perm]
    order_w = masks_w[perm]
    order_opt = optimistic[perm]
    native = solve_segenum_list_native(
        inst, order_w, order_opt, max(t_end - time.monotonic(), 0.001),
        seed_gain=seed_gain,
    )
    if native is not None:
        return native
    opt_map = {m: float(o) for m, o in zip(order_ints, order_opt)}
    return _replay(ctx, order_ints, opt_map, t_end, seed_gain=seed_gain)
