"""The cluster solver's device-bounded escalations, on PyTorch.

Port of the two rungs of ``freddie_tpu/solver/segenum.py`` that reach
``jax``: the wide (bound-filtered) enumeration for MAX_SEGS < Mi <=
WIDE_MAX_SEGS and the union-closure enumeration, whose bound evaluation
goes to the device once N x |closure| crosses BOUNDS_DEVICE_MIN. Their
bodies are the JAX package's, with only the bound call swapped for a
torch one; everything jax-free (the per-structure scan, the canonical
replay, the native list replay) is imported from ``freddie_tpu``.

The gates (MAX_SEGS, WIDE_MAX_SEGS, WIDE_CANDIDATE_CAP, CLOSURE_MAX_SEGS,
CLOSURE_CAP, BOUNDS_DEVICE_MIN) are read from ``freddie_tpu``'s module at
call time, so there is one source of truth and a test that patches them
there drives both packages.

Exactness: every bound is g_total minus a sum of positive profits, each
a multiple of 0.5, with every partial sum far below 2^23, so f32 holds
each value exactly whatever the summation order, block size or device;
the values -- and therefore the canonical visit order -- equal the host
``_PerStructure.optimistic_block`` and the JAX package's bit for bit.
"""

from __future__ import annotations

import time

import numpy as np

from freddie_tpu.solver import segenum as _se
from freddie_tpu.solver.exact import ClusterInstance, SolveResult
from freddie_tpu.solver.native import solve_segenum_list_native
from freddie_tpu.solver.segenum import _granularity, _PerStructure, _replay

# Wall seconds spent in device bound evaluation (transfers included), the
# counterpart of freddie_tpu.solver.segenum.DEVICE_SECONDS.
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
    if not (_se.MAX_SEGS < Mi <= _se.WIDE_MAX_SEGS):
        return None
    if N == 0:
        return SolveResult("OPTIMAL", 0.0, [], None)
    t_end = time.monotonic() + deadline_s
    n_masks = 1 << Mi
    optimistic = optimistic_device(inst, n_masks, device)
    passing = np.flatnonzero(optimistic <= incumbent_cost + 1e-9)
    if len(passing) > _se.WIDE_CANDIDATE_CAP:
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
    if not (1 <= Mi <= _se.CLOSURE_MAX_SEGS):
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
            if len(closure) > _se.CLOSURE_CAP:
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
            if len(cset) > _se.CLOSURE_CAP:
                return None
        mask_ints = sorted(cset)
        masks_w = np.array(
            [[(m >> (64 * w)) & 0xFFFFFFFFFFFFFFFF for w in range(ctx.W)]
             for m in mask_ints],
            dtype=np.uint64,
        ).reshape(len(mask_ints), ctx.W)
    if N * len(mask_ints) >= _se.BOUNDS_DEVICE_MIN:
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
