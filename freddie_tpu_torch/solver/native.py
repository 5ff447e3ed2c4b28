"""ctypes bindings for the C++ branch-and-bound core (native/bnb_solver.cpp).

Same algorithm and deterministic order as solver.exact.solve_exact --
results are bit-identical (asserted by tests); the native core exists for
throughput on large tint sets. The library is built on first use with g++
(no external deps); if no toolchain is available, callers fall back to the
Python implementation transparently.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .exact import ClusterInstance, SolveResult

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "bnb_solver.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "libbnb.so")

_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        srcs = [
            _SRC,
            os.path.join(os.path.dirname(_SRC), "segenum.cpp"),
            os.path.join(os.path.dirname(_SRC), "round_solver.cpp"),
        ]
        newest = max(os.path.getmtime(s) for s in srcs)
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < newest:
            # Per-pid temp + atomic os.replace: concurrent processes must
            # never dlopen a half-written .so.
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp] + srcs,
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        lib.solve_bnb.restype = ctypes.c_int
        lib.solve_segenum.restype = ctypes.c_int
        lib.solve_segenum_list.restype = ctypes.c_int
        lib.solve_segenum_list_w2.restype = ctypes.c_int
        lib.solve_round.restype = ctypes.c_int
        lib.solve_round_cached.restype = ctypes.c_int
        lib.closure_cache_new.restype = ctypes.c_void_p
        lib.closure_cache_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _build_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _pack_bits(mat: np.ndarray, words: int) -> np.ndarray:
    """(N, M) bool -> (N, words) uint64, bit b of word w = column w*64+b."""
    n, m = mat.shape
    padded = np.zeros((n, words * 64), dtype=bool)
    if m:
        padded[:, :m] = mat
    packed = np.packbits(padded, axis=1, bitorder="little")  # (n, words*8) u8
    return np.ascontiguousarray(packed).view(np.uint64).reshape(n, words)


def solve_exact_native(
    inst: ClusterInstance, deadline_s: float = 60.0, node_budget: int = 0
) -> SolveResult | None:
    """Native solve; None when the toolchain/library is unavailable.
    node_budget > 0 stops deterministically with status 'BUDGET' and the
    incumbent found so far."""
    lib = _load()
    if lib is None:
        return None
    rows = inst.rows
    N = len(rows)
    if N == 0:
        return SolveResult("OPTIMAL", 0.0, [], None)
    M = len(inst.seg_len)
    words = max((M + 63) // 64, 1)

    order = sorted(range(N), key=lambda i: (-rows[i].garbage, i))
    pos_of = {o: p for p, o in enumerate(order)}
    if inst.exons_mat is not None:
        exons = _pack_bits(inst.exons_mat[order].astype(bool), words)
        corr = _pack_bits(inst.corr_mat[order].astype(bool), words)
    else:
        exons = _pack_bits(np.stack([rows[i].exons for i in order]).astype(bool), words)
        corr = _pack_bits(np.stack([rows[i].corr for i in order]).astype(bool), words)
    garbage = np.array([rows[i].garbage for i in order], dtype=np.float64)
    seg_len = np.ascontiguousarray(inst.seg_len, dtype=np.int64)

    gap_counts = np.array([len(rows[o].gaps) for o in order], dtype=np.int32)
    total_gaps = int(gap_counts.sum())
    if total_gaps:
        masks = np.stack(
            [np.asarray(m, dtype=bool) for o in order for (m, _l) in rows[o].gaps]
        )
        gap_masks = _pack_bits(masks, words)
        gap_lens = np.array(
            [l for o in order for (_m, l) in rows[o].gaps], dtype=np.int64
        )
    else:
        gap_masks = np.zeros((1, words), dtype=np.uint64)
        gap_lens = np.zeros(1, dtype=np.int64)

    pos_arr = np.empty(N, dtype=np.int32)
    pos_arr[order] = np.arange(N, dtype=np.int32)
    incomp = pos_arr[np.asarray(inst.incomp, dtype=np.int64).reshape(-1, 2)]

    out_assigned = np.zeros(N, dtype=np.int32)
    out_n = ctypes.c_int32(0)
    out_obj = ctypes.c_double(0.0)
    out_E = np.zeros(words, dtype=np.uint64)
    out_nodes = ctypes.c_int64(0)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    status = lib.solve_bnb(
        ctypes.c_int(N),
        ctypes.c_int(M),
        ptr(np.ascontiguousarray(exons), ctypes.c_uint64),
        ptr(np.ascontiguousarray(corr), ctypes.c_uint64),
        ptr(garbage, ctypes.c_double),
        ptr(seg_len, ctypes.c_int64),
        ptr(gap_counts, ctypes.c_int32),
        ptr(np.ascontiguousarray(gap_masks), ctypes.c_uint64),
        ptr(gap_lens, ctypes.c_int64),
        ctypes.c_int(len(incomp)),
        ptr(np.ascontiguousarray(incomp), ctypes.c_int32),
        ctypes.c_int64(inst.eps_scale),
        ctypes.c_int64(inst.eps_scaled),
        ctypes.c_int64(inst.offset),
        ctypes.c_double(deadline_s),
        ctypes.c_int64(node_budget),
        ptr(out_assigned, ctypes.c_int32),
        ctypes.byref(out_n),
        ctypes.byref(out_obj),
        ptr(out_E, ctypes.c_uint64),
        ctypes.byref(out_nodes),
    )
    if status == 1:
        return SolveResult("TIMEOUT", out_obj.value, [], None, out_nodes.value)
    assigned = sorted(order[p] for p in out_assigned[: out_n.value].tolist())
    E = np.zeros(M, dtype=bool)
    if M:
        bits = np.unpackbits(out_E.view(np.uint8), bitorder="little")
        E = bits[:M].astype(bool)
    return SolveResult(
        "BUDGET" if status == 2 else "OPTIMAL",
        out_obj.value, assigned, E, out_nodes.value,
    )


def solve_round_native(
    inst: ClusterInstance, deadline_s: float, node_budget: int
) -> "tuple[str, SolveResult] | None":
    """Consolidated native round solve (native/round_solver.cpp): phase-1
    branch-and-bound plus the union-closure escalation in one call, fed by
    the instance's flat arrays (no per-row Python objects, no per-rung
    repacking). Returns None when the library or the flat arrays are
    unavailable -- the caller then runs the rung-by-rung chain, with
    identical results (dispatch gates are content-only twins).

    Returns (kind, result): kind 'final' (result is the answer),
    'budget' (phase-1 BUDGET, closure declined on content -- caller
    escalates with the incumbent in `result`), 'closure_timeout'
    (caller runs the LP proof / full search with the incumbent), or
    'closure_device' (closure built but N*K crosses the device-bounds
    gate -- caller re-runs the closure escalation in Python, where the
    bound evaluation goes to the batched XLA matmul)."""
    lib = _load()
    if lib is None or inst.exons_mat is None or inst.garbage_arr is None:
        return None
    from .segenum import BOUNDS_DEVICE_MIN, CLOSURE_CAP, CLOSURE_MAX_SEGS

    N, Mi = inst.exons_mat.shape
    if N == 0:
        return "final", SolveResult("OPTIMAL", 0.0, [], None)
    words = max((Mi + 63) // 64, 1)
    I_b = np.ascontiguousarray(inst.exons_mat, dtype=np.uint8)
    C_b = np.ascontiguousarray(inst.corr_mat, dtype=np.uint8)
    garbage = np.ascontiguousarray(inst.garbage_arr, dtype=np.float64)
    seg_len = np.ascontiguousarray(inst.seg_len, dtype=np.int64)
    gap_counts = np.ascontiguousarray(inst.gap_counts, dtype=np.int32)
    G = max(len(inst.gap_lo), 1)
    gap_lo = np.zeros(G, dtype=np.int32)
    gap_hi = np.zeros(G, dtype=np.int32)
    gap_len = np.zeros(G, dtype=np.int64)
    gap_lo[: len(inst.gap_lo)] = inst.gap_lo
    gap_hi[: len(inst.gap_hi)] = inst.gap_hi
    gap_len[: len(inst.gap_len_arr)] = inst.gap_len_arr
    incomp = np.ascontiguousarray(
        np.asarray(inst.incomp, dtype=np.int32).reshape(-1, 2)
    )

    out_assigned = np.zeros(N, dtype=np.int32)
    out_n = ctypes.c_int32(0)
    out_obj = ctypes.c_double(0.0)
    out_E = np.zeros(words, dtype=np.uint64)
    out_nodes = ctypes.c_int64(0)

    status = lib.solve_round(
        ctypes.c_int(N),
        ctypes.c_int(Mi),
        _ptr(I_b, ctypes.c_uint8),
        _ptr(C_b, ctypes.c_uint8),
        _ptr(garbage, ctypes.c_double),
        _ptr(seg_len, ctypes.c_int64),
        _ptr(gap_counts, ctypes.c_int32),
        _ptr(gap_lo, ctypes.c_int32),
        _ptr(gap_hi, ctypes.c_int32),
        _ptr(gap_len, ctypes.c_int64),
        ctypes.c_int(len(incomp)),
        _ptr(incomp, ctypes.c_int32),
        ctypes.c_int64(inst.eps_scale),
        ctypes.c_int64(inst.eps_scaled),
        ctypes.c_int64(inst.offset),
        ctypes.c_double(deadline_s),
        ctypes.c_int64(node_budget),
        ctypes.c_int64(CLOSURE_MAX_SEGS),
        ctypes.c_int64(CLOSURE_CAP),
        ctypes.c_int64(BOUNDS_DEVICE_MIN),
        _ptr(out_assigned, ctypes.c_int32),
        ctypes.byref(out_n),
        ctypes.byref(out_obj),
        _ptr(out_E, ctypes.c_uint64),
        ctypes.byref(out_nodes),
    )
    assigned = out_assigned[: out_n.value].tolist()
    E = np.zeros(Mi, dtype=bool)
    if Mi:
        bits = np.unpackbits(out_E.view(np.uint8), bitorder="little")
        E = bits[:Mi].astype(bool)
    if status == 0:
        return "final", SolveResult(
            "OPTIMAL", out_obj.value, assigned, E, out_nodes.value
        )
    if status == 1:
        return "final", SolveResult(
            "TIMEOUT", out_obj.value, [], None, out_nodes.value
        )
    if status == 3:
        # Closure answers report nodes=0 like the Python closure path.
        return "final", SolveResult("OPTIMAL", out_obj.value, assigned, E, 0)
    incumbent = SolveResult(
        "BUDGET", out_obj.value, assigned, E, out_nodes.value
    )
    kinds = {2: "budget", 4: "closure_timeout", 5: "closure_device"}
    return kinds[status], incumbent


def _pack_segenum(inst: ClusterInstance, dtype=np.uint32, words: int = 1):
    """Flat bitmask arrays for the segenum entry points (u32 for the full
    enumeration ABI, u64 for the list-replay ABI; words=2 emits (n, 2)
    little-endian uint64 word rows for the two-word replay ABI)."""
    rows = inst.rows
    M = len(inst.seg_len)
    assert M <= 8 * dtype().itemsize * words, (M, dtype, words)

    def masks_of(vecs: list) -> np.ndarray:
        """Stack of bool vectors -> little-endian bitmask words each."""
        n = len(vecs)
        padded = np.zeros((n, 64 * words), dtype=bool)
        if n and M:
            padded[:, :M] = np.asarray(vecs, dtype=bool)
        packed = (
            np.packbits(padded, axis=1, bitorder="little").view(np.uint64)
        )
        if words == 1:
            return packed.ravel().astype(dtype)
        return np.ascontiguousarray(packed.reshape(n, words))

    if inst.exons_mat is not None:
        I_masks = masks_of(inst.exons_mat)
        C_masks = masks_of(inst.corr_mat)
    else:
        I_masks = masks_of([r.exons for r in rows])
        C_masks = masks_of([r.corr for r in rows])
    garbage = np.array([r.garbage for r in rows], dtype=np.float64)
    seg_len = np.ascontiguousarray(inst.seg_len, dtype=np.int64)
    gap_counts = np.array([len(r.gaps) for r in rows], dtype=np.int32)
    if int(gap_counts.sum()):
        gap_masks = masks_of([m for r in rows for (m, _l) in r.gaps])
        gap_lens = np.array([l for r in rows for (_m, l) in r.gaps], dtype=np.int64)
    else:
        gap_masks = (np.zeros(1, dtype=dtype) if words == 1
                     else np.zeros((1, words), dtype=np.uint64))
        gap_lens = np.zeros(1, dtype=np.int64)
    incomp = np.asarray(inst.incomp, dtype=np.int32).reshape(-1, 2)
    return I_masks, C_masks, garbage, seg_len, gap_counts, gap_masks, gap_lens, incomp


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _segenum_result(status, out_assigned, out_n, out_obj, out_E, M):
    if status < 0:
        return None
    if status == 1:
        return SolveResult("TIMEOUT", out_obj.value, [], None, 0)
    E = np.array([(int(out_E.value) >> b) & 1 for b in range(M)], dtype=bool)
    assigned = sorted(out_assigned[: out_n.value].tolist())
    return SolveResult("OPTIMAL", out_obj.value, assigned, E, 0)


def solve_segenum_native(inst: ClusterInstance, deadline_s: float = 60.0) -> SolveResult | None:
    """Native structure-enumeration solve (C++ twin of solver.segenum);
    None when the library is unavailable or Mi > segenum.MAX_SEGS (the
    same content cap the Python twin enforces, so availability only
    changes speed). Results bit-equal to the Python implementation
    (tests/test_segenum_native.py)."""
    from .segenum import MAX_SEGS

    lib = _load()
    M = len(inst.seg_len)
    if lib is None or M > MAX_SEGS:
        return None
    N = len(inst.rows)
    if N == 0:
        return SolveResult("OPTIMAL", 0.0, [], None)

    (I_masks, C_masks, garbage, seg_len, gap_counts, gap_masks, gap_lens,
     incomp) = _pack_segenum(inst)
    out_assigned = np.zeros(N, dtype=np.int32)
    out_n = ctypes.c_int32(0)
    out_obj = ctypes.c_double(0.0)
    out_E = ctypes.c_uint32(0)

    status = lib.solve_segenum(
        ctypes.c_int(N),
        ctypes.c_int(M),
        _ptr(I_masks, ctypes.c_uint32),
        _ptr(C_masks, ctypes.c_uint32),
        _ptr(garbage, ctypes.c_double),
        _ptr(seg_len, ctypes.c_int64),
        _ptr(gap_counts, ctypes.c_int32),
        _ptr(np.ascontiguousarray(gap_masks), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(gap_lens), ctypes.c_int64),
        ctypes.c_int(len(incomp)),
        _ptr(np.ascontiguousarray(incomp), ctypes.c_int32),
        ctypes.c_int64(inst.eps_scale),
        ctypes.c_int64(inst.eps_scaled),
        ctypes.c_int64(inst.offset),
        ctypes.c_double(deadline_s),
        _ptr(out_assigned, ctypes.c_int32),
        ctypes.byref(out_n),
        ctypes.byref(out_obj),
        ctypes.byref(out_E),
    )
    return _segenum_result(status, out_assigned, out_n, out_obj, out_E, M)


def solve_segenum_list_native(
    inst: ClusterInstance,
    order: np.ndarray,
    order_opt: np.ndarray,
    deadline_s: float = 60.0,
    seed_gain: float | None = None,
) -> SolveResult | None:
    """Native canonical replay over an explicit pre-sorted (mask,
    optimistic) list -- the engine behind the wide and union-closure
    escalations (see segenum.solve_segment_enum_wide/_closure). None when
    the library is unavailable; the caller then replays the same list in
    Python with identical results. seed_gain is the external DFS floor
    (result-preservation argument in native/segenum.cpp's run_enum)."""
    lib = _load()
    M = len(inst.seg_len)
    if lib is None or M > 128:
        return None
    N = len(inst.rows)
    if N == 0:
        return SolveResult("OPTIMAL", 0.0, [], None)

    order = np.asarray(order)
    words = 1 if M <= 64 else 2
    (I_masks, C_masks, garbage, seg_len, gap_counts, gap_masks, gap_lens,
     incomp) = _pack_segenum(inst, dtype=np.uint64, words=words)
    if order.ndim == 2 and order.shape[1] == 1:
        order = order[:, 0]
    order_opt = np.ascontiguousarray(order_opt, dtype=np.float64)
    out_assigned = np.zeros(N, dtype=np.int32)
    out_n = ctypes.c_int32(0)
    out_obj = ctypes.c_double(0.0)

    common_pre = [
        ctypes.c_int(N),
        ctypes.c_int(M),
        _ptr(np.ascontiguousarray(I_masks), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(C_masks), ctypes.c_uint64),
        _ptr(garbage, ctypes.c_double),
        _ptr(seg_len, ctypes.c_int64),
        _ptr(gap_counts, ctypes.c_int32),
        _ptr(np.ascontiguousarray(gap_masks), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(gap_lens), ctypes.c_int64),
        ctypes.c_int(len(incomp)),
        _ptr(np.ascontiguousarray(incomp), ctypes.c_int32),
        ctypes.c_int64(inst.eps_scale),
        ctypes.c_int64(inst.eps_scaled),
        ctypes.c_int64(inst.offset),
    ]
    common_post = [
        _ptr(order_opt, ctypes.c_double),
        ctypes.c_int64(len(order)),
        ctypes.c_double(deadline_s),
        ctypes.c_double(float("-inf") if seed_gain is None else seed_gain),
        _ptr(out_assigned, ctypes.c_int32),
        ctypes.byref(out_n),
        ctypes.byref(out_obj),
    ]
    if words == 1:
        order1 = np.ascontiguousarray(order, dtype=np.uint64)
        out_E = ctypes.c_uint64(0)
        status = lib.solve_segenum_list(
            *common_pre, _ptr(order1, ctypes.c_uint64), *common_post,
            ctypes.byref(out_E),
        )
        return _segenum_result(status, out_assigned, out_n, out_obj, out_E, M)
    order2 = np.ascontiguousarray(order.reshape(len(order), 2),
                                  dtype=np.uint64)
    out_E2 = np.zeros(2, dtype=np.uint64)
    status = lib.solve_segenum_list_w2(
        *common_pre, _ptr(order2, ctypes.c_uint64), *common_post,
        _ptr(out_E2, ctypes.c_uint64),
    )
    if status < 0:
        return None
    if status == 1:
        return SolveResult("TIMEOUT", out_obj.value, [], None, 0)
    E_int = int(out_E2[0]) | (int(out_E2[1]) << 64)
    E = np.array([(E_int >> b) & 1 for b in range(M)], dtype=bool)
    assigned = sorted(out_assigned[: out_n.value].tolist())
    return SolveResult("OPTIMAL", out_obj.value, assigned, E, 0)
