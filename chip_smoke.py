#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py --kernels  # phases 1 and 2 only, no result line
    python3 chip_smoke.py --fuzz N   # everything, then N seed shifts of the fuzz

Builds the segmentation-DP kernels from ``freddie_tpu_torch/csrc`` and,
on the card:

1. holds K1 (``solve_batch_cuda``) and K2 (``pipelined=True``) bit for
   bit against their plain PyTorch version (TF32 off and on) and each
   other at the segment stage's chunk shapes and the kernel benchmark
   shape, with narrow and wide weights (two to four 7-bit limbs),
   candidate counts far below P (dead blocks) and read_support at both
   ends of its range, holds both kernels' chains against
   ``_walk_chains``, times all three, and reckons each kernel's bound
   from the run's inputs;
2. drives K2's path (``solve_batch_cuda(pipelined=True)``) once with the
   launch counts at zero, profiles one K1 and one K2 call, checks that
   K2's chains cost no launch after its kernel, prints what the runtime
   reports for K2 (blocks per SM, registers, shared memory) and times it
   at B = G, 2G, 8G and 2048 beside a step model;
3. holds the cluster solver's device bounds against the host bounds,
   and the port's two-phase solve on the card against the CPU, with the
   gates set so that the wide and the closure rung both run;
4. drives the port's whole pipeline (split -> segment -> cluster ->
   isoforms) over the 25,920-read benchmark corpus through the port's
   benchmark (``freddie_tpu_torch.bench.segment.measure``, whose JSON line
   it prints after ``[bench] ``) and checks that the
   DP really ran in K1, that the segment TSVs equal the host-oracle
   route's byte for byte, and how many simulated isoforms came back;
5. holds the batched polyA scan on the card against the numpy twin and
   the C scorer window by window, times it against the C scorer, and
   runs the segment stage with the batched route forced (Python phase
   A path), byte-identical to the host-oracle route;
6. runs the loci mesh on one card (the card listed as four or three
   shards): bit-equal to one K1 launch, and the production dispatch
   equal to the host oracle at B=5 and at the stage's buckets;
7. runs the distributed pipeline in two gloo processes on card 0 and
   the ``workflow`` CLI, each byte-identical to the pipeline of 4;
8. the widest bucket: a batch at P = 224 launched and bit-equal to the
   plain version, chains included; problems of the P = 256 bucket through
   the dispatch solved by the host oracle without a launch, the wrapper
   still raising there; and ``segment --max-problem-size 250`` through
   the CLI on a corpus with a 245-candidate problem, on the card and on
   the CPU, byte-identical;
9. the segment stage on the card with a stream window of 5 tints (forced
   flushes of partial buckets), byte-identical to the run of 4;
10. the entry points: ``entry(device)`` once and ``dryrun_multichip(4)``
    over the card listed four times (and over the real cards when there
    are several);
11. the tools at a small size: ``bound_device_experiment`` on a two-point
    grid, ``profile_kernel_phases`` at (64, 64, 384), the weak-scaling
    mode of ``parallel.bench`` over the card listed 1, 2, 4 times,
    ``warm_kernels``;
12. with ``--fuzz N``: N seed shifts of the parity suite's three corpora,
    the device route against the host-oracle route.

K1's launch count in the kernel table sums the runs of 4-10, each read
with the count set to zero just before it; the line before the card's
name gives each path's own count. No phase imports JAX. Details go to earlier lines; the line before the
last is the kernel table as JSON, the last line ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero without that
line; so does a machine with no GPU.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from freddie_tpu_torch.bench.common import (
    KERNEL_SHAPE, STAGE_SHAPES, TIMED_REPS, bound_ms, card_line, same_tsvs, synthetic_batch,
    time_ms)

REPO = os.path.dirname(os.path.abspath(__file__))

# (B, P, R): the segment stage's full chunk at the (P, R) buckets
# (16, 128), (32, 512), (64, 512) -- min(suggested_batch_size, 512)
# rounded down to a power of two -- then the three launches the stage
# makes on the benchmark corpus, then the kernel benchmark of bench.py.
CHUNK_SHAPES = [(512, 16, 128), (256, 32, 512), (64, 64, 512)] + STAGE_SHAPES
BENCH_SHAPE = KERNEL_SHAPE
# K2 only: a lone block with one problem, and G+3 problems (blocks that
# own two), at (P, R) = (32, 512); G is K2's grid on this card.
PIPE_P_R = (32, 512)


def log(*args):
    print(*args, flush=True)


def max_abs_diff(a, b, P: int) -> float:
    """Largest |difference| between two (K, best_j, best_k) results over K's
    rows 0..P-2 (the backpointers), best_j and best_k."""
    return float(max(
        (a[0][:, : P - 1] - b[0][:, : P - 1]).abs().max().item(),
        (a[1] - b[1]).abs().max().item(),
        (a[2] - b[2]).abs().max().item(),
    ))


def kernel_phase(dev, card) -> dict:
    """K1 and K2 (solve_batch_cuda, pipelined off and on) against
    _solve_batch_torch on the card (TF32 off and on) and each other: K
    rows 0..P-2, best_j and best_k bit-equal, K's last row (best_j,
    best_k), both kernels' chains equal to _walk_chains of the plain result;
    median times of all three. Returns, per kernel, the largest error,
    the times and the bound at the benchmark shape."""
    import numpy as np
    import torch

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import (
        ScaledThresholds, _solve_batch_torch, _walk_chains, to_device)

    thr = ScaledThresholds(0.9)
    lookup = torch.from_numpy(thr.lookup).to(dev)
    rng = np.random.default_rng(2024)
    max_err = {"segdp": 0.0, "segdp_pipelined": 0.0}
    times = {}
    G = segdp_cuda.pipelined_grid(65535, PIPE_P_R[0])
    pipe_only = [((1,) + PIPE_P_R, False), ((G + 3,) + PIPE_P_R, False)]
    # (shape, wide, short, read_support): every chunk shape narrow and
    # wide (x97: two limbs), the benchmark shape, K2's grid edges; then
    # candidate counts of 3..P/4 at each P (most blocks dead), three and
    # four weight limbs, and read_support at 1 and far above most sums.
    cases = ([(s, w, False, 3) for s in CHUNK_SHAPES for w in (False, True)]
             + [(BENCH_SHAPE, False, False, 3)]
             + [(s, False, False, 3) for s, _w in pipe_only]
             + [(s, False, True, 3) for s in CHUNK_SHAPES[3:]]
             + [((64, 32, 96), 97 * 300, False, 3), ((64, 16, 6), 2**19, False, 3),
                ((64, 32, 384), False, False, 1), ((64, 64, 384), True, False, 200)])
    bounds = {}
    for (B, P, R), wide, short, rs in cases:
        t = to_device(synthetic_batch(rng, B, P, R, wide, short), dev)
        args = (t["C"], t["y"], t["W"], t["n_cand"], rs, lookup, thr.scale)
        k1 = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
        k2 = segdp_cuda.solve_batch_cuda(*args, pipelined=True, with_chains=True)
        got = {"segdp": k1[:3], "segdp_pipelined": k2[:3]}
        plain = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                plain.append(_solve_batch_torch(*args))
                torch.cuda.synchronize()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        where = f"at B={B} P={P} R={R} wide={wide} short={short} read_support={rs}"
        walked = _walk_chains(*plain[0])
        for name, chains in (("K1", k1[3]), ("K2", k2[3])):
            if not torch.equal(chains, walked):
                raise RuntimeError(f"{name}'s chains != _walk_chains of the plain result {where}")
        for name, (K, bj, bk) in got.items():
            for tf32, ref in zip((False, True), plain):
                err = max_abs_diff((K, bj, bk), ref, P)
                if err != 0:
                    raise RuntimeError(f"{name} != plain (tf32 {tf32}) {where}: "
                                       f"max abs err {err}")
                max_err[name] = max(max_err[name], err)
            if not (torch.equal(K[:, P - 1, 0], bj) and torch.equal(K[:, P - 1, 1], bk)):
                raise RuntimeError(f"{name}: K's last row does not hold best_j, best_k {where}")
        if max_abs_diff(got["segdp_pipelined"], got["segdp"], P) != 0:
            raise RuntimeError(f"K2 != K1 {where}")
        n_seg = int((got["segdp"][1] >= 0).sum())
        k1_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args))
        k2_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True))
        p_ms = time_ms(lambda: _solve_batch_torch(*args))
        times[(B, P, R, wide, short, rs)] = (k1_ms, k2_ms, p_ms)
        b_ms, b_by, by_bytes, by_ops = bound_ms(t, P)
        bounds[(B, P, R, wide, short, rs)] = b_ms, b_by
        log(f"[kernel] B={B} P={P} R={R} wide={wide} short={short} read_support={rs} "
            f"(K2 grid {segdp_cuda.pipelined_grid(B, P)}): K1 and K2 bit-equal to "
            f"plain (tf32 off and on) and to each other, both kernels' chains equal to "
            f"_walk_chains, {n_seg}/{B} segmented; "
            f"K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms, plain {p_ms:.3f} ms "
            f"(median of {TIMED_REPS}); bound {b_ms:.4f} ms by {b_by} (bytes "
            f"{by_bytes:.4f} ms, operations {by_ops:.4f} ms); on {card}")
        del t, args, got, plain, k1, k2, walked
        torch.cuda.empty_cache()
    key = BENCH_SHAPE + (False, False, 3)
    k1_ms, k2_ms, p_ms = times[key]
    b_ms, b_by = bounds[key]
    # No one PyTorch call computes the DP: there is no library time.
    common = dict(plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return {
        "segdp": dict(max_abs_err=max_err["segdp"], ms=k1_ms, **common),
        "segdp_pipelined": dict(max_abs_err=max_err["segdp_pipelined"], ms=k2_ms, **common),
    }


def pipelined_path(dev, card) -> int:
    """K2's path, ``solve_batch_cuda(pipelined=True)``, driven once at the
    benchmark shape with every launch count at zero; its result is held
    against K1's. Then one K1 and one K2 call under torch.profiler: the
    pair-statistics pass alone, the wavefront with its chain walk, and
    K2; K1's two launches again at the segment stage's three shapes; the
    plain chain walk (_walk_chains) that both kernels' last phase replaces
    on the card; that K2's call with chains ends in its one kernel; what
    the runtime reports for K2; and K2's tail. The profiles and the tail
    are ``freddie_tpu_torch.tools.profile_kernel_phases``'s. Returns K2's
    launches in the driven run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import ScaledThresholds, _walk_chains, to_device
    from freddie_tpu_torch.tools.profile_kernel_phases import device_ms_by_kernel, k2_tail

    thr = ScaledThresholds(0.9)
    t = to_device(synthetic_batch(np.random.default_rng(7), *BENCH_SHAPE, False), dev)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3,
            torch.from_numpy(thr.lookup).to(dev), thr.scale)
    segdp_cuda.LAUNCHES = 0
    segdp_cuda.PIPELINED_LAUNCHES = 0
    out = segdp_cuda.solve_batch_cuda(*args, pipelined=True)
    torch.cuda.synchronize()
    launches, k1_launches = segdp_cuda.PIPELINED_LAUNCHES, segdp_cuda.LAUNCHES
    if launches <= 0 or k1_launches != 0:
        raise RuntimeError(f"K2's path made {launches} K2 and {k1_launches} K1 launches")
    ref = segdp_cuda.solve_batch_cuda(*args)
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise RuntimeError("K2's path disagrees with K1")
    log(f"[pipelined] solve_batch_cuda(pipelined=True) at B,P,R={BENCH_SHAPE}: "
        f"{launches} K2 launch, 0 K1 launches; K, best_j, best_k equal to K1's")

    reps = 3
    dev_ms = device_ms_by_kernel(
        [lambda: segdp_cuda.solve_batch_cuda(*args),
         lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True)], reps)
    if len(dev_ms) == 3:
        log(f"[pipelined] profiler device time per call at {BENCH_SHAPE}: K1 "
            f"pair_stats alone {dev_ms['pair_stats_kernel']:.3f} ms + wavefront "
            f"with the chain walk {dev_ms['wavefront_kernel']:.3f} ms; K2 "
            f"{dev_ms['segdp_pipelined_kernel']:.3f} ms (mean of {reps}) on {card}")
    else:
        log(f"[pipelined] profiler recorded no device time for {sorted(dev_ms)}: "
            "per-phase times not measured")
    # At the segment stage's shapes the whole call follows the host (a
    # dozen small torch ops before the two launches), so K1's device time
    # there is read from the profiler as well.
    for shape in CHUNK_SHAPES[3:]:
        ts = to_device(synthetic_batch(np.random.default_rng(7), *shape, False), dev)
        sargs = (ts["C"], ts["y"], ts["W"], ts["n_cand"], 3, args[5], thr.scale)
        k1_ms = device_ms_by_kernel([lambda: segdp_cuda.solve_batch_cuda(*sargs)], reps)
        log(f"[pipelined] profiler device time per call at {shape}: K1 pair_stats "
            f"{k1_ms.get('pair_stats_kernel', 0.0):.3f} ms + wavefront with the chain walk "
            f"{k1_ms.get('wavefront_kernel', 0.0):.3f} ms (mean of {reps}; 0.000: not measured) "
            f"on {card}")
    walk_ms = time_ms(lambda: _walk_chains(*ref))
    t0 = time.perf_counter()
    _walk_chains(*ref)
    walk_host_ms = (time.perf_counter() - t0) * 1e3
    log(f"[pipelined] the plain chain walk at {BENCH_SHAPE}: {walk_ms:.3f} ms on the card "
        f"(median of {TIMED_REPS}), {walk_host_ms:.3f} ms of host time to enqueue its "
        f"launches; K1 walks the chains inside wavefront_kernel, on {card}")

    # K2 with its chains: the same launches as without them, the last of
    # them its own kernel, so nothing walks the chains afterwards.
    names = {}
    for with_chains in (False, True):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = segdp_cuda.solve_batch_cuda(*args, pipelined=True, with_chains=with_chains)
            torch.cuda.synchronize()
        on_card = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        names[with_chains] = [e.name for e in on_card]
    own = [n for n in names[True] if "segdp_pipelined_kernel" in n]
    if len(own) != 1 or "segdp_pipelined_kernel" not in names[True][-1] \
            or names[True] != names[False]:
        raise RuntimeError(f"K2 with chains enqueued {names[True]}, without {names[False]}: "
                           "expected the same launches, ending in segdp_pipelined_kernel")
    if not torch.equal(got[3], _walk_chains(*ref)):
        raise RuntimeError("K2's chains != _walk_chains of K1's result")
    log(f"[pipelined] solve_batch_cuda(pipelined=True, with_chains=True): "
        f"{len(names[True])} launches, the same as without chains, the last "
        f"segdp_pipelined_kernel; chains equal to _walk_chains")
    for P in (16, 32, 64, 96, 160):
        log(f"[pipelined] K2 at P={P}, as the runtime reports it: "
            f"{json.dumps(segdp_cuda.pipelined_occupancy(P))}, grid "
            f"{segdp_cuda.pipelined_grid(65535, P)}, on {card}")
    _B, P, R = BENCH_SHAPE
    tail = k2_tail(dev, P, R, BENCH_SHAPE[0], args[5], thr.scale)
    for r in tail["rows"]:
        log(f"[pipelined] K2 tail, B={r['B']} (G={tail['G']}, {r['steps']} steps) P={P} R={R}: "
            f"{r['k2_ms']:.3f} ms, step model {r['model_ms']:.3f} ms "
            f"(step {tail['step_ms']:.3f} ms); K1 {r['k1_ms']:.3f} ms (medians of "
            f"{TIMED_REPS}), on {card}")
    return launches


def cluster_phase(dev, card) -> None:
    """The cluster solver's device bounds on the card against the host
    bounds (``_PerStructure.optimistic_block``), and the port's two-phase
    solve on the card against the CPU with the wide and the closure rung
    forced to run."""
    import numpy as np
    import torch

    from freddie_tpu_torch.solver import segenum as tse
    from freddie_tpu_torch.solver import two_phase as ttp
    from freddie_tpu_torch.solver.native import native_available
    from freddie_tpu_torch.solver.two_phase import solve_two_phase
    from freddie_tpu_torch.utils.sim import clustered_instance

    def host_bounds(ctx, masks):
        out = np.empty(len(masks), dtype=np.float64)
        for lo in range(0, len(masks), 1 << 12):
            out[lo : lo + (1 << 12)] = ctx.optimistic_block(masks[lo : lo + (1 << 12)])
        return out

    for Mi in (21, 24):
        for N in (300, 1000):
            inst = clustered_instance(np.random.default_rng(Mi * N), N, Mi)
            t0 = time.perf_counter()
            got = tse.optimistic_device(inst, 1 << Mi, dev)
            dev_s = time.perf_counter() - t0
            # Every mask at Mi = 21, N = 300; elsewhere a strided sample of
            # 2^16, where the host's full pass would take most of a minute
            # (Mi = 21, N = 1000) or several.
            stride = 1 if (Mi, N) == (21, 300) else (1 << Mi) >> 16
            masks = np.arange(0, 1 << Mi, stride, dtype=np.uint64)
            t0 = time.perf_counter()
            want = host_bounds(tse._PerStructure(inst), masks)
            host_s = time.perf_counter() - t0
            if not np.array_equal(got[::stride], want):
                raise RuntimeError(f"optimistic_device != host at Mi={Mi} N={N}")
            log(f"[cluster] optimistic_device Mi={Mi} N={N}: {1 << Mi} masks in "
                f"{dev_s * 1e3:.3f} ms on the card (host clock, transfers included); "
                f"equal to the host bounds on {len(masks)} masks "
                f"({host_s:.3f} s on the host) on {card}")

    N = 1000
    K = -(-tse.BOUNDS_DEVICE_MIN // N)
    rng = np.random.default_rng(40)
    ctx = tse._PerStructure(clustered_instance(rng, N, 40, k_true=2))
    masks = np.unique(np.concatenate([
        ctx.I_int[:, 0], rng.integers(0, 1 << 40, size=K, dtype=np.uint64)]))[:, None]
    want = host_bounds(ctx, masks)
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            t0 = time.perf_counter()
            got = tse.optimistic_masks_device(ctx, masks, dev)
            dev_s = time.perf_counter() - t0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        if not np.array_equal(got, want):
            raise RuntimeError(f"optimistic_masks_device != host (tf32 {tf32})")
        log(f"[cluster] optimistic_masks_device N={N} K={len(masks)} Mi=40 tf32={tf32}: "
            f"{dev_s * 1e3:.3f} ms on the card (host clock), equal to the host bounds")

    calls = {"optimistic_device": 0, "optimistic_masks_device": 0}
    real = {name: getattr(tse, name) for name in calls}

    def counted(name):
        def fn(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return fn

    # The native solver twins compile with g++ at first use in a fresh
    # checkout; build them before the solves are timed.
    t0 = time.perf_counter()
    native_ok = native_available()
    log(f"[cluster] native solver engines: available={native_ok} "
        f"({time.perf_counter() - t0:.3f} s, build included)")
    saved = (tse.CLOSURE_CAP, tse.BOUNDS_DEVICE_MIN, ttp.NODE_BUDGET)
    cases = [
        ("wide", clustered_instance(np.random.default_rng(1), 20, 22),
         dict(CLOSURE_CAP=0), "optimistic_device"),
        ("closure", clustered_instance(np.random.default_rng(3), 1000, 40, k_true=2),
         dict(BOUNDS_DEVICE_MIN=1), "optimistic_masks_device"),
    ]
    try:
        for name in calls:
            setattr(tse, name, counted(name))
        ttp.NODE_BUDGET = 1
        for rung, inst, gates, bound in cases:
            for k, v in gates.items():
                setattr(tse, k, v)
            res, secs = {}, {}
            for where in (dev, "cpu"):
                before = calls[bound]
                t0 = time.perf_counter()
                res[str(where)] = solve_two_phase(inst, 120.0, where)
                secs[str(where)] = time.perf_counter() - t0
                if calls[bound] == before:
                    raise RuntimeError(f"the {rung} rung did not run on {where}")
            a, b = res[str(dev)], res["cpu"]
            if not (a.status == b.status == "OPTIMAL" and a.objective == b.objective
                    and a.assigned == b.assigned
                    and np.array_equal(np.asarray(a.isoform), np.asarray(b.isoform))):
                raise RuntimeError(f"solve_two_phase ({rung} rung) differs: card "
                                   f"{a.status} {a.objective}, cpu {b.status} {b.objective}")
            log(f"[cluster] solve_two_phase, {rung} rung, N={len(inst.rows)} "
                f"Mi={len(inst.seg_len)}: card {secs[str(dev)]:.3f} s, cpu "
                f"{secs['cpu']:.3f} s; same status, objective {a.objective}, "
                f"{len(a.assigned)} reads assigned, same isoform")
            tse.CLOSURE_CAP, tse.BOUNDS_DEVICE_MIN = saved[:2]
    finally:
        tse.CLOSURE_CAP, tse.BOUNDS_DEVICE_MIN, ttp.NODE_BUDGET = saved
        for name, fn in real.items():
            setattr(tse, name, fn)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported by the cluster bounds")


def pipeline_phase(dev, workdir: str):
    """The port's pipeline on the card over the benchmark corpus, through
    the port's benchmark (``bench.segment.measure``: the pipeline, three
    hot segment runs, the host-oracle route and its byte-identity,
    recovery, the kernel microbenchmarks; not its milder second corpus,
    which drives no path the first does not); prints its JSON line after
    ``[bench] ``. Returns the K1 launches of the pipeline run (read by the
    benchmark with the counts at zero just before it) and where its inputs
    and outputs are."""
    from freddie_tpu_torch.bench import segment as bench

    result, run = bench.measure(
        dev, workdir, log=lambda msg: log(msg.replace("[bench]", "[pipeline]", 1)),
        mild=False)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported on the port's path")
    launches = result["segment_k1_launches"]
    if launches <= 0 or not result["segment_matches_host_oracle"]:
        raise RuntimeError(f"the benchmark reported {launches} K1 launches")
    log("[bench] " + json.dumps(result))
    return launches, run


def polya_windows(rng, n: int):
    """n soft-clip-like windows and their scan chars: random bases with up
    to three runs of 15-60 of the char (10% noise), of lengths 0 to 1.25
    MAX_WINDOW, the bucket edges and MAX_WINDOW + 1 among them."""
    import numpy as np

    from freddie_tpu_torch.ops.polya_batch import MAX_WINDOW

    bases = np.array(list("ACGT"))
    edges = [0, 1, 20, 64, 65, MAX_WINDOW - 1, MAX_WINDOW, MAX_WINDOW + 1]
    windows, chars = [], []
    for i in range(n):
        L = edges[i] if i < len(edges) else int(rng.integers(0, MAX_WINDOW * 5 // 4 + 1))
        c = "A" if rng.random() < 0.5 else "T"
        w = bases[rng.integers(0, 4, size=L)]
        for _ in range(int(rng.integers(0, 4))):
            lo = int(rng.integers(0, max(L, 1)))
            hi = min(L, lo + int(rng.integers(15, 61)))
            w[lo:hi] = np.where(rng.random(hi - lo) < 0.1, w[lo:hi], c)
        windows.append("".join(w))
        chars.append(c)
    return windows, chars


def polya_phase(dev, card, run: dict, workdir: str) -> int:
    """The port's batched polyA scan on the card: equal to the numpy twin
    (_scan_np) and the C scorer on every window, timed against the C
    scorer; then the segment stage with the Python phase A path and the
    batched route forced over the benchmark corpus, whose TSVs must equal
    the host-oracle route's. Returns the K1 launches of that run."""
    import numpy as np
    import torch

    from freddie_tpu_torch.config import SegmentConfig
    from freddie_tpu_torch.ops import polya_batch as tpb
    from freddie_tpu_torch.ops.polya import _load_ctok
    from freddie_tpu_torch.ops.polya_batch import MAX_WINDOW, _scan_np
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.stages.segment import run_segment

    ctok = _load_ctok()
    if ctok is None or not hasattr(ctok, "best_run"):
        raise RuntimeError("the C polyA scorer (native/polyatok.c) did not build")
    windows, chars = polya_windows(np.random.default_rng(5), 40_000)
    lens = np.array([len(w) for w in windows], dtype=np.int32)
    Lmax = int(lens.max())
    grid = np.zeros((len(windows), Lmax), dtype=np.uint8)
    grid[np.arange(Lmax)[None, :] < lens[:, None]] = np.frombuffer(
        "".join(windows).encode(), dtype=np.uint8)
    found, first, length, cnt = _scan_np(grid == np.array([[ord(c)] for c in chars],
                                                          dtype=np.uint8), lens)
    twin = [(int(f), int(n), int(k)) if ok else None
            for ok, f, n, k in zip(found, first, length, cnt)]
    scans = tpb.SCANS
    got = tpb.best_poly_batch(windows, chars, dev)
    torch.cuda.synchronize()
    if tpb.SCANS == scans:
        raise RuntimeError("best_poly_batch made no scan on the card")
    c_res = [ctok.best_run(w, 0, len(w), 0, c) for w, c in zip(windows, chars)]
    bad = [i for i in range(len(windows)) if not got[i] == twin[i] == c_res[i]]
    if bad:
        i = bad[0]
        raise RuntimeError(f"best_poly_batch disagrees on {len(bad)} windows, e.g. length "
                           f"{len(windows[i])}: card {got[i]}, numpy {twin[i]}, C {c_res[i]}")
    short = [i for i in range(len(windows)) if len(windows[i]) <= MAX_WINDOW]
    sw, sc = [windows[i] for i in short], [chars[i] for i in short]
    card_s, c_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        tpb.best_poly_batch(sw, sc, dev)
        card_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for w, c in zip(sw, sc):
            ctok.best_run(w, 0, len(w), 0, c)
        c_s.append(time.perf_counter() - t0)
    log(f"[polya] best_poly_batch on the card equal to _scan_np and the C scorer on "
        f"{len(windows)} windows of length 0..{Lmax} ({sum(r is not None for r in got)} "
        f"runs found, {len(windows) - len(short)} past MAX_WINDOW={MAX_WINDOW} on the host); "
        f"{len(short)} windows <= MAX_WINDOW: card {min(card_s) * 1e3:.3f} ms (host clock, "
        f"packing, transfers and readback included; min of 3), C scorer "
        f"{min(c_s) * 1e3:.3f} ms, on {card}")

    forced = {"FREDDIE_SEGCORE": "0", "FREDDIE_POLYA_DEVICE": "1"}
    saved = {k: os.environ.get(k) for k in forced}
    out = os.path.join(workdir, "segment_polya")
    os.environ.update(forced)
    try:
        segdp_cuda.LAUNCHES = 0
        scans = tpb.SCANS
        t0 = time.perf_counter()
        run_segment(os.path.join(run["out"], "split"), out, SegmentConfig(), device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, scans = segdp_cuda.LAUNCHES, tpb.SCANS - scans
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if scans <= 0 or launches <= 0:
        raise RuntimeError(f"forced polyA segment run: {scans} scans, {launches} K1 launches")
    names = same_tsvs(out, run["host_segment"], "forced polyA segment run")
    log(f"[polya] segment with FREDDIE_SEGCORE=0 FREDDIE_POLYA_DEVICE=1: {secs:.3f} s, "
        f"{scans} polyA scans and {launches} K1 launches on the card; {len(names)} segment "
        f"TSVs byte-identical to the host-oracle route, on {card}")
    return launches


def mesh_phase(dev, card) -> int:
    """The loci mesh on one card, as ``__graft_entry__.py:dryrun_multichip``
    runs it on a CPU mesh: solve_batch_sharded over the card listed four
    times (a stream per shard) bit-equal to one K1 launch; the production
    dispatch with loci_devices patched to four and to three shards (which
    pads the batch of 8 to 9) at B=5 and at the stage's (P, R) buckets
    equal to solve_host; over the real cards too when there are several.
    Returns the dispatches' K1 launches."""
    import numpy as np
    import torch

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import (
        DPProblem, ScaledThresholds, solve_batch_device, solve_host, to_device)
    from freddie_tpu_torch.parallel import mesh

    thr = ScaledThresholds(0.9)
    rng = np.random.default_rng(11)
    shards = [dev] * 4
    batch = synthetic_batch(rng, 256, 32, 512, False)
    args = (batch["C"], batch["y"], batch["W"], batch["n_cand"], 3, thr.lookup, thr.scale)
    t0 = time.perf_counter()
    got = mesh.solve_batch_sharded(*args, shards)
    sh_s = time.perf_counter() - t0
    t = to_device(batch, dev)
    want = segdp_cuda.solve_batch_cuda(t["C"], t["y"], t["W"], t["n_cand"], 3,
                                       torch.from_numpy(thr.lookup).to(dev), thr.scale)
    if not all(np.array_equal(g, w.cpu().numpy()) for g, w in zip(got, want)):
        raise RuntimeError("solve_batch_sharded over 4 shards != one K1 launch")
    log(f"[mesh] solve_batch_sharded over {len(shards)} shards of {dev} at B,P,R=256,32,512: "
        f"bit-equal to one K1 launch ({sh_s * 1e3:.3f} ms, host clock incl. transfers, "
        f"first call), on {card}")

    def problem(P, R):
        inc = rng.integers(0, 6, size=(P, R))
        inc[rng.random(size=(P, R)) < 0.5] = 0
        y = np.sort(rng.integers(1, 20_000, size=P)).astype(np.int64)
        y[0] = 0
        return DPProblem(C=np.cumsum(inc, axis=0).astype(np.int64), y=y,
                         W=rng.integers(1, 5, size=R).astype(np.int64), read_support=3)

    cases = [("B=5", [problem(int(rng.integers(3, 30)), int(rng.integers(1, 40)))
                      for _ in range(5)], 8, 128)]
    cases += [(f"bucket ({P},{R})", [problem(P, R) for _ in range(5)], P, R)
              for P, R in ((64, 512), (32, 512), (16, 128))]
    want = [[solve_host(p, thr) for p in problems] for _what, problems, _P, _R in cases]
    # 4 shards split the padded batch of 8 evenly; 3 pad it to 9. The
    # work gate is at zero: these batches are far below it.
    layouts = [("4 shards of one card", shards), ("3 shards of one card", [dev] * 3)]
    if torch.cuda.device_count() > 1:
        layouts.append((f"the {torch.cuda.device_count()} cards", None))
    real, gate = mesh.loci_devices, mesh.MESH_MIN_WORK
    segdp_cuda.LAUNCHES = 0
    mesh.MESH_MIN_WORK = 0
    try:
        for name, devices in layouts:
            if devices is not None:
                mesh.loci_devices = lambda d=devices: d
            for (what, problems, P, R), w in zip(cases, want):
                got = solve_batch_device(problems, thr, pad_p_to=P, pad_r_to=R, device="cuda")
                if got != w:
                    raise RuntimeError(f"the dispatch over {name} != solve_host at {what}")
            mesh.loci_devices = real
            log(f"[mesh] dispatch over {name}: equal to solve_host at "
                f"{', '.join(c[0] for c in cases)}")
    finally:
        mesh.loci_devices, mesh.MESH_MIN_WORK = real, gate
    torch.cuda.synchronize()
    launches = segdp_cuda.LAUNCHES
    if launches < 7 * len(cases):
        raise RuntimeError(f"the mesh dispatch made {launches} K1 launches")
    return launches


WORKER = """
import json, sys
from freddie_tpu_torch.ops import segdp_cuda
from freddie_tpu_torch.parallel import dist
rank, world = dist.initialize("127.0.0.1:" + sys.argv[1], 2, int(sys.argv[2]), timeout=600)
merged = dist.run_pipeline_distributed(sys.argv[3], [sys.argv[4]], sys.argv[5],
                                       device=sys.argv[6])
dist.dist.destroy_process_group()
print("RESULT " + json.dumps({"rank": rank, "records": len(merged),
                              "device": dist.rank_device(sys.argv[6], rank),
                              "launches": segdp_cuda.LAUNCHES, "jax": "jax" in sys.modules}))
"""

# The port's CLI entry (what `python -m freddie_tpu_torch.cli` runs), then
# the K1 launches it made and the batches its dispatch solved on the host
# because their bucket is wider than K1 holds.
CLI = """
import sys
from freddie_tpu_torch import cli
from freddie_tpu_torch.ops import segdp_cuda
rc = cli.main(sys.argv[1:])
print("LAUNCHES", segdp_cuda.LAUNCHES, "jax" in sys.modules)
print("WIDE_HOST_BATCHES", segdp_cuda.WIDE_HOST_BATCHES)
sys.exit(rc)
"""


def run_procs(cmds: list[list[str]], timeout: float) -> list[str]:
    """Run the commands at once from the repo root; their stdouts. Every
    process is killed if one outlasts ``timeout``; any failure raises."""
    procs = [subprocess.Popen(c, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{p.args[:4]} exited {p.returncode}:\n{out[-2000:]}\n{err[-3000:]}")
    return [out for out, _err in outs]


def same_run(a: str, b: str, what: str) -> None:
    """a's GTF and segment and cluster TSVs equal b's, byte for byte."""
    if not filecmp.cmp(os.path.join(a, "isoforms.gtf"), os.path.join(b, "isoforms.gtf"),
                       shallow=False):
        raise RuntimeError(f"{what}: the GTF differs from the single-process pipeline's")
    for stage in ("segment", "cluster"):
        same_tsvs(os.path.join(a, stage), os.path.join(b, stage), f"{what}, {stage}")


def dist_phase(device: str, card, run: dict, workdir: str) -> int:
    """Two processes in a gloo group on localhost, on card ``rank % count``
    of ``device`` ("cuda"; card 0 for both on one card), run
    run_pipeline_distributed over the benchmark corpus; the merged GTF and
    every segment and cluster TSV must equal the single-process run's.
    Returns the K1 launches of both ranks."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    out = os.path.join(workdir, "dist")
    t0 = time.perf_counter()
    outs = run_procs([[sys.executable, "-c", WORKER, port, str(r), run["bam"], run["fq"], out,
                       device] for r in range(2)], timeout=600)
    wall = time.perf_counter() - t0
    res = [json.loads(ln[len("RESULT "):]) for o in outs for ln in o.splitlines()
           if ln.startswith("RESULT ")]
    if len(res) != 2 or len({r["records"] for r in res}) != 1 or any(r["jax"] for r in res):
        raise RuntimeError(f"distributed ranks reported {res}")
    same_run(out, run["out"], "distributed pipeline")
    launches = sum(r["launches"] for r in res)
    if launches <= 0:
        raise RuntimeError("the distributed ranks never launched K1")
    log(f"[dist] 2 ranks (gloo, on {[r['device'] for r in res]}): {res[0]['records']} "
        f"merged records, GTF "
        f"and every segment and cluster TSV byte-identical to the single-process run; "
        f"K1 launches by rank {[r['launches'] for r in res]}; wall {wall:.3f} s "
        f"(process start included), on {card}")
    return launches


def workflow_phase(device: str, card, run: dict, workdir: str) -> int:
    """``freddie_tpu_torch.cli workflow --device <device>`` on a one-sample
    config over the benchmark BAM; its GTF must equal the pipeline's.
    Returns its K1 launches."""
    cfg = os.path.join(workdir, "wf.yaml")
    out = os.path.join(workdir, "wf")
    with open(cfg, "w") as f:
        f.write(f"outpath: {out}\nsamples:\n  S1:\n    bam: {run['bam']}\n"
                f"    reads: [{run['fq']}]\n")
    t0 = time.perf_counter()
    (stdout,) = run_procs([[sys.executable, "-c", CLI, "workflow", cfg, "--device", device]],
                          timeout=600)
    wall = time.perf_counter() - t0
    tail = [ln.split() for ln in stdout.splitlines() if ln.startswith("LAUNCHES ")]
    if not tail or tail[-1][2] != "False":
        raise RuntimeError(f"the workflow CLI did not report its launches, or imported jax: {tail}")
    launches = int(tail[-1][1])
    if launches <= 0:
        raise RuntimeError("the workflow never launched K1")
    if not filecmp.cmp(os.path.join(out, "results", "S1", "isoforms.gtf"),
                       os.path.join(run["out"], "isoforms.gtf"), shallow=False):
        raise RuntimeError("the workflow's GTF differs from the pipeline's")
    log(f"[workflow] cli workflow --device {device}: GTF byte-identical to the pipeline's, "
        f"{launches} K1 launches; wall {wall:.3f} s (process start included), on {card}")
    return launches


# A corpus one of whose DP problems has 245 candidates (the P = 256
# bucket) and others 190 and 209 (P = 192 and 224) when the segment stage
# runs with sigma 1, variance factor 9.9 and max_problem_size 250.
WIDE_CORPUS = dict(
    seed=8192, n_genes=2, isoforms_per_gene=6, reads_per_isoform=40, exons_per_gene=30,
    minus_strand_genes=True, truncate_prob=0.3, tail_prob=0.7, end_jitter=30,
    indel_rate=0.15, alt_splice=True, junction_jitter=40, big_del_rate=0.1,
)
WIDE_FLAGS = ["--max-problem-size", "250", "--sigma", "1", "--variance-factor", "9.9"]


def wide_phase(dev, card, workdir: str) -> int:
    """The widest bucket. A batch of 8 at P = 224 (the widest bucket K1
    holds) launched and bit-equal to the plain version, chains included;
    problems of the P = 256 bucket through solve_batch_device equal to
    solve_host with the host-route counter moved and LAUNCHES not;
    solve_batch_cuda at P = 256 still raising; then the ``segment`` CLI
    with --max-problem-size 250 on WIDE_CORPUS with --device cuda and
    --device cpu, byte-identical. Returns the K1 launches of the CLI run
    on the card."""
    import numpy as np
    import torch

    from freddie_tpu_torch.config import SplitConfig
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import (
        DPProblem, ScaledThresholds, _solve_batch_torch, _walk_chains, solve_batch_device,
        solve_host, to_device)
    from freddie_tpu_torch.stages.split import run_split
    from freddie_tpu_torch.utils.sim import simulate

    thr = ScaledThresholds(0.9)
    lookup = torch.from_numpy(thr.lookup).to(dev)
    rng = np.random.default_rng(224)
    B, P, R = 8, 224, 128
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t = to_device(synthetic_batch(rng, B, P, R, False), dev)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    K, bj, bk, chains = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
    torch.cuda.synchronize()
    k1_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    plain = _solve_batch_torch(*args)
    err = max_abs_diff((K, bj, bk), plain, P)
    if err != 0 or not torch.equal(chains, _walk_chains(*plain)):
        raise RuntimeError(f"K1 != plain at B={B} P={P} R={R}: max abs err {err}")
    k1_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args))
    log(f"[wide] K1 at B={B} P={P} R={R} (K1_MAX_P = {segdp_cuda.K1_MAX_P}): bit-equal to "
        f"plain, chains equal to _walk_chains, {int((bj >= 0).sum())}/{B} segmented; "
        f"{k1_ms:.3f} ms (median of {TIMED_REPS}); the call's peak device memory "
        f"{k1_mib:.0f} MiB (its (B, P, P, P) scratch is {B * P**3 * 4 / 2**20:.0f} MiB); on {card}")
    del t, args, K, bj, bk, chains, plain
    torch.cuda.empty_cache()

    problems = []
    for _ in range(3):
        p, r = int(rng.integers(225, 251)), 24
        inc = rng.integers(0, 6, size=(p, r))
        inc[rng.random(size=(p, r)) < 0.5] = 0
        y = np.sort(rng.choice(np.arange(1, 40_000), size=p, replace=False)).astype(np.int64)
        y[0] = 0
        problems.append(DPProblem(C=np.cumsum(inc, axis=0).astype(np.int64), y=y,
                                  W=rng.integers(1, 5, size=r).astype(np.int64), read_support=3))
    launches, routed = segdp_cuda.LAUNCHES, segdp_cuda.WIDE_HOST_BATCHES
    got = solve_batch_device(problems, thr, pad_p_to=256, pad_r_to=128, device=dev)
    if got != [solve_host(pr, thr) for pr in problems]:
        raise RuntimeError("the P = 256 bucket through the dispatch != solve_host")
    if segdp_cuda.LAUNCHES != launches or segdp_cuda.WIDE_HOST_BATCHES != routed + 1:
        raise RuntimeError("the P = 256 bucket was not routed to the host oracle")
    t = to_device(synthetic_batch(rng, 1, 256, 64, False), dev)
    try:
        segdp_cuda.solve_batch_cuda(t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    except ValueError as e:
        log(f"[wide] {len(problems)} problems of {[len(pr.y) for pr in problems]} candidates "
            f"(the P = 256 bucket) through solve_batch_device: equal to solve_host, 0 launches, "
            f"1 batch routed to the host; solve_batch_cuda at P = 256 raises: {e}")
    else:
        raise RuntimeError("solve_batch_cuda took P = 256")

    d = os.path.join(workdir, "wide")
    os.makedirs(d)
    sim = simulate(**WIDE_CORPUS)
    bam, fq = os.path.join(d, "r.bam"), os.path.join(d, "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    run_split(bam, [fq], os.path.join(d, "split"), SplitConfig())
    outs = run_procs([[sys.executable, "-c", CLI, "segment", "-s", os.path.join(d, "split"),
                       "-o", os.path.join(d, name), *WIDE_FLAGS, "--device", name]
                      for name in (dev.type, "cpu")], timeout=600)
    tail = [ln.split() for ln in outs[0].splitlines() if ln.startswith("LAUNCHES ")]
    routed = [ln.split() for ln in outs[0].splitlines() if ln.startswith("WIDE_HOST_BATCHES ")]
    if not tail or not routed or int(tail[-1][1]) <= 0 or int(routed[-1][1]) <= 0:
        raise RuntimeError(f"the wide segment run reported {tail} launches, {routed} routed")
    names = same_tsvs(os.path.join(d, dev.type), os.path.join(d, "cpu"),
                      "segment --max-problem-size 250, card against cpu")
    log(f"[wide] cli segment {' '.join(WIDE_FLAGS)} on {len(sim.reads)} reads: --device "
        f"{dev.type} made {tail[-1][1]} K1 launches and routed {routed[-1][1]} batch(es) to "
        f"the host; {len(names)} segment TSVs byte-identical to --device cpu")
    return int(tail[-1][1])


def window_phase(dev, card, run: dict, workdir: str) -> int:
    """The segment stage on the card with a stream window of 5 tints over
    the benchmark corpus: partial buckets are flushed every 5 tints, so
    more and smaller launches than the unwindowed run's; the TSVs must be
    byte-identical to the pipeline's. Returns its K1 launches."""
    import torch

    from freddie_tpu_torch.config import SegmentConfig
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.stages.segment import run_segment

    out = os.path.join(workdir, "segment_window")
    segdp_cuda.LAUNCHES = 0
    segdp_cuda.LAUNCH_SHAPES.clear()
    t0 = time.perf_counter()
    run_segment(os.path.join(run["out"], "split"), out, SegmentConfig(stream_window=5),
                device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = segdp_cuda.LAUNCHES
    shapes = sorted(set(segdp_cuda.LAUNCH_SHAPES))
    names = same_tsvs(out, os.path.join(run["out"], "segment"), "windowed segment run")
    if launches <= 3:
        raise RuntimeError(f"the stream window forced no flush: {launches} K1 launches")
    log(f"[window] segment with stream_window=5: {secs:.3f} s, {launches} K1 launches "
        f"(3 without a window), batch sizes {sorted({s[0] for s in shapes})}; {len(names)} "
        f"segment TSVs byte-identical to the unwindowed run, on {card}")
    return launches


def entry_phase(dev, card) -> int:
    """The port's entry points: ``entry(device)``'s forward once, held
    against the plain version, and ``dryrun_multichip(4)`` over the card
    listed four times (over the real cards too when there are several).
    Returns the K1 launches."""
    import torch

    from freddie_tpu_torch import entry as tentry
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import ScaledThresholds, _solve_batch_torch

    segdp_cuda.LAUNCHES = 0
    forward, example = tentry.entry(device=dev)
    K, bj, bk = forward(*example)
    torch.cuda.synchronize()
    if segdp_cuda.LAUNCHES != 1:
        raise RuntimeError(f"entry's forward made {segdp_cuda.LAUNCHES} K1 launches")
    plain = _solve_batch_torch(*example[:4], 3, example[4], ScaledThresholds(0.9).scale)
    if max_abs_diff((K, bj, bk), plain, K.shape[1]) != 0:
        raise RuntimeError("entry's forward != the plain version")
    log(f"[entry] entry(device={dev}): forward launched K1 once, K {tuple(K.shape)} bit-equal "
        f"to the plain version, {int((bj >= 0).sum())}/{len(bj)} segmented")
    res = [tentry.dryrun_multichip(4, device=dev)]
    if torch.cuda.device_count() > 1:
        res.append(tentry.dryrun_multichip(torch.cuda.device_count(), device="cuda"))
    for r in res:
        log(f"[entry] dryrun_multichip({r['shards']}) over {r['devices']}: sharded solve, "
            f"dispatch at B = n + 1, the stage's buckets and the forced polyA scan equal to "
            f"their host oracles ({json.dumps(r['checked'])}); {r['sharded_dispatches']} "
            f"sharded dispatches, {r['k1_launches']} K1 launches, on {card}")
    torch.cuda.synchronize()
    return segdp_cuda.LAUNCHES


def tools_phase(dev, card) -> None:
    """The tooling at a small size: the bound experiment on a two-point
    grid (card bounds equal to the host's), the kernel phase profile at
    (64, 64, 384), the weak-scaling mode over the card listed 1, 2 and 4
    times (a dispatch check: the results are held equal across n, and no
    scaling is measured), and the kernel warm-up."""
    from freddie_tpu_torch.parallel import bench as pbench
    from freddie_tpu_torch.tools import bound_device_experiment, profile_kernel_phases, warm_kernels

    bounds = bound_device_experiment.run(dev, [(250, 4_000), (1000, 100_000)], [(300, 16)], 3,
                                         log=lambda row: log(f"[tools] bounds {row}"))
    log(f"[tools] bound_device_experiment: card bounds equal to the host's at "
        f"{len(bounds['grid'])} points; crossover work {bounds['crossover_work']} "
        f"(BOUNDS_DEVICE_MIN = {bounds['bounds_device_min']}), on {card}")
    profile_kernel_phases.profile_shape(dev, STAGE_SHAPES[2],
                                        lambda msg: log(msg.replace("[phases]", "[tools]", 1)))
    weak = pbench.weak_scaling([dev] * 4, reps=3)
    if weak["distinct_devices"] or weak["at_mesh"] != 4:
        raise RuntimeError(f"weak scaling over one card listed four times reported {weak}")
    log(f"[tools] weak-scaling mode over {dev} listed 1, 2, 4 times (a check of the sharded "
        f"dispatch, not a scaling measurement): results equal across n; reads/s per mesh size "
        f"{json.dumps(weak['per_mesh'])}, ratio {weak['value']:.3f}, on {card}")
    warm_kernels.warm(lambda msg: log(msg.replace("[warm]", "[tools] warm_kernels:", 1)))


def fuzz_phase(dev, card, n_shifts: int) -> None:
    """``n_shifts`` seed shifts of the parity suite's three corpora on the
    card with the device route forced, against the host-oracle route."""
    from freddie_tpu_torch.tools.run_fuzz_shifts import fuzz_device_against_host

    n = fuzz_device_against_host(dev, range(n_shifts), log)
    log(f"[fuzz] {n} corpora over {n_shifts} seed shifts byte-identical to the host-oracle "
        f"route, on {card}")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="the kernel phases only; exits 3, no result line")
    ap.add_argument("--fuzz", type=int, default=0, metavar="N",
                    help="after everything else, N seed shifts of the fuzz")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from freddie_tpu_torch.device import resolve_device
    from freddie_tpu_torch.ops._build import load_library

    dev = resolve_device("cuda")
    card = card_line()
    log(card)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    built = load_library("segdp")
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    log(f"[build] {os.path.relpath(built.path, REPO)} in {built.seconds:.2f} s (nvcc)")
    for ln in ptxas:
        log(f"[build] {ln}")

    started = time.perf_counter()

    def timed(name, phase, *args):
        """Run a phase and say how long it took by the host clock."""
        t0 = time.perf_counter()
        out = phase(*args)
        log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    kern = timed("kernels", kernel_phase, dev, card)
    pipe_launches = timed("pipelined", pipelined_path, dev, card)
    if opts.kernels:
        log("[kernels] kernel phases only: the paths were not driven, no result line")
        return 3
    timed("cluster", cluster_phase, dev, card)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=REPO)
    by_path = {}
    try:
        by_path["pipeline"], run = timed("pipeline", pipeline_phase, dev, workdir)
        by_path["polya"] = timed("polya", polya_phase, dev, card, run, workdir)
        by_path["mesh"] = timed("mesh", mesh_phase, dev, card)
        by_path["dist"] = timed("dist", dist_phase, dev.type, card, run, workdir)
        by_path["workflow"] = timed("workflow", workflow_phase, dev.type, card, run, workdir)
        by_path["wide"] = timed("wide", wide_phase, dev, card, workdir)
        by_path["window"] = timed("window", window_phase, dev, card, run, workdir)
        by_path["entry"] = timed("entry", entry_phase, dev, card)
        timed("tools", tools_phase, dev, card)
        if opts.fuzz:
            timed("fuzz", fuzz_phase, dev, card, opts.fuzz)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    log(f"[time] the whole run, from the build's end: {time.perf_counter() - started:.1f} s")
    log(f"[kernels] segdp (K1) launches by path: {json.dumps(by_path)}; "
        f"segdp_pipelined (K2): {json.dumps({'pipelined': pipe_launches})}")
    log(card)
    rows = [("segdp", "freddie_tpu/ops/segdp_pallas.py:65", sum(by_path.values())),
            ("segdp_pipelined", "freddie_tpu/ops/segdp_pallas.py:445", pipe_launches)]
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "freddie_tpu_torch/csrc/segdp.cu",
        "replaces": replaces,
        "launches": n,
        **kern[name],
    } for name, replaces, n in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
