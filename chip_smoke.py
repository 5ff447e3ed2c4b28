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
8. the wide buckets, where K1's wavefront runs on thread-block clusters:
   K1 at (8, 256, 128) and (2, 512, 128) bit-equal to the plain version,
   chains included, with time, the wavefront's device time and peak
   memory; K1 at (8, 224, 128) on one block a problem, on clusters, and on
   clusters with H forced into device memory, bit-equal; a sweep of both
   wavefronts over P and B on clusters of 8 and 16 blocks with the
   runtime's resident clusters and the cluster barrier's latency floor
   (the data behind CLUSTER_MIN_P); K2's cluster route at (8, 256, 128)
   and (2, 512, 128), driven with the counts at zero, bit-equal to K1 and
   to the plain version, chains included, timed beside K1 with the bound
   and its launch's device time; a sweep of K2 over P and B on its
   one-block route and on clusters of 8 and 16 blocks (the data behind
   K2_CLUSTER_MIN_P and k2_cluster_size_for); K1 and K2 past the widths
   that a ring of whole outside planes held -- (8, 704, 128), (1, 960,
   128), (2, 960, 128), (1, 1312, 128) -- by shape, and with the row ring
   forced to its least depth at (8, 256, 128) and (2, 512, 128), each
   call driven with the counts at zero, bit-equal to the plain version,
   chains included, timed with its route; K2's one-block route at
   (8, 256, 128), forced, driven with the counts at zero, equal to K1;
   K1 at (8, 256, 128) in three groups
   under a scratch budget forced low, bit-equal; problems of the P = 256
   bucket through the dispatch, one launch at B = 4, equal to the host
   oracle;
   ``segment --max-problem-size 250`` through the CLI on a corpus with
   buckets 192, 224 and 256, on the card and on the CPU, byte-identical;
   and ``segment --max-problem-size 500`` on a corpus with a problem in
   the P = 512 bucket, on the card and by the host-oracle route
   (``--no-device``), byte-identical (the host-oracle run takes minutes
   of one core, so it starts before phase 1 and runs beside phases 1-7);
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
        log(f"[pipelined] K2's one-block route at P={P} (by shape K2 takes its cluster "
            f"route from K2_CLUSTER_MIN_P = {segdp_cuda.K2_CLUSTER_MIN_P}), as the runtime "
            f"reports it: {json.dumps(segdp_cuda.pipelined_occupancy(P))}, grid "
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
# the K1 launches it made, whether jax was imported, the launches whose
# wavefront held H in device memory, those whose wavefront ran on
# clusters, the (B, P, R) of the launches, and the process's peak device
# memory (bytes; 0 where it used no card).
CLI = """
import json, sys
import torch
from freddie_tpu_torch import cli
from freddie_tpu_torch.ops import segdp_cuda
rc = cli.main(sys.argv[1:])
print("LAUNCHES", segdp_cuda.LAUNCHES, "jax" in sys.modules, segdp_cuda.DEVICE_H_LAUNCHES,
      segdp_cuda.CLUSTER_LAUNCHES)
print("SHAPES", json.dumps(list(segdp_cuda.LAUNCH_SHAPES)))
print("PEAK", torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0)
sys.exit(rc)
"""


def cli_counts(stdout: str) -> tuple[int, int, list, int, int]:
    """The K1 launches, device-memory-H launches, launch shapes, cluster
    launches and peak device memory that a run of CLI printed; raises when
    it did not print them or imported jax."""
    tail = [ln.split() for ln in stdout.splitlines() if ln.startswith("LAUNCHES ")]
    shapes = [ln for ln in stdout.splitlines() if ln.startswith("SHAPES ")]
    peak = [ln.split() for ln in stdout.splitlines() if ln.startswith("PEAK ")]
    if not tail or tail[-1][2] != "False" or not shapes or not peak:
        raise RuntimeError(f"the CLI did not report its launches, or imported jax: {tail}")
    return (int(tail[-1][1]), int(tail[-1][3]), json.loads(shapes[-1][len("SHAPES "):]),
            int(tail[-1][4]), int(peak[-1][1]))


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
    launches = cli_counts(stdout)[0]
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
# A corpus one of whose DP problems has 488 candidates (the P = 512
# bucket) under P512_FLAGS: a wide junction jitter and a narrow smoothing
# kernel make many candidates and few fixed breakpoints. The host oracle
# takes minutes of one core over it (the (P, P, P) pair tensors of every
# problem), so it starts early, beside the other phases (start_p512_host).
P512_CORPUS = dict(WIDE_CORPUS, n_genes=1, seed=8, exons_per_gene=100, reads_per_isoform=30,
                   junction_jitter=200)
P512_FLAGS = ["--max-problem-size", "500", "--sigma", "0.5", "--variance-factor", "9.9"]


def start_p512_host(workdir: str) -> dict:
    """Simulates P512_CORPUS, splits it, and starts the ``segment`` CLI's
    host-oracle route (--no-device) over it in a process of its own, its
    output in files; the wide phase holds the card's run against it.
    Returns where the corpus, the output and the process are."""
    from freddie_tpu_torch.config import SplitConfig
    from freddie_tpu_torch.stages.split import run_split
    from freddie_tpu_torch.utils.sim import simulate

    d = os.path.join(workdir, "p512")
    os.makedirs(d)
    sim = simulate(**P512_CORPUS)
    bam, fq = os.path.join(d, "r.bam"), os.path.join(d, "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split = os.path.join(d, "split")
    run_split(bam, [fq], split, SplitConfig())
    log_path = os.path.join(d, "host.log")
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", CLI, "segment", "-s", split, "-o", os.path.join(d, "host"),
             *P512_FLAGS, "--no-device"], cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
    return dict(dir=d, split=split, reads=len(sim.reads), proc=proc, log=log_path,
                started=time.perf_counter())


def wide_batch(dev, rng, B, P, R):
    """solve_batch_cuda's arguments for a synthetic batch on ``dev`` whose
    first problem fills all P candidates, and the batch's tensors."""
    import torch

    from freddie_tpu_torch.ops.segdp import ScaledThresholds, to_device

    batch = synthetic_batch(rng, B, P, R, False)
    batch["n_cand"][0] = P
    thr = ScaledThresholds(0.9)
    t = to_device(batch, dev)
    return (t["C"], t["y"], t["W"], t["n_cand"], 3, torch.from_numpy(thr.lookup).to(dev),
            thr.scale), t


def same_result(a, b) -> bool:
    """Two solve_batch_cuda results (with chains) equal tensor for tensor."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


# The sweep behind segdp_cuda.CLUSTER_MIN_P and CLUSTER_SIZE: both K1
# wavefronts at each (P, B), on clusters of each size: B = 1 and 8 at every
# wide width, and the segment stage's full chunks at P = 96 and 128.
SWEEP = [(P, B) for P in (96, 128, 192, 224, 256, 512) for B in (1, 8)] + [(96, 128), (128, 64)]
SWEEP_N = (8, 16)


def cluster_sweep(dev, card, rng) -> None:
    """K1 at each (P, B) of SWEEP: the one-block wavefront (where
    it fits, P <= K1_SMEM_MAX_P) and the cluster wavefront on N blocks for
    N in SWEEP_N, bit-equal to each other (and to the plain version where
    no one-block run exists), each call's time, the profiler's device time
    of each wavefront launch, cudaOccupancyMaxActiveClusters, and the
    latency floor: P-1 rounds of the cluster barrier alone on B clusters."""
    import torch

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import _solve_batch_torch, _walk_chains
    from freddie_tpu_torch.tools.profile_kernel_phases import device_ms_by_kernel

    for P, B in SWEEP:
        args, _t = wide_batch(dev, rng, B, P, 128)
        routes = ([0] if P <= segdp_cuda.K1_SMEM_MAX_P else []) + list(SWEEP_N)
        got = {n: segdp_cuda.solve_batch_cuda(*args, with_chains=True, cluster_size=n)
               for n in routes}
        if 0 in got:
            what = "the one-block wavefront"
            bad = [n for n, res in got.items() if not same_result(res, got[0])]
        else:
            # The plain version's K keeps -1 in its last row, where the
            # kernels store best_j and best_k.
            what = "the plain version"
            plain = _solve_batch_torch(*args)
            walked = _walk_chains(*plain)
            bad = [n for n, res in got.items() if max_abs_diff(res[:3], plain, P) != 0
                   or not torch.equal(res[3], walked)]
            del plain, walked
        if bad:
            raise RuntimeError(f"K1 at B={B} P={P}: the wavefront on clusters of {bad} "
                               f"!= {what}")
        parts = []
        for n in routes:
            ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, cluster_size=n))
            dev_ms = device_ms_by_kernel(
                [lambda: segdp_cuda.solve_batch_cuda(*args, cluster_size=n)])
            wave = dev_ms.get("wavefront_cluster_kernel" if n else "wavefront_kernel")
            if n == 0:
                parts.append(f"one block a problem {ms:.3f} ms (wavefront {wave} ms)")
                continue
            occ = segdp_cuda.cluster_occupancy(P, n)
            floor = time_ms(lambda: segdp_cuda.cluster_barrier_probe(B, n, P - 1))
            parts.append(f"N={n} {ms:.3f} ms (wavefront {wave} ms; max active clusters "
                         f"{occ['max_active_clusters']}, {occ['smem_bytes']} B a block, "
                         f"{occ['registers']} registers; barrier floor {floor:.4f} ms)")
        log(f"[sweep] K1 at B={B} P={P} R=128 (by shape: clusters of "
            f"{segdp_cuda.cluster_size_for(B, P)}): results equal to {what}, chains "
            f"included; whole call (medians of {TIMED_REPS}), the wavefront launch's device "
            f"time (profiler, mean of 3) and the floor of {P - 1} cluster-barrier rounds "
            f"alone: {'; '.join(parts)}; on {card}")
        del args, _t, got
        torch.cuda.empty_cache()


# The sweep behind segdp_cuda.K2_CLUSTER_MIN_P and k2_cluster_size_for:
# K2 at each (P, B) on its one-block route and on its cluster route on
# each cluster size that takes P; B = 1 and 8 at every width from P = 96
# to 512, and the segment stage's full chunks at R = 128 of the P = 96,
# 128 and 256 buckets.
K2_SWEEP = [(P, B) for P in (96, 128, 160, 192, 256, 512) for B in (1, 8)] + [
    (96, 128), (128, 64), (256, 16)]


def k2_sweep(dev, card, rng) -> None:
    """K2 at each (P, B) of K2_SWEEP: the one-block route and the cluster
    route on N blocks for N in SWEEP_N where it takes P, bit-equal to each
    other and to K1, each call's time (K1's beside it), the profiler's
    device time of each K2 launch, and what the runtime reports for the
    cluster route (resident clusters, shared memory, registers) with the
    clusters the call runs on."""
    import torch

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.tools.profile_kernel_phases import device_ms_by_kernel

    for P, B in K2_SWEEP:
        args, _t = wide_batch(dev, rng, B, P, 128)
        k1 = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
        routes = [0, *SWEEP_N]
        bad = [n for n in routes if not same_result(
            segdp_cuda.solve_batch_cuda(*args, pipelined=True, with_chains=True,
                                        cluster_size=n), k1)]
        if bad:
            raise RuntimeError(f"K2 at B={B} P={P}: the routes {bad} (0: one block) != K1")
        parts = [f"K1 {time_ms(lambda: segdp_cuda.solve_batch_cuda(*args)):.3f} ms"]
        for n in routes:
            ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True,
                                                             cluster_size=n))
            dev_ms = device_ms_by_kernel(
                [lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True, cluster_size=n)])
            if n == 0:
                parts.append(f"one block an SM {ms:.3f} ms (launch "
                             f"{dev_ms.get('segdp_pipelined_kernel')} ms; grid "
                             f"{segdp_cuda.pipelined_grid(B, P)})")
                continue
            occ = segdp_cuda.k2_cluster_occupancy(P, n)
            parts.append(f"N={n} {ms:.3f} ms (launch "
                         f"{dev_ms.get('segdp_pipelined_cluster_kernel')} ms; "
                         f"{segdp_cuda.pipelined_cluster_grid(B, P, n)} clusters; max active "
                         f"clusters {occ['max_active_clusters']}, {occ['smem_bytes']} B a block, "
                         f"{occ['registers']} registers)")
        by_shape = segdp_cuda.launch_route(B, P, pipelined=True)
        log(f"[sweep] K2 at B={B} P={P} R=128 (by shape: "
            f"{'clusters of %d' % by_shape[0] if by_shape[0] else 'one block an SM'}): every "
            f"route equal to K1, chains included; whole call (medians of {TIMED_REPS}) and the "
            f"K2 launch's device time (profiler, mean of 3): {'; '.join(parts)}; on {card}")
        del args, _t, k1
        torch.cuda.empty_cache()


# K1 and K2 past the widths that each block's ring of two whole outside
# planes held (K1 refused P > 674 on 8 blocks and P > 948 on 16; K2 took
# its one-block route past 690), by shape. P = 1312 is the first bucket
# whose outside tensor passes 2^31 floats.
EVERY_WIDTH = [(8, 704, 128), (1, 960, 128), (2, 960, 128), (1, 1312, 128)]
# The repeats a call of every_width is timed over (fewer than TIMED_REPS:
# at these widths one call takes 10-100 ms).
EVERY_WIDTH_REPS = 3


def plain_in_parts(args):
    """The plain version's K, best_j, best_k and chains over a batch, one
    problem at a time (its (1, P, P, P) tensors are 9 GB at P = 1312)."""
    import torch

    from freddie_tpu_torch.ops.segdp import _solve_batch_torch, _walk_chains

    parts = []
    for b in range(args[0].shape[0]):
        res = _solve_batch_torch(*[a[b:b + 1] for a in args[:4]], *args[4:])
        parts.append(res + (_walk_chains(*res),))
    return tuple(torch.cat(x) for x in zip(*parts))


def every_width(dev, card, rng, wide: dict) -> dict:
    """K1 and K2 at EVERY_WIDTH by shape, and with the ring of rows forced
    at the shapes of ``wide`` (whose batches and plain results it reuses):
    each call driven once with every count at zero, which must show one
    launch, on the kernel's cluster route; K, best_j, best_k and the
    chains bit-equal to the plain version; each call's time (median of
    EVERY_WIDTH_REPS) with its route and bound, and the plain version's
    (one cold run, CUDA events: the first call at that width, so the
    allocator's first requests for its tensors are inside it). Returns
    those calls' launches of K1 and of K2."""
    import torch

    from freddie_tpu_torch.ops import segdp_cuda

    cases = [(shape, None, None) for shape in EVERY_WIDTH]
    cases += [(shape, True, w) for shape, w in wide.items()]
    launches = {False: 0, True: 0}
    for (B, P, R), row_ring, w in cases:
        if w is None:
            args, t = wide_batch(dev, rng, B, P, R)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            plain = plain_in_parts(args)
            stop.record()
            stop.synchronize()
            p_ms, p_what = start.elapsed_time(stop), "one cold run"
        else:
            args, t, plain, p_ms, p_what = w["args"], w["t"], w["plain"], w["p_ms"], "above"
        b_ms, b_by, _by_bytes, _by_ops = bound_ms(t, P)
        parts = []
        for pipelined in (False, True):
            segdp_cuda.LAUNCHES = segdp_cuda.CLUSTER_LAUNCHES = 0
            segdp_cuda.PIPELINED_LAUNCHES = segdp_cuda.PIPELINED_CLUSTER_LAUNCHES = 0
            res = segdp_cuda.solve_batch_cuda(*args, pipelined=pipelined, with_chains=True,
                                              row_ring=row_ring)
            torch.cuda.synchronize()
            n = (segdp_cuda.PIPELINED_CLUSTER_LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES,
                 segdp_cuda.LAUNCHES) if pipelined else (
                segdp_cuda.CLUSTER_LAUNCHES, segdp_cuda.LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES)
            what = "K2" if pipelined else "K1"
            how = "the ring of rows forced" if row_ring else "by shape"
            if n != (1, 1, 0):
                raise RuntimeError(f"{what} at B={B} P={P} R={R} ({how}): (cluster-route, "
                                   f"all, other kernel's) launches {n}, not (1, 1, 0)")
            err = max_abs_diff(res[:3], plain, P)
            if err != 0 or not torch.equal(res[3], plain[3]):
                raise RuntimeError(f"{what} at B={B} P={P} R={R} ({how}) != plain: max "
                                   f"abs err {err}")
            launches[pipelined] += n[0]
            N, cap, rows = segdp_cuda.launch_route(B, P, pipelined, row_ring=row_ring)
            ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=pipelined,
                                                             row_ring=row_ring),
                         reps=EVERY_WIDTH_REPS)
            parts.append(f"{what} {ms:.3f} ms on clusters of {N} blocks, the ring of "
                         f"{'rows' if rows else 'planes'}, H in "
                         f"{'shared' if P <= cap else 'device'} memory")
            del res
        log(f"[wide] every width, B={B} P={P} R={R} "
            f"({'the ring of rows forced' if row_ring else 'by shape'}): K1 "
            f"and K2 bit-equal to plain, chains included, each one launch on its cluster route "
            f"with the counts at zero; {'; '.join(parts)} (medians of {EVERY_WIDTH_REPS}); plain "
            f"{p_ms:.3f} ms ({p_what}); bound {b_ms:.4f} ms by {b_by}; on {card}")
        del args, t, plain
        torch.cuda.empty_cache()
    return dict(k1=launches[False], k2=launches[True])


def wide_phase(dev, card, workdir: str, p512: dict) -> dict:
    """The wide buckets, where K1's wavefront runs on thread-block
    clusters: K1 at (8, 256, 128) and (2, 512, 128) against the plain
    version, with its wavefront's device time and the call's peak memory;
    K1 at (8, 224, 128) on one block a problem, on clusters and on clusters
    with H forced into device memory, against each other; the sweep
    (cluster_sweep); K2's sweep (k2_sweep); K2 at (8, 256, 128) and (2,
    512, 128), driven with the counts at zero (its cluster route), against
    K1 and the plain version, timed; K2's one-block route at (8, 256, 128),
    forced, driven with the counts at zero, against K1; K1 under a scratch
    budget forced low enough for three groups; problems of the P = 256
    bucket through solve_batch_device against solve_host; and the ``segment`` CLI on the card against the CPU
    (--max-problem-size 250, buckets up to 256) and against the host
    oracle (--max-problem-size 500, a problem in the P = 512 bucket; its
    host run was started by start_p512_host).
    Returns the CLI runs' K1 launches, cluster launches and device-memory-H
    launches, K2's cluster-route launches and its one-block route's, and
    the wide kernel rows."""
    import numpy as np
    import torch

    from freddie_tpu_torch.config import SplitConfig
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import (
        DPProblem, ScaledThresholds, _solve_batch_torch, _walk_chains, solve_batch_device,
        solve_host)
    from freddie_tpu_torch.stages.split import run_split
    from freddie_tpu_torch.tools.profile_kernel_phases import device_ms_by_kernel
    from freddie_tpu_torch.utils.sim import simulate

    rng = np.random.default_rng(256)
    rows = {}
    wide = {}  # (B, P, R): the batch's arguments and tensors, K1's result, the plain one
    for B, P, R in ((8, 256, 128), (2, 512, 128)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        args, t = wide_batch(dev, rng, B, P, R)
        k1 = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
        torch.cuda.synchronize()
        k1_mib = torch.cuda.max_memory_allocated(dev) / 2**20
        plain = _solve_batch_torch(*args)
        plain += (_walk_chains(*plain),)
        err = max_abs_diff(k1[:3], plain, P)
        if err != 0 or not torch.equal(k1[3], plain[3]):
            raise RuntimeError(f"K1 != plain at B={B} P={P} R={R}: max abs err {err}")
        k1_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args))
        p_ms = time_ms(lambda: _solve_batch_torch(*args))
        phases = device_ms_by_kernel([lambda: segdp_cuda.solve_batch_cuda(*args)])
        b_ms, b_by, by_bytes, by_ops = bound_ms(t, P)
        n = segdp_cuda.cluster_size_for(B, P)
        log(f"[wide] K1 at B={B} P={P} R={R} (wavefront on clusters of {n} blocks from "
            f"CLUSTER_MIN_P = {segdp_cuda.CLUSTER_MIN_P}, H in their shared memory up to P = "
            f"{segdp_cuda.cluster_smem_max_p(n)}; "
            f"{segdp_cuda.group_size(B, P)} problems a group): bit-equal to plain, chains equal "
            f"to _walk_chains, {int((k1[1] >= 0).sum())}/{B} segmented; {k1_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms (medians of {TIMED_REPS}); on the device pair_stats "
            f"{phases.get('pair_stats_kernel')} ms + wavefront "
            f"{phases.get('wavefront_cluster_kernel')} ms (profiler, mean of 3); bound "
            f"{b_ms:.4f} ms by {b_by} (bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms); "
            f"the call's peak device memory {k1_mib:.0f} MiB; on {card}")
        wide[B, P, R] = dict(args=args, t=t, k1=k1, plain=plain, k1_ms=k1_ms, p_ms=p_ms,
                             bound=(b_ms, b_by, by_bytes, by_ops))
        if P == 256:
            wide_args, k1_256 = args, k1
            rows["K1 wide (cluster wavefront)"] = dict(
                max_abs_err=err, ms=k1_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
        del args, t, k1, plain
    torch.cuda.empty_cache()

    # The wavefronts on a batch that all take: P = 224 on one block a
    # problem, on clusters, and on clusters with H forced to device memory.
    args, _t = wide_batch(dev, rng, 8, 224, 128)
    runs = {"one block": dict(cluster_size=0), "clusters": {},
            "clusters, H in device memory": dict(smem_max_p=0)}
    res = {k: segdp_cuda.solve_batch_cuda(*args, with_chains=True, **kw) for k, kw in runs.items()}
    if not all(same_result(r, res["one block"]) for r in res.values()):
        raise RuntimeError("K1 at P = 224: the wavefronts disagree")
    times = {k: time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, **kw)) for k, kw in runs.items()}
    log(f"[wide] K1 at B=8 P=224 R=128: K, best_j, best_k and the chains equal on every "
        f"wavefront; {', '.join(f'{k} {v:.3f} ms' for k, v in times.items())} (medians of "
        f"{TIMED_REPS}), on {card}")
    del args, _t, res

    cluster_sweep(dev, card, rng)
    k2_sweep(dev, card, rng)

    # K2's path above K2_SMEM_MAX_P (its cluster route), driven once at
    # each wide shape with every count at zero.
    segdp_cuda.LAUNCHES = segdp_cuda.DEVICE_H_LAUNCHES = segdp_cuda.CLUSTER_LAUNCHES = 0
    segdp_cuda.PIPELINED_LAUNCHES = segdp_cuda.PIPELINED_DEVICE_H_LAUNCHES = 0
    segdp_cuda.PIPELINED_CLUSTER_LAUNCHES = 0
    k2 = {shape: segdp_cuda.solve_batch_cuda(*w["args"], pipelined=True, with_chains=True)
          for shape, w in wide.items()}
    torch.cuda.synchronize()
    k2_launches = segdp_cuda.PIPELINED_CLUSTER_LAUNCHES
    if k2_launches != len(wide) or segdp_cuda.PIPELINED_LAUNCHES != k2_launches \
            or segdp_cuda.LAUNCHES != 0:
        raise RuntimeError(f"K2's wide path made {segdp_cuda.PIPELINED_LAUNCHES} K2 launches, "
                           f"{k2_launches} on its cluster route, and {segdp_cuda.LAUNCHES} K1 "
                           "launches")
    for (B, P, R), w in wide.items():
        res = k2[B, P, R]
        err = max_abs_diff(res[:3], w["plain"], P)
        if err != 0 or not torch.equal(res[3], w["plain"][3]) or not same_result(res, w["k1"]):
            raise RuntimeError(f"K2's cluster route at B={B} P={P} R={R} != K1 or plain: max "
                               f"abs err {err}")
        args = w["args"]
        n = segdp_cuda.k2_cluster_size_for(B, P)
        k2_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True))
        dev_ms = device_ms_by_kernel([lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True)])
        b_ms, b_by, by_bytes, by_ops = w["bound"]
        log(f"[wide] K2 at B={B} P={P} R={R} (cluster route from K2_CLUSTER_MIN_P = "
            f"{segdp_cuda.K2_CLUSTER_MIN_P}: {segdp_cuda.pipelined_cluster_grid(B, P, n)} "
            f"clusters of {n} blocks, H in their shared memory up to P = "
            f"{segdp_cuda.k2_cluster_smem_max_p(n)}; the runtime reports "
            f"{json.dumps(segdp_cuda.k2_cluster_occupancy(P, n))}): bit-equal to plain and to "
            f"K1, chains included; K2 {k2_ms:.3f} ms, K1 {w['k1_ms']:.3f} ms, plain "
            f"{w['p_ms']:.3f} ms (medians of {TIMED_REPS}); K2's launch on the device "
            f"{dev_ms.get('segdp_pipelined_cluster_kernel')} ms (profiler, mean of 3); bound "
            f"{b_ms:.4f} ms by {b_by} (bytes {by_bytes:.4f} ms, operations {by_ops:.4f} ms); "
            f"on {card}")
        if P == 256:
            rows["K2 wide"] = dict(max_abs_err=err, ms=k2_ms, plain_ms=w["p_ms"], bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None)

    every = every_width(dev, card, rng, wide)

    # The one-block route, which the tests hold the cluster route against,
    # driven once at P = 256 (forced) with every count at zero.
    segdp_cuda.PIPELINED_LAUNCHES = segdp_cuda.PIPELINED_DEVICE_H_LAUNCHES = 0
    segdp_cuda.PIPELINED_CLUSTER_LAUNCHES = segdp_cuda.LAUNCHES = 0
    one = segdp_cuda.solve_batch_cuda(*wide_args, pipelined=True, with_chains=True,
                                      cluster_size=0)
    torch.cuda.synchronize()
    one_launches = segdp_cuda.PIPELINED_DEVICE_H_LAUNCHES
    if (one_launches, segdp_cuda.PIPELINED_CLUSTER_LAUNCHES, segdp_cuda.LAUNCHES) != (1, 0, 0):
        raise RuntimeError(f"K2's one-block route at P = 256 made {one_launches} device-memory-H "
                           f"launches, {segdp_cuda.PIPELINED_CLUSTER_LAUNCHES} cluster launches")
    if not same_result(one, k1_256):
        raise RuntimeError("K2's one-block route at P = 256 != K1")
    one_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*wide_args, pipelined=True,
                                                         cluster_size=0))
    rows["K2 wide, one block an SM"] = dict(rows["K1 wide (cluster wavefront)"], ms=one_ms)
    log(f"[wide] K2's one-block route at B=8 P=256 R=128 (forced; by shape it takes only P "
        f"below K2_CLUSTER_MIN_P = {segdp_cuda.K2_CLUSTER_MIN_P}; grid "
        f"{segdp_cuda.pipelined_grid(8, 256)}, H in device memory above K2_SMEM_MAX_P = "
        f"{segdp_cuda.K2_SMEM_MAX_P}; the runtime reports "
        f"{json.dumps(segdp_cuda.pipelined_occupancy(256))}): {one_launches} launch with the "
        f"counts at zero, equal to K1, chains included; {one_ms:.3f} ms (median of "
        f"{TIMED_REPS}), on {card}")
    del wide, k2, one

    # A scratch budget forced low: K1 solves the batch in three groups.
    budget = segdp_cuda.SCRATCH_BUDGET
    segdp_cuda.SCRATCH_BUDGET = 3 * segdp_cuda.scratch_bytes(256)
    try:
        g = segdp_cuda.group_size(8, 256)
        grouped = segdp_cuda.solve_batch_cuda(*wide_args, with_chains=True)
        grouped_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*wide_args))
    finally:
        segdp_cuda.SCRATCH_BUDGET = budget
    if -(-8 // g) < 3 or not same_result(grouped, k1_256):
        raise RuntimeError(f"K1 in groups of {g} at P = 256 != K1 in one group")
    log(f"[wide] K1 at B=8 P=256 R=128 in groups of {g} ({-(-8 // g)} groups on one set of "
        f"scratch buffers): equal to the batch in one group; {grouped_ms:.3f} ms (median of "
        f"{TIMED_REPS}), on {card}")
    del wide_args, k1_256, grouped
    torch.cuda.empty_cache()

    thr = ScaledThresholds(0.9)
    problems = []
    for _ in range(3):
        p, r = int(rng.integers(225, 251)), 24
        inc = rng.integers(0, 6, size=(p, r))
        inc[rng.random(size=(p, r)) < 0.5] = 0
        y = np.sort(rng.choice(np.arange(1, 40_000), size=p, replace=False)).astype(np.int64)
        y[0] = 0
        problems.append(DPProblem(C=np.cumsum(inc, axis=0).astype(np.int64), y=y,
                                  W=rng.integers(1, 5, size=r).astype(np.int64), read_support=3))
    segdp_cuda.LAUNCHES = segdp_cuda.DEVICE_H_LAUNCHES = segdp_cuda.CLUSTER_LAUNCHES = 0
    segdp_cuda.LAUNCH_SHAPES.clear()
    got = solve_batch_device(problems, thr, pad_p_to=256, pad_r_to=128, device=dev)
    if got != [solve_host(pr, thr) for pr in problems]:
        raise RuntimeError("the P = 256 bucket through the dispatch != solve_host")
    if (segdp_cuda.LAUNCHES, segdp_cuda.CLUSTER_LAUNCHES) != (1, 1) \
            or list(segdp_cuda.LAUNCH_SHAPES) != [(4, 256, 128)]:
        raise RuntimeError(f"the P = 256 bucket made {segdp_cuda.LAUNCHES} K1 launches, "
                           f"{segdp_cuda.CLUSTER_LAUNCHES} on clusters, at "
                           f"{list(segdp_cuda.LAUNCH_SHAPES)}")
    log(f"[wide] {len(problems)} problems of {[len(pr.y) for pr in problems]} candidates "
        f"(the P = 256 bucket) through solve_batch_device: 1 K1 launch at B=4 (padded from "
        f"1, not 8) with its wavefront on clusters, equal to solve_host")

    d = os.path.join(workdir, "wide")
    os.makedirs(d)
    sim = simulate(**WIDE_CORPUS)
    bam, fq = os.path.join(d, "r.bam"), os.path.join(d, "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    run_split(bam, [fq], os.path.join(d, "split"), SplitConfig())
    segment = [sys.executable, "-c", CLI, "segment"]
    outs = run_procs([
        segment + ["-s", os.path.join(d, "split"), "-o", os.path.join(d, out), *WIDE_FLAGS,
                   "--device", out] for out in (dev.type, "cpu")
    ] + [segment + ["-s", p512["split"], "-o", os.path.join(p512["dir"], dev.type),
                    *P512_FLAGS, "--device", dev.type]], timeout=600)
    rc = p512["proc"].wait(timeout=900)
    with open(p512["log"]) as f:
        host_log = f.read()
    if rc != 0:
        raise RuntimeError(f"segment {' '.join(P512_FLAGS)} --no-device exited {rc}:\n"
                           f"{host_log[-3000:]}")
    log(f"[wide] the host-oracle route over the P = 512 corpus ended "
        f"{time.perf_counter() - p512['started']:.1f} s after it started")
    k1_launches = h_launches = c_launches = 0
    for what, flags, out, card_dir, other_dir, want in (
            ("--device cpu", WIDE_FLAGS, outs[0], os.path.join(d, dev.type), os.path.join(d, "cpu"),
             {192, 224, 256}),
            ("the host-oracle route (--no-device)", P512_FLAGS, outs[2],
             os.path.join(p512["dir"], dev.type), os.path.join(p512["dir"], "host"), {512})):
        launches, on_device, shapes, on_clusters, peak = cli_counts(out)
        widths = {P for _B, P, _R in shapes}
        wide_shapes = [s for s in shapes if s[1] >= segdp_cuda.CLUSTER_MIN_P]
        if launches < len(want) or not want <= widths or on_clusters != len(wide_shapes):
            raise RuntimeError(f"segment {' '.join(flags)}: {launches} K1 launches, "
                               f"{on_clusters} on clusters, at (B, P, R) {shapes}")
        names = same_tsvs(card_dir, other_dir, f"segment {' '.join(flags)}, card against {what}")
        n_reads = len(sim.reads) if flags is WIDE_FLAGS else p512["reads"]
        groups = {tuple(s): -(-s[0] // segdp_cuda.group_size(s[0], s[1])) for s in wide_shapes}
        log(f"[wide] cli segment {' '.join(flags)} on {n_reads} reads: --device {dev.type} "
            f"made {launches} K1 launches, {on_clusters} of them (every one at P >= "
            f"{segdp_cuda.CLUSTER_MIN_P}) on clusters, {on_device} with H in device memory, at "
            f"(B, P, R) {sorted(set(map(tuple, shapes)))}; K1 groups by wide shape "
            f"{json.dumps({str(k): v for k, v in sorted(groups.items())})}; the process's peak "
            f"device memory {peak / 2**20:.0f} MiB; {len(names)} segment TSVs byte-identical "
            f"to {what}")
        k1_launches += launches
        c_launches += on_clusters
        h_launches += on_device
    return dict(k1_launches=k1_launches, k1_cluster_launches=c_launches,
                k1_device_h_launches=h_launches, k2_cluster_launches=k2_launches,
                k2_one_block_launches=one_launches, k1_every_width_launches=every["k1"],
                k2_every_width_launches=every["k2"], rows=rows)


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

    workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=REPO)
    by_path, p512 = {}, None
    try:
        if not opts.kernels:
            p512 = timed("p512 corpus", start_p512_host, workdir)
        kern = timed("kernels", kernel_phase, dev, card)
        pipe_launches = timed("pipelined", pipelined_path, dev, card)
        if opts.kernels:
            log("[kernels] kernel phases only: the paths were not driven, no result line")
            return 3
        timed("cluster", cluster_phase, dev, card)
        by_path["pipeline"], run = timed("pipeline", pipeline_phase, dev, workdir)
        by_path["polya"] = timed("polya", polya_phase, dev, card, run, workdir)
        by_path["mesh"] = timed("mesh", mesh_phase, dev, card)
        by_path["dist"] = timed("dist", dist_phase, dev.type, card, run, workdir)
        by_path["workflow"] = timed("workflow", workflow_phase, dev.type, card, run, workdir)
        wide = timed("wide", wide_phase, dev, card, workdir, p512)
        by_path["wide"] = wide["k1_launches"]
        by_path["window"] = timed("window", window_phase, dev, card, run, workdir)
        by_path["entry"] = timed("entry", entry_phase, dev, card)
        timed("tools", tools_phase, dev, card)
        if opts.fuzz:
            timed("fuzz", fuzz_phase, dev, card, opts.fuzz)
    finally:
        if p512 is not None and p512["proc"].poll() is None:
            p512["proc"].kill()
            p512["proc"].wait()
        shutil.rmtree(workdir, ignore_errors=True)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    log(f"[time] the whole run, from the build's end: {time.perf_counter() - started:.1f} s")
    log(f"[kernels] segdp (K1) launches by path: {json.dumps(by_path)}, of which with the "
        f"wavefront on clusters: {json.dumps({'wide': wide['k1_cluster_launches']})}, with H in "
        f"device memory: {json.dumps({'wide': wide['k1_device_h_launches']})}; "
        f"segdp_pipelined (K2): {json.dumps({'pipelined': pipe_launches})}, on its cluster "
        f"route: {json.dumps({'wide': wide['k2_cluster_launches']})}, on its one-block route "
        f"with H in device memory: {json.dumps({'wide': wide['k2_one_block_launches']})}; "
        f"past the widths a ring of whole planes held and with the row ring forced, on the "
        f"cluster routes: K1 {wide['k1_every_width_launches']}, K2 "
        f"{wide['k2_every_width_launches']}")
    if min(wide["k1_cluster_launches"], wide["k2_cluster_launches"],
           wide["k2_one_block_launches"], wide["k1_every_width_launches"],
           wide["k2_every_width_launches"]) <= 0:
        raise RuntimeError("a wide route was launched no time in its run")
    log(card)
    kern.update(wide["rows"])
    rows = [("segdp", "freddie_tpu/ops/segdp_pallas.py:65", sum(by_path.values())),
            ("segdp_pipelined", "freddie_tpu/ops/segdp_pallas.py:445", pipe_launches),
            ("K1 wide (cluster wavefront)", "freddie_tpu/ops/segdp_pallas.py:65",
             wide["k1_cluster_launches"]),
            ("K2 wide", "freddie_tpu/ops/segdp_pallas.py:445",
             wide["k2_cluster_launches"] + wide["k2_every_width_launches"]),
            ("K2 wide, one block an SM", "freddie_tpu/ops/segdp_pallas.py:445",
             wide["k2_one_block_launches"])]
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
