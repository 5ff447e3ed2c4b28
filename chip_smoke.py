#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the segmentation-DP kernels from ``freddie_tpu_torch/csrc`` and,
on the card:

1. holds K1 (``solve_batch_cuda``) and K2 (``pipelined=True``) bit for
   bit against their plain PyTorch version and each other at the segment
   stage's chunk shapes and the kernel benchmark shape, and times all
   three;
2. drives K2's path (``solve_batch_cuda(pipelined=True)``) once with the
   launch counts at zero and profiles one K1 and one K2 call;
3. holds the cluster solver's device bounds against the host bounds,
   and the port's two-phase solve on the card against the CPU, with the
   gates set so that the wide and the closure rung both run;
4. drives the port's whole pipeline (split -> segment -> cluster ->
   isoforms) over the 25,920-read benchmark corpus and checks that the
   DP really ran in K1, that the segment TSVs equal the host-oracle
   route's byte for byte, and how many simulated isoforms came back.

No phase imports JAX. Details go to earlier lines; the line before the
last is the kernel table as JSON, the last line ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero without that
line; so does a machine with no GPU.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The benchmark corpus (bench.py): 96 genes x 3 isoforms x 90 reads,
# noisy. Its 96 tints pass the device-coverage gate (64), so the stage's
# coverage build on the device and the kernel both run.
SIM = dict(
    seed=9001, n_genes=96, isoforms_per_gene=3, reads_per_isoform=90,
    minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8,
    end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6,
    big_del_rate=0.06,
)
# (B, P, R): the segment stage's full chunk at the (P, R) buckets
# (16, 128), (32, 512), (64, 512) -- min(suggested_batch_size, 512)
# rounded down to a power of two -- then the three launches the stage
# makes on the benchmark corpus, then the kernel benchmark of bench.py.
CHUNK_SHAPES = [
    (512, 16, 128), (256, 32, 512), (64, 64, 512),
    (512, 16, 384), (64, 32, 384), (64, 64, 384),
]
BENCH_SHAPE = (2048, 64, 512)
# K2 only: a lone block with one problem, and G+3 problems (blocks that
# own two), at (P, R) = (32, 512); G is K2's grid on this card.
PIPE_P_R = (32, 512)
TIMED_REPS = 5


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synthetic_batch(rng, B, P, R, wide):
    """Padded DP batch with varied candidate counts: monotone coverage with
    plateaus and jumps (tests/test_segdp.py), sorted positions, weights
    1..4 (x97 past the 7-bit range when ``wide``)."""
    import numpy as np

    inc = rng.integers(0, 12, size=(B, P, R))
    inc[rng.random(size=(B, P, R)) < 0.5] = 0
    C = np.cumsum(inc, axis=1).astype(np.int32)
    y = np.sort(rng.integers(1, 20_000, size=(B, P)), axis=1).astype(np.int32)
    y[:, 0] = 0
    n_cand = rng.integers(max(3, P // 2), P + 1, size=B).astype(np.int32)
    for b in range(B):
        n = n_cand[b]
        C[b, n:] = C[b, n - 1]
        y[b, n:] = y[b, n - 1]
    W = rng.integers(1, 5, size=(B, R)).astype(np.float32) * (97 if wide else 1)
    return dict(C=C, y=y, W=W, n_cand=n_cand)


def time_ms(fn, reps=TIMED_REPS) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


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
    best_k); median times of all three. Returns, per kernel, the largest
    error and the times at the benchmark shape."""
    import numpy as np
    import torch

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import ScaledThresholds, _solve_batch_torch, to_device

    thr = ScaledThresholds(0.9)
    lookup = torch.from_numpy(thr.lookup).to(dev)
    rng = np.random.default_rng(2024)
    max_err = {"segdp": 0.0, "segdp_pipelined": 0.0}
    times = {}
    G = segdp_cuda.pipelined_grid(65535, PIPE_P_R[0])
    pipe_only = [((1,) + PIPE_P_R, False), ((G + 3,) + PIPE_P_R, False)]
    cases = ([(s, w) for s in CHUNK_SHAPES for w in (False, True)]
             + [(BENCH_SHAPE, False)] + pipe_only)
    for (B, P, R), wide in cases:
        t = to_device(synthetic_batch(rng, B, P, R, wide), dev)
        args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
        got = {
            "segdp": segdp_cuda.solve_batch_cuda(*args, wide_weights=wide),
            "segdp_pipelined": segdp_cuda.solve_batch_cuda(*args, wide_weights=wide,
                                                           pipelined=True),
        }
        plain = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                plain.append(_solve_batch_torch(*args))
                torch.cuda.synchronize()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        where = f"at B={B} P={P} R={R} wide={wide}"
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
        k1_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, wide_weights=wide))
        k2_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, wide_weights=wide,
                                                            pipelined=True))
        p_ms = time_ms(lambda: _solve_batch_torch(*args))
        times[(B, P, R, wide)] = (k1_ms, k2_ms, p_ms)
        log(f"[kernel] B={B} P={P} R={R} wide={wide} (K2 grid "
            f"{segdp_cuda.pipelined_grid(B, P)}): K1 and K2 bit-equal to "
            f"plain (tf32 off and on) and to each other, {n_seg}/{B} segmented; "
            f"K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms, plain {p_ms:.3f} ms "
            f"(median of {TIMED_REPS}) on {card}")
        del t, args, got, plain
        torch.cuda.empty_cache()
    k1_ms, k2_ms, p_ms = times[BENCH_SHAPE + (False,)]
    return {
        "segdp": dict(max_abs_err=max_err["segdp"], ms=k1_ms, plain_ms=p_ms),
        "segdp_pipelined": dict(max_abs_err=max_err["segdp_pipelined"], ms=k2_ms,
                                plain_ms=p_ms),
    }


def pipelined_path(dev, card) -> int:
    """K2's path, ``solve_batch_cuda(pipelined=True)``, driven once at the
    benchmark shape with every launch count at zero; its result is held
    against K1's. Then one K1 and one K2 call under torch.profiler: the
    pair-statistics pass alone, the wavefront, and K2. Returns K2's
    launches in the driven run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import ScaledThresholds, to_device

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            segdp_cuda.solve_batch_cuda(*args)
            segdp_cuda.solve_batch_cuda(*args, pipelined=True)
        torch.cuda.synchronize()
    dev_ms = {}
    for evt in prof.key_averages():
        for name in ("pair_stats_kernel", "wavefront_kernel", "segdp_pipelined_kernel"):
            if name in evt.key:
                total = getattr(evt, "device_time_total", None)
                if total is None:
                    total = getattr(evt, "cuda_time_total", 0.0)
                dev_ms[name] = dev_ms.get(name, 0.0) + total / 1000.0 / reps
    if len(dev_ms) == 3:
        log(f"[pipelined] profiler device time per call at {BENCH_SHAPE}: K1 "
            f"pair_stats alone {dev_ms['pair_stats_kernel']:.3f} ms + wavefront "
            f"{dev_ms['wavefront_kernel']:.3f} ms; K2 "
            f"{dev_ms['segdp_pipelined_kernel']:.3f} ms (mean of {reps}) on {card}")
    else:
        log(f"[pipelined] profiler recorded no device time for {sorted(dev_ms)}: "
            "per-phase times not measured")
    return launches


def cluster_phase(dev, card) -> None:
    """The cluster solver's device bounds on the card against the host
    bounds (``_PerStructure.optimistic_block``), and the port's two-phase
    solve on the card against the CPU with the wide and the closure rung
    forced to run."""
    import numpy as np
    import torch

    from freddie_tpu.solver import segenum as jse
    from freddie_tpu.solver import two_phase as jtp
    from freddie_tpu.solver.native import native_available
    from freddie_tpu_torch.solver import segenum as tse
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
            # Every mask at Mi = 21; a strided sample of 2^16 at Mi = 24,
            # where the host's full pass would take minutes.
            stride = 1 if Mi == 21 else (1 << Mi) >> 16
            masks = np.arange(0, 1 << Mi, stride, dtype=np.uint64)
            t0 = time.perf_counter()
            want = host_bounds(jse._PerStructure(inst), masks)
            host_s = time.perf_counter() - t0
            if not np.array_equal(got[::stride], want):
                raise RuntimeError(f"optimistic_device != host at Mi={Mi} N={N}")
            log(f"[cluster] optimistic_device Mi={Mi} N={N}: {1 << Mi} masks in "
                f"{dev_s * 1e3:.3f} ms on the card (host clock, transfers included); "
                f"equal to the host bounds on {len(masks)} masks "
                f"({host_s:.3f} s on the host) on {card}")

    N = 1000
    K = -(-jse.BOUNDS_DEVICE_MIN // N)
    rng = np.random.default_rng(40)
    ctx = jse._PerStructure(clustered_instance(rng, N, 40, k_true=2))
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
    saved = (jse.CLOSURE_CAP, jse.BOUNDS_DEVICE_MIN, jtp.NODE_BUDGET)
    cases = [
        ("wide", clustered_instance(np.random.default_rng(1), 20, 22),
         dict(CLOSURE_CAP=0), "optimistic_device"),
        ("closure", clustered_instance(np.random.default_rng(3), 1000, 40, k_true=2),
         dict(BOUNDS_DEVICE_MIN=1), "optimistic_masks_device"),
    ]
    try:
        for name in calls:
            setattr(tse, name, counted(name))
        jtp.NODE_BUDGET = 1
        for rung, inst, gates, bound in cases:
            for k, v in gates.items():
                setattr(jse, k, v)
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
            jse.CLOSURE_CAP, jse.BOUNDS_DEVICE_MIN = saved[:2]
    finally:
        jse.CLOSURE_CAP, jse.BOUNDS_DEVICE_MIN, jtp.NODE_BUDGET = saved
        for name, fn in real.items():
            setattr(tse, name, fn)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported by the cluster bounds")


def recovery(gtf: str, truth) -> tuple[int, int]:
    """Truth isoforms recovered, by bench.py's criterion: a reported
    transcript with the same exon count, internal boundaries within
    2*junction_jitter+2 and ends within end_jitter+15."""
    got: dict[str, list] = {}
    with open(gtf) as f:
        for line in f:
            fields = line.split("\t")
            if len(fields) > 4 and fields[2] == "exon":
                tid = line.split('transcript_id "')[1].split('"')[0]
                got.setdefault(tid, []).append((int(fields[3]), int(fields[4])))
    chains = [sorted(v) for v in got.values()]
    internal_tol = 2 * SIM["junction_jitter"] + 2
    end_tol = SIM["end_jitter"] + 15

    def matches(t, g):
        if len(t) != len(g):
            return False
        tb = [b for ex in t for b in ex]
        gb = [b for ex in g for b in ex]
        return all(
            abs(a - b) <= (end_tol if i in (0, len(tb) - 1) else internal_tol)
            for i, (a, b) in enumerate(zip(tb, gb))
        )

    return sum(1 for t in truth if any(matches(list(t), g) for g in chains)), len(chains)


def tsv_tree(root: str) -> list[str]:
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _dirs, fns in os.walk(root) for f in fns if f.endswith(".tsv")
    )


def pipeline_phase(dev, workdir: str) -> int:
    """The port's pipeline on the card over the benchmark corpus; returns
    the K1 launches it made."""
    import torch

    from freddie_tpu_torch.config import PipelineConfig, SegmentConfig
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.stages.pipeline import run_pipeline
    from freddie_tpu_torch.stages.segment import run_segment
    from freddie_tpu_torch.utils.sim import simulate

    t0 = time.perf_counter()
    sim = simulate(**SIM)
    bam, fq = os.path.join(workdir, "reads.bam"), os.path.join(workdir, "reads.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    truth = sorted(tuple(t.exons) for t in sim.transcripts)
    log(f"[pipeline] simulated {len(sim.reads)} reads, {len(truth)} isoforms "
        f"in {time.perf_counter() - t0:.2f} s")

    out = os.path.join(workdir, "run")
    segdp_cuda.LAUNCHES = 0
    segdp_cuda.PIPELINED_LAUNCHES = 0
    t0 = time.perf_counter()
    stats = run_pipeline(bam, [fq], out, PipelineConfig(), log=log, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segdp_cuda.LAUNCHES
    if launches <= 0:
        raise RuntimeError("the pipeline's segment stage never launched the kernel")
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported on the port's path")
    stage_s = {k: v["seconds"] for k, v in stats.items() if isinstance(v, dict)}
    log(f"[pipeline] stages (s): {json.dumps(stage_s)}; wall {wall:.3f} s; "
        f"{launches} kernel launches")

    seg_dir = os.path.join(out, "segment")
    hot = []
    for i in range(3):
        d = os.path.join(workdir, f"segment_hot{i}")
        t0 = time.perf_counter()
        run_segment(os.path.join(out, "split"), d, SegmentConfig(), device=dev)
        torch.cuda.synchronize()
        hot.append(time.perf_counter() - t0)
        shutil.rmtree(d)
    host_dir = os.path.join(workdir, "segment_host")
    t0 = time.perf_counter()
    run_segment(os.path.join(out, "split"), host_dir, SegmentConfig(use_device=False),
                device=dev)
    host_s = time.perf_counter() - t0
    names = tsv_tree(seg_dir)
    if not names or names != tsv_tree(host_dir):
        raise RuntimeError("segment TSV sets differ between the device and host routes")
    differ = [n for n in names if not filecmp.cmp(
        os.path.join(seg_dir, n), os.path.join(host_dir, n), shallow=False)]
    if differ:
        raise RuntimeError(f"segment TSVs differ from the host route: {differ[:5]}")
    log(f"[pipeline] segment on the card: hot {min(hot):.3f} s (min of 3: "
        f"{', '.join(f'{h:.3f}' for h in hot)}); host-oracle route {host_s:.3f} s; "
        f"{len(names)} segment TSVs byte-identical")

    matched, reported = recovery(stats["gtf"], truth)
    if reported == 0:
        raise RuntimeError("the pipeline reported no transcripts")
    log(f"[pipeline] recovery {matched}/{len(truth)} = {matched / len(truth):.3f} "
        f"of simulated isoforms ({reported} transcripts reported)")
    return launches


def main() -> int:
    import torch

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

    kern = kernel_phase(dev, card)
    pipe_launches = pipelined_path(dev, card)
    cluster_phase(dev, card)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=REPO)
    try:
        launches = pipeline_phase(dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log(card)
    rows = [("segdp", "freddie_tpu/ops/segdp_pallas.py:65", launches),
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
