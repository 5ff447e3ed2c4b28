#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the segmentation-DP kernel from ``freddie_tpu_torch/csrc``, holds
it bit for bit against its plain PyTorch version on the card at the
segment stage's chunk shapes and at the kernel benchmark shape, then
drives the port's whole pipeline (split -> segment -> cluster ->
isoforms) over the 25,920-read benchmark corpus on the card and checks
that the DP really ran in the kernel, that no JAX was imported, that the
segment TSVs equal the host-oracle route's byte for byte, and how many
simulated isoforms came back. Details go to earlier lines; the line
before the last is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; so does a machine with no GPU.
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


def kernel_phase(dev, card) -> dict:
    """solve_batch_cuda vs _solve_batch_torch on the card (TF32 off and
    on): K rows 0..P-2, best_j and best_k bit-equal; median times."""
    import numpy as np
    import torch

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp import ScaledThresholds, _solve_batch_torch, to_device

    thr = ScaledThresholds(0.9)
    lookup = torch.from_numpy(thr.lookup).to(dev)
    rng = np.random.default_rng(2024)
    max_err = 0.0
    times = {}
    cases = [(s, w) for s in CHUNK_SHAPES for w in (False, True)] + [(BENCH_SHAPE, False)]
    for (B, P, R), wide in cases:
        t = to_device(synthetic_batch(rng, B, P, R, wide), dev)
        args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
        Kc, bjc, bkc = segdp_cuda.solve_batch_cuda(*args, wide_weights=wide)
        torch.cuda.synchronize()
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                Kt, bjt, bkt = _solve_batch_torch(*args)
                torch.cuda.synchronize()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            err = max(
                (Kc[:, : P - 1] - Kt[:, : P - 1]).abs().max().item(),
                (bjc - bjt).abs().max().item(),
                (bkc - bkt).abs().max().item(),
            )
            same_row = bool(torch.equal(Kc[:, P - 1, 0], bjc) and torch.equal(Kc[:, P - 1, 1], bkc))
            if err != 0 or not same_row:
                raise RuntimeError(
                    f"kernel != plain at B={B} P={P} R={R} wide={wide} "
                    f"tf32={tf32}: max abs err {err}, last row ok {same_row}")
            max_err = max(max_err, float(err))
        n_seg = int((bjc >= 0).sum())
        k_ms = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, wide_weights=wide))
        p_ms = time_ms(lambda: _solve_batch_torch(*args))
        times[(B, P, R, wide)] = (k_ms, p_ms)
        log(f"[kernel] B={B} P={P} R={R} wide={wide}: bit-equal to plain "
            f"(tf32 off and on), {n_seg}/{B} segmented; kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms (median of {TIMED_REPS}) on {card}")
        del t, args, Kc, bjc, bkc, Kt, bjt, bkt
        torch.cuda.empty_cache()
    k_ms, p_ms = times[BENCH_SHAPE + (False,)]
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms)


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
    the kernel launches it made."""
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
    workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=REPO)
    try:
        launches = pipeline_phase(dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    log(card)
    log(json.dumps({"kernels": [{
        "name": "segdp",
        "route": "cuda",
        "source": "freddie_tpu_torch/csrc/segdp.cu",
        "replaces": "freddie_tpu/ops/segdp_pallas.py:65",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
