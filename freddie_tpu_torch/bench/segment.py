"""The port's headline benchmark: the segment stage on a simulated noisy
corpus, with the rest of the pipeline and the DP kernels beside it.

    python -m freddie_tpu_torch.bench.segment [--device cuda|cuda:N|cpu]
                                              [--small] [--json PATH]

One process, on the port's own code. ``--device cuda`` (the default)
needs a card and raises without one; nothing is measured on the CPU
unless ``--device cpu`` asks for it. Measures, on the benchmark corpus
(25,920 reads over 96 loci; ``--small``: 6 genes x 20 reads):

- ``run_pipeline`` once (split with 2 threads, cluster with 4 threads and
  a 1-minute solver deadline): per-stage seconds from ``StageMetrics``,
  the wall, the cluster solver's device seconds, and K1's launches during
  it with their (B, P, R). Its segment stage is the cold run;
- the segment stage again, three times (hot: the minimum; all three are
  reported), and once on the host-oracle route (``use_device=False``),
  whose TSVs the device route's must equal byte for byte: a difference
  raises;
- recovery of the simulated isoforms, all and reachable, and the
  recovery on the milder 40-gene corpus in the same process;
- K1 at the kernel benchmark shape (2048, 64, 512) and at the stage's
  three shapes, and K2 at the benchmark shape: CUDA-event median of 5
  whole ``solve_batch_cuda`` calls, each beside the card's bound for the
  same batch. On the CPU these are host-clock times of the plain version
  under ``plain_host_ms``; ``ms`` and ``bound_ms`` stay null there.

The original freddie is not run: ``reference_segment_s`` and
``segment_matches_reference`` are null, and the baseline of
``vs_host_oracle`` is the port's own host-oracle route. Earlier lines are
free text; the last line is one JSON object with
``"metric": "segment_stage_reads_per_s"`` (also written to ``--json``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import ClusterConfig, PipelineConfig, SegmentConfig, SplitConfig
from ..device import resolve_device
from ..ops import segdp_cuda
from ..ops.segdp import ScaledThresholds, to_device
from ..solver.segenum import DEVICE_SECONDS
from ..stages.pipeline import run_pipeline
from ..stages.segment import run_segment
from ..utils.sim import BENCH_CORPUS, simulate
from .common import (
    KERNEL_SHAPE, SMALL_CORPUS, SMALL_KERNEL_SHAPE, STAGE_SHAPES, TIMED_REPS, bound_ms,
    build_dataset, card_line, recovery, same_tsvs, synthetic_batch, time_ms)

# The milder corpus whose recovery is reported beside the headline's
# (tests/test_many_loci.py's simulation and tolerances).
MILD_CORPUS = dict(seed=11, n_genes=40, isoforms_per_gene=3, reads_per_isoform=80,
                   end_jitter=20, indel_rate=0.05, junction_jitter=4)
MILD_SMALL = dict(MILD_CORPUS, n_genes=4, reads_per_isoform=20)
MILD_TOL = dict(internal_tol=10, end_tol=40)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_times(dev: torch.device, shapes, k2_shape) -> list[dict]:
    """K1 at ``shapes`` and K2 at ``k2_shape``, whole calls on resident
    inputs. On a card: CUDA-event median of TIMED_REPS and the card's bound
    for the batch. On the CPU: the plain version by the host clock."""
    thr = ScaledThresholds(0.9)
    lookup = torch.from_numpy(thr.lookup).to(dev)
    rows = []
    for name, pipelined, (B, P, R) in ([("segdp", False, s) for s in shapes]
                                       + [("segdp_pipelined", True, k2_shape)]):
        t = to_device(synthetic_batch(np.random.default_rng(7), B, P, R, False), dev)
        args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
        row = dict(name=name, B=B, P=P, R=R, ms=None, bound_ms=None, bound_by=None,
                   plain_host_ms=None)
        if dev.type == "cuda":
            row["ms"] = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=pipelined))
            row["bound_ms"], row["bound_by"] = bound_ms(t, P)[:2]
        else:
            times = []
            for _ in range(TIMED_REPS):
                t0 = time.perf_counter()
                segdp_cuda.solve_batch_cuda(*args, pipelined=pipelined)
                times.append((time.perf_counter() - t0) * 1e3)
            row["plain_host_ms"] = statistics.median(times)
        rows.append(row)
        del t, args
    return rows


def mild_recovery(dev: torch.device, workdir: str, corpus: dict) -> float:
    """The share of the milder corpus's isoforms that the pipeline on
    ``dev`` recovers."""
    d = os.path.join(workdir, "mild")
    os.makedirs(d)
    sim = simulate(**corpus)
    bam, fq = os.path.join(d, "r.bam"), os.path.join(d, "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    stats = run_pipeline(bam, [fq], os.path.join(d, "out"), PipelineConfig(),
                         log=lambda *_: None, device=dev)
    truth = sorted(tuple(t.exons) for t in sim.transcripts)
    matched, _reported = recovery(stats["gtf"], truth, **MILD_TOL)
    return matched / max(len(truth), 1)


def measure(dev: torch.device, workdir: str, small: bool = False, log=print,
            mild: bool = True):
    """Everything the module's docstring lists, on ``dev``, with the work
    files under ``workdir``; without ``mild`` the milder corpus is not run
    and its recovery is reported as null. Returns (the result dict, the run's paths:
    ``bam``, ``fq``, ``out`` and ``host_segment``). Raises when the device
    route's segment TSVs differ from the host-oracle route's, when the
    pipeline reports no transcript, or when a card's segment stage never
    launched K1."""
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    bam, fq, n_reads, truth, reachable = build_dataset(
        workdir, SMALL_CORPUS if small else BENCH_CORPUS)
    log(f"[bench] simulated {n_reads} reads, {len(truth)} isoforms "
        f"({len(reachable)} reachable) in {time.perf_counter() - t0:.2f} s")

    cfg = PipelineConfig(split=SplitConfig(threads=2),
                         cluster=ClusterConfig(threads=4, timeout=1))
    out = os.path.join(workdir, "run")
    segdp_cuda.LAUNCHES = 0
    segdp_cuda.PIPELINED_LAUNCHES = 0
    segdp_cuda.LAUNCH_SHAPES.clear()
    bounds_s = DEVICE_SECONDS[0]
    t0 = time.perf_counter()
    stats = run_pipeline(bam, [fq], out, cfg, log=log, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    bounds_s = DEVICE_SECONDS[0] - bounds_s
    launches, shapes = segdp_cuda.LAUNCHES, [list(s) for s in segdp_cuda.LAUNCH_SHAPES]
    if on_card and launches <= 0:
        raise RuntimeError("the pipeline's segment stage never launched the kernel")
    stage_s = {k: v["seconds"] for k, v in stats.items() if isinstance(v, dict)}
    n_tints = stats["segment"]["result"]
    log(f"[bench] stages (s): {json.dumps(stage_s)}; wall {wall:.3f} s; "
        f"{launches} kernel launches at {shapes}")

    split_dir, seg_dir = os.path.join(out, "split"), os.path.join(out, "segment")
    hot = []
    for i in range(3):
        d = os.path.join(workdir, f"segment_hot{i}")
        t0 = time.perf_counter()
        run_segment(split_dir, d, SegmentConfig(), device=dev)
        _sync(dev)
        hot.append(time.perf_counter() - t0)
        shutil.rmtree(d)
    host_dir = os.path.join(workdir, "segment_host")
    t0 = time.perf_counter()
    run_segment(split_dir, host_dir, SegmentConfig(use_device=False), device=dev)
    host_s = time.perf_counter() - t0
    names = same_tsvs(seg_dir, host_dir, "segment TSVs, device route against host oracle")
    log(f"[bench] segment on {dev}: hot {min(hot):.3f} s (min of 3: "
        f"{', '.join(f'{h:.3f}' for h in hot)}); host-oracle route {host_s:.3f} s; "
        f"{len(names)} segment TSVs byte-identical")

    matched, reported = recovery(stats["gtf"], truth)
    if reported == 0:
        raise RuntimeError("the pipeline reported no transcripts")
    matched_reachable, _ = recovery(stats["gtf"], reachable)
    log(f"[bench] recovery {matched}/{len(truth)} = {matched / len(truth):.3f} "
        f"of simulated isoforms ({reported} transcripts reported)")
    mild_rate = (mild_recovery(dev, workdir, MILD_SMALL if small else MILD_CORPUS)
                 if mild else None)

    kshape = SMALL_KERNEL_SHAPE if small else KERNEL_SHAPE
    kernels = kernel_times(dev, [kshape] + ([] if small else STAGE_SHAPES), kshape)
    head = kernels[0]
    seg_s = min(hot)
    result = dict(
        metric="segment_stage_reads_per_s",
        value=n_reads / seg_s,
        unit="reads/s",
        vs_host_oracle=host_s / seg_s,
        reads=n_reads,
        loci=n_tints,
        segment_s=seg_s,
        segment_hot_runs_s=hot,
        segment_cold_s=stage_s["segment"],
        host_oracle_segment_s=host_s,
        segment_matches_host_oracle=True,
        segment_tsvs=len(names),
        reference_segment_s=None,
        segment_matches_reference=None,
        split_s=stage_s["split"],
        split_reads_per_s=n_reads / stage_s["split"],
        cluster_s=stage_s["cluster"],
        cluster_loci_per_s=stats["cluster"]["result"] / stage_s["cluster"],
        cluster_timeout_min=cfg.cluster.timeout,
        cluster_device_s=bounds_s,
        isoforms_s=stage_s["isoforms"],
        pipeline_wall_s=wall,
        segment_k1_launches=launches,
        segment_k1_shapes=shapes,
        kernels=kernels,
        kernel_reads_per_s=(head["B"] * head["R"] / (head["ms"] * 1e-3)
                            if head["ms"] else None),
        reported_transcripts=reported,
        truth_transcripts=len(truth),
        recovered_transcripts=matched,
        recovery_rate=matched / max(len(truth), 1),
        reachable_transcripts=len(reachable),
        recovered_reachable=matched_reachable,
        recovery_rate_reachable=matched_reachable / max(len(reachable), 1),
        recovery_rate_mild=mild_rate,
        small=small,
        device=torch.cuda.get_device_name(dev) if on_card else "cpu",
        card=card_line() if on_card else None,
        backend="torch",
    )
    return result, dict(bam=bam, fq=fq, out=out, host_segment=host_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--small", action="store_true",
                    help="a 6-gene corpus and a tiny kernel shape: checks the structure")
    ap.add_argument("--json", help="also write the result line here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # raises for cuda without a card

    def log(*a):
        print(*a, flush=True)

    workdir = tempfile.mkdtemp(prefix="freddie_torch_bench_")
    try:
        result, _paths = measure(dev, workdir, small=args.small, log=log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = json.dumps(result)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
