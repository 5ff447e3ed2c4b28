"""Large-corpus stress harness: generate a multi-contig simulated corpus
and run the pipeline stage by stage with walls and peak RSS.

    python -m freddie_tpu_torch.tools.stress_run gen --out DIR --contigs 4 --genes 9250
    python -m freddie_tpu_torch.tools.stress_run run --corpus DIR [--device cuda|cpu]
                                                    [--threads N] [--window W]

``gen`` builds one simulation per contig (the benchmark corpus's noise
profile, per-contig seeds, read names made unique by contig), writes
per-contig BAMs and merges them into one coordinate-sorted multi-contig
BAM and a FASTQ with the package's own codec. 9250 genes x 3 isoforms x
90 reads x 4 contigs = 9,990,000 reads. Run it as its own process so its
memory does not count in the pipeline's.

``run`` executes split -> segment -> cluster -> isoforms in one process
and prints, as one JSON line, the per-stage walls, the total, reads/s,
the transcript count and the process's peak RSS. ``--window``
sets ``SegmentConfig.stream_window`` (0: off).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import sys
import time

from ..utils.sim import BENCH_CORPUS

SIM_NOISE = {k: v for k, v in BENCH_CORPUS.items() if k not in ("seed", "n_genes")}


def cmd_gen(args) -> None:
    from ..io.bam import BamReader, BamRecord, BamWriter
    from ..utils.sim import simulate

    os.makedirs(args.out, exist_ok=True)
    contig_bams, contigs, lengths = [], [], []
    with open(os.path.join(args.out, "stress.fastq"), "w") as fq:
        for i in range(args.contigs):
            contig = f"chr{i + 1}"
            t0 = time.time()
            sim = simulate(seed=args.seed + i, contig=contig, n_genes=args.genes, **SIM_NOISE)
            for r in sim.reads:  # unique across contigs
                r.name = f"{contig}_{r.name}"
            cb = os.path.join(args.out, f"_{contig}.bam")
            sim.write_bam(cb)
            for r in sim.reads:
                fq.write(f"@{r.name}\n{r.fastq_seq}\n+\n{'I' * len(r.fastq_seq)}\n")
            contig_bams.append(cb)
            contigs.append(contig)
            lengths.append(sim.contig_len)
            print(f"[gen] {contig}: {len(sim.reads)} reads, {sim.contig_len / 1e6:.0f} Mb, "
                  f"{time.time() - t0:.0f}s", flush=True)
            del sim
    # Each per-contig BAM is coordinate-sorted; concatenated in header
    # order they make a coordinate-sorted multi-contig BAM.
    merged = os.path.join(args.out, "stress.bam")
    t0 = time.time()
    n = 0
    with BamWriter(merged, contigs, lengths) as w:
        for i, cb in enumerate(contig_bams):
            with BamReader(cb) as rd:
                for rec in rd:
                    w.write(BamRecord(
                        query_name=rec.query_name, flag=rec.flag, reference_id=i,
                        reference_start=rec.reference_start, mapq=rec.mapq,
                        cigartuples=rec.cigartuples, query_sequence=rec.query_sequence))
                    n += 1
            os.remove(cb)
    print(f"[gen] merged {n} records over {len(contigs)} contigs in "
          f"{time.time() - t0:.0f}s -> {merged}", flush=True)


def _peak_rss_gb() -> float:
    """The process's peak resident set: VmHWM of /proc/self/status, or
    where the kernel does not report it, getrusage's ru_maxrss (kB)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1e6  # kB -> GB
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def cmd_run(args) -> None:
    from ..config import PipelineConfig
    from ..device import resolve_device
    from ..stages.cluster import run_cluster
    from ..stages.isoforms import run_isoforms
    from ..stages.segment import run_segment
    from ..stages.split import run_split

    dev = resolve_device(args.device)
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        split=dataclasses.replace(cfg.split, threads=args.threads),
        segment=dataclasses.replace(cfg.segment, threads=args.threads,
                                    stream_window=args.window),
        cluster=dataclasses.replace(cfg.cluster, threads=args.threads),
        isoforms=dataclasses.replace(cfg.isoforms, threads=args.threads),
    )
    bam = os.path.join(args.corpus, "stress.bam")
    fq = os.path.join(args.corpus, "stress.fastq")
    out = args.workdir or os.path.join(args.corpus, "out")
    split, segment, cluster = (os.path.join(out, s) for s in ("split", "segment", "cluster"))
    gtf = os.path.join(out, "isoforms.gtf")
    stages = [
        ("split", lambda: run_split(bam, [fq], split, cfg.split)),
        ("segment", lambda: run_segment(split, segment, cfg.segment, device=dev)),
        ("cluster", lambda: run_cluster(segment, cluster, cfg.cluster, device=dev)),
        ("isoforms", lambda: run_isoforms(split, cluster, gtf, cfg.isoforms)),
    ]
    walls = {}
    for name, fn in stages:
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
    with open(fq) as f:
        n_reads = sum(1 for _ in f) // 4
    with open(gtf) as f:
        n_tx = sum(1 for line in f if "\ttranscript\t" in line)
    total = sum(walls.values())
    print(json.dumps(dict(
        walls=walls, total_s=total, reads=n_reads, reads_per_s=n_reads / total,
        transcripts=n_tx, peak_rss_gb=_peak_rss_gb(), threads=args.threads,
        window=args.window, device=str(dev),
    )), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen", help="simulate and merge the corpus")
    g.add_argument("--out", required=True)
    g.add_argument("--contigs", type=int, default=4)
    g.add_argument("--genes", type=int, default=9250)
    g.add_argument("--seed", type=int, default=77_000)
    g.set_defaults(fn=cmd_gen)
    r = sub.add_parser("run", help="run the four stages over a generated corpus")
    r.add_argument("--corpus", required=True)
    r.add_argument("--workdir", default=None)
    r.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    r.add_argument("--threads", type=int, default=os.cpu_count() or 4)
    r.add_argument("--window", type=int, default=0)
    r.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
