"""Measure how often cluster ILP instances have non-unique optima.

    python -m freddie_tpu_torch.tools.audit_tiebreak [N_SHIFTS] [--device cuda|cpu]

Runs the parity suite's three simulation configs across seed shifts,
drives split -> segment -> cluster, and classifies every solver instance
the production rounds loop produces with ``solver.audit.audit_instance``.
An instance is 'nonunique' when two distinct (isoform, assignment) pairs
attain the optimal objective: the only regime where the canonical
tie-break could legitimately differ from an ILP solver's.
``--deadline-s`` and ``--node-cap`` raise the audit's budget for the
hardest instances.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from ..config import ClusterConfig, SegmentConfig, SplitConfig
from ..io.tsv import parse_segment_tsv
from ..solver.audit import audit_instance
from ..stages.cluster import cluster_tint
from ..stages.segment import run_segment
from ..stages.split import run_split
from ..utils.sim import PARITY_CORPORA, parity_corpus, simulate


def audit_config(name: str, shift: int, stats: dict, device, deadline_s: float,
                 node_cap: int) -> None:
    with tempfile.TemporaryDirectory() as d:
        sim = simulate(**parity_corpus(name, shift))
        bam, fq = os.path.join(d, "r.bam"), os.path.join(d, "r.fastq")
        sim.write_bam(bam)
        sim.write_fastq(fq)
        split_dir, seg_dir = os.path.join(d, "split"), os.path.join(d, "segment")
        counts = run_split(bam, [fq], split_dir, SplitConfig())
        run_segment(split_dir, seg_dir, SegmentConfig(), device=device)

        def hook(inst):
            verdict = audit_instance(inst, deadline_s=deadline_s, node_cap=node_cap,
                                     device=device)
            stats[verdict] = stats.get(verdict, 0) + 1
            stats.setdefault("sizes", []).append((len(inst.rows), len(inst.seg_len)))

        for contig, n in counts.items():
            for t in range(n):
                tint = parse_segment_tsv(
                    os.path.join(seg_dir, contig, f"segment_{contig}_{t}.tsv"))
                cluster_tint(tint, ClusterConfig(), device=device, instance_hook=hook)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shifts", nargs="?", type=int, default=5, help="seed shifts to run")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--deadline-s", type=float, default=30.0)
    ap.add_argument("--node-cap", type=int, default=2_000_000)
    args = ap.parse_args(argv)
    stats: dict = {}
    for shift in range(args.shifts):
        for name in PARITY_CORPORA:
            audit_config(name, shift, stats, args.device, args.deadline_s, args.node_cap)
            counts = {k: v for k, v in stats.items() if k != "sizes"}
            print(f"[{name} shift={shift}] cumulative: {sum(counts.values())} instances, "
                  f"{counts}", flush=True)
    sizes = stats.pop("sizes", [])
    total = sum(stats.values())
    if sizes:
        ns, ms = np.array(sizes).T
        print(f"instance sizes: N median={np.median(ns):.0f} max={ns.max()}, "
              f"Mi median={np.median(ms):.0f} max={ms.max()}")
    nonu = stats.get("nonunique", 0)
    print(f"TOTAL {total} instances: {stats} -> nonunique rate {nonu / max(total, 1):.3%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
