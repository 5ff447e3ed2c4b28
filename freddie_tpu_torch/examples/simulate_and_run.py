"""Worked example: simulate Nanopore-style reads and run the full pipeline.

    python -m freddie_tpu_torch.examples.simulate_and_run OUT_DIR [--device cuda|cpu]

Writes OUT_DIR/{reads.bam,reads.fastq,annotation.gtf} and the pipeline's
outputs under OUT_DIR/run/ (per-stage TSV directories and isoforms.gtf),
then prints a truth-against-output summary. With real data, skip the
simulation and give the CLI a sorted BAM and its FASTQ:

    python -m freddie_tpu_torch.cli pipeline -b reads.sorted.bam -r reads.fastq -o out/
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config import PipelineConfig
from ..stages.pipeline import run_pipeline
from ..utils.sim import simulate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default="example_out")
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    sim = simulate(seed=7, n_genes=5, isoforms_per_gene=3, reads_per_isoform=20,
                   minus_strand_genes=True, alt_splice=True, truncate_prob=0.15)
    bam = os.path.join(args.outdir, "reads.bam")
    fastq = os.path.join(args.outdir, "reads.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fastq)
    sim.write_annotation_gtf(os.path.join(args.outdir, "annotation.gtf"))
    print(f"simulated {len(sim.reads)} reads / {len(sim.transcripts)} transcripts")

    stats = run_pipeline(bam, [fastq], os.path.join(args.outdir, "run"), PipelineConfig(),
                         device=args.device)
    want = {tuple(tr.exons) for tr in sim.transcripts}
    got, cur, found = set(), [], 0
    with open(stats["gtf"]) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if fields[2] == "transcript":
                found += 1
                if cur:
                    got.add(tuple(cur))
                cur = []
            elif fields[2] == "exon":
                cur.append((int(fields[3]), int(fields[4])))
    if cur:
        got.add(tuple(cur))
    print(f"reported {found} transcripts; {len(want & got)}/{len(want)} "
          f"simulated structures recovered exactly")
    print(f"GTF: {stats['gtf']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
