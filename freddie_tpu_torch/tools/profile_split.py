"""Profile the split stage on a large simulated dataset.

    python -m freddie_tpu_torch.tools.profile_split [N_GENES] [READS_PER_ISOFORM]

Prints the stage's wall time and reads/s and a cProfile top-30 by
cumulative time. The split stage is host code: it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import shutil
import sys
import tempfile
import time

from ..config import SplitConfig
from ..stages.split import run_split
from ..utils.sim import BENCH_CORPUS, simulate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_genes", nargs="?", type=int, default=400)
    ap.add_argument("reads_per_isoform", nargs="?", type=int, default=250)
    args = ap.parse_args(argv)
    workdir = tempfile.mkdtemp(prefix="freddie_torch_prof_split_")
    try:
        t0 = time.perf_counter()
        sim = simulate(**dict(BENCH_CORPUS, seed=4242, n_genes=args.n_genes,
                              reads_per_isoform=args.reads_per_isoform))
        bam, fq = os.path.join(workdir, "prof.bam"), os.path.join(workdir, "prof.fastq")
        sim.write_bam(bam)
        sim.write_fastq(fq)
        n_reads = len(sim.reads)
        print(f"[sim] {n_reads} reads in {time.perf_counter() - t0:.1f}s")
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        counts = run_split(bam, [fq], os.path.join(workdir, "split"), SplitConfig(threads=1))
        prof.disable()
        dt = time.perf_counter() - t0
        print(f"[split] {sum(counts.values())} tints, {dt:.2f}s, {n_reads / dt:.0f} reads/s")
        pstats.Stats(prof).sort_stats("cumulative").print_stats(30)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
