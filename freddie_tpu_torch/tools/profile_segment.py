"""cProfile the segment stage on the benchmark corpus.

    python -m freddie_tpu_torch.tools.profile_segment [--device cuda|cpu] [--small]
                                                      [--sort cumtime] [--lines N]

Builds the benchmark corpus (``bench.common.build_dataset``), runs split,
a warm segment run (kernel build, native libraries), then profiles
``run_segment`` to show where the host time of phases A and C goes.
cProfile adds cost to every Python call and none to native code or to the
card, so read proportions from it and times from
``python -m freddie_tpu_torch.bench.segment``.
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

from ..bench.common import SMALL_CORPUS, build_dataset
from ..config import SegmentConfig, SplitConfig
from ..device import resolve_device
from ..stages.segment import run_segment
from ..stages.split import run_split
from ..utils.sim import BENCH_CORPUS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--small", action="store_true", help="the 6-gene corpus")
    ap.add_argument("--sort", default="cumtime")
    ap.add_argument("--lines", type=int, default=45)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    workdir = tempfile.mkdtemp(prefix="freddie_torch_prof_")
    try:
        bam, fq, n_reads, _truth, _reach = build_dataset(
            workdir, SMALL_CORPUS if args.small else BENCH_CORPUS)
        split_dir = os.path.join(workdir, "split")
        t0 = time.perf_counter()
        counts = run_split(bam, [fq], split_dir, SplitConfig(threads=2))
        print(f"[prof] {n_reads} reads / {sum(counts.values())} tints; split "
              f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
        cfg = SegmentConfig(threads=4)
        t0 = time.perf_counter()
        run_segment(split_dir, os.path.join(workdir, "seg_warm"), cfg, device=dev)
        print(f"[prof] warm run {time.perf_counter() - t0:.2f}s", file=sys.stderr)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        run_segment(split_dir, os.path.join(workdir, "seg_prof"), cfg, device=dev)
        prof.disable()
        dt = time.perf_counter() - t0
        print(f"[prof] profiled run {dt:.2f}s ({n_reads / dt:.0f} reads/s) on {dev}",
              file=sys.stderr)
        pstats.Stats(prof, stream=sys.stdout).sort_stats(args.sort).print_stats(args.lines)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
