"""Capture the cluster stage's hardest solver instances as a pickle corpus.

    python -m freddie_tpu_torch.tools.capture_hard_instances --workdir DIR
        [--device cuda|cpu] [--slow-s S] [--timeout-min M] [--genes N] [--small]

Builds the benchmark corpus, runs split and segment, then clusters every
tint with the production solver while recording each ``ClusterInstance``
whose solve takes more than ``--slow-s`` seconds or does not end OPTIMAL.
The corpus feeds ``freddie_tpu_torch.tools.solver_experiment``, so a bound
or a prune can be judged without running the pipeline again. ``--genes``
overrides the corpus's gene count (1000 gives the ~300k-read scale where
the dense instances live).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--slow-s", type=float, default=1.0)
    ap.add_argument("--timeout-min", type=float, default=0.25)
    ap.add_argument("--genes", type=int, default=0)
    ap.add_argument("--small", action="store_true", help="the 6-gene corpus")
    args = ap.parse_args(argv)

    from ..bench.common import SMALL_CORPUS, build_dataset
    from ..config import ClusterConfig, SegmentConfig, SplitConfig
    from ..device import resolve_device
    from ..io.tsv import parse_segment_tsv
    from ..stages import cluster as cl
    from ..stages.segment import run_segment
    from ..stages.split import run_split
    from ..utils.sim import BENCH_CORPUS

    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    split_dir = os.path.join(args.workdir, "split")
    seg_dir = os.path.join(args.workdir, "segment")
    if not os.path.isdir(seg_dir):
        corpus = dict(SMALL_CORPUS if args.small else BENCH_CORPUS)
        if args.genes:
            corpus["n_genes"] = args.genes
        bam, fq, n_reads, _truth, _reach = build_dataset(args.workdir, corpus)
        print(f"[capture] {n_reads} reads simulated")
        run_split(bam, [fq], split_dir, SplitConfig(threads=2))
        run_segment(split_dir, seg_dir, SegmentConfig(threads=4), device=dev)
        print("[capture] split+segment done")

    corpus, orig_solve = [], cl.solve_two_phase

    def timed_solve(inst, deadline_s, device="cuda"):
        t0 = time.perf_counter()
        res = orig_solve(inst, deadline_s, device)
        dt = time.perf_counter() - t0
        if dt > args.slow_s or res.status != "OPTIMAL":
            corpus.append(dict(inst=inst, dt=dt, status=res.status, objective=res.objective,
                               assigned=res.assigned, n=len(inst.rows), mi=len(inst.seg_len),
                               n_incomp=len(inst.incomp)))
            print(f"[capture] hard: N={len(inst.rows)} Mi={len(inst.seg_len)} "
                  f"incomp={len(inst.incomp)} dt={dt:.2f}s {res.status}")
        return res

    cfg = ClusterConfig(threads=1, timeout=args.timeout_min)
    cl.solve_two_phase = timed_solve
    t0 = time.perf_counter()
    n_tints = 0
    try:
        for contig in sorted(os.listdir(seg_dir)):
            cdir = os.path.join(seg_dir, contig)
            if not os.path.isdir(cdir):
                continue
            for fn in sorted(os.listdir(cdir)):
                if fn.startswith("segment_") and fn.endswith(".tsv"):
                    cl.cluster_tint(parse_segment_tsv(os.path.join(cdir, fn)), cfg, device=dev)
                    n_tints += 1
    finally:
        cl.solve_two_phase = orig_solve
    out = os.path.join(args.workdir, "hard_instances.pkl")
    with open(out, "wb") as f:
        pickle.dump(corpus, f)
    n_to = sum(1 for c in corpus if c["status"] != "OPTIMAL")
    print(f"[capture] {n_tints} tints in {time.perf_counter() - t0:.1f}s; {len(corpus)} hard "
          f"instances ({n_to} non-OPTIMAL) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
