"""Wall-time breakdown of the cluster stage, component by component.

    python -m freddie_tpu_torch.tools.profile_cluster --segment-dir DIR
        [--device cuda|cpu] [--timeout-min M] [--limit N]

Wraps timers around the stage's components (TSV parse, preprocessing,
partitioning, instance build, and each solver rung) and runs the
single-thread Python path (``cluster_tint``) over an existing segment
directory. Prints a table per component, the distribution of
per-instance solve times and the statuses. ``--limit`` takes only the
first N tints.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter, defaultdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segment-dir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--timeout-min", type=float, default=1.0)
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args(argv)

    from ..config import ClusterConfig
    from ..device import resolve_device
    from ..solver import segenum as se
    from ..solver import two_phase as tp
    from ..stages import cluster as cl

    dev = resolve_device(args.device)
    acc, cnt, solves = defaultdict(float), Counter(), []

    def timed(name, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            acc[name] += time.perf_counter() - t0
            cnt[name] += 1
            return out
        return wrap

    # (module, attribute, label): names the stage and the rung chain look
    # up in their own module at call time.
    patches = [
        (cl, "parse_segment_tsv", "parse"), (cl, "preprocess", "preprocess"),
        (cl, "partition_reads", "partition"), (cl, "build_instance", "build_instance"),
        (tp, "solve_round_native", "solve.round_native"), (tp, "_solve_raw", "solve.dfs"),
        (se, "solve_segment_enum_closure", "solve.closure"),
        (tp, "solve_segment_enum", "solve.segenum"),
        (se, "solve_segment_enum_wide", "solve.wide"), (tp, "lp_lower_bound", "solve.lp"),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _label in patches]
    orig_solve = cl.solve_two_phase

    def solve(inst, deadline_s, device="cuda"):
        t0 = time.perf_counter()
        res = orig_solve(inst, deadline_s, device)
        solves.append((time.perf_counter() - t0, res.status, len(inst.rows),
                       len(inst.seg_len), len(inst.incomp)))
        return res

    jobs = []
    for contig in sorted(os.listdir(args.segment_dir)):
        cdir = os.path.join(args.segment_dir, contig)
        if os.path.isdir(cdir):
            jobs += [os.path.join(cdir, fn) for fn in sorted(os.listdir(cdir))
                     if fn.startswith("segment_") and fn.endswith(".tsv")]
    if args.limit:
        jobs = jobs[: args.limit]
    cfg = ClusterConfig(timeout=args.timeout_min, threads=1)
    try:
        for mod, attr, label in patches:
            setattr(mod, attr, timed(label, getattr(mod, attr)))
        cl.solve_two_phase = solve
        t0 = time.perf_counter()
        for path in jobs:
            tint = cl.parse_segment_tsv(path)
            t1 = time.perf_counter()
            cl.cluster_tint(tint, cfg, device=dev)
            acc["cluster_tint.total"] += time.perf_counter() - t1
        wall = time.perf_counter() - t0
    finally:
        cl.solve_two_phase = orig_solve
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)

    print(f"\n=== cluster profile: {len(jobs)} tints on {dev}, wall {wall:.1f}s ===")
    for name in sorted(acc, key=lambda n: -acc[n]):
        print(f"  {name:24s} {acc[name]:8.2f}s  x{cnt[name]}")
    solve_total = sum(s[0] for s in solves)
    print(f"\n  instances: {len(solves)}, solve total {solve_total:.1f}s")
    print(f"  statuses: {dict(Counter(s[1] for s in solves))}")
    solves.sort(reverse=True)
    print(f"  top-100 share: {sum(s[0] for s in solves[:100]) / max(solve_total, 1e-9):.2f}")
    print("  top-20 (dt, status, N, Mi, n_incomp):")
    for s in solves[:20]:
        print(f"    {s[0]:7.2f}s {s[1]:8s} N={s[2]:4d} Mi={s[3]:3d} inc={s[4]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
