"""Command-line interface of the port.

The JAX package's parser and subcommands, with ``--device {cuda,cpu}``
(default ``cuda``) on ``segment``, ``cluster`` and ``pipeline``, which run
on this package; every other subcommand runs ``freddie_tpu`` as it is:

    python -m freddie_tpu_torch.cli pipeline -b BAM -r READS... -o DIR [--device cuda]
    python -m freddie_tpu_torch.cli segment  -s SPLIT_DIR -o DIR [--device cuda]
    python -m freddie_tpu_torch.cli cluster  -s SEGMENT_DIR -o DIR [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

from freddie_tpu import cli as jax_cli
from freddie_tpu.config import ClusterConfig, PipelineConfig, SegmentConfig

PORTED = ("segment", "cluster", "pipeline")


def build_parser() -> argparse.ArgumentParser:
    p = jax_cli.build_parser()
    p.prog = "freddie-tpu-torch"
    sub = next(a for a in p._actions if isinstance(a, argparse._SubParsersAction))
    for name in PORTED:
        sub.choices[name].add_argument(
            "--device", choices=["cuda", "cpu"], default="cuda",
            help="where the segmentation DP and the cluster solver's "
                 "bounds run (cuda: the card; cpu: the plain PyTorch "
                 "versions on the host)",
        )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command not in PORTED:
        return jax_cli.main(argv)
    if args.command == "segment":
        from .stages.segment import run_segment

        cfg = SegmentConfig(
            consider_ends=args.consider_ends,
            sigma=args.sigma,
            threshold_rate=args.threshold_rate,
            variance_factor=args.variance_factor,
            max_problem_size=args.max_problem_size,
            min_read_support_outside=args.min_read_support_outside,
            threads=args.threads,
            use_device=not args.no_device,
        )
        n = run_segment(args.split_dir.rstrip("/"), args.outdir.rstrip("/"), cfg,
                        device=args.device)
        print(f"[segment] {n} tints")
    elif args.command == "cluster":
        from .stages.cluster import run_cluster

        cfg = ClusterConfig(
            recycle_model=args.recycle_model,
            gap_offset=args.gap_offset,
            epsilon=args.epsilon,
            max_rounds=args.max_rounds,
            min_isoform_size=args.min_isoform_size,
            max_ilp=args.max_ilp,
            timeout=args.timeout,
            threads=args.threads,
            logs_dir=args.logs_dir,
        )
        n = run_cluster(args.segment_dir.rstrip("/"), args.outdir.rstrip("/"), cfg,
                        device=args.device)
        print(f"[cluster] {n} tints")
    else:
        from .stages.pipeline import run_pipeline

        cfg = PipelineConfig.from_yaml(args.config) if args.config else PipelineConfig()
        run_pipeline(args.bam, args.reads, args.outdir, cfg,
                     resume=args.resume, protect=args.protect, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
