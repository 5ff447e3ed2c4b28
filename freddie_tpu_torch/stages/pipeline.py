"""The end-to-end pipeline on PyTorch: split -> segment -> cluster -> isoforms.

Port of ``freddie_tpu/stages/pipeline.py`` with the same stage, resume
and protect semantics (the reference Snakefile's checkpoints). Split and
isoforms are host stages; the segment stage's DP and the cluster
solver's bounds run on ``device``.
"""

from __future__ import annotations

import os
import shutil

from ..config import PipelineConfig
from ..ops import segdp_cuda
from ..utils.fsio import is_complete, mark_complete, protect_outputs, set_writable
from ..utils.metrics import StageMetrics
from .cluster import run_cluster
from .isoforms import run_isoforms
from .segment import run_segment
from .split import run_split


def _remove(path: str) -> None:
    set_writable(path)
    if os.path.isdir(path):
        shutil.rmtree(path)
    else:
        os.remove(path)


def run_pipeline(
    bam: str,
    reads: list[str],
    outdir: str,
    cfg: PipelineConfig | None = None,
    resume: bool = False,
    protect: bool = False,
    log=print,
    device="cuda",
) -> dict:
    """Run the four stages into ``outdir``; returns per-stage stats and
    the GTF path under ``"gtf"``.

    resume=True skips stages whose outputs are complete and re-runs the
    incremental ones (segment, cluster) in place over a crashed run's
    partial output; protect=True makes each completed stage's outputs
    read-only. ``device`` ('cuda' or 'cpu') is where the segment DP
    and the cluster solver's device bounds run."""
    cfg = cfg or PipelineConfig()
    os.makedirs(outdir, exist_ok=True)
    split_dir = os.path.join(outdir, "split")
    segment_dir = os.path.join(outdir, "segment")
    cluster_dir = os.path.join(outdir, "cluster")
    gtf_path = os.path.join(outdir, "isoforms.gtf")
    stats: dict = {}

    def stage(name, out_path, fn, incremental=False):
        if os.path.exists(out_path):
            if resume and is_complete(out_path):
                log(f"[pipeline] {name}: complete, skipping")
                return None
            if resume and incremental:
                log(f"[pipeline] {name}: incomplete output, resuming in place")
                set_writable(out_path)
            else:
                if resume:
                    log(f"[pipeline] {name}: incomplete output, re-running")
                _remove(out_path)
        metrics = StageMetrics(name)
        wide = (segdp_cuda.WIDE_HOST_BATCHES, segdp_cuda.WIDE_HOST_PROBLEMS)
        for attempt in range(cfg.retries + 1):
            try:
                result = fn()
                break
            except Exception:
                if attempt == cfg.retries:
                    raise
                log(f"[pipeline] {name}: attempt {attempt + 1} failed; retrying")
                if not incremental and os.path.exists(out_path):
                    _remove(out_path)
        mark_complete(out_path)
        if protect:
            protect_outputs(out_path)
        if isinstance(result, dict):
            metrics.add("tints", sum(result.values()))
        elif isinstance(result, int):
            metrics.add("tints", result)
        # DP batches the dispatch solved on the host because their bucket
        # is wider than the card's kernel holds.
        if segdp_cuda.WIDE_HOST_BATCHES > wide[0]:
            metrics.add("wide_host_batches", segdp_cuda.WIDE_HOST_BATCHES - wide[0])
            metrics.add("wide_host_problems", segdp_cuda.WIDE_HOST_PROBLEMS - wide[1])
        stats[name] = dict(**metrics.finish(), result=result)
        log(f"[pipeline] {name}: done in {stats[name]['seconds']:.2f}s ({result})")
        return result

    stage("split", split_dir, lambda: run_split(bam, reads, split_dir, cfg.split))
    stage("segment", segment_dir,
          lambda: run_segment(split_dir, segment_dir, cfg.segment, device=device),
          incremental=True)
    stage("cluster", cluster_dir,
          lambda: run_cluster(segment_dir, cluster_dir, cfg.cluster, device=device),
          incremental=True)
    stage("isoforms", gtf_path,
          lambda: run_isoforms(split_dir, cluster_dir, gtf_path, cfg.isoforms))
    stats["gtf"] = gtf_path
    return stats
