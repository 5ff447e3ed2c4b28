"""Multi-sample workflow runner on PyTorch (the reference's Snakemake).

Port of ``freddie_tpu/stages/workflow.py:run_workflow``: the same config
schema, per-stage ``PipelineConfig`` construction, alignment step and
resume semantics, with each sample run through this package's
``run_pipeline`` on ``device``. The config loader and the dotted-path
overrides are that module's code as it is (its header has the schema).
"""

from __future__ import annotations

import os
from typing import Any

from ..config import PipelineConfig
from .pipeline import run_pipeline


def apply_overrides(raw: dict, overrides: dict[str, Any]) -> dict:
    """Apply {'a.b.c': value} overrides into a nested dict; every path must
    already exist (matching the reference's assert at Snakefile:8)."""
    for path, value in overrides.items():
        keys = path.split(".")
        node = raw
        for i, k in enumerate(keys[:-1]):
            # Intermediate sections may be legitimately absent (e.g. an
            # unset `stages.segment`); create them so any stage parameter
            # can be overridden from the command line.
            if k not in node or node[k] is None:
                node[k] = {}
            node = node[k]
        node[keys[-1]] = value
    return raw


def load_workflow_config(path: str, overrides: dict[str, Any] | None = None) -> dict:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    if overrides:
        apply_overrides(raw, overrides)
    return raw


def run_workflow(config: dict, resume: bool = True, log=print, device="cuda") -> dict:
    """Run every sample of ``config`` (the schema of
    ``freddie_tpu.stages.workflow``) into ``outpath/results/<sample>``;
    returns per-sample pipeline stats. ``device`` ('cuda' or 'cpu') is
    where each sample's segment DP and cluster bounds run."""
    outpath = config["outpath"].rstrip("/")
    stage_cfg = config.get("stages", {}) or {}
    defaults = PipelineConfig()
    pcfg = PipelineConfig(**{
        name: getattr(defaults, name).__class__(**(stage_cfg.get(name, {}) or {}))
        for name in ("split", "segment", "cluster", "isoforms")
    })
    results = {}
    for sample, spec in config["samples"].items():
        sample_out = os.path.join(outpath, "results", sample)
        log(f"[workflow] sample {sample} -> {sample_out}")
        bam = spec.get("bam")
        if bam is None:
            # The reference's minimap2 rule: `genome` + `reads` in place
            # of a pre-aligned `bam`; skipped on resume once the BAM exists.
            from ..io.align import align_reads

            genome = spec.get("genome")
            if not genome:
                raise ValueError(f"sample {sample}: provide either 'bam' or 'genome'")
            bam = os.path.join(sample_out, f"{sample}.sorted.bam")
            if not (resume and os.path.exists(bam)):
                os.makedirs(sample_out, exist_ok=True)
                n = align_reads(genome, list(spec["reads"]), bam,
                                threads=int(spec.get("threads", 4)))
                log(f"[workflow] aligned {sample}: {n} records -> {bam}")
        results[sample] = run_pipeline(bam, list(spec["reads"]), sample_out, pcfg,
                                       resume=resume, log=log, device=device)
    return results
