"""Stage 3 -- cluster, with the solver's device bounds on PyTorch.

Port of ``freddie_tpu/stages/cluster.py``'s stage loop (``run_cluster``,
``_cluster_one``, ``cluster_tint``). Preprocessing, partitioning, the
instance build, the consolidated native engine and the TSV codec are the
JAX package's jax-free code, imported unchanged; the per-instance solve
is this package's ``solve_two_phase``, whose wide and closure rungs
evaluate their bounds on ``device`` instead of through ``jax``. Outputs
are byte-identical to ``freddie_tpu``'s ``run_cluster``.

Spawned pool workers evaluate the bounds on the CPU (the JAX package
pins its workers to CPU-XLA the same way), so only the parent process
holds a CUDA context.
"""

from __future__ import annotations

import dataclasses
import json
import os

from freddie_tpu.config import ClusterConfig
from freddie_tpu.io.tsv import SegTint, format_cluster_tsv, parse_segment_tsv
from freddie_tpu.solver.clucore import cluster_tint_native
from freddie_tpu.stages import cluster as _cl
from freddie_tpu.stages.cluster import (
    build_instance,
    informative_segs,
    partition_reads,
    preprocess,
)
from freddie_tpu.utils.fsio import atomic_write
from freddie_tpu.utils.metrics import SolverLog, summarize_solver_logs
from freddie_tpu.utils.procenv import cpu_worker_env

from ..solver.two_phase import solve_two_phase


def cluster_tint(tint: SegTint, cfg: ClusterConfig,
                 device="cuda") -> tuple[list[dict], list[int]]:
    """Full per-tint clustering; returns (isoforms, garbage_rep_ids) and
    fills read.partition / poly_tail_category, as ``freddie_tpu``'s
    ``cluster_tint`` does, with the solver's device bounds on ``device``."""
    import time as _time

    ilp = preprocess(tint, cfg)
    partitions = partition_reads(tint, ilp, cfg.max_ilp)
    M = len(tint.segs)
    isoforms: list[dict] = []
    garbage_rids: list[int] = []
    slog = SolverLog(cfg.logs_dir, tint.id)

    for p_idx, (remaining, incomp) in enumerate(partitions):
        for rep_id in remaining:
            for ridx in tint.read_reps[rep_id]:
                tint.reads[ridx].partition = p_idx
        remaining = list(remaining)
        for _round in range(cfg.max_rounds):
            mult_left = sum(len(tint.read_reps[i]) for i in remaining)
            if mult_left < cfg.min_isoform_size:
                break
            informative = informative_segs(tint, ilp, remaining)
            inst = build_instance(tint, ilp, remaining, incomp, informative, cfg)
            slog.dump_instance(p_idx, _round, inst)
            t0 = _time.perf_counter()
            res = solve_two_phase(inst, cfg.timeout * 60.0, device)
            slog.record(p_idx, _round, len(remaining), res, _time.perf_counter() - t0)
            slog.dump_solution(p_idx, _round, res)
            if res.status != "OPTIMAL":
                break
            assigned_pos = set(res.assigned)
            assigned = [r for p, r in enumerate(remaining) if p in assigned_pos]
            assigned_mult = sum(len(tint.read_reps[i]) for i in assigned)
            if assigned_mult < cfg.min_isoform_size:
                break
            # Isoform exon bitstring: solver E on informative segments; the
            # (constant) read value elsewhere (py/freddie_cluster.py:602-610).
            inf_idx = [j for j in range(M) if informative[j]]
            col_of = {j: c for c, j in enumerate(inf_idx)}
            ref_row = ilp.I[min(remaining)]
            exons = [
                int(res.isoform[col_of[j]]) if informative[j] else int(ref_row[j])
                for j in range(M)
            ]
            rid_to_corrections = {}
            for rep_id in assigned:
                data = tint.reads[tint.read_reps[rep_id][0]].data
                rid_to_corrections[rep_id] = [
                    "-"
                    if not informative[j]
                    else ("X" if ilp.C[rep_id][j] == 1 and exons[j] == 1 else str(data[j]))
                    for j in range(M)
                ]
            isoforms.append(dict(exons=exons, rid_to_corrections=rid_to_corrections))
            assigned_set = set(assigned)
            remaining = [r for r in remaining if r not in assigned_set]
        garbage_rids.extend(sorted(remaining))
    slog.close()
    return isoforms, garbage_rids


def _cluster_one(job: tuple[str, str, str, ClusterConfig, str]) -> int:
    in_path, out_path, contig, cfg, device = job
    # Idempotent per-tint resume: an existing file is a completed shard.
    if os.path.exists(out_path):
        return 1
    if cfg.logs_dir is not None:
        # Solver logs per contig (tint ids repeat across contigs).
        cfg = dataclasses.replace(cfg, logs_dir=os.path.join(cfg.logs_dir, contig))
    else:
        # The consolidated native engine returns None when a round needs
        # a Python rung (the device bounds among them) and raises on an
        # invariant trip; both fall through to the path below with
        # byte-identical output.
        try:
            out = cluster_tint_native(in_path, cfg)
        except Exception:
            out = None
        if out is not None:
            with atomic_write(out_path, "wb") as f:
                f.write(out)
            return 1
    tint = parse_segment_tsv(in_path)
    isoforms, garbage = cluster_tint(tint, cfg, device)
    with atomic_write(out_path) as f:
        f.write(format_cluster_tsv(tint, isoforms, garbage))
    return 1


def run_cluster(segment_dir: str, outdir: str, cfg: ClusterConfig | None = None,
                owns=None, device="cuda") -> int:
    """Full cluster stage over a segment directory; returns #tints.

    ``owns(contig, tint_id) -> bool`` restricts to this process's shard.
    ``device`` ('cuda' or 'cpu') is where the solver's wide and closure
    bounds run in this process; 'cuda' without a GPU raises. Scheduling
    (thread pool, or a spawn process pool above POOL_MIN_BYTES of input)
    is ``freddie_tpu``'s, and POOL_MIN_BYTES is read from there at call
    time."""
    from ..device import resolve_device

    dev = str(resolve_device(device))
    cfg = cfg or ClusterConfig()
    os.makedirs(outdir, exist_ok=True)
    jobs = []
    for contig in sorted(os.listdir(segment_dir)):
        cdir = os.path.join(segment_dir, contig)
        if not os.path.isdir(cdir):
            continue
        out_cdir = os.path.join(outdir, contig)
        os.makedirs(out_cdir, exist_ok=True)
        # Sweep stray .tmp files of a crashed run, in this process's
        # shard only (another host may be mid-write on its own tints).
        for fn in os.listdir(out_cdir):
            if fn.endswith(".tsv.tmp"):
                try:
                    tid = int(fn[: -len(".tsv.tmp")].split("_")[-1])
                except ValueError:
                    continue
                if owns is None or owns(contig, tid):
                    os.remove(os.path.join(out_cdir, fn))
        for fn in sorted(os.listdir(cdir)):
            if not (fn.startswith("segment_") and fn.endswith(".tsv")):
                continue
            tint_id = int(fn[:-4].split("_")[-1])
            if owns is not None and not owns(contig, tint_id):
                continue
            jobs.append((
                os.path.join(cdir, fn),
                os.path.join(out_cdir, f"cluster_{contig}_{tint_id}.tsv"),
                contig,
                cfg,
                dev,
            ))
    total_bytes = sum(os.path.getsize(j[0]) for j in jobs)
    pooled = False
    if cfg.threads > 1 and len(jobs) > 1 and total_bytes > _cl.POOL_MIN_BYTES:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        from concurrent.futures.process import BrokenProcessPool

        # Biggest inputs first; workers bound on the CPU. Spawn workers
        # re-import __main__: a calling script must guard its top level.
        order = sorted(range(len(jobs)), key=lambda k: -os.path.getsize(jobs[k][0]))
        try:
            with cpu_worker_env(), ProcessPoolExecutor(
                max_workers=cfg.threads,
                mp_context=multiprocessing.get_context("spawn"),
            ) as ex:
                n = sum(ex.map(_cluster_one, [jobs[k][:4] + ("cpu",) for k in order],
                               chunksize=4))
            pooled = True
        except BrokenProcessPool:
            pass
    if not pooled:
        if cfg.threads > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
                n = sum(ex.map(_cluster_one, jobs))
        else:
            n = sum(_cluster_one(j) for j in jobs)
    if cfg.logs_dir is not None:
        with open(os.path.join(cfg.logs_dir, "solver_summary.json"), "w") as f:
            json.dump(summarize_solver_logs(cfg.logs_dir), f, indent=1)
    return n
