"""Stage 2 -- segment, on PyTorch: the streaming segment stage.

Port of ``freddie_tpu/stages/segment.py:run_segment``. Phases A and C
(parse, splice signal, coverage, float surface, genotyping, per-read
polyA/gap annotation, TSV formatting) are the JAX package's host code,
imported unchanged; phase B, the batched breakpoint DP, goes to this
package's dispatch (``ops.segdp``), which runs the CUDA kernel for a CUDA
device (split over the visible cards for the bare "cuda" once a batch
passes ``parallel.mesh.MESH_MIN_WORK``, by default never) and the plain
PyTorch twin for the CPU.

The routing constants are the JAX stage's own objects (tuned there; see
its comments), so both stages bucket, chunk, gate and window the same
corpus identically. Outputs are byte-identical to ``freddie_tpu``'s
``run_segment`` and to the host oracle route (``use_device=False``).

Tints that take the Python phase A path (the native engine off or
refusing a tint) may have their polyA soft-clip scans batched across the
whole corpus into phase C2 (``ops.polya_batch``), decided as the JAX
stage decides once phase A's read total is known: from
``POLYA_DEVICE_MIN_READS`` reads, on a CUDA device, unless the C Kadane
scorer is built; FREDDIE_POLYA_DEVICE=1 forces it (on the CPU it then
runs the torch scan). Native tints annotate inside the C finalizer. Every
route writes the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

from freddie_tpu.config import SegmentConfig
from freddie_tpu.io.tsv import format_segment_tsv, load_read_sequences, parse_split_tsv
from freddie_tpu.ops.polya import annotate_gaps_and_polya
from freddie_tpu.ops.segdp import DPProblem, bucket_shape, solve_host, suggested_batch_size
from freddie_tpu.ops.thresholds import ScaledThresholds
from freddie_tpu.stages import segment as jax_segment
from freddie_tpu.stages.segment import (  # noqa: F401  (the JAX stage's gates)
    AUTO_WINDOW,
    AUTO_WINDOW_MIN_TINTS,
    DEVICE_COVERAGE_MIN_TINTS,
    DEVICE_MIN_WORK,
    MAX_INFLIGHT_CHUNKS,
    READBACK_THREAD,
    STREAM_CHUNK_MAX,
    NativeTintWork,
    TintWork,
    finalize_tint,
    finalize_tint_native,
    genotype_tint,
    prepare_tint,
    prepare_tint_native,
)
from freddie_tpu.utils.fsio import atomic_write

from ..device import resolve_device
from ..ops.polya_batch import annotate_gaps_and_polya_batch
from ..ops.segdp import collect_batch_device, dispatch_batch_device
from ..utils.metrics import profile_trace


def run_segment(split_dir: str, outdir: str, cfg: SegmentConfig | None = None,
                owns=None, device="cuda") -> int:
    """Full segment stage over a split directory; returns #tints processed.

    Same schedule as the JAX stage: phase A streams tints serially and
    dispatches each (P, R) bucket's chunk the moment it fills (async, on
    the device's current stream); a readback thread waits on each chunk's
    event so readback overlaps the rest of phase A; tints are genotyped
    and written in order as soon as all their problems are solved.
    ``owns(contig, tint_id) -> bool`` restricts the stage to one locus
    shard. ``device`` ('cuda', 'cuda:N' or 'cpu') is resolved up front
    when ``cfg.use_device``; a missing GPU raises. The bare 'cuda' splits
    a DP batch over every visible card from ``parallel.mesh.MESH_MIN_WORK``
    (by default never)."""
    cfg = cfg or SegmentConfig()
    dev = resolve_device(device) if cfg.use_device else None
    os.makedirs(outdir, exist_ok=True)
    thr = ScaledThresholds(cfg.threshold_rate)
    jobs: list[tuple[str, int, str, str]] = []
    for contig in sorted(os.listdir(split_dir)):
        cdir = os.path.join(split_dir, contig)
        if not os.path.isdir(cdir):
            continue
        os.makedirs(os.path.join(outdir, contig), exist_ok=True)
        for fn in sorted(os.listdir(cdir)):
            if fn.startswith("split_") and fn.endswith(".tsv"):
                tint_id = int(fn[:-4].split("_")[-1])
                if owns is not None and not owns(contig, tint_id):
                    continue
                jobs.append((
                    contig,
                    tint_id,
                    os.path.join(cdir, fn),
                    os.path.join(cdir, f"reads_{contig}_{tint_id}.tsv"),
                ))

    from freddie_tpu.ops.segcore import load_segcore

    eng = None if os.environ.get("FREDDIE_SEGCORE") == "0" else load_segcore()

    def prepare_one(job):
        _contig, _tint_id, split_tsv, reads_tsv = job
        if eng is not None:
            try:
                return prepare_tint_native(split_tsv, reads_tsv, cfg, thr, eng)
            except Exception:
                pass  # the Python oracle path handles what the engine rejects
        tint = parse_split_tsv(split_tsv)
        load_read_sequences(tint, reads_tsv)
        return prepare_tint(tint, cfg, thr)

    works: list = []
    all_problems: list[DPProblem | None] = []
    offsets: list[int] = []
    solutions: list[list[int] | None] = []
    buckets: dict[tuple[int, int], list[int]] = {}
    pending: list = []  # (chunk_ids, handles, work, res, fut) in dispatch order
    readback = None
    if READBACK_THREAD and os.environ.get("FREDDIE_READBACK_THREAD") != "0":
        from concurrent.futures import ThreadPoolExecutor

        readback = ThreadPoolExecutor(1, thread_name_prefix="freddie-readback")
    total_work = 0  # cumulative DP cost seen so far (device-worth gate)
    device_on = False
    unsolved: list[int] = []  # per tint: problems awaiting solutions
    tint_of: list[int] = []  # per problem
    # Per finalized tint, in order: None once written, else the (final
    # positions, segs) of a Python-path tint whose polyA scans wait for
    # the batched phase C2.
    finals: list = []
    # The batched-polyA route needs phase A's read total; until it is
    # decided (None), Python-path tints hold the in-order drain.
    batch_polya = None
    full_chunks: set = set()  # buckets that dispatched a full chunk

    def chunk_size(P, R):
        bs = min(suggested_batch_size(P, R), STREAM_CHUNK_MAX)
        p2 = 8
        while p2 * 2 <= bs:
            p2 *= 2
        return p2

    def finish_tint(t):
        """Finalize tint t and write it, or return its (final positions,
        segs) when its polyA scans go to phase C2."""
        contig, tint_id, split_tsv, reads_tsv = jobs[t]
        work, off = works[t], offsets[t]
        n = sum(len(iw.problems) for iw in work.intervals)
        sols = solutions[off : off + n]
        k = 0
        for iw in work.intervals:  # re-map local problem ids
            iw.problems = list(range(k, k + len(iw.problems)))
            k += len(iw.problems)
        out_path = os.path.join(outdir, contig, f"segment_{contig}_{tint_id}.tsv")
        if isinstance(work, NativeTintWork):
            try:
                out = finalize_tint_native(work, sols, cfg, thr, eng)
            except Exception:
                # C-side invariant trip: redo this tint on the Python
                # oracle path (phase A is deterministic, so the solutions
                # line up 1:1).
                tint = parse_split_tsv(split_tsv)
                load_read_sequences(tint, reads_tsv)
                pwork, _probs = prepare_tint(tint, cfg, thr)
                out = format_segment_tsv(tint, finalize_tint(pwork, sols, cfg, thr)).encode()
            with atomic_write(out_path, "wb") as f:
                f.write(out)
            works[t] = None  # free the tint (and its C-side capsule) eagerly
            return None
        final_positions, segs = genotype_tint(work, sols, cfg, thr)
        if batch_polya:
            return final_positions, segs
        for read in work.tint.reads:
            read.gaps = annotate_gaps_and_polya(
                read.data, segs, read.intervals, read.seq, read.strand
            )
        with atomic_write(out_path) as f:
            f.write(format_segment_tsv(work.tint, final_positions))
        works[t] = None
        return None

    def drain_ready(allow_python):
        while len(finals) < len(works) and unsolved[len(finals)] == 0:
            t = len(finals)
            if not (allow_python or isinstance(works[t], NativeTintWork)):
                break
            finals.append(finish_tint(t))

    def take(entry):
        chunk, handles, wk, res, fut = entry
        if fut is not None:
            handles = fut.result()
        for gid, sol in zip(chunk, collect_batch_device(handles, wk, res)):
            solutions[gid] = sol
            unsolved[tint_of[gid]] -= 1

    n_collected = 0  # prefix of `pending` already read back inline

    def dispatch_chunks(key, force=False, allow_python=False):
        nonlocal n_collected
        idxs = buckets.get(key, [])
        P, R = key
        bs = chunk_size(P, R)
        while len(idxs) >= bs or (force and idxs):
            chunk, idxs = idxs[:bs], idxs[bs:]
            buckets[key] = idxs
            if len(chunk) == bs:
                full_chunks.add(key)
            # A bucket's final partial chunk pads up to its full chunk
            # shape (padding rows replicate problem 0, outputs unused).
            pad_b = bs if (key in full_chunks and len(chunk) < bs) else 0
            handles, wk, res = dispatch_batch_device(
                [all_problems[i] for i in chunk], thr, pad_p_to=P,
                pad_r_to=R, pad_b_to=pad_b,
                dev_cov=len(jobs) >= DEVICE_COVERAGE_MIN_TINTS, device=device,
            )
            for i in chunk:  # dispatched exactly once: free the C/iv copies
                all_problems[i] = None
            fut = None
            if readback is not None and handles is not None:
                fut = readback.submit(np.asarray, handles)
            pending.append((chunk, handles, wk, res, fut))
            # Bound device memory: read the OLDEST chunk back inline once
            # MAX_INFLIGHT_CHUNKS are pending. A distinct None sentinel
            # (not handles=None, which also marks the int32-overflow host
            # fallback) tells the final loop it was already collected.
            while len(pending) - n_collected > MAX_INFLIGHT_CHUNKS:
                take(pending[n_collected])
                pending[n_collected] = None
                n_collected += 1
                drain_ready(allow_python)

    stream_window = int(
        os.environ.get("FREDDIE_SEGMENT_WINDOW", cfg.stream_window) or 0
    )
    if not stream_window and len(jobs) >= AUTO_WINDOW_MIN_TINTS:
        stream_window = AUTO_WINDOW

    try:
        with profile_trace(os.environ.get("FREDDIE_TRACE_DIR")):
            for job in jobs:
                work, problems = prepare_one(job)
                off = len(all_problems)
                offsets.append(off)
                works.append(work)
                all_problems.extend(problems)
                solutions.extend([None] * len(problems))
                tint_of.extend([len(works) - 1] * len(problems))
                n_unsolved = 0
                for gid in range(off, off + len(problems)):
                    p = all_problems[gid]
                    if len(p.y) <= 2:
                        solutions[gid] = []
                        continue
                    n_unsolved += 1
                    total_work += len(p.y) ** 3 * p.C.shape[1]
                    buckets.setdefault(bucket_shape(len(p.y), p.C.shape[1]), []).append(gid)
                unsolved.append(n_unsolved)
                if not device_on and cfg.use_device and total_work >= DEVICE_MIN_WORK:
                    device_on = True
                if device_on:
                    force = bool(stream_window and len(works) % stream_window == 0)
                    for key in list(buckets):
                        dispatch_chunks(key, force=force)
                drain_ready(False)

            # Phase A totals known: fix the batched-polyA route as the JAX
            # stage does (its gate read here, at call time, so patching
            # it there forces both stages). The C Kadane scorer, when
            # built, beats the batch even on a card; a CPU device keeps
            # the host scorer. FREDDIE_POLYA_DEVICE=1 forces the batch.
            total_reads = sum(len(w.tint.reads) for w in works if isinstance(w, TintWork))
            batch_polya = (cfg.use_device
                           and total_reads >= jax_segment.POLYA_DEVICE_MIN_READS)
            if batch_polya and not os.environ.get("FREDDIE_POLYA_DEVICE"):
                from freddie_tpu.ops.polya import _load_ctok

                ctok = _load_ctok()
                batch_polya = not (ctok is not None and hasattr(ctok, "best_run")) and (
                    dev.type == "cuda"
                )

            if device_on:
                for key in sorted(buckets):
                    dispatch_chunks(key, force=True, allow_python=True)
            else:
                # Tiny total workload (or use_device=False): the host
                # oracle; same results either way.
                for gid, sol in enumerate(solutions):
                    if sol is None:
                        solutions[gid] = solve_host(all_problems[gid], thr)
                        unsolved[tint_of[gid]] -= 1

            drain_ready(True)
            for entry in pending:
                if entry is None:
                    continue  # read back inline under MAX_INFLIGHT_CHUNKS
                take(entry)
                drain_ready(True)
            if len(finals) != len(works):
                raise RuntimeError(
                    f"segment: {len(works) - len(finals)} tints left unsolved"
                )

            # Phase C2: every deferred read's polyA scans across ALL tints
            # in one batched pass on the device; C3 writes those tints.
            held = [t for t, fin in enumerate(finals) if fin is not None]
            if held:
                reads = [read for t in held for read in works[t].tint.reads]
                items = [(read.data, finals[t][1], read.intervals, read.seq, read.strand)
                         for t in held for read in works[t].tint.reads]
                for read, toks in zip(reads, annotate_gaps_and_polya_batch(items, dev)):
                    read.gaps = toks
            for t in held:
                contig, tint_id = jobs[t][0], jobs[t][1]
                out_path = os.path.join(outdir, contig, f"segment_{contig}_{tint_id}.tsv")
                with atomic_write(out_path) as f:
                    f.write(format_segment_tsv(works[t].tint, finals[t][0]))
                works[t] = None
    finally:
        if readback is not None:
            readback.shutdown(wait=True)
    return len(jobs)
