"""Stage 4 -- isoforms: per-cluster consensus + boundary correction -> GTF.

Reproduces the reference (py/freddie_isoforms.py) exactly, including its
quirks that shape the output byte-for-byte:

- consensus spans: a read's vote window is [first '1', last '1'], except
  'S'-tail reads which vote over the whole tint (:215-224 -- note the
  reference tests tail=='S' for BOTH ends);
- a segment becomes exonic when >= 3 votes and ratio > 0.5 (:231);
- strand is '-' when S-tails outnumber E-tails (:234-237);
- boundary correction snaps each exon start/end to the offset in a +-w
  window where >= majority of member reads have an alignment boundary;
  candidate offsets are scanned ascending and the LAST qualifying one wins
  (:122-140);
- GTF: transcript start is 1-based (+1) but exon lines keep the raw
  0-based start (:93 vs :108); records sort by (chrom, start0, text).
"""

from __future__ import annotations

import os
from itertools import groupby

from ..config import IsoformsConfig
from ..io.tsv import parse_cluster_tsv, parse_split_alignment_boundaries


def consensus(isoforms: dict, segments: dict, reads: dict) -> None:
    for key, isoform in isoforms.items():
        chrom, tint, _, _ = key
        segs = segments[(chrom, tint)]
        M = len(segs)
        cons = [0] * M
        cov = [0] * M
        tails = {"N": 0, "S": 0, "E": 0}
        for rid in isoform["rids"]:
            read = reads[rid]
            assert len(read["data"]) == M
            if "1" not in read["data"]:
                continue
            first = 0 if read["tail"] == "S" else read["data"].index("1")
            last = (
                M - 1
                if read["tail"] == "S"
                else M - 1 - read["data"][::-1].index("1")
            )
            assert 0 <= first <= last < M
            for j in range(first, last + 1):
                cons[j] += read["data"][j] == "1"
                cov[j] += 1
            tails[read["tail"]] += 1
        flags = [x / c > 0.5 if x >= 3 else False for x, c in zip(cons, cov)]
        if True not in flags:
            continue
        isoform["strand"] = "-" if tails["S"] > tails["E"] else "+"
        starts, ends = [], []
        for d, grp in groupby(enumerate(flags), lambda t: t[1]):
            if d is not True:
                continue
            grp = list(grp)
            starts.append(segs[grp[0][0]][0])
            ends.append(segs[grp[-1][0]][1])
        isoform["starts"], isoform["ends"] = starts, ends
        for s, e in zip(starts, ends):
            assert s < e


def correct_boundaries(
    side: str, isoforms: dict, reads: dict, majority: float, window: int
) -> None:
    if window == 0:
        return
    assert side in ("starts", "ends")
    for isoform in isoforms.values():
        if side not in isoform:
            continue
        n = len(isoform["rids"])
        for idx, iso_pos in enumerate(isoform[side]):
            votes = {x: 0 for x in range(-window, window + 1)}
            for rid in isoform["rids"]:
                for read_pos in reads[rid][side]:
                    x = read_pos - iso_pos
                    if x in votes:
                        votes[x] += 1
            for x, v in votes.items():  # ascending x; last winner sticks
                if v / n >= majority:
                    isoform[side][idx] = x + iso_pos


def gtf_records(isoforms: dict) -> list[tuple[tuple, str]]:
    records = []
    for key, isoform in isoforms.items():
        if "starts" not in isoform:
            continue
        chrom, tint, _pid, iid = key
        starts, ends = isoform["starts"], isoform["ends"]
        strand = isoform["strand"]
        name = f"{chrom}_{tint}_{iid}"
        lines = [
            "\t".join(
                [
                    chrom,
                    "freddie",
                    "transcript",
                    str(starts[0] + 1),
                    str(ends[-1]),
                    ".",
                    strand,
                    ".",
                    f'transcript_id "{name}"; read_support "{len(isoform["rids"])}";',
                ]
            )
        ]
        for eid, (s, e) in enumerate(zip(starts, ends), start=1):
            lines.append(
                "\t".join(
                    [
                        chrom,
                        "freddie",
                        "exon",
                        str(s),
                        str(e),
                        ".",
                        strand,
                        ".",
                        f'transcript_id "{name}"; exon_number "{eid}"; '
                        f'exon_id "{name}_{eid}"; ',
                    ]
                )
            )
        records.append(((chrom, starts[0]), "\n".join(lines)))
    return records


def tint_isoforms(
    cluster_tsv: str, split_tsv: str, cfg: IsoformsConfig
) -> list[tuple[tuple, str]]:
    # Native engine (native/isocore.cpp): the whole tint in one C call;
    # any parse/invariant trip falls through to the Python oracle path
    # below with identical records (tests/test_isocore.py).
    from ..ops.isocore import tint_gtf_native

    try:
        recs = tint_gtf_native(cluster_tsv, split_tsv, cfg)
    except Exception:
        recs = None
    if recs is not None:
        return recs
    segments, reads, isoforms = parse_cluster_tsv(cluster_tsv)
    consensus(isoforms, segments, reads)
    parse_split_alignment_boundaries(split_tsv, reads)
    correct_boundaries("starts", isoforms, reads, cfg.majority_threshold, cfg.correction_window)
    correct_boundaries("ends", isoforms, reads, cfg.majority_threshold, cfg.correction_window)
    return gtf_records(isoforms)


def _tint_isoforms_job(job: tuple[str, str, IsoformsConfig]):
    cluster_tsv, split_tsv, cfg = job
    return tint_isoforms(cluster_tsv, split_tsv, cfg)


def run_isoforms(
    split_dir: str, cluster_dir: str, output: str, cfg: IsoformsConfig | None = None
) -> int:
    """Full isoforms stage; returns the number of GTF transcript records.

    With cfg.threads > 1 tints are processed by a process pool (the
    consensus work is pure Python, so threads would serialize on the GIL;
    the reference pools processes here too, py/freddie_isoforms.py:274).
    The final sort makes the output order pool-independent."""
    cfg = cfg or IsoformsConfig()
    jobs: list[tuple[str, str, IsoformsConfig]] = []
    for contig in sorted(os.listdir(cluster_dir)):
        cdir = os.path.join(cluster_dir, contig)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if not (fn.startswith("cluster_") and fn.endswith(".tsv")):
                continue
            tint_id = int(fn[:-4].split("_")[-1])
            split_tsv = os.path.join(split_dir, contig, f"split_{contig}_{tint_id}.tsv")
            assert os.path.isfile(split_tsv), split_tsv
            jobs.append((os.path.join(cdir, fn), split_tsv, cfg))
    records: list[tuple[tuple, str]] = []
    pooled = False
    # Spawned workers pay an interpreter + package-import startup; the
    # consensus math itself is fast per byte of input, so the pool only
    # wins on large datasets.
    total_bytes = sum(
        os.path.getsize(p) for cl, sp, _cfg in jobs for p in (cl, sp)
    )
    if cfg.threads > 1 and len(jobs) > 1 and total_bytes > 128 << 20:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        from concurrent.futures.process import BrokenProcessPool

        from ..utils.procenv import cpu_worker_env

        # spawn, not fork: the parent may hold a CUDA context and its
        # threads, and forking such a process can deadlock the children.
        # The scoped env keeps workers off the card (utils/procenv.py)
        # -- the consensus math never touches it.
        try:
            with cpu_worker_env(), ProcessPoolExecutor(
                max_workers=cfg.threads,
                mp_context=multiprocessing.get_context("spawn"),
            ) as ex:
                records = [
                    r for recs in ex.map(_tint_isoforms_job, jobs, chunksize=5)
                    for r in recs
                ]
            pooled = True
        except BrokenProcessPool:
            # Workers can die at startup in constrained environments
            # (container limits, signal storms); results are
            # deterministic either way, so degrade to serial rather
            # than fail the stage.
            records = []
    if not pooled:
        for job in jobs:
            records.extend(_tint_isoforms_job(job))
    records.sort()
    from ..utils.fsio import atomic_write

    with atomic_write(output) as f:
        for _key, text in records:
            f.write(text)
            f.write("\n")
    return len(records)
