"""Reads and loci from the simulated BAM, as the original freddie's split
stage states them (py/freddie_split.py).

- A read's exonic intervals: its CIGAR walked from the alignment start,
  deletions longer than ``max_del_size`` read as introns, each run
  between introns one interval [start, end); empty ones dropped.
- Unmapped, secondary and supplementary records are dropped, and so are
  reads with one interval (nonspliced).
- Loci: reads in file order, a new batch where a read starts past the
  batch's furthest end. In a batch, the intervals sorted by (start, end,
  read) merge into simple tints while each starts at or before the
  running end; simple tints that share a read join one tint, kept with
  at least ``min_reads`` reads.

Oversized tints (the program breaks them on weak junctions) are not
stated here: ``reference_tints`` raises on one, since the benchmark's
samples hold none.
"""

from __future__ import annotations

from ..frozen.bamio import (CDEL, CDIFF, CEQUAL, CINS, CMATCH, CREF_SKIP, CSOFT_CLIP,
                            FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED, read_bam)


def exon_intervals(cigar, start: int, max_del_size: int) -> list[tuple[int, int]]:
    q = cigar[0][1] if cigar[0][0] == CSOFT_CLIP else 0
    t_lo = t_hi = start
    q_lo = q_hi = q
    runs = []
    for op, n in cigar:
        if op == CDEL and n > max_del_size:
            op = CREF_SKIP
        if op == CDEL:
            t_hi += n
        elif op == CINS:
            q_hi += n
        elif op in (CMATCH, CEQUAL, CDIFF):
            t_hi += n
            q_hi += n
        elif op == CREF_SKIP:
            runs.append((t_lo, t_hi, q_lo, q_hi))
            t_hi += n
            t_lo, q_lo = t_hi, q_hi
    if t_lo < t_hi:
        runs.append((t_lo, t_hi, q_lo, q_hi))
    return [(a, b) for a, b, c, d in runs if a != b and c != d]


def bam_reads(bam: str, max_del_size: int) -> tuple[dict, list]:
    """({read name: its intervals}, [(contig, name, intervals)] of the kept
    reads in file order) for every mapped primary alignment."""
    refs, records = read_bam(bam)
    by_name, kept = {}, []
    drop = FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_SUPPLEMENTARY
    for rec in records:
        if rec.flag & drop or rec.reference_id < 0:
            continue
        ivs = exon_intervals(rec.cigartuples, rec.reference_start, max_del_size)
        by_name[rec.query_name] = ivs
        if len(ivs) > 1:
            kept.append((refs[rec.reference_id], rec.query_name, ivs))
    return by_name, kept


def reference_tints(kept: list, min_reads: int, max_intervals: int,
                    max_reads: int) -> list[tuple[str, tuple, frozenset]]:
    """Every tint as (contig, its intervals, the names of its reads)."""
    tints = []

    def close(contig, batch):
        triples = sorted((s, e, r) for r, (_n, ivs) in enumerate(batch) for s, e in ivs)
        simple, member = [], [[] for _ in batch]  # simple tints; each read's
        for s, e, r in triples:
            if not simple or s > simple[-1][1]:
                simple.append([s, e, []])
            simple[-1][1] = max(simple[-1][1], e)
            simple[-1][2].append(r)
            member[r].append(len(simple) - 1)
        seen = [False] * len(simple)
        for first in range(len(simple)):
            if seen[first]:
                continue
            seen[first], stack, group = True, [first], []
            while stack:
                t = stack.pop()
                group.append(t)
                for r in simple[t][2]:
                    for u in member[r]:
                        if not seen[u]:
                            seen[u] = True
                            stack.append(u)
            rids = {r for t in group for r in simple[t][2]}
            if len(rids) < min_reads:
                continue
            if len(group) >= max_intervals or len(rids) >= max_reads:
                raise ValueError(f"an oversized tint on {contig}: the reference does not "
                                 "state how the program breaks it")
            tints.append((contig, tuple(sorted((simple[t][0], simple[t][1]) for t in group)),
                          frozenset(batch[r][0] for r in rids)))

    contig, batch, end = None, [], None
    for c, name, ivs in kept:
        s, e = ivs[0][0], ivs[-1][1]
        if c != contig or s > end:
            if batch:
                close(contig, batch)
            contig, batch, end = c, [], e
        end = max(end, e)
        batch.append((name, ivs))
    if batch:
        close(contig, batch)
    return tints
