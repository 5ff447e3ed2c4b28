"""The GTF as the original freddie's isoforms stage states it
(py/freddie_isoforms.py), from the cluster stage's assignment.

This follows the program's state: the cluster TSVs say which reads make
each isoform and carry each read's segment genotypes and tail, and the
cluster stage's solver is not restated here. The genotypes themselves are
checked by ``segments.genotype_mismatches``; the reads' alignment
boundaries come from the BAM (``split.bam_reads``), not from the split
TSVs. Per isoform:

- a read votes over [its first '1', its last '1'] (over the whole tint
  where its tail is 'S'); a segment is exonic with at least 3 votes and
  more than half of them '1'; runs of exonic segments are the exons;
- the strand is '-' where 'S' tails outnumber 'E' tails;
- each exon start (then end) moves to the last offset x in -w..w, taken
  in ascending order, at which at least ``majority`` of the isoform's
  reads have an alignment start (end) at the boundary plus x;
- records: a transcript line with the first start + 1, exon lines with
  the raw starts, sorted by (contig, first start, text).
"""

from __future__ import annotations

import os
from itertools import groupby


def _isoforms_of(path: str):
    segments, reads, isoforms = None, {}, {}
    with open(path) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if fields[0].startswith("#"):
                pos = [int(x) for x in fields[2].split(",")]
                segments = list(zip(pos[:-1], pos[1:]))
                chrom, tint = fields[0][1:], int(fields[1])
                continue
            if fields[0].startswith("isoform_") or fields[7] == "*":
                continue
            rid = int(fields[0])
            reads[rid] = dict(name=fields[1], tail=fields[6], data=fields[8])
            key = (chrom, tint, int(fields[5]), int(fields[7]))
            isoforms.setdefault(key, dict(rids=[]))["rids"].append(rid)
    return segments, reads, isoforms


def _consensus(isoform, segs, reads) -> bool:
    M = len(segs)
    cons, cov = [0] * M, [0] * M
    tails = {"N": 0, "S": 0, "E": 0}
    for rid in isoform["rids"]:
        read = reads[rid]
        data = read["data"]
        if len(data) != M:
            raise ValueError("a read's genotypes do not span its tint's segments")
        if "1" not in data:
            continue
        first = 0 if read["tail"] == "S" else data.index("1")
        last = M - 1 if read["tail"] == "S" else M - 1 - data[::-1].index("1")
        for j in range(first, last + 1):
            cons[j] += data[j] == "1"
            cov[j] += 1
        tails[read["tail"]] += 1
    flags = [x / c > 0.5 if x >= 3 else False for x, c in zip(cons, cov)]
    if True not in flags:
        return False
    isoform["strand"] = "-" if tails["S"] > tails["E"] else "+"
    isoform["starts"], isoform["ends"] = [], []
    for d, grp in groupby(enumerate(flags), lambda t: t[1]):
        if d:
            grp = list(grp)
            isoform["starts"].append(segs[grp[0][0]][0])
            isoform["ends"].append(segs[grp[-1][0]][1])
    return True


def _correct(isoform, side: int, bounds: list, majority: float, window: int) -> None:
    key = "starts" if side == 0 else "ends"
    n = len(isoform["rids"])
    for idx, iso_pos in enumerate(isoform[key]):
        votes = dict.fromkeys(range(-window, window + 1), 0)
        for b in bounds:
            for read_pos in b[side]:
                x = read_pos - iso_pos
                if x in votes:
                    votes[x] += 1
        for x, v in votes.items():
            if v / n >= majority:
                isoform[key][idx] = x + iso_pos


def reference_gtf(cluster_dir: str, by_name: dict, majority: float, window: int) -> list[str]:
    """The GTF's transcript records (each a transcript line and its exon
    lines), in the order the file holds them."""
    records = []
    for contig in sorted(os.listdir(cluster_dir)):
        d = os.path.join(cluster_dir, contig)
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if not (fn.startswith("cluster_") and fn.endswith(".tsv")):
                continue
            segs, reads, isoforms = _isoforms_of(os.path.join(d, fn))
            for (chrom, tint, _pid, iid), iso in isoforms.items():
                if not _consensus(iso, segs, reads):
                    continue
                if window:
                    ivs = [by_name.get(reads[r]["name"], []) for r in iso["rids"]]
                    bounds = [([s for s, _e in v], [e for _s, e in v]) for v in ivs]
                    _correct(iso, 0, bounds, majority, window)
                    _correct(iso, 1, bounds, majority, window)
                name = f"{chrom}_{tint}_{iid}"
                starts, ends, strand = iso["starts"], iso["ends"], iso["strand"]
                lines = ["\t".join([chrom, "freddie", "transcript", str(starts[0] + 1),
                                    str(ends[-1]), ".", strand, ".",
                                    f'transcript_id "{name}"; read_support "{len(iso["rids"])}";'])]
                for eid, (s, e) in enumerate(zip(starts, ends), start=1):
                    lines.append("\t".join([chrom, "freddie", "exon", str(s), str(e), ".", strand,
                                            ".", f'transcript_id "{name}"; exon_number "{eid}"; '
                                            f'exon_id "{name}_{eid}"; ']))
                records.append(((chrom, starts[0]), "\n".join(lines)))
    records.sort()
    return [text for _k, text in records]


def gtf_records(gtf: str) -> list[str]:
    """The GTF file's transcript records, as ``reference_gtf`` gives them."""
    records, cur = [], []
    with open(gtf) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.split("\t")[2:3] == ["transcript"] and cur:
                records.append("\n".join(cur))
                cur = []
            cur.append(line)
    if cur:
        records.append("\n".join(cur))
    return records


def gtf_mismatches(gtf: str, want: list[str]) -> int:
    """Records in one list and not in the other, counted with multiplicity,
    plus one where the two agree as sets but not in order."""
    got = gtf_records(gtf)
    from collections import Counter

    a, b = Counter(got), Counter(want)
    wrong = sum(((a - b) + (b - a)).values())
    return wrong or int(got != want)
