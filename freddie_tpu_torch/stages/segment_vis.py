"""Stage 6b (optional) -- segmentation-QC tool.

Equivalent of the reference's freddie_segment_vis.py: compare the
segmentation's breakpoints against annotation splice positions and dump a
pickle of (segments+track, transcripts-with-data, reads-with-data) for
interactive inspection.

Pipeline (py/freddie_segment_vis.py:224-245):
  1. annotation exon boundaries per chrom, with <w-apart neighborhoods
     merged to their support-weighted rounded average (:59-92);
  2. segmentation positions from segment TSV headers (:94-104);
  3. segmentation positions snapped to the nearest annotation position
     within +-w (:106-114) -- note the reference passes the segmentation
     positions as both arguments of switch_to_nearest, which this
     reproduces behaviorally via snap_to_annotation(seg, ann);
  4. a seg/annotation track ('<', '>', '-') over the merged positions;
  5. per-read and per-transcript 0/1/2 data against the track segments.
"""

from __future__ import annotations

import pickle
import re

import numpy as np


def read_annotation_exons(annotation_gtf: str) -> dict:
    """chrom -> {tid: {tid, gid, intervals}} (1-based inclusive GTF)."""
    out: dict = {}
    for line in open(annotation_gtf):
        if line[0] == "#":
            continue
        f = line.split("\t")
        if f[2] != "exon":
            continue
        chrom = f[0]
        gid_m = re.search(r'gene_id "(?P<gid>[^"]+)"', f[8])
        tid_m = re.search(r'transcript_id "(?P<tid>[^"]+)"', f[8])
        if not tid_m:
            continue
        tid = tid_m.group("tid")
        t = out.setdefault(chrom, {}).setdefault(
            tid, dict(tid=tid, gid=gid_m.group("gid") if gid_m else "", intervals=[])
        )
        t["intervals"].append((int(f[3]), int(f[4])))
    return out


def annotation_positions(cid_to_transcripts: dict, w: int = 5) -> dict:
    """Merge exon-boundary positions closer than w into weighted averages
    (py/freddie_segment_vis.py:59-92)."""
    out = {}
    for chrom, transcripts in cid_to_transcripts.items():
        counts: dict[int, int] = {}
        for t in transcripts.values():
            for s, e in t["intervals"]:
                counts[s] = counts.get(s, 0) + 1
                counts[e] = counts.get(e, 0) + 1
        positions = sorted(counts)
        merged: list[list[int]] = [[]]
        for a, b in zip(positions[:-1], positions[1:]):
            if b - a < w:
                if not merged[-1]:
                    merged[-1].append(a)
                merged[-1].append(b)
            elif merged[-1]:
                merged.append([])
        if merged and not merged[-1]:
            merged.pop()
        final = set(counts)
        for group in merged:
            final.difference_update(group)
            final.add(
                int(round(np.average(group, weights=[counts[p] for p in group])))
            )
        out[chrom] = sorted(final)
    return out


def segmentation_positions(segment_tsvs: list[str]) -> dict:
    out: dict = {}
    for path in segment_tsvs:
        for line in open(path):
            if line[0] != "#":
                continue
            f = line[1:].rstrip("\n").split("\t")
            out.setdefault(f[0], set()).update(int(x) for x in f[2].split(","))
    return out


def snap_to_annotation(seg_pos: dict, ann_pos: dict, w: int = 5) -> dict:
    """Thin out <w-apart segmentation positions, then snap each remaining
    one to the nearest annotation position within +-w
    (py/freddie_segment_vis.py:106-114)."""
    out = {}
    for chrom, positions in seg_pos.items():
        ps = sorted(positions)
        ps = [a for a, b in zip(ps[:-1], ps[1:]) if b - a > w] + ps[-1:]
        targets = set(ann_pos.get(chrom, ()))
        snapped = []
        for p in ps:
            hits = [(abs(x - p), x) for x in range(p - w, p + w + 1) if x in targets]
            snapped.append(min(hits)[1] if hits else p)
        out[chrom] = snapped
    return out


def seg_track(seg_pos: dict, ann_pos: dict) -> dict:
    """Segments + a track marking annotation-only stretches
    (py/freddie_segment_vis.py:130-172): '-' inside annotation-only runs,
    '<'/'>' at their flanks."""
    out = {}
    for chrom in seg_pos:
        flags = {0: 3}
        for p in seg_pos[chrom]:
            flags[p] = flags.get(p, 0) | 1
        for p in ann_pos.get(chrom, ()):
            flags[p] = flags.get(p, 0) | 2
        items = sorted(flags.items())
        segs, track = [], []
        for (p1, t1), (p2, t2) in zip(items[:-1], items[1:]):
            segs.append((p1, p2))
            if t1 == 2 and t2 == 2:
                track.append("-")
            elif t1 != 2 and t2 == 2:
                track.append("<")
            elif t1 == 2 and t2 != 2:
                track.append(">")
            else:
                track.append(" ")
        out[chrom] = dict(segs=segs, track=track)
    return out


def intervals_to_data(intervals, segs) -> dict:
    """0/1/2 coverage genotype of a set of intervals against segments
    (py/freddie_segment_vis.py:199-222)."""
    covered = set()
    for s, e in intervals:
        covered.update(range(s, e))
    data = {}
    for idx, (s, e) in enumerate(segs):
        if not any(s <= s2 <= e or s2 <= s <= e2 for s2, e2 in intervals):
            continue
        c = sum(1 for p in range(s, e) if p in covered) / (e - s)
        data[idx] = 1 if c > 0.9 else (0 if c < 0.1 else 2)
    return data


def read_split_reads(split_tsvs: list[str]) -> dict:
    out: dict = {}
    for path in split_tsvs:
        for line in open(path):
            if line[0] == "#":
                continue
            f = line.rstrip("\n").split("\t")
            ivs = [tuple(map(int, x.split(":")[0].split("-"))) for x in f[5:]]
            out.setdefault(f[2], []).append(
                dict(
                    rid=int(f[0]),
                    name=f[1],
                    tid=f[1].split("_")[0],
                    strand=f[3],
                    tint=f[4],
                    intervals=ivs,
                )
            )
    return out


def run_segment_vis(
    split_tsvs: list[str],
    segment_tsvs: list[str],
    annotation_gtf: str,
    output: str,
) -> None:
    cid_to_transcripts = read_annotation_exons(annotation_gtf)
    ann_pos = annotation_positions(cid_to_transcripts)
    seg_pos = segmentation_positions(segment_tsvs)
    snapped = snap_to_annotation(seg_pos, ann_pos)
    cid_to_segs = seg_track({c: set(v) for c, v in snapped.items()}, ann_pos)
    cid_to_reads = read_split_reads(split_tsvs)

    for chrom, reads in cid_to_reads.items():
        if chrom not in cid_to_segs:
            continue
        segs = cid_to_segs[chrom]["segs"]
        for read in reads:
            read["data"] = intervals_to_data(read["intervals"], segs)
        for t in cid_to_transcripts.get(chrom, {}).values():
            t["data"] = intervals_to_data(t["intervals"], segs)

    with open(output, "wb") as f:
        pickle.dump((cid_to_segs, cid_to_transcripts, cid_to_reads), f)
