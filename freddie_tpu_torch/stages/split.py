"""Stage 1 -- split: partition splice-aligned reads into transcriptional
intervals ("tints").

Re-implements the reference's locus partitioner
(py/freddie_split.py) with identical semantics:

- stream the BAM per contig, dropping unmapped/secondary/supplementary
  records and (by default) nonspliced reads (:210-242);
- batch reads into coarse loci by genomic overlap of their spans;
- merge per-read exonic intervals into "simple tints" and group simple
  tints that share reads (BFS over the read<->interval relation, :295-353);
- keep groups with >= 3 reads; break oversized groups (>=100 intervals or
  >=1500 reads) into sub-tints over junction-support graphs (:244-293);
- emit one split TSV per tint plus per-tint read-sequence TSVs (:367-481).

All of this is host-side streaming work (I/O bound); the device work starts
at the segment stage. Unlike the reference (one process per contig), the
loop is a single streaming pass over the sorted BAM (records of each
contig are consumed incrementally, never buffered whole). With the C++
decoder the per-alignment CIGAR walk runs inside the native batch API
(array-native ingest); `threads > 1` overlaps that decode with tint
building via a prefetch thread.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, Iterator

from ..config import SplitConfig
from ..core.cigar import alignment_intervals, cigar_to_str, Interval
from ..io.bam import BamRecord
from ..io.fastx import read_fastx


@dataclass
class SplitRead:
    id: int
    name: str
    contig: str
    strand: str
    intervals: list[Interval]
    simple_tints: list[int] = field(default_factory=list)


@dataclass
class Tint:
    intervals: list[tuple[int, int]]
    rids: list[int]


def record_to_read(rec: BamRecord, rid: int, max_del_size: int) -> SplitRead:
    intervals = [
        iv
        for iv in alignment_intervals(
            rec.cigartuples,
            rec.reference_start,
            len(rec.query_sequence),
            max_del_size=max_del_size,
        )
        if iv[0] != iv[1] and iv[2] != iv[3]
    ]
    return SplitRead(
        id=rid,
        name=rec.query_name,
        contig=rec.reference_name,
        strand="-" if rec.is_reverse else "+",
        intervals=intervals,
    )


def group_overlapping_reads(
    records: Iterable[BamRecord], contig: str, cfg: SplitConfig
) -> Iterator[list[SplitRead]]:
    """Batch reads into coarse loci: a new batch starts whenever the next
    read begins past the running max end of the current batch
    (py/freddie_split.py:210-242). Records may be BamRecords (intervals
    extracted here) or IngestRecords (intervals pre-extracted by the C++
    batch walk)."""
    reads: list[SplitRead] = []
    end = None
    for rec in records:
        if rec.is_unmapped or rec.is_supplementary or rec.is_secondary or rec.reference_name is None:
            continue
        assert rec.reference_name == contig, (rec.reference_name, contig)
        pre = getattr(rec, "intervals", None)
        if pre is not None:
            read = SplitRead(
                id=len(reads),
                name=rec.query_name,
                contig=rec.reference_name,
                strand="-" if rec.is_reverse else "+",
                intervals=pre,
            )
        else:
            read = record_to_read(rec, rid=len(reads), max_del_size=cfg.max_del_size)
        if (not cfg.consider_nonspliced) and len(read.intervals) == 1:
            continue
        s = read.intervals[0][0]
        e = read.intervals[-1][1]
        if end is None:
            end = e
        if s > end:
            yield reads
            reads = []
            read.id = 0
            end = e
        end = max(end, e)
        reads.append(read)
    if reads:
        yield reads


def break_oversized_tint(tint: Tint, reads: list[SplitRead]) -> Iterator[Tint]:
    """Break an oversized tint into sub-tints via connected components of the
    junction-support graph over its intervals (py/freddie_split.py:244-293).

    Graph nodes are the tint's intervals; an edge connects the intervals
    flanking a splice junction used by >= 2 reads. Components whose reads
    number > 2 become sub-tints; a read may land in several sub-tints.
    """
    import numpy as np

    intervals = tint.intervals
    start = intervals[0][0]
    end = intervals[-1][1]
    n = len(intervals)
    pos_to_iv = np.full(end - start, n, dtype=np.int64)
    for idx, (s, e) in enumerate(intervals):
        pos_to_iv[s - start : e - start] = idx
    iv_to_rids: list[set[int]] = [set() for _ in intervals]
    rid_to_ivs: dict[int, set[int]] = {rid: set() for rid in tint.rids}
    edge_weight: dict[tuple[int, int], int] = {}
    for rid in tint.rids:
        alns = reads[rid].intervals
        for aln in alns:
            v = int(pos_to_iv[aln[0] - start])
            iv_to_rids[v].add(rid)
            rid_to_ivs[rid].add(v)
        for a1, a2 in zip(alns[:-1], alns[1:]):
            v1 = int(pos_to_iv[a1[1] - start - 1])
            v2 = int(pos_to_iv[a2[0] - start])
            assert v1 <= v2 < n, (a1, a2, v1, v2)
            edge_weight[(v1, v2)] = edge_weight.get((v1, v2), 0) + 1

    # Union-find over intervals with the weight->=2 edges.
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (u, v), w in edge_weight.items():
        if w >= 2:
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[max(ru, rv)] = min(ru, rv)

    comps: dict[int, list[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    # Component order: by smallest member (== discovery order of
    # nx.connected_components over nodes added 0..n-1).
    for root in sorted(comps, key=lambda r: min(comps[r])):
        comp = comps[root]
        c_rids: set[int] = set()
        for i in comp:
            c_rids.update(iv_to_rids[i])
        if len(c_rids) > 2:
            used_ivs: set[int] = set()
            for rid in c_rids:
                used_ivs.update(rid_to_ivs[rid])
            yield Tint(
                intervals=[intervals[i] for i in sorted(used_ivs)],
                rids=sorted(c_rids),
            )


def build_tints(reads: list[SplitRead], cfg: SplitConfig) -> list[Tint]:
    """Merge read intervals into simple tints, group by shared reads, apply
    the >=3-read filter and the oversize caps (py/freddie_split.py:295-364)."""
    simple: list[dict] = []
    start = end = None
    rids: list[int] = []
    triples = sorted((iv[0], iv[1], r.id) for r in reads for iv in r.intervals)
    for s, e, rid in triples:
        if start is None:
            start, end = s, e
        if s > end:
            simple.append(dict(start=start, end=end, rids=rids))
            start, end, rids = s, e, []
        end = max(end, e)
        rids.append(rid)
        reads[rid].simple_tints.append(len(simple))
    if start is None:
        return []
    simple.append(dict(start=start, end=end, rids=rids))

    # Group simple tints that share reads (iterative DFS; same components
    # as the reference's deque-as-stack BFS at :325-353).
    enqueued = [False] * len(simple)
    tints: list[Tint] = []
    for idx in range(len(simple)):
        if enqueued[idx]:
            continue
        group: list[int] = []
        stack = [idx]
        enqueued[idx] = True
        while stack:
            t = stack.pop()
            group.append(t)
            for rid in simple[t]["rids"]:
                for i in reads[rid].simple_tints:
                    if not enqueued[i]:
                        enqueued[i] = True
                        stack.append(i)
        grp_rids: set[int] = set()
        grp_intervals: list[tuple[int, int]] = []
        for t in group:
            grp_rids.update(simple[t]["rids"])
            grp_intervals.append((simple[t]["start"], simple[t]["end"]))
        if len(grp_rids) < cfg.min_reads_per_tint:
            continue
        tints.append(Tint(intervals=sorted(grp_intervals), rids=sorted(grp_rids)))
    assert all(enqueued)

    final: list[Tint] = []
    for tint in tints:
        if (
            len(tint.intervals) < cfg.max_tint_intervals
            and len(tint.rids) < cfg.max_tint_reads
        ):
            final.append(tint)
        else:
            final.extend(break_oversized_tint(tint, reads))
    return final


def format_split_tsv(contig: str, tint_id: int, tint: Tint, reads: list[SplitRead]) -> str:
    """Render one split TSV (wire format of py/freddie_split.py:445-481)."""
    lines = [
        "\t".join(
            [
                f"#{contig}",
                str(tint_id),
                ",".join(f"{s}-{e}" for s, e in tint.intervals),
                str(len(tint.rids)),
            ]
        )
    ]
    for rid in tint.rids:
        r = reads[rid]
        fields = [str(r.id), r.name, r.contig, r.strand, str(tint_id)]
        fields += [
            f"{ts}-{te}:{qs}-{qe}:{cig if isinstance(cig, str) else cigar_to_str(cig)}"
            for ts, te, qs, qe, cig in r.intervals
        ]
        lines.append("\t".join(fields))
    return "\n".join(lines) + "\n"


def split_contig(
    records: Iterable[BamRecord],
    contig: str,
    outdir: str,
    cfg: SplitConfig,
    rname_to_tint: dict[str, dict],
) -> int:
    """Process one contig's records; write split TSVs; fill rname_to_tint.

    Returns the number of tints written."""
    tint_id = 0
    contig_outdir = os.path.join(outdir, contig)
    for reads in group_overlapping_reads(records, contig, cfg):
        for tint in build_tints(reads, cfg):
            if tint_id == 0:
                os.makedirs(contig_outdir, exist_ok=False)
            path = os.path.join(contig_outdir, f"split_{contig}_{tint_id}.tsv")
            with open(path, "w") as f:
                f.write(format_split_tsv(contig, tint_id, tint, reads))
            for rid in tint.rids:
                name = reads[rid].name
                entry = rname_to_tint.setdefault(
                    name, dict(contig=contig, rid=rid, tint_ids=[])
                )
                assert entry["contig"] == contig
                assert entry["rid"] == rid, (contig, rid, name, entry["rid"])
                entry["tint_ids"].append(tint_id)
            tint_id += 1
    return tint_id


def distribute_read_sequences(
    read_files: list[str],
    rname_to_tint: dict[str, dict],
    outdir: str,
    max_open_handles: int = 512,
) -> None:
    """Route each read's raw sequence to reads_{contig}_{tint}.tsv files.

    Equivalent end state to the reference's write-then-shell-sort-then-split
    (py/freddie_split.py:367-424) without the intermediate reads.tsv: rows
    are grouped per (contig, tint) directly; row order within a file is
    irrelevant downstream (the segment stage builds an rid->seq dict).

    Open file handles are LRU-capped at max_open_handles (evicted files
    reopen in append mode), so tint counts far beyond RLIMIT_NOFILE -- the
    reference bumps the rlimit for its per-contig handles at
    py/freddie_split.py:522-526 -- cannot exhaust descriptors.
    """
    from collections import OrderedDict

    handles: OrderedDict[tuple[str, int], object] = OrderedDict()
    opened: set[tuple[str, int]] = set()

    def get_handle(key: tuple[str, int]):
        fh = handles.get(key)
        if fh is not None:
            handles.move_to_end(key)
            return fh
        if len(handles) >= max_open_handles:
            _, old = handles.popitem(last=False)
            old.close()
        contig, tint_id = key
        path = os.path.join(outdir, contig, f"reads_{contig}_{tint_id}.tsv")
        fh = open(path, "a" if key in opened else "w")
        opened.add(key)
        handles[key] = fh
        return fh

    try:
        for read_file in read_files:
            for name, seq in read_fastx(read_file):
                info = rname_to_tint.get(name)
                if info is None:
                    continue
                contig, rid = info["contig"], info["rid"]
                for tint_id in info["tint_ids"]:
                    fh = get_handle((contig, tint_id))
                    fh.write(f"{rid}\t{contig}\t{tint_id}\t{seq}\n")
    finally:
        for fh in handles.values():
            fh.close()


def _prefetch_records(it: Iterator, chunk: int = 8192, depth: int = 4) -> Iterator:
    """Pull records from `it` in a worker thread, handing chunks to the
    consumer through a bounded queue: decode (C++, GIL released) overlaps
    grouping/tint building. This is what `split -t` enables; with the
    reference's per-contig process pool the analogous overlap is decode vs
    downstream stages (py/freddie_split.py:509-513)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker():
        try:
            buf = []
            for x in it:
                buf.append(x)
                if len(buf) >= chunk:
                    q.put(buf)
                    buf = []
            if buf:
                q.put(buf)
            q.put(None)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield from item


def run_split(
    bam_path: str,
    read_files: list[str],
    outdir: str,
    cfg: SplitConfig | None = None,
) -> dict[str, int]:
    """Full split stage: BAM -> per-tint TSVs + read-sequence TSVs.

    Returns {contig: n_tints}."""
    cfg = cfg or SplitConfig()
    os.makedirs(outdir, exist_ok=True)
    from ..io.bam_native import (
        NativeBamReader,
        iter_interval_records,
        native_split_available,
        open_bam,
        run_split_native,
    )

    # Engine dispatch is availability-only (never content): the C++ core
    # (native/split_core.cpp) and this Python path are byte-identical twins
    # (tests/test_native_split.py), so a missing toolchain only changes
    # speed. FREDDIE_SPLIT_ENGINE=python forces the oracle twin.
    engine = os.environ.get("FREDDIE_SPLIT_ENGINE", "auto")
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"FREDDIE_SPLIT_ENGINE={engine!r} (want auto|native|python)")
    if engine != "python" and native_split_available():
        return run_split_native(bam_path, read_files, outdir, cfg)
    if engine == "native":
        raise RuntimeError("FREDDIE_SPLIT_ENGINE=native but the C++ core is unavailable")

    reader = open_bam(bam_path)
    keep = {
        n
        for n, l in zip(reader.references, reader.lengths)
        if l > cfg.contig_min_size
    }
    assert keep, "No contigs left! Check BAM header or contig_min_size"

    rname_to_tint: dict[str, dict] = {}
    counts: dict[str, int] = {}

    # Array-native ingest: with the C++ decoder the per-alignment CIGAR
    # walk runs in the batch API (flat interval arrays); the Python
    # fallback yields BamRecords and walks CIGARs in record_to_read.
    if isinstance(reader, NativeBamReader):
        record_iter = iter_interval_records(reader, cfg.max_del_size)
    else:
        record_iter = iter(reader)
    if cfg.threads > 1:
        # Overlap C++ decode + record building with downstream tint work.
        record_iter = _prefetch_records(record_iter)

    # Single streaming pass over the coordinate-sorted BAM: records arrive
    # grouped by contig in header order. Each contig's records are consumed
    # incrementally (a whole-genome contig never sits in RAM); runs the
    # caller skips are drained before advancing.
    def contig_runs() -> Iterator[tuple[str, Iterator[BamRecord]]]:
        it = record_iter
        pending: list[BamRecord | None] = [next(it, None)]

        def run(contig: str) -> Iterator[BamRecord]:
            while pending[0] is not None:
                rec = pending[0]
                if rec.is_unmapped or rec.reference_name is None:
                    pending[0] = next(it, None)
                    continue
                if rec.reference_name != contig:
                    return
                pending[0] = next(it, None)
                yield rec

        while pending[0] is not None:
            rec = pending[0]
            if rec.is_unmapped or rec.reference_name is None:
                pending[0] = next(it, None)
                continue
            gen = run(rec.reference_name)
            yield rec.reference_name, gen
            for _ in gen:  # drain any records the caller left unread
                pass

    for contig, records in contig_runs():
        if contig not in keep:
            continue
        n = split_contig(records, contig, outdir, cfg, rname_to_tint)
        if n:
            counts[contig] = n
    reader.close()

    distribute_read_sequences(read_files, rname_to_tint, outdir)
    return counts
