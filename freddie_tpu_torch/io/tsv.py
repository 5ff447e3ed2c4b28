"""Shared wire formats: split/segment/cluster TSVs and the output GTF.

One canonical parser+writer per schema, byte-compatible with the
reference's formats (which re-implements parsing per stage with regexes:
py/freddie_segment.py:17-38, py/freddie_cluster.py:15-34,
py/freddie_isoforms.py:143-200). Field layouts:

split TSV (one tint per file; py/freddie_split.py:445-481):
  #<contig>\t<tint_id>\t<s-e,...>\t<n_reads>
  <rid>\t<name>\t<contig>\t<strand>\t<tint>\t<ts-te:qs-qe:CIGAR>...

reads TSV: <rid>\t<contig>\t<tint>\t<seq>

segment TSV (py/freddie_segment.py:715-732):
  #<contig>\t<tint_id>\t<pos,pos,...>
  <rid>\t<name>\t<contig>\t<strand>\t<tint>\t<012-data>\t<gap,gap,...(trailing commas)>

cluster TSV (py/freddie_cluster.py:639-691):
  #<contig>\t<tint_id>\t<pos,...>
  isoform_<iid>\t<tint>\t<exon-bits>
  <rid>\t<name>\t<contig>\t<strand>\t<tint>\t<partition>\t<tail>\t<iid|*>\t<corrections>\t<exon cols...>\t<poly entries>
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..core.cigar import str_to_cigar

_IV_RE = re.compile(r"(\d+)-(\d+):(\d+)-(\d+):(.*)")

# ---------------------------------------------------------------------- split


@dataclass(slots=True)
class TintRead:
    id: int
    name: str
    chrom: str
    strand: str
    tint: int
    intervals: list  # [(ts, te, qs, qe, cigar)]
    seq: str = ""
    data: list = field(default_factory=list)
    gaps: list = field(default_factory=list)


@dataclass(slots=True)
class SplitTint:
    id: int
    chrom: str
    intervals: list  # [(s, e)]
    read_count: int
    reads: list  # [TintRead]
    read_reps: list = field(default_factory=list)  # [(key, [read_idx,...])]


_tsvparse_mod = None
_tsvparse_failed = False


def _load_tsvparse():
    """Build/load the C split-TSV parser (native/tsvparse.c) on first use;
    None when no toolchain is available (callers fall back to the Python
    parser transparently -- results are identical,
    tests/test_native_tsvparse.py)."""
    global _tsvparse_mod, _tsvparse_failed
    if _tsvparse_mod is not None or _tsvparse_failed:
        return _tsvparse_mod
    try:
        import importlib.util
        import os
        import subprocess
        import sysconfig

        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        src = os.path.join(root, "native", "tsvparse.c")
        lib = os.path.join(root, "native", "tsvparse.so")
        if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
            inc = sysconfig.get_paths()["include"]
            # Per-pid temp + atomic os.replace: concurrent processes must
            # never dlopen a half-written .so.
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(
                ["gcc", "-O2", "-shared", "-fPIC", f"-I{inc}", "-o", tmp, src],
                check=True, capture_output=True,
            )
            os.replace(tmp, lib)
        spec = importlib.util.spec_from_file_location("tsvparse", lib)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _tsvparse_mod = mod
    except Exception:
        _tsvparse_failed = True
        _tsvparse_mod = None
    return _tsvparse_mod


def _parse_split_tsv_py(path: str) -> SplitTint:
    """Pure-Python split-TSV parser (the semantic oracle; also the
    fallback when the C extension is unavailable or raises)."""
    tint = None
    for line in open(path):
        fields = line.rstrip("\n").split("\t")
        if line[0] == "#":
            assert tint is None, f"{path}: multiple tints in one split file"
            intervals = [
                (int(s), int(e))
                for s, e in (x.split("-") for x in fields[2].split(","))
            ]
            assert all(a[1] < b[0] for a, b in zip(intervals[:-1], intervals[1:]))
            assert all(s < e for s, e in intervals)
            tint = SplitTint(
                id=int(fields[1]),
                chrom=fields[0][1:],
                intervals=intervals,
                read_count=int(fields[3]),
                reads=[],
            )
        else:
            ivs = []
            for f in fields[5:]:
                m = _IV_RE.match(f)
                ts, te, qs, qe = (
                    int(m.group(1)), int(m.group(2)),
                    int(m.group(3)), int(m.group(4)),
                )
                ivs.append((ts, te, qs, qe, str_to_cigar(m.group(5))))
            assert all(
                a[1] <= b[0] and a[3] <= b[2] for a, b in zip(ivs[:-1], ivs[1:])
            )
            assert all(ts < te and qs < qe for ts, te, qs, qe, _ in ivs)
            tint.reads.append(
                TintRead(
                    id=int(fields[0]),
                    name=fields[1],
                    chrom=fields[2],
                    strand=fields[3],
                    tint=int(fields[4]),
                    intervals=ivs,
                )
            )
    assert tint is not None and len(tint.reads) == tint.read_count
    _fill_read_reps(tint)
    return tint


def _fill_read_reps(tint: SplitTint) -> None:
    # Read representatives: reads sharing the same exonic-interval tuple
    # (py/freddie_segment.py:163-170).
    reps: dict[tuple, list[int]] = {}
    for ridx, read in enumerate(tint.reads):
        key = tuple((ts, te) for ts, te, _, _, _ in read.intervals)
        reps.setdefault(key, []).append(ridx)
    tint.read_reps = list(reps.items())


def parse_split_tsv(path: str) -> SplitTint:
    """Parse one split TSV (exactly one tint per file, as the reference
    asserts at py/freddie_segment.py:699). Uses the C extension when a
    toolchain is available; any C-side exception falls back to the
    Python oracle, so acceptance/rejection of a file never depends on the
    toolchain."""
    mod = _load_tsvparse()
    if mod is not None:
        from .bam import CIGAR_OPS

        try:
            chrom, tint_id, intervals, n_reads, rows, reps = mod.parse_split_file(
                path, CIGAR_OPS
            )
        except Exception:
            return _parse_split_tsv_py(path)
        tint = SplitTint(
            id=tint_id,
            chrom=chrom,
            intervals=intervals,
            read_count=n_reads,
            # Positional: C rows are (id, name, chrom, strand, tint,
            # intervals) in TintRead field order; kwargs construction
            # measurably dominates at 300k reads.
            reads=[TintRead(*row) for row in rows],
            read_reps=reps,
        )
        assert len(tint.reads) == tint.read_count
        return tint
    return _parse_split_tsv_py(path)


def load_read_sequences(tint: SplitTint, reads_tsv: str) -> None:
    rid_to_seq = None
    mod = _load_tsvparse()
    if mod is not None and hasattr(mod, "load_reads_seqs"):
        try:
            rid_to_seq = mod.load_reads_seqs(reads_tsv)
        except Exception:
            rid_to_seq = None  # Python loop reproduces the error semantics
    if rid_to_seq is None:
        rid_to_seq = {}
        for line in open(reads_tsv):
            fields = line.rstrip("\n").split("\t")
            rid_to_seq[int(fields[0])] = fields[3]
    assert len(rid_to_seq) == len(tint.reads)
    for read in tint.reads:
        read.seq = rid_to_seq[read.id]


# -------------------------------------------------------------------- segment


# 0/1/2 genotype values -> their ASCII digits in one C-speed pass.
_DATA_DIGITS = bytes.maketrans(bytes(range(3)), b"012")


def format_segment_tsv(tint: SplitTint, final_positions: list[int]) -> str:
    lines = ["\t".join([f"#{tint.chrom}", str(tint.id), ",".join(map(str, final_positions))])]
    for read in tint.reads:
        # bytes(data).translate == "".join(map(str, data)) for values in
        # 0..2 (the only genotypes), at C speed; the gap join reproduces
        # "".join(f"{g}," ...) including the trailing comma.
        lines.append(
            "\t".join(
                [
                    str(read.id),
                    read.name,
                    read.chrom,
                    read.strand,
                    str(read.tint),
                    bytes(read.data).translate(_DATA_DIGITS).decode("ascii"),
                    ",".join(read.gaps) + "," if read.gaps else "",
                ]
            )
        )
    return "\n".join(lines) + "\n"


_INTERNAL_GAP = re.compile(r"(\d+)-(\d+):(\d+),")
_SOFTCLIP_GAP = re.compile(r"([ES]SC):(\d+),")
_POLY_GAP = re.compile(r"([ES][AT])_(\d+):(\d+),")


@dataclass(slots=True)
class SegRead:
    id: int
    name: str
    chrom: str
    strand: str
    tint: int
    data: list[int]
    gaps: dict  # {(j1, j2): size}
    softclip: dict  # {'SSC'|'ESC': size}
    poly_tail: dict  # {'SA'|'ST'|'EA'|'ET': (length, gap)}
    # Filled by the cluster stage:
    poly_tail_category: str = "N"
    partition: int = -1


@dataclass(slots=True)
class SegTint:
    id: int
    chrom: str
    positions: list[int]
    segs: list  # [(s, e, length)]
    reads: list  # [SegRead]
    read_reps: list = field(default_factory=list)  # [[read_idx,...]]


def parse_segment_tsv(path: str) -> SegTint:
    """Parse one segment TSV. Uses the C extension when available; any
    C-side exception (including malformed-token strictness) falls back
    to the permissive Python parser, so acceptance never depends on the
    toolchain (equivalence pinned by tests/test_native_tsvparse.py)."""
    mod = _load_tsvparse()
    if mod is not None:
        try:
            tid, chrom, positions, rows, reps = mod.parse_segment_file(path)
        except Exception:
            return _parse_segment_tsv_py(path)
        return SegTint(
            id=tid,
            chrom=chrom,
            positions=positions,
            segs=[(s, e, e - s) for s, e in zip(positions[:-1], positions[1:])],
            reads=[
                SegRead(id=rid, name=nm, chrom=rc, strand=st, tint=rt,
                        data=d, gaps=g, softclip=sc, poly_tail=pt)
                for rid, nm, rc, st, rt, d, g, sc, pt in rows
            ],
            read_reps=reps,
        )
    return _parse_segment_tsv_py(path)


def _parse_segment_tsv_py(path: str) -> SegTint:
    """Pure-Python segment-TSV parser (the semantic oracle and fallback)."""
    tint = None
    rep_of: dict[str, list[int]] = {}
    for line in open(path):
        fields = line.rstrip("\n").split("\t")
        if line[0] == "#":
            assert tint is None, f"{path}: multiple tints in one segment file"
            positions = [int(x) for x in fields[2].split(",")]
            assert all(a < b for a, b in zip(positions[:-1], positions[1:]))
            tint = SegTint(
                id=int(fields[1]),
                chrom=fields[0][1:],
                positions=positions,
                segs=[(s, e, e - s) for s, e in zip(positions[:-1], positions[1:])],
                reads=[],
            )
        else:
            data_str = fields[5]
            gaps_str = fields[6] if len(fields) > 6 else ""
            read = SegRead(
                id=int(fields[0]),
                name=fields[1],
                chrom=fields[2],
                strand=fields[3],
                tint=int(fields[4]),
                data=[int(d) for d in data_str],
                gaps={
                    (int(a), int(b)): int(c)
                    for a, b, c in _INTERNAL_GAP.findall(gaps_str)
                },
                softclip={k: int(v) for k, v in _SOFTCLIP_GAP.findall(gaps_str)},
                poly_tail={
                    k: (int(l), int(g)) for k, l, g in _POLY_GAP.findall(gaps_str)
                },
            )
            assert len(read.data) == len(tint.segs)
            assert read.chrom == tint.chrom
            assert all(0 <= a < b < len(read.data) for a, b in read.gaps)
            # Read-rep key: data with ambiguity collapsed + bucketed gap sizes
            # + polyA side/gap signature (py/freddie_cluster.py:154-159).
            key = [data_str.replace("2", "0")]
            key += [
                ".{}".format(c if int(c) > 10 else 0)
                for _, _, c in _INTERNAL_GAP.findall(gaps_str)
            ]
            key += [
                ".{}{}".format(k[0], g if int(g) > 10 else 0)
                for k, _, g in _POLY_GAP.findall(gaps_str)
            ]
            rep_of.setdefault("".join(key), []).append(len(tint.reads))
            tint.reads.append(read)
    assert tint is not None
    tint.read_reps = list(rep_of.values())
    return tint


# -------------------------------------------------------------------- cluster


def format_cluster_tsv(tint: SegTint, isoforms: list, garbage_rids: list[int]) -> str:
    """isoforms: [{'exons': [0/1,...], 'rid_to_corrections': {rep_id: [str,...]}}]"""
    out = []
    out.append(
        "\t".join(
            [
                f"#{tint.chrom}",
                str(tint.id),
                ",".join([str(s) for s, _, _ in tint.segs] + [str(tint.segs[-1][1])]),
            ]
        )
    )

    def read_row(ridx: int, iid_str: str, corrections: list[str]) -> str:
        read = tint.reads[ridx]
        fields = [
            str(read.id),
            read.name,
            read.chrom,
            read.strand,
            str(read.tint),
            str(read.partition),
            str(read.poly_tail_category),
            iid_str,
            "".join(map(str, corrections)),
        ]
        exon_strs = [str(x) for x in corrections]
        for (j1, j2), l in read.gaps.items():
            exon_strs[j1] += f"({l})"
        fields.extend(exon_strs)
        for k, v in sorted(read.poly_tail.items()):
            fields.append(f"{k}:{v}")
        return "\t".join(fields)

    for iid, isoform in enumerate(isoforms):
        out.append("\t".join([f"isoform_{iid}", str(tint.id), "".join(map(str, isoform["exons"]))]))
        for rep_id, corrections in isoform["rid_to_corrections"].items():
            for ridx in tint.read_reps[rep_id]:
                out.append(read_row(ridx, str(iid), corrections))
    for rep_id in garbage_rids:
        for ridx in tint.read_reps[rep_id]:
            data = tint.reads[ridx].data
            out.append(read_row(ridx, "*", [str(x) for x in data]))
    return "\n".join(out) + "\n"


def parse_cluster_tsv(path: str):
    """Parse a cluster TSV for the isoforms stage
    (py/freddie_isoforms.py:159-200): returns (segments, reads, isoforms)
    keyed like the reference; garbage reads are skipped."""
    segments: dict = {}
    reads: dict = {}
    isoforms: dict = {}
    for line in open(path):
        fields = line.rstrip("\n").split("\t")
        if fields[0][0] == "#":
            chrom = fields[0][1:]
            tint = int(fields[1])
            pos = [int(x) for x in fields[2].split(",")]
            segments[(chrom, tint)] = list(zip(pos[:-1], pos[1:]))
            continue
        if fields[0].startswith("isoform_"):
            continue
        if fields[7] == "*":
            continue
        read = dict(
            rid=int(fields[0]),
            rname=fields[1],
            chrom=fields[2],
            strand=fields[3],
            tint=int(fields[4]),
            pid=int(fields[5]),
            tail=fields[6],
            iid=int(fields[7]),
            data=fields[8],
        )
        assert len(read["data"]) == len(segments[(read["chrom"], read["tint"])])
        reads[read["rid"]] = read
        key = (read["chrom"], read["tint"], read["pid"], read["iid"])
        isoforms.setdefault(key, dict(rids=set()))["rids"].add(read["rid"])
    for isoform in isoforms.values():
        lens = {len(reads[rid]["data"]) for rid in isoform["rids"]}
        assert len(lens) == 1
    return segments, reads, isoforms


def parse_split_alignment_boundaries(path: str, reads: dict) -> None:
    """Attach per-read alignment interval starts/ends from the split TSV
    (py/freddie_isoforms.py:143-156). Uses the C parser when available
    (it already asserts every interval is nonempty); falls back to the
    line parser otherwise."""
    mod = _load_tsvparse()
    if mod is not None:
        from .bam import CIGAR_OPS

        try:
            _c, _t, _iv, _n, rows, _reps = mod.parse_split_file(path, CIGAR_OPS)
        except Exception:
            rows = None
        if rows is not None:
            for rid, _name, _chrom, _strand, _tint, ivs in rows:
                if rid not in reads:
                    continue
                reads[rid]["starts"] = tuple(iv[0] for iv in ivs)
                reads[rid]["ends"] = tuple(iv[1] for iv in ivs)
            return
    for line in open(path):
        if line.startswith("#"):
            continue
        fields = line.rstrip("\n").split("\t")
        rid = int(fields[0])
        if rid not in reads:
            continue
        pairs = [f.split(":")[0].split("-") for f in fields[5:]]
        starts, ends = zip(*[(int(a), int(b)) for a, b in pairs])
        for s, e in zip(starts, ends):
            assert s < e
        reads[rid]["starts"] = starts
        reads[rid]["ends"] = ends
