"""Alignment orchestration: minimap2 splice alignment -> sorted BAM.

The reference's Snakefile runs `minimap2 -a -x splice | samtools sort &&
samtools index` as its first rule (Snakefile:30-47).
Here the same step is a library/workflow function with no samtools
dependency: minimap2's SAM stream is parsed directly and written as a
coordinate-sorted BAM by this package's own codec (io.bam.BamWriter).
No .bai index is produced -- the split stage streams the whole BAM and
never seeks (unlike pysam's fetch), so an index is unnecessary.

minimap2 itself remains an external binary, exactly as in the reference
(its conda env, envs/minimap2.yml); `minimap2_available()` gates the
workflow step with a clear error when it is absent.
"""

from __future__ import annotations

import shutil
import subprocess

from .bam import CIGAR_OP_CODE, BamRecord, BamWriter


def minimap2_available(binary: str = "minimap2") -> bool:
    return shutil.which(binary) is not None


def parse_sam_line(line: str, ref_id: dict[str, int]) -> BamRecord | None:
    """One SAM alignment line -> BamRecord (None for unparseable/unmapped
    records with no coordinate)."""
    f = line.rstrip("\n").split("\t")
    if len(f) < 11:
        return None
    flag = int(f[1])
    rname = f[2]
    cigar = []
    if f[5] != "*":
        num = 0
        for ch in f[5]:
            if ch.isdigit():
                num = num * 10 + ord(ch) - 48
            else:
                cigar.append((CIGAR_OP_CODE[ch], num))
                num = 0
    return BamRecord(
        query_name=f[0],
        flag=flag,
        reference_id=ref_id.get(rname, -1),
        reference_start=int(f[3]) - 1,
        mapq=int(f[4]) if f[4] != "*" else 255,
        cigartuples=cigar,
        query_sequence=f[9] if f[9] != "*" else "",
        reference_name=rname if rname != "*" else None,
    )


def sam_to_sorted_bam(sam_lines, out_bam: str) -> int:
    """Consume a SAM text stream (header + alignments), coordinate-sort in
    memory, and write a BAM; returns the number of records written.

    This replaces the reference's `samtools sort` stage. Records are held
    in RAM -- fine for the read counts the downstream caps are built for
    (minimap2's own index of the genome dominates memory anyway).
    """
    references: list[str] = []
    lengths: list[int] = []
    records: list[BamRecord] = []
    ref_id: dict[str, int] = {}
    for line in sam_lines:
        if line.startswith("@"):
            if line.startswith("@SQ"):
                fields = dict(
                    kv.split(":", 1) for kv in line.rstrip("\n").split("\t")[1:]
                    if ":" in kv
                )
                ref_id[fields["SN"]] = len(references)
                references.append(fields["SN"])
                lengths.append(int(fields["LN"]))
            continue
        rec = parse_sam_line(line, ref_id)
        if rec is not None:
            records.append(rec)
    # Coordinate sort: unmapped (ref_id -1) last, like samtools.
    records.sort(
        key=lambda r: (r.reference_id if r.reference_id >= 0 else 1 << 30,
                       r.reference_start)
    )
    w = BamWriter(out_bam, references, lengths)
    for rec in records:
        w.write(rec)
    w.close()
    return len(records)


def align_reads(
    genome_fasta: str,
    read_files: list[str],
    out_bam: str,
    threads: int = 4,
    binary: str = "minimap2",
) -> int:
    """minimap2 -a -x splice (the reference's exact preset,
    Snakefile:45-47) -> coordinate-sorted BAM; returns records written."""
    if not minimap2_available(binary):
        raise RuntimeError(
            "minimap2 not found on PATH; install it or provide a pre-aligned "
            "sorted BAM (the reference has the same external dependency, "
            "envs/minimap2.yml)"
        )
    proc = subprocess.Popen(
        [binary, "-a", "-x", "splice", "-t", str(threads), genome_fasta]
        + list(read_files),
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )
    assert proc.stdout is not None
    n = sam_to_sorted_bam(proc.stdout, out_bam)
    proc.stdout.close()
    stderr = proc.stderr.read() if proc.stderr else ""
    if proc.wait() != 0:
        raise RuntimeError(f"minimap2 failed: {stderr[-2000:]}")
    return n
