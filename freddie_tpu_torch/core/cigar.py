"""CIGAR algebra: converting a splice alignment into exonic intervals.

Semantics match the reference's interval extraction
(py/freddie_split.py:63-207):

- Deletions (D) longer than ``max_del_size`` are reclassified as introns (N).
- Each maximal run between introns becomes one exonic interval
  (tstart, tend, qstart, qend, cigar), 0-based half-open on both target and
  query, where the per-interval cigar holds only exon-consuming ops
  (M/I/D/=/X after the D->N rewrite).
- Soft clips shift the query window; hard clips are not expected on primary
  alignments (supplementary/secondary are filtered upstream).
"""

from __future__ import annotations

from ..io.bam import (
    CDEL,
    CDIFF,
    CEQUAL,
    CINS,
    CMATCH,
    CREF_SKIP,
    CSOFT_CLIP,
)

QUERY_CONSUMING = frozenset({CINS, CSOFT_CLIP, CMATCH, CEQUAL, CDIFF})
TARGET_CONSUMING = frozenset({CDEL, CMATCH, CEQUAL, CDIFF})
EXON_CONSUMING = frozenset({CINS, CDEL, CMATCH, CEQUAL, CDIFF})
TARGET_AND_QUERY = frozenset({CMATCH, CEQUAL, CDIFF})

# An exonic interval of one alignment:
# (target_start, target_end, query_start, query_end, [(op, len), ...])
Interval = tuple[int, int, int, int, list[tuple[int, int]]]


def alignment_intervals(
    cigar: list[tuple[int, int]],
    reference_start: int,
    query_length: int,
    max_del_size: int = 20,
) -> list[Interval]:
    """Split one alignment into exonic intervals at introns.

    ``query_length`` must equal the stored sequence length (the sum of
    query-consuming op lengths); asserted like the reference does
    (py/freddie_split.py:142).
    """
    assert cigar, "empty CIGAR"
    qstart = cigar[0][1] if cigar[0][0] == CSOFT_CLIP else 0
    qlen = sum(c for t, c in cigar if t in QUERY_CONSUMING)
    assert qlen == query_length, (qlen, query_length)
    qend = qlen
    if cigar[-1][0] == CSOFT_CLIP:
        qend -= cigar[-1][1]
    assert qend > qstart

    intervals: list[Interval] = []
    q_lo = q_hi = qstart
    t_lo = t_hi = reference_start
    interval_cigar: list[tuple[int, int]] = []
    for t, c in cigar:
        assert 0 <= t < 10, t
        if t == CDEL and c > max_del_size:
            t = CREF_SKIP
        if t in EXON_CONSUMING:
            interval_cigar.append((t, c))
        if t == CDEL:
            t_hi += c
        elif t == CINS:
            q_hi += c
        elif t in TARGET_AND_QUERY:
            t_hi += c
            q_hi += c
        if t == CREF_SKIP:
            intervals.append((t_lo, t_hi, q_lo, q_hi, interval_cigar))
            interval_cigar = []
            t_hi += c
            t_lo = t_hi
            q_lo = q_hi
    if t_lo < t_hi:
        intervals.append((t_lo, t_hi, q_lo, q_hi, interval_cigar))
    return intervals


def cigar_to_str(cigar: list[tuple[int, int]]) -> str:
    from ..io.bam import CIGAR_OPS

    return "".join(f"{c}{CIGAR_OPS[t]}" for t, c in cigar)


_CIGAR_RE = None


def str_to_cigar(s: str) -> list[tuple[int, int]]:
    from ..io.bam import CIGAR_OP_CODE

    global _CIGAR_RE
    if _CIGAR_RE is None:
        import re

        _CIGAR_RE = re.compile(r"(\d+)([A-Z=])")
    return [(CIGAR_OP_CODE[op], int(n)) for n, op in _CIGAR_RE.findall(s)]
