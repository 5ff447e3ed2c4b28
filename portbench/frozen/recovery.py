"""Recovery of simulated isoforms from a GTF.

Frozen copy of ``freddie_tpu_torch/bench/common.py:gtf_chains`` and
``recovery``, with the tolerances passed in: a truth isoform is recovered
when a reported transcript has the same exon count, internal boundaries
within ``internal_tol`` and ends within ``end_tol``.
"""

from __future__ import annotations


def gtf_chains(gtf: str) -> list[list[tuple[int, int]]]:
    """Every reported transcript's sorted exon chain."""
    got: dict[str, list] = {}
    with open(gtf) as f:
        for line in f:
            fields = line.split("\t")
            if len(fields) > 4 and fields[2] == "exon":
                tid = line.split('transcript_id "')[1].split('"')[0]
                got.setdefault(tid, []).append((int(fields[3]), int(fields[4])))
    return [sorted(v) for v in got.values()]


def recovery(gtf: str, truth, internal_tol: int, end_tol: int) -> tuple[int, int]:
    """(truth isoforms recovered, transcripts reported)."""
    chains = gtf_chains(gtf)

    def matches(t, g):
        if len(t) != len(g):
            return False
        tb = [b for ex in t for b in ex]
        gb = [b for ex in g for b in ex]
        return all(
            abs(a - b) <= (end_tol if i in (0, len(tb) - 1) else internal_tol)
            for i, (a, b) in enumerate(zip(tb, gb))
        )

    return sum(1 for t in truth if any(matches(list(t), g) for g in chains)), len(chains)
