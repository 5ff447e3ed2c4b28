"""The split and segment TSVs of a checked pass, held to the reference.

- ``split_mismatches``: the program's tints (contig, intervals, read
  names) and each read's intervals against ``split.reference_tints`` and
  ``split.bam_reads``.
- ``genotype_mismatches``: every read row of every segment TSV. Given the
  TSV's breakpoints, a read's genotype of the segment [p, q) of a tint
  interval starting at s is 1 where its coverage c of [p - s, q - s)
  (each aligned interval [ts, te) counted over ts - s .. te - s, both
  ends, as the original freddie counts it) reads yes over the length
  L = q - p + 1, 0 where it reads no, else 2, in float64
  (``thresholds.verdicts``); the segment between two tint intervals is 0.
  The tint intervals are the reference's, found by the TSV's read names.
- ``breakpoints_missing``: every breakpoint the reference DP chose, and
  every fixed one, must be among the TSV's positions.
- ``read_columns``: a tint's reads' cumulative coverage at candidate
  positions, from their BAM intervals: the DP's operands, worked out
  again (``check``).

The soft-clip, gap and polyA annotations of the rows (the last column)
are not checked.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .thresholds import verdicts


def _tsvs(root: str, prefix: str):
    for contig in sorted(os.listdir(root)):
        d = os.path.join(root, contig)
        if os.path.isdir(d):
            for fn in sorted(os.listdir(d)):
                if fn.startswith(prefix) and fn.endswith(".tsv"):
                    yield os.path.join(d, fn)


def segment_tints(segment_dir: str) -> list[tuple[str, int]]:
    """(contig, tint id) of every segment TSV."""
    out = []
    for path in _tsvs(segment_dir, "segment_"):
        with open(path) as f:
            head = f.readline().split("\t")
        out.append((head[0][1:], int(head[1])))
    return out


def read_split_dir(split_dir: str) -> list[tuple[str, int, tuple, dict]]:
    """[(contig, tint id, intervals, {read name: [(ts, te), ...]})]"""
    out = []
    for path in _tsvs(split_dir, "split_"):
        with open(path) as f:
            head = f.readline().rstrip("\n").split("\t")
            ivs = tuple(tuple(int(v) for v in p.split("-")) for p in head[2].split(","))
            reads = {}
            for line in f:
                fields = line.rstrip("\n").split("\t")
                reads[fields[1]] = [tuple(int(v) for v in iv.split(":")[0].split("-"))
                                    for iv in fields[5:]]
        out.append((head[0][1:], int(head[1]), ivs, reads))
    return out


def split_mismatches(split_dir: str, ref_tints: list, by_name: dict) -> int:
    """Tints in one set and not the other, plus reads whose intervals
    differ from the BAM's."""
    got = read_split_dir(split_dir)
    mine = {(c, ivs, frozenset(reads)) for c, _t, ivs, reads in got}
    theirs = set(ref_tints)
    wrong = len(mine ^ theirs)
    for _c, _t, _ivs, reads in got:
        wrong += sum(1 for name, ivs in reads.items() if by_name.get(name) != ivs)
    return wrong


def read_segment_tsv(path: str):
    """(contig, tint id, positions, [(read name, genotype string)])"""
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t")
        rows = [(fl[1], fl[5]) for fl in (line.rstrip("\n").split("\t") for line in f)]
    return head[0][1:], int(head[1]), [int(v) for v in head[2].split(",")], rows


def _home(tint_ivs, reads_ivs):
    """Every aligned interval of the reads as (read, ts, te, tint interval)
    arrays, each interval placed in the tint interval it starts in."""
    flat = [(r, ts, te) for r, ivs in enumerate(reads_ivs) for ts, te in ivs]
    rid, ts, te = (np.array(c, dtype=np.int64) for c in zip(*flat)) if flat else (
        np.zeros(0, np.int64),) * 3
    starts = np.array([s for s, _e in tint_ivs], dtype=np.int64)
    return rid, ts, te, np.searchsorted(starts, ts, side="right") - 1


def read_columns(tint_ivs, k: int, cands, reads_ivs) -> np.ndarray:
    """(reads, candidates) int64: each read's bases in tint interval ``k``
    that lie before each candidate y (y-space, from the interval's start
    s): the sum over its aligned intervals there of max(0, min(te - s,
    y - 1) - (ts - s) + 1). The DP's cumulative coverage C, one column a
    read."""
    rid, ts, te, home = _home(tint_ivs, reads_ivs)
    s, e = tint_ivs[k]
    m = (home == k) & (ts <= e)
    ys, ye = ts[m] - s, te[m] - s
    y = np.asarray(cands, dtype=np.int64)
    over = np.clip(np.minimum(ye[:, None], y[None, :] - 1) - ys[:, None] + 1, 0, None)
    cols = np.zeros((len(reads_ivs), len(y)), dtype=np.int64)
    np.add.at(cols, rid[m], over)
    return cols


def by_column(C: np.ndarray, W: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A DP problem's coverage (P, R) and weights (R,) as its distinct
    columns, sorted, each with the sum of its weights: the DP's every sum
    runs over the columns weighted, so two problems that agree here have
    one answer."""
    cols, inv = np.unique(np.ascontiguousarray(C.T), axis=0, return_inverse=True)
    return cols, np.bincount(inv.reshape(-1), weights=W, minlength=len(cols)).astype(np.int64)


def genotypes(tint_ivs, positions, reads_ivs, rate: float,
              dtype=torch.float64) -> list[str] | None:
    """Each read's genotype string, or None where the positions do not fall
    into the tint's intervals."""
    pos = np.asarray(positions, dtype=np.int64)
    n = len(reads_ivs)
    rid, ts, te, home = _home(tint_ivs, reads_ivs)
    parts = []
    taken = 0
    for k, (s, e) in enumerate(tint_ivs):
        fy = pos[(pos >= s) & (pos <= e)] - s
        taken += len(fy)
        if len(fy) == 0:
            return None
        lo, hi = fy[:-1], fy[1:] - 1  # segment i covers lo[i]..hi[i]
        m = (home == k) & (ts <= e)
        ys, ye = ts[m] - s, te[m] - s
        over = np.clip(np.minimum(ye[:, None], hi[None, :])
                       - np.maximum(ys[:, None], lo[None, :]) + 1, 0, None)
        cov = np.zeros((n, len(lo)), dtype=np.int64)
        np.add.at(cov, rid[m], over)
        seg_len = torch.from_numpy(fy[1:] - fy[:-1] + 1)[None, :]
        yes, no = verdicts(torch.from_numpy(cov), seg_len, rate, dtype)
        g = np.where(yes.numpy(), 1, np.where(no.numpy(), 0, 2))
        if k:
            parts.append(np.zeros((n, 1), dtype=g.dtype))
        parts.append(g)
    if taken != len(pos):
        return None
    table = np.frombuffer(b"012", dtype=np.uint8)
    g = np.concatenate(parts, axis=1)
    return [table[row].tobytes().decode() for row in g]


def genotype_mismatches(segment_dir: str, ref_tints: list, by_name: dict, rate: float,
                        control: bool = False):
    """(read rows whose genotypes differ, rows checked, {(contig, tint id):
    (reference intervals, TSV positions, read names)}). With ``control`` the rows
    held to the reference are the reference's own in float32, in the
    program's place."""
    tint_of = {names: ivs for _c, ivs, names in ref_tints}
    wrong = checked = 0
    found = {}
    for path in _tsvs(segment_dir, "segment_"):
        contig, tid, positions, rows = read_segment_tsv(path)
        checked += len(rows)
        ivs = tint_of.get(frozenset(name for name, _d in rows))
        reads = [by_name.get(name, []) for name, _d in rows]
        got = None if ivs is None else genotypes(ivs, positions, reads, rate)
        if got is None:
            wrong += len(rows)
            continue
        found[(contig, tid)] = (ivs, set(positions), [name for name, _d in rows])
        if control:
            rows = list(zip([n for n, _d in rows],
                            genotypes(ivs, positions, reads, rate, torch.float32)))
        wrong += sum(1 for (_n, data), want in zip(rows, got) if data != want)
    return wrong, checked, found


def breakpoints_missing(captured: dict, answers: dict, found: dict) -> int:
    """Breakpoints of the reference (fixed ones and those its DP chose)
    absent from the TSV positions. ``captured[(contig, tint)]`` holds the
    pass's intervals as phase C received them: (candidates, fixed, problem
    bounds, problem ids); ``answers[(contig, tint, pid)]`` the reference
    DP's answer."""
    missing = 0
    for key, intervals in captured.items():
        if key not in found or len(found[key][0]) != len(intervals):
            missing += sum(len(iv[1]) for iv in intervals) or 1
            continue
        ivs, positions = found[key][:2]
        for (s, _e), (cands, fixed, bounds, pids) in zip(ivs, intervals):
            want = set(fixed)
            for (s_c, _e_c), pid in zip(bounds, pids):
                want.update(s_c + local for local in answers[key + (pid,)])
            missing += sum(1 for c in want if s + cands[c] not in positions)
    return missing
