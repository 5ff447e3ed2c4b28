"""Holds one checked pass's outputs to the reference; decides ``correct``.

Seven numbers, each an exact comparison with the limit 0 (PERF.md gives
the readings the limits rest on):

- ``split_wrong``: tints and read intervals of the split TSVs that differ
  from the reference's reading of the BAM (``split``);
- ``coverage_wrong``: DP problems whose coverage and weights, as phase A
  built them, differ by distinct column from the reference's, worked out
  from the tint's reads in the BAM at the problem's candidates
  (``segments.read_columns``);
- ``dp_wrong``: DP problems of the pass whose answer, as the segment
  stage's phase C received it, differs from the float64 reference DP
  (``segdp``) on the reference's own operands: that coverage, the
  candidates' positions and the reads' counts;
- ``breaks_missing``: breakpoints of the reference's answers (and the
  fixed ones) missing from the segment TSVs;
- ``dp_unseen``: segment TSVs whose tint's DP answers the harness's
  capture did not see (so that ``dp_wrong`` cannot pass unread);
- ``genotype_wrong``: segment TSV read rows whose genotypes differ from
  the reference's (``segments``);
- ``gtf_wrong``: GTF transcript records that differ from the reference's
  isoforms stage over the pass's cluster TSVs (``isoforms``).

What the reference follows from the program and does not restate: each
problem's candidate positions (phase A's smoothing, peaks and fixed
breakpoints) and the cluster stage's read-to-isoform assignment.

With ``control`` the same two numbers of DP answers and genotypes are
also read with the reference computed in float32, the precision below
the original's float64, put in the program's place: the control, which
has to fail them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import isoforms, segdp, segments, split


def operands(captured: dict, found: dict, by_name: dict):
    """The DP problems of a pass with their operands worked out again: for
    each problem, its key, the reference's operands (C, y, W: the tint's
    reads' coverage from the BAM at the program's candidates y, by
    distinct column), the program's answer, and whether phase A's own C
    and weights, by distinct column, differ from the reference's. A
    problem whose tint has no segment TSV gets no operands (None)."""
    out = []
    for key, (ivs, probs) in captured.items():
        ref = found.get(key)
        if ref is None or len(ref[0]) != len(ivs):
            out.extend((key + (pid,), None, probs[pid][3], True)
                       for iv in ivs for pid in iv[3])
            continue
        reads = [by_name.get(name, []) for name in ref[2]]
        for k, (cands, _fixed, bounds, pids) in enumerate(ivs):
            cols = segments.read_columns(ref[0], k, cands, reads)
            for (s_c, e_c), pid in zip(bounds, pids):
                C, y, W, answer = probs[pid]
                mine = segments.by_column(cols[:, s_c : e_c + 1].T,
                                          np.ones(len(reads), dtype=np.int64))
                theirs = segments.by_column(np.asarray(C), np.asarray(W))
                differs = not (np.array_equal(mine[0], theirs[0])
                               and np.array_equal(mine[1], theirs[1]))
                out.append((key + (pid,), (mine[0].T, np.asarray(y, dtype=np.int64), mine[1]),
                            answer, differs))
    return out


def run_checks(config: dict, bam: str, outdir: str, captured: dict, device="cpu",
               control: bool = False):
    """([(number, value, limit)], what was checked, and with ``control`` the
    control's [(number, value, limit)], else None)."""
    p = config["pipeline"]
    s_cfg, g_cfg, i_cfg = p["split"], p["segment"], p["isoforms"]
    rate, support = g_cfg["threshold_rate"], g_cfg["min_read_support_outside"]
    by_name, kept = split.bam_reads(bam, s_cfg["max_del_size"])
    ref_tints = split.reference_tints(kept, s_cfg["min_reads_per_tint"],
                                      s_cfg["max_tint_intervals"], s_cfg["max_tint_reads"])
    numbers = [("split_wrong", segments.split_mismatches(os.path.join(outdir, "split"),
                                                         ref_tints, by_name), 0)]
    wrong, rows, found = segments.genotype_mismatches(os.path.join(outdir, "segment"),
                                                      ref_tints, by_name, rate)

    work = operands(captured, found, by_name)
    numbers.append(("coverage_wrong", sum(1 for *_x, differs in work if differs), 0))
    solvable = [w for w in work if w[1] is not None]
    ours = segdp.solve_all([w[1] for w in solvable], support, rate, device)
    numbers.append(("dp_wrong", sum(a != b for a, (_k, _o, b, _d) in zip(ours, solvable))
                    + len(work) - len(solvable), 0))
    controls = None
    if control:
        low = segdp.solve_all([w[1] for w in solvable], support, rate, device,
                              dtype=torch.float32)
        low_rows = segments.genotype_mismatches(os.path.join(outdir, "segment"), ref_tints,
                                                by_name, rate, control=True)[0]
        controls = [("dp_wrong", sum(a != b for a, b in zip(ours, low)), 0),
                    ("genotype_wrong", low_rows, 0)]

    answers = {k: a for (k, *_r), a in zip(solvable, ours)}
    intervals = {k: ivs for k, (ivs, _p) in captured.items()}
    numbers.append(("breaks_missing", segments.breakpoints_missing(intervals, answers, found), 0))
    # a tint whose answers the capture did not see would pass the DP check
    # unread: each one counts
    numbers.append(("dp_unseen", len(set(segments.segment_tints(os.path.join(outdir, "segment")))
                                     - set(captured)), 0))
    numbers.append(("genotype_wrong", wrong, 0))
    want = isoforms.reference_gtf(os.path.join(outdir, "cluster"), by_name,
                                  i_cfg["majority_threshold"], i_cfg["correction_window"])
    numbers.append(("gtf_wrong", isoforms.gtf_mismatches(os.path.join(outdir, "isoforms.gtf"),
                                                         want), 0))
    seen = dict(tints=len(ref_tints), dp_problems=len(work),
                dp_problems_segmented=sum(1 for a in ours if a), segment_rows=rows,
                gtf_records=len(want))
    return numbers, seen, controls
