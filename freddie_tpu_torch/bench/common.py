"""What the port's benchmarks, tools and ``chip_smoke.py`` share: the
benchmark corpus, synthetic DP batches, CUDA-event timing, the card's
bound for one DP call, recovery against simulation truth and TSV
comparison."""

from __future__ import annotations

import filecmp
import os
import statistics
import subprocess

import numpy as np
import torch

from ..utils.sim import BENCH_CORPUS, simulate

# The kernel benchmark's (B, P, R) and the three launches the segment
# stage makes on the benchmark corpus.
KERNEL_SHAPE = (2048, 64, 512)
STAGE_SHAPES = [(512, 16, 384), (64, 32, 384), (64, 64, 384)]
# The structure-check mode (6 genes x 20 reads, a tiny kernel shape).
SMALL_CORPUS = dict(BENCH_CORPUS, n_genes=6, reads_per_isoform=20)
SMALL_KERNEL_SHAPE = (16, 16, 128)
TIMED_REPS = 5


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_dataset(workdir: str, corpus: dict = BENCH_CORPUS):
    """Simulates ``corpus`` into ``workdir``; returns (bam, fastq, number
    of reads, truth, reachable truth). Truth is every simulated isoform's
    exon chain; reachable truth keeps the isoforms with at least 3
    full-length reads (truncated reads support shorter chains by design,
    and min_isoform_size = 3 is the floor for reporting an isoform)."""
    sim = simulate(**corpus)
    bam, fq = os.path.join(workdir, "reads.bam"), os.path.join(workdir, "reads.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    truth = sorted(tuple(t.exons) for t in sim.transcripts)
    n_exons = {t.name: len(t.exons) for t in sim.transcripts}
    full: dict[str, int] = {}
    for r in sim.reads:
        if len(r.exons) == n_exons[r.transcript]:
            full[r.transcript] = full.get(r.transcript, 0) + 1
    reachable = sorted(tuple(t.exons) for t in sim.transcripts if full.get(t.name, 0) >= 3)
    return bam, fq, len(sim.reads), truth, reachable


def synthetic_batch(rng, B, P, R, wide, short=False):
    """Padded DP batch with varied candidate counts (P/2..P, or 3..P/4 when
    ``short``): monotone coverage with plateaus and jumps
    (tests/test_segdp.py), sorted positions, weights 1..4 times ``wide``
    when it is a number, x97 (past the 7-bit range) when it is True."""
    inc = rng.integers(0, 12, size=(B, P, R))
    inc[rng.random(size=(B, P, R)) < 0.5] = 0
    C = np.cumsum(inc, axis=1).astype(np.int32)
    y = np.sort(rng.integers(1, 20_000, size=(B, P)), axis=1).astype(np.int32)
    y[:, 0] = 0
    lo, hi = (3, max(4, P // 4)) if short else (max(3, P // 2), P)
    n_cand = rng.integers(lo, hi + 1, size=B).astype(np.int32)
    for b in range(B):
        n = n_cand[b]
        C[b, n:] = C[b, n - 1]
        y[b, n:] = y[b, n - 1]
    factor = 97 if wide is True else (int(wide) or 1)
    W = rng.integers(1, 5, size=(B, R)).astype(np.float32) * factor
    if W.sum(axis=1).max() >= 2**24:
        raise ValueError("weights too large: scores must stay exact in float32")
    return dict(C=C, y=y, W=W, n_cand=n_cand)


# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate and dense int8 tensor-core rate, which the pair contraction's
# s8 x s8 -> s32 products run at.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def bound_ms(t, P: int) -> tuple[float, str, float, float]:
    """The least time the card could take for one solve_batch call on the
    batch ``t``: the larger of its bytes (C, y, W, n_cand read once; K,
    best_j, best_k and the chains written once) over the memory rate and
    its operations over the int8 peak. The operations are those this
    batch's data needs: per problem with n candidates, the C(n, 3) live
    triples j < k < k_ of the pair contraction, 2R multiply-adds each.
    Returns (bound, "bytes" or "operations", the bytes' time, the
    operations' time), in ms."""
    B, _P, R = t["C"].shape
    read = sum(t[k].numel() * t[k].element_size() for k in ("C", "y", "W", "n_cand"))
    written = 4 * (B * P * P + 2 * B + B * (P + 2))
    n = t["n_cand"].to("cpu").double()
    ops = float((n * (n - 1) * (n - 2) / 6).sum()) * 2 * R * 2
    by_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT8_OPS_PER_S * 1e3
    which = "bytes" if by_bytes >= by_ops else "operations"
    return max(by_bytes, by_ops), which, by_bytes, by_ops


def time_ms(fn, reps=TIMED_REPS) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


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


def recovery(gtf: str, truth, internal_tol: int | None = None,
             end_tol: int | None = None) -> tuple[int, int]:
    """(truth isoforms recovered, transcripts reported): a truth isoform is
    recovered when a reported transcript has the same exon count, internal
    boundaries within ``internal_tol`` and ends within ``end_tol``; by
    default the benchmark corpus's 2*junction_jitter+2 and end_jitter+15."""
    chains = gtf_chains(gtf)
    if internal_tol is None:
        internal_tol = 2 * BENCH_CORPUS["junction_jitter"] + 2
    if end_tol is None:
        end_tol = BENCH_CORPUS["end_jitter"] + 15

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


def tsv_tree(root: str) -> list[str]:
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _dirs, fns in os.walk(root) for f in fns if f.endswith(".tsv")
    )


def same_tsvs(a: str, b: str, what: str) -> list[str]:
    """The TSV names under a and b, after checking they are the same set,
    byte for byte."""
    names = tsv_tree(a)
    if not names or names != tsv_tree(b):
        raise RuntimeError(f"{what}: TSV sets differ ({len(names)} vs {len(tsv_tree(b))})")
    differ = [n for n in names if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                                                  shallow=False)]
    if differ:
        raise RuntimeError(f"{what}: TSVs differ: {differ[:5]}")
    return names
