"""The frozen copies against the program's originals, and the reference DP
against the program's host oracle, at small sizes on the CPU."""

import filecmp

import numpy as np
import pytest
import torch

from portbench.frozen import bamio, sim
from portbench.reference import segdp, split


@pytest.mark.parametrize("seed", [7, 2147483659])
def test_the_frozen_simulator_writes_the_programs_bytes(tmp_path, seed):
    from freddie_tpu_torch.utils.sim import simulate

    kw = dict(n_genes=5, isoforms_per_gene=3, reads_per_isoform=12, minus_strand_genes=True,
              truncate_prob=0.2, tail_prob=0.8, end_jitter=25, indel_rate=0.1,
              alt_splice=True, junction_jitter=6, big_del_rate=0.06)
    ours, theirs = sim.simulate(seed=seed, **kw), simulate(seed=seed, **kw)
    for a, b, what in ((ours, tmp_path / "a", "ours"), (theirs, tmp_path / "b", "theirs")):
        a.write_bam(str(b) + ".bam")
        a.write_fastq(str(b) + ".fastq")
    for ext in (".bam", ".fastq"):
        assert filecmp.cmp(str(tmp_path / "a") + ext, str(tmp_path / "b") + ext, shallow=False)


def test_the_bam_reader_and_cigar_walk_match_the_programs(tmp_path):
    from freddie_tpu_torch.core.cigar import alignment_intervals
    from freddie_tpu_torch.io.bam import BamReader

    s = sim.simulate(seed=3, n_genes=3, reads_per_isoform=15, indel_rate=0.1, big_del_rate=0.1,
                     junction_jitter=6)
    path = str(tmp_path / "r.bam")
    s.write_bam(path)
    _refs, records = bamio.read_bam(path)
    with BamReader(path) as r:
        theirs = list(r)
    assert [x.query_name for x in records] == [x.query_name for x in theirs]
    for ours, t in zip(records, theirs):
        assert ours.cigartuples == t.cigartuples and ours.query_length == len(t.query_sequence)
        want = [(a, b) for a, b, c, d, _ in alignment_intervals(
            t.cigartuples, t.reference_start, len(t.query_sequence), 20) if a != b and c != d]
        assert split.exon_intervals(ours.cigartuples, ours.reference_start, 20) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_reference_dp_answers_as_the_programs_host_oracle(seed):
    from freddie_tpu_torch.ops.segdp import DPProblem, solve_host
    from freddie_tpu_torch.ops.thresholds import ScaledThresholds

    rng = np.random.default_rng(seed)
    thr = ScaledThresholds(0.9)
    problems = []
    for _ in range(24):
        P, R = int(rng.integers(3, 20)), int(rng.integers(1, 40))
        y = np.cumsum(rng.integers(1, 30, size=P))
        y[0] = 0
        # coverage of R reps, each covering y-space runs: monotone rows
        inc = rng.integers(0, 2, size=(P, R)) * np.diff(np.concatenate([[0], y]))[:, None]
        C = np.cumsum(inc, axis=0)
        W = rng.integers(1, 6, size=R)
        problems.append((C, y, W))
    ours = segdp.solve_all(problems, 3, 0.9)
    theirs = [solve_host(DPProblem(C=C, y=y, W=W, read_support=3), thr) for C, y, W in problems]
    assert ours == theirs
    assert any(ours)
    low = segdp.solve_all(problems, 3, 0.9, dtype=torch.float32)
    assert len(low) == len(ours)
