"""Simulated inputs the port's checks drive it with.

``simulate`` is the JAX package's jax-free read simulator (spliced
transcripts -> noisy aligned reads -> BAM + FASTQ, with the truth
isoforms), re-exported. ``clustered_instance`` makes cluster-solver
instances from a numpy generator, shaped as the JAX package's solver
tests make them (tests/test_segenum_wide.py), so that a machine without
JAX and without the test suite can build the same instances.
``BENCH_CORPUS`` is the benchmark corpus's ``simulate`` arguments.
"""

from __future__ import annotations

import numpy as np

from freddie_tpu.solver.exact import ClusterInstance, ReadRow
from freddie_tpu.utils.sim import simulate  # noqa: F401

# The benchmark corpus (bench.py): 96 genes x 3 isoforms x 90 reads,
# noisy, 25,920 reads. Its 96 tints pass the device-coverage gate (64),
# so the segment stage's coverage build on the device and K1 both run.
BENCH_CORPUS = dict(
    seed=9001, n_genes=96, isoforms_per_gene=3, reads_per_isoform=90,
    minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8,
    end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6,
    big_del_rate=0.06,
)


def clustered_instance(rng, N, M, k_true=3) -> ClusterInstance:
    """N reads clustered around k_true random exon structures, with exons
    dropped as correctable (corr) segments and no conflicts: the shape
    real Mi > 20 instances take, where the optimistic filter of the wide
    rung bites hard."""
    trues = [rng.random(M) < 0.5 for _ in range(k_true)]
    rows = []
    for _ in range(N):
        base = trues[int(rng.integers(k_true))].copy()
        corr = np.zeros(M, dtype=bool)
        for j in np.flatnonzero(rng.random(M) < 0.08):
            if base[j]:
                base[j] = False
                corr[j] = True
        rows.append(ReadRow(exons=base, corr=corr,
                            garbage=3.0 * float(rng.integers(1, 4)), gaps=[]))
    return ClusterInstance(rows=rows, seg_len=rng.integers(50, 2000, size=M),
                           incomp=[], epsilon=0.2, offset=20)
