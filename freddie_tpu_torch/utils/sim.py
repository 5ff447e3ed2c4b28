"""Simulated inputs the port's checks drive it with.

``simulate`` is the JAX package's jax-free read simulator (spliced
transcripts -> noisy aligned reads -> BAM + FASTQ, with the truth
isoforms), re-exported. ``clustered_instance`` makes cluster-solver
instances from a numpy generator, shaped as the JAX package's solver
tests make them (tests/test_segenum_wide.py), so that a machine without
JAX and without the test suite can build the same instances.
"""

from __future__ import annotations

import numpy as np

from freddie_tpu.solver.exact import ClusterInstance, ReadRow
from freddie_tpu.utils.sim import simulate  # noqa: F401


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
