"""Segment phase C's seconds a pass: the program's ``segment.finalize``
spans (one a tint: final breakpoints, genotypes, annotation and its
write) and its ``segment.polya_batch`` span (phases C2 and C3) over the
traced passes, divided by their count."""

from portbench.spans import per_pass


def read(run):
    return per_pass(run, "segment.finalize", "segment.polya_batch")
