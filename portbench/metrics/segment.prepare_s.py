"""Segment phase A's seconds a pass: the program's ``segment.prepare``
spans (one a tint: parse, splice signal, coverage, float surface, DP
slicing) over the traced passes, divided by their count."""

from portbench.spans import per_pass


def read(run):
    return per_pass(run, "segment.prepare")
