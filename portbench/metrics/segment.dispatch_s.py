"""The host side of the DP dispatch, in seconds a pass: the program's
``segment.dispatch`` spans (one a chunk: padding, the coverage build,
the copies and K1's launch) over the traced passes, divided by their
count."""

from portbench.spans import per_pass


def read(run):
    return per_pass(run, "segment.dispatch")
