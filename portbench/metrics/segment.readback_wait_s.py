"""Seconds a pass that the segment stage's own thread is blocked on DP
answers: the program's ``segment.readback_wait`` spans (one a chunk: the
readback thread's result and the chains' walk) over the traced passes,
divided by their count."""

from portbench.spans import per_pass


def read(run):
    return per_pass(run, "segment.readback_wait")
