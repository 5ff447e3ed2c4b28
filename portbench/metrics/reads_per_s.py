"""Reads a second through the whole pipeline: the reads of every pass of
the window over the time from the first pass's start to the last pass's
end (the last pass runs to its end, and the window ends with it)."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(p.reads for p in run.passes) / run.window_s
