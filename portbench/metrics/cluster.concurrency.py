"""How many threads the cluster stage keeps busy: the seconds of the
program's ``cluster.tint`` spans (one a tint, in whichever thread ran
it) over those of its ``stage.cluster`` spans, in the traced passes.
From 1 to the stage's threads; None where no tint ran in this process
(the stage's process pool)."""

from portbench.spans import recorded, seconds


def read(run):
    spans = recorded(run)
    if spans is None:
        return None
    stage = seconds(spans, ("stage.cluster",))
    tints = seconds(spans, ("cluster.tint",))
    return tints / stage if stage > 0 and tints > 0 else None
