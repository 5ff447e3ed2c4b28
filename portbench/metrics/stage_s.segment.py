"""The segment stage's seconds per pass: the StageMetrics seconds that
run_pipeline returns, summed over the window's passes and divided by
their count."""

STAGE = "segment"


def read(run):
    got = [p.stage_s[STAGE] for p in run.passes if p.ok and STAGE in p.stage_s]
    return sum(got) / len(got) if got else None
