"""Set-up time: from the process's start (its start time in /proc) to the
first timed pass, warm-up passes included."""


def read(run):
    return run.setup_s
