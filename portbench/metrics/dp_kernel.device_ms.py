"""K1's device time a pass, in ms: the profiler's durations of its kernels
(``pair_stats_kernel``, ``wavefront*``) over the traced passes, divided
by their count."""


def read(run):
    t = run.traced
    if not t or not t["k1_ops"]:
        return None
    return sum(e - s for _n, s, e in t["k1_ops"]) * 1e-6 / t["passes"]
