"""The share of the traced window, in %, in which no kernel, copy or fill
ran on the card (``trace.reduce_trace``): 100 (1 - busy / window)."""


def read(run):
    t = run.traced
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
