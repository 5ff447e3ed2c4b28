"""K1's share of its roofline, in %: over the traced passes, the sum of
the least time the card could take for each K1 call (``frozen.bound``,
from the call's (B, P, R) and its ``n_cand``) over the device time of
the same calls' kernels. Against the H100 SXM's published peaks at 700 W;
the run prints the card's power limit beside it."""

from portbench.frozen.bound import bound_ms


def read(run):
    t = run.traced
    if not t or not t["k1_ops"] or not t["k1_calls"]:
        return None
    bound = sum(bound_ms(B, P, R, n)[0] for (B, P, R), n in t["k1_calls"])
    device_ms = sum(e - s for _n, s, e in t["k1_ops"]) * 1e-6
    return 100.0 * bound / device_ms
