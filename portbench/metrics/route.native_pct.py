"""The share of tints, in %, that took the native engines: the program's
``route.native`` and ``route.fallback`` counters (one a tint at each
stage that has a native twin: segment phases A and C, the DP on the
card, cluster, isoforms) over the traced passes,
100 native / (native + fallback)."""

from portbench.spans import counts, recorded


def read(run):
    spans = recorded(run)
    if spans is None:
        return None
    got = counts(spans)
    native, fallback = got.get("route.native", 0), got.get("route.fallback", 0)
    return 100.0 * native / (native + fallback) if native + fallback else None
