"""Reduces a ``torch.profiler`` trace of some passes to what the per-layer
metrics read: each device operation's name and interval, the device's
busy seconds inside the traced window, and the idle gaps named by the
pipeline stage the host was in.

The harness marks the window with ``record_function`` annotations, so the
marks and the device's operations share the profiler's clock:
``portbench.pass_begin``, ``portbench.pass_end`` and, when a stage ends,
``portbench.stage_done:<stage>``.
"""

from __future__ import annotations

import bisect

# What occupies the device: kernels, copies and fills. Annotations that
# the profiler mirrors onto the device's timeline are not work.
DEVICE_WORK = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
MARK = "portbench."


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events, stages: list[str]) -> dict:
    """``events``: (name, device, activity type, start ns, end ns) tuples,
    device "cpu" or "cuda". Returns ``ops`` [(name, start, end)] of the
    device's work inside the window, ``busy_s``, ``window_s``,
    ``gaps`` [(stage, seconds)] longest first (each idle
    stretch cut at the stage boundaries inside it), ``activities`` (the types
    seen on the device, for the record)."""
    begins = sorted(s for n, d, _a, s, _e in events if d == "cpu" and n == MARK + "pass_begin")
    ends = sorted(e for n, d, _a, _s, e in events if d == "cpu" and n == MARK + "pass_end")
    if not begins or not ends:
        return dict(ops=[], busy_s=0.0, window_s=0.0, gaps=[], activities=[])
    lo, hi = begins[0], ends[-1]
    # Stage boundaries: a pass starts in its first stage; each
    # stage_done mark moves it to the next stage of ``stages``.
    bounds = [(b, stages[0]) for b in begins]
    for n, d, _a, s, _e in events:
        if d == "cpu" and n.startswith(MARK + "stage_done:"):
            done = n.split(":", 1)[1]
            nxt = stages.index(done) + 1 if done in stages else len(stages)
            bounds.append((s, stages[nxt] if nxt < len(stages) else "between passes"))
    bounds.sort()
    keys = [b for b, _n in bounds]
    activities = sorted({a for _n, d, a, _s, _e in events if d == "cuda"})
    ops = [(n, max(s, lo), min(e, hi)) for n, d, a, s, e in events
           if d == "cuda" and a in DEVICE_WORK and e > lo and s < hi]
    busy = _union([(s, e) for _n, s, e in ops])
    gaps, cur = [], lo
    for s, e in busy + [[hi, hi]]:
        # an idle stretch, cut where the host moved to another stage
        t = cur
        while t < s:
            i = bisect.bisect_right(keys, t) - 1
            nxt = min(keys[i + 1] if i + 1 < len(keys) else s, s)
            gaps.append((bounds[i][1] if i >= 0 else stages[0], (nxt - t) * 1e-9))
            t = nxt
        cur = max(cur, e)
    gaps.sort(key=lambda g: -g[1])
    return dict(ops=ops, busy_s=sum(e - s for s, e in busy) * 1e-9, window_s=(hi - lo) * 1e-9,
                gaps=gaps, activities=activities)


def profiler_events(prof) -> list[tuple]:
    """The (name, device, activity type, start ns, end ns) of every event of
    a finished ``torch.profiler.profile``. Where the profiler's events do
    not say their activity type, a device event is work unless it is one
    of the harness's marks mirrored onto the device's timeline."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start, name = e.start_ns(), e.name()
        on_card = e.device_type() == cuda
        if hasattr(e, "activity_type"):
            kind = str(e.activity_type())
        elif on_card:
            kind = "gpu_user_annotation" if name.startswith(MARK) else "kernel"
        else:
            kind = "cpu"
        out.append((name, "cuda" if on_card else "cpu", kind, start, start + e.duration_ns()))
    return out


def top_ops(ops, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time: [[name, seconds]]."""
    total: dict[str, int] = {}
    for name, s, e in ops:
        total[name] = total.get(name, 0) + (e - s)
    return [[k, v * 1e-9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
