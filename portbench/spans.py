"""The program's own spans and counters, as the per-layer readers read them.

The program records its spans (``freddie_tpu_torch.utils.metrics``:
``span``, ``count``, ``recorded``) only while a torch profiler records in
its process, so after a run they are those of the traced passes. Each is
stamped with ``time.time_ns()``, the profiler's clock, so they line up
with the device operations of ``run.traced["ops"]``. A program without
spans gives nothing to read: every function here then returns None.
"""

from __future__ import annotations


def recorded(run) -> list[dict] | None:
    """The closed spans of the traced passes, or None where the run was not
    traced or the program records no spans."""
    if not run.traced or not run.traced.get("passes"):
        return None
    try:
        from freddie_tpu_torch.utils.metrics import recorded as program_spans
    except ImportError:
        return None
    got = [s for s in program_spans() if s.get("end_ns") is not None]
    return got or None


def seconds(spans, names) -> float:
    """The spans named in ``names``, their seconds summed."""
    return sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] in names) * 1e-9


def per_pass(run, *names) -> float | None:
    """Seconds a traced pass in the spans ``names``; None where the program
    recorded none of them."""
    spans = recorded(run)
    if spans is None or not any(s["name"] in names for s in spans):
        return None
    return seconds(spans, names) / run.traced["passes"]


def counts(spans) -> dict:
    """Every counter, summed over ``spans``."""
    out: dict = {}
    for s in spans:
        for k, v in s["counts"].items():
            out[k] = out.get(k, 0) + v
    return out


def idle_by_span(spans, ops) -> dict:
    """The device's idle seconds inside the traced ``pipeline`` spans, each
    idle stretch named by the innermost span open on the pipeline's own
    thread at that time ("pipeline" where no other is). ``ops``:
    (name, start ns, end ns) of the device's work, ``run.traced["ops"]``."""
    busy = []
    for _n, s, e in sorted(ops, key=lambda o: o[1]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    out: dict = {}
    for pipe in (s for s in spans if s["name"] == "pipeline"):
        lo, hi = pipe["start_ns"], pipe["end_ns"]
        mine = [s for s in spans if s["pipeline"] == pipe["id"] and s["thread"] == pipe["thread"]]
        # the innermost open span changes only at a span's start or end
        cuts = sorted({lo, hi} | {t for s in mine for t in (s["start_ns"], s["end_ns"])
                                  if lo <= t <= hi})
        for a, b in zip(cuts[:-1], cuts[1:]):
            idle = b - a - sum(max(0, min(e, b) - max(s, a)) for s, e in busy)
            if idle <= 0:
                continue
            open_ = [s for s in mine if s["start_ns"] <= a and s["end_ns"] >= b]
            name = max(open_, key=lambda s: s["start_ns"])["name"] if open_ else "pipeline"
            out[name] = out.get(name, 0.0) + idle * 1e-9
    return out
