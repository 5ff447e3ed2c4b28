"""LP-assisted two-phase exact solve whose device rungs run on PyTorch.

Port of ``freddie_tpu/solver/two_phase.py``: the same escalation chain
(consolidated native round, union closure, full enumeration, wide
enumeration, LP proof, full search), with the closure and wide rungs
taken from this package (``solver.segenum``) so their bounds run on
``device``. Every other rung is that module's host code as it is.
NODE_BUDGET is this module's own constant, read at call time.
"""

from __future__ import annotations

import time

from . import segenum
from .exact import ClusterInstance, SolveResult, solve_exact
from .lp_bound import lp_lower_bound
from .native import solve_exact_native, solve_round_native
from .segenum import solve_segment_enum

# Phase-1 budget: easy instances finish well under this; hard ones
# escalate quickly to the (native) structure enumeration. The value is
# part of the deterministic output contract (it decides which engine's
# equally-optimal tie-break an instance gets), so changes require a
# deliberate golden-fixture regeneration (tests/test_golden.py recipe).
# The value is the JAX package's (its module keeps the tuning history);
# both packages must agree on it to write the same bytes.
NODE_BUDGET = 1_000


def _objective_granularity(inst: ClusterInstance) -> float:
    """Objective values are sums of integers (corrections) and garbage
    costs; with the reference's cost models garbage is integral
    ('constant') or half-integral ('exons'/'introns')."""
    if all(float(r.garbage).is_integer() for r in inst.rows):
        return 1.0
    return 0.5


def _solve_raw(inst, deadline_s, node_budget=0) -> SolveResult:
    res = solve_exact_native(inst, deadline_s, node_budget)
    if res is not None:
        return res
    return solve_exact(inst, deadline_s, node_budget)


def solve_two_phase(inst: ClusterInstance, deadline_s: float = 60.0,
                    device="cuda") -> SolveResult:
    """Exact solve; result-identical to ``freddie_tpu``'s
    ``solve_two_phase`` (comments on each rung there)."""
    t0 = time.monotonic()
    nr = solve_round_native(inst, deadline_s, NODE_BUDGET)
    if nr is not None:
        kind, res = nr
        if kind == "final":
            return res
        # 'closure_device' (N x closure crosses the device-bounds gate)
        # runs the closure rung below; 'budget' and 'closure_timeout' go
        # straight to the later rungs.
        if kind != "closure_device":
            return _escalate(inst, res, t0, deadline_s, device,
                             try_enum=(kind == "budget"))
    else:
        res = _solve_raw(inst, deadline_s, NODE_BUDGET)
        if res.status != "BUDGET":
            return res
    remaining = max(deadline_s - (time.monotonic() - t0), 1.0)
    closure_res = segenum.solve_segment_enum_closure(
        inst, remaining, incumbent_cost=res.objective, device=device
    )
    if closure_res is not None and closure_res.status == "OPTIMAL":
        return closure_res
    return _escalate(inst, res, t0, deadline_s, device,
                     try_enum=closure_res is None)


def _escalate(
    inst: ClusterInstance,
    res: SolveResult,
    t0: float,
    deadline_s: float,
    device,
    try_enum: bool,
) -> SolveResult:
    """Escalations past the union closure (``freddie_tpu``'s ``_escalate``):
    full enumeration, the wide rung on ``device``, the LP proof of the
    phase-1 incumbent ``res``, the full search."""
    if try_enum:
        remaining = max(deadline_s - (time.monotonic() - t0), 1.0)
        enum_res = solve_segment_enum(inst, remaining)
        if enum_res is not None and enum_res.status == "OPTIMAL":
            return enum_res
        if enum_res is None:
            remaining = max(deadline_s - (time.monotonic() - t0), 1.0)
            wide_res = segenum.solve_segment_enum_wide(
                inst, res.objective, remaining, device=device
            )
            if wide_res is not None and wide_res.status == "OPTIMAL":
                return wide_res
    gran = _objective_granularity(inst)
    bound = lp_lower_bound(inst)
    if bound is not None and bound > res.objective - gran + 1e-4:
        return SolveResult("OPTIMAL", res.objective, res.assigned, res.isoform, res.nodes)
    remaining = max(deadline_s - (time.monotonic() - t0), 1.0)
    return _solve_raw(inst, remaining)
