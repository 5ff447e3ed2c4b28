"""LP-assisted two-phase exact solve whose device rungs run on PyTorch.

Port of ``freddie_tpu/solver/two_phase.py``: the same escalation chain
(consolidated native round, union closure, full enumeration, wide
enumeration, LP proof, full search), with the closure and wide rungs
taken from this package (``solver.segenum``) so their bounds run on
``device`` instead of through ``jax``. Every other rung is the JAX
package's jax-free code. NODE_BUDGET is read from ``freddie_tpu``'s
module at call time (one source of truth, patchable by tests).
"""

from __future__ import annotations

import time

from freddie_tpu.solver import two_phase as _tp
from freddie_tpu.solver.exact import ClusterInstance, SolveResult
from freddie_tpu.solver.lp_bound import lp_lower_bound
from freddie_tpu.solver.native import solve_round_native
from freddie_tpu.solver.segenum import solve_segment_enum
from freddie_tpu.solver.two_phase import _objective_granularity, _solve_raw

from . import segenum


def solve_two_phase(inst: ClusterInstance, deadline_s: float = 60.0,
                    device="cuda") -> SolveResult:
    """Exact solve; result-identical to ``freddie_tpu``'s
    ``solve_two_phase`` (comments on each rung there)."""
    t0 = time.monotonic()
    nr = solve_round_native(inst, deadline_s, _tp.NODE_BUDGET)
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
        res = _solve_raw(inst, deadline_s, _tp.NODE_BUDGET)
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
