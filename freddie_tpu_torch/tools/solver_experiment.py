"""Replay a captured hard-instance corpus through the production solver.

    python -m freddie_tpu_torch.tools.solver_experiment --corpus PKL
        [--device cuda|cpu] [--timeout-min M]
        [--engine two_phase|exact_native|exact_py]

Compares wall time and status with what
``freddie_tpu_torch.tools.capture_hard_instances`` recorded and requires
the same objective and assignment for every instance that both runs
solved to OPTIMAL: the guard rail of a bound or prune experiment. Exits 1
on a mismatch. Load only a corpus that the capture tool wrote: a pickle
runs code when it is loaded.
"""

from __future__ import annotations

import argparse
import pickle
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--timeout-min", type=float, default=0.25)
    ap.add_argument("--engine", default="two_phase",
                    choices=["two_phase", "exact_native", "exact_py"])
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..solver.exact import solve_exact
    from ..solver.native import solve_exact_native
    from ..solver.two_phase import solve_two_phase

    dev = resolve_device(args.device)
    with open(args.corpus, "rb") as f:
        corpus = pickle.load(f)
    solve = dict(
        two_phase=lambda inst, d: solve_two_phase(inst, d, dev),
        exact_native=solve_exact_native,
        exact_py=solve_exact,
    )[args.engine]
    deadline = args.timeout_min * 60.0
    total_old = total_new = 0.0
    to_old = to_new = mismatches = 0
    for i, rec in enumerate(corpus):
        t0 = time.perf_counter()
        res = solve(rec["inst"], deadline)
        dt = time.perf_counter() - t0
        total_old += rec["dt"]
        total_new += dt
        to_old += rec["status"] != "OPTIMAL"
        to_new += res.status != "OPTIMAL"
        tag = ""
        if (rec["status"] == res.status == "OPTIMAL"
                and (res.objective != rec["objective"] or res.assigned != rec["assigned"])):
            tag = "  << RESULT MISMATCH"
            mismatches += 1
        print(f"[{i:3d}] N={rec['n']:4d} Mi={rec['mi']:3d} inc={rec['n_incomp']:6d} "
              f"{rec['status']:8s}{rec['dt']:7.2f}s -> {res.status:8s}{dt:7.2f}s{tag}")
    print(f"\nwall {total_old:.1f}s -> {total_new:.1f}s; non-OPTIMAL {to_old} -> {to_new}; "
          f"result mismatches {mismatches}")
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
