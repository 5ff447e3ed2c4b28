"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Earlier lines on standard error say what the run did; its last lines there
are each compared number beside its limit. The last line of standard
output is one JSON object: ``correct``, ``attempted`` and ``failed``
(passes), ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``,
and ``checks`` (each compared number with its limit). Exits 2 without a
result where the cell's devices are missing, and 3 where JAX or the JAX
package was loaded. Before the last line every process the run started
has ended: any found below it is ended and named.
"""

from __future__ import annotations

import argparse
import json
import sys

from .harness import log, run_cell
from .hygiene import end_descendants, foreign_modules, stop_resource_tracker

# The CPU tests' rehearsal sample: the configuration's profile at 6 loci
# of 20 reads an isoform.
REHEARSAL = dict(n_genes=6, reads_per_isoform=20)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        if args.rehearse_cpu:
            code, result = run_cell(args, sample=REHEARSAL, device="cpu")
        else:
            code, result = run_cell(args)
    finally:
        # whatever happened above, nothing the run started outlives it
        tracker = stop_resource_tracker()
        if tracker is not None:
            log(f"portbench: stopped multiprocessing's resource tracker (pid {tracker})")
        for line in end_descendants():
            log(f"portbench: ended a process the run left behind: {line}")
    foreign = foreign_modules()
    if foreign:
        log(f"portbench: the run loaded {', '.join(foreign)}; no result")
        return 3
    if result is None:
        return code
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
