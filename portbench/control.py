"""The program's and the control's readings of the compared numbers, seed
by seed, in one process (the set-up's kernel builds paid once):

    python3 -m portbench.control --workload <cell> --seeds 11,12,13

For each seed, one whole pass of the cell's sample at its own size, then
the check (``reference.check``) twice: with the program's outputs, and
with the reference computed in float32 in the program's place. One JSON
line a seed: ``program`` and ``control``, each number with its limit.
The limits in PERF.md rest on these readings. The benchmark's runs do not
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import types

from .harness import log, run_cell
from .hygiene import end_descendants, stop_resource_tracker


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--genes", type=int, help="simulate this many loci instead")
    args = ap.parse_args(argv)
    sample = None if args.genes is None else dict(n_genes=args.genes)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = types.SimpleNamespace(workload=args.workload, seed=seed, seconds=0, trace=0)
        code, res = run_cell(run, sample=sample, device=args.device, warmup=0 if i else 1,
                             control=True)
        if res is None:
            return code
        print(json.dumps(dict(seed=seed, correct=res["correct"], program=res["checks"],
                              control=res["control_checks"])), flush=True)
    stop_resource_tracker()
    for line in end_descendants():
        log(f"portbench: ended a process the run left behind: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
