"""The harness's CPU rehearsal with the cluster stage's spawn pool forced
on (``POOL_MIN_BYTES = 0``), as the process-hygiene test runs it:

    python -m portbench.tests.pool_run --workload <cell> --seed <n> --seconds <s> [--leave-child]

``--leave-child`` starts a sleeping child process before the run, which
the run's own sweep has to end and name.
"""

import sys


def main() -> int:
    import freddie_tpu_torch.stages.cluster as cluster

    from portbench.run import main as run_main

    cluster.POOL_MIN_BYTES = 0
    argv = sys.argv[1:]
    if "--leave-child" in argv:
        import subprocess

        argv.remove("--leave-child")
        subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
    return run_main(argv + ["--rehearse-cpu"])


if __name__ == "__main__":
    sys.exit(main())
