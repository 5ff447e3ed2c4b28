"""No process outlives a run (CPU, the harness's rehearsal mode).

Each case starts a run in a session of its own with the cluster stage's
spawn pool forced on (``pool_run``), and after it exits reads the session
(field 6 of ``/proc/<pid>/stat``) of every process on the machine.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "ont-cdna-96loci.pipeline"


def in_session(sid: int) -> list[str]:
    left = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[3]) == sid and fields[0] != "Z":
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    left.append(f"{d}: {f.read().replace(b'\0', b' ').decode(errors='replace')}")
        except (OSError, ValueError):
            pass  # the process ended while we read it
    return left


def run_in_session(*extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "portbench.tests.pool_run", "--workload", CELL, "--seed", "41",
         "--seconds", "0.5", *extra],
        cwd=ROOT, start_new_session=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    time.sleep(1.0)
    return proc, out, err, in_session(proc.pid)


def test_a_run_with_the_spawn_pool_leaves_no_process():
    proc, out, err, left = run_in_session()
    assert proc.returncode == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    assert "stopped multiprocessing's resource tracker" in err, err[-3000:]
    assert "left behind" not in err
    assert left == [], left


def test_the_sweep_ends_and_names_a_child_left_running():
    proc, out, err, left = run_in_session("--leave-child")
    assert proc.returncode == 0, err[-3000:]
    named = [line for line in err.splitlines() if "left behind" in line]
    assert len(named) == 1 and "time.sleep(600)" in named[0], err[-3000:]
    assert left == [], left
    # the sweep's report comes before the compared numbers, which end stderr
    lines = err.strip().splitlines()
    assert lines[-1].startswith("check ") and lines.index(named[0]) < len(lines) - 5
