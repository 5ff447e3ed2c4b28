"""A run with the timed path broken underneath reads ``correct`` false
(CPU, the harness's rehearsal; ``fault_run`` plants each fault)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# fault -> the compared number that must catch it
FAULTS = {
    "coverage": "coverage_wrong",
    "dp_answer": "dp_wrong",
    "half_batch": "dp_wrong",
    "genotype": "genotype_wrong",
    "gtf": "gtf_wrong",
    "unseen": "dp_unseen",
}


def run(*argv):
    out = subprocess.run([sys.executable, "-m", *argv, "--workload", "ont-cdna-96loci.pipeline",
                          "--seed", "2147483659", "--seconds", "0.2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_reads_not_correct(fault):
    line = run("portbench.tests.fault_run", fault)
    assert line["correct"] is False
    assert line["checks"][FAULTS[fault]]["value"] > line["checks"][FAULTS[fault]]["limit"]


def test_the_same_run_unbroken_reads_correct():
    line = run("portbench.tests.fault_run", "none")
    assert line["correct"] is True
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
