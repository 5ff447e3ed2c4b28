"""The harness on the CPU: its rehearsal's last line, finding its files by
name, and the modules it loads."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import generator, registry

ROOT = registry.ROOT
CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]

# Runs the rehearsal with an import hook that refuses JAX and the JAX
# package by top-level name, and then lists the top-level names loaded.
BLOCKED_RUN = r"""
import importlib.abc, runpy, sys
BLOCK = {"jax", "jaxlib", "flax", "freddie_tpu"}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["portbench.run"] + sys.argv[1:]
try:
    runpy.run_module("portbench.run", run_name="__main__")
except SystemExit as e:
    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCK)
    print("LOADED " + ",".join(loaded), file=sys.stderr)
    raise
"""


def rehearse(cell, trace, blocked=False):
    cmd = [sys.executable, "-c", BLOCKED_RUN] if blocked else [sys.executable, "-m", "portbench.run"]
    out = subprocess.run(cmd + ["--workload", cell, "--seed", "2147483659", "--seconds", "0.5",
                                "--trace", str(trace), "--rehearse-cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    return out


def test_the_rehearsal_prints_the_contracts_last_line():
    bench = registry.load_benchmark()
    for cell, trace in ((CELLS[0], 0), (CELLS[-1], 1)):
        out = rehearse(cell, trace)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        want = {m["name"] for m in registry.metrics(bench, cell, traced=bool(trace))}
        if trace:
            # the CPU has no device trace: only the program's spans and counters read
            assert {"stage_s.split", "stage_s.segment", "stage_s.cluster", "stage_s.isoforms",
                    "dispatch.k1_launches"} <= set(line["metrics"]) <= want
            assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        else:
            assert set(line["metrics"]) == want
        for m in line["metrics"].values():
            assert m["value"] >= 0 and m["unit"]
        # the compared numbers end stderr, each beside its limit
        tail = out.stderr.strip().splitlines()[-len(line["checks"]):]
        assert [t.split()[1].rstrip(":") for t in tail] == list(line["checks"])


def test_every_file_is_found_by_name_and_a_new_one_without_an_edit(tmp_path):
    bench = registry.load_benchmark()
    for entry in bench["configs"]:
        assert registry.config(bench, entry["name"])["simulator"]
    for cell in bench["workloads"]:
        generator.check_mix(cell["traffic"], registry.traffic(cell["traffic"]))
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert callable(registry.reader(m["name"]))
    # a copy of the benchmark, with one more metric and configuration
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "portbench" / "metrics" / "dummy.count.py").write_text(
        "def read(run):\n    return 7.0\n")
    (root / "portbench" / "configs" / "dummy.json").write_text(json.dumps({"simulator": {}}))
    bench["per_layer"].append(dict(name="dummy.count", unit="n", better="lower",
                                   source="program_counter", layer="dummy", moves="reads_per_s",
                                   workloads=[CELLS[0]]))
    bench["configs"].append(dict(name="dummy", source="-", file="portbench/configs/dummy.json",
                                 reduced=[], why="-"))
    bench["workloads"].append(dict(name="dummy.cell", config="dummy", traffic="pipeline",
                                   chips=1, why="-"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    copy = registry.load_benchmark(str(root))
    assert registry.reader("dummy.count", str(root / "portbench"))(None) == 7.0
    assert registry.config(copy, "dummy", str(root)) == {"simulator": {}}
    assert "dummy.count" in {m["name"] for m in registry.metrics(copy, CELLS[0], traced=True)}
    assert registry.workload(copy, "dummy.cell")["config"] == "dummy"
    assert "dummy.count" not in {m["name"] for m in registry.metrics(copy, "dummy.cell", traced=True)}


def test_a_new_mix_runs_from_its_data_file_alone(tmp_path):
    """A mix added as one data file in a copy of the checkout (two samples a
    pass, through the workflow entry) runs without an edit of any file."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = dict(registry.traffic("pipeline"), entry="workflow", samples_per_pass=2,
               what="two samples a pass through run_workflow")
    (tmp_path / "portbench" / "traffic" / "two_samples.json").write_text(json.dumps(mix))
    bench = registry.load_benchmark()
    bench["workloads"].append(dict(name="dummy.two_samples", config=bench["configs"][0]["name"],
                                   traffic="two_samples", chips=1, why="-"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "dummy.two_samples", "--seed", "2147483659", "--seconds", "0.5",
                          "--rehearse-cpu"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] >= 1, line
    assert "checked sample 1 of the last pass" in out.stderr
    assert os.path.isdir(tmp_path / ".portbench_cache" / "samples")
    # two samples a pass: twice the reads of one pass of the one-sample mix
    passes = [ln for ln in out.stderr.splitlines() if "sample(s) of" in ln]
    assert passes and "2 sample(s)" in passes[0], passes


@pytest.mark.parametrize("change", [dict(loop="open"), dict(clients=2), dict(entry="serve"),
                                    dict(samples_per_pass=0), dict(rate_per_s=3.0)])
def test_a_mix_the_generator_does_not_drive_is_refused(change):
    with pytest.raises(ValueError):
        generator.check_mix("x", dict(registry.traffic("pipeline"), **change))


def test_a_sample_is_simulated_once_and_read_back(tmp_path):
    from portbench.corpus import load_sample

    sim = dict(registry.config(registry.load_benchmark(),
                               registry.load_benchmark()["configs"][0]["name"])["simulator"],
               n_genes=2, reads_per_isoform=5)
    first = load_sample("c", sim, 2147483659, str(tmp_path))
    again = load_sample("c", sim, 2147483659, str(tmp_path))
    other = load_sample("c", sim, 2147483660, str(tmp_path))
    assert not first.cached and again.cached and not other.cached
    assert (first.bam, first.n_reads, first.truth) == (again.bam, again.n_reads, again.truth)
    assert other.bam != first.bam
    assert sorted(os.listdir(tmp_path / "samples")) == sorted(
        os.path.basename(os.path.dirname(s.bam)) for s in (first, other))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    out = rehearse(CELLS[0], 1, blocked=True)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stderr.strip().splitlines()[-1].strip() == "LOADED"
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_no_portbench_source_names_the_jax_package():
    import ast

    for d, _dirs, files in os.walk(os.path.join(ROOT, "portbench")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, fn)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for name in names:
                    assert name.split(".")[0] not in {"jax", "jaxlib", "flax", "freddie_tpu"}, fn


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--rehearse-cpu"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "freddie_tpu_torch" in out.stderr


def test_the_trace_reduces_to_busy_time_and_idle_gaps_by_stage():
    from portbench.trace import reduce_trace

    mark = "portbench."
    events = [(mark + "pass_begin", "cpu", "user_annotation", 0, 1),
              (mark + "stage_done:split", "cpu", "user_annotation", 100, 101),
              (mark + "stage_done:segment", "cpu", "user_annotation", 300, 301),
              (mark + "stage_done:cluster", "cpu", "user_annotation", 500, 501),
              (mark + "stage_done:isoforms", "cpu", "user_annotation", 600, 601),
              (mark + "pass_end", "cpu", "user_annotation", 700, 701),
              ("k1", "cuda", "kernel", 150, 160), ("copy", "cuda", "gpu_memcpy", 155, 260),
              (mark + "pass_end", "cuda", "gpu_user_annotation", 700, 701),
              ("k1", "cuda", "kernel", 800, 900)]  # after the window
    t = reduce_trace(events, ["split", "segment", "cluster", "isoforms"])
    assert t["window_s"] == 701e-9 and abs(t["busy_s"] - 110e-9) < 1e-15
    assert [(n, round(s * 1e9)) for n, s in t["gaps"]] == [
        ("cluster", 200), ("between passes", 101), ("split", 100), ("isoforms", 100),
        ("segment", 50), ("segment", 40)]
