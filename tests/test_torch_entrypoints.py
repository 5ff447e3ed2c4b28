"""The port's entry points and tooling, each in an interpreter that
refuses ``jax`` and ``freddie_tpu``.

Every module is run as ``python -m`` would run it (``runpy``, ``__main__``)
on the CPU at a small size, after a meta-path finder that raises on any
import of ``jax``, ``jaxlib`` or ``freddie_tpu`` has been installed; at
the end no such module may be loaded. One case imports both packages, in
the test process: the port's ``entry`` against ``__graft_entry__.entry``
on the same example batch (integers: tolerance zero).
"""

import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import tomllib

import jax
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_ALONE = textwrap.dedent("""
    import importlib.abc, runpy, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "freddie_tpu"):
                raise ImportError(f"{name} is refused here")
            return None

    sys.meta_path.insert(0, Refuse())
    for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "freddie_tpu")]:
        del sys.modules[m]
    sys.path.insert(0, sys.argv[1])
    runs = [r.split("\\x1f") for r in sys.argv[2].split("\\x1e")]
    rc = 0
    for module, *argv in runs:
        sys.argv = [module, *argv]
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        print(f"RAN {module} {rc}", flush=True)
        if rc:
            break
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "freddie_tpu"))
    assert not loaded, loaded
    sys.exit(rc)
""")


def alone(*runs, cwd=None, timeout=400):
    """Runs each (module, *argv) of ``runs`` in turn as ``__main__`` in one
    interpreter that refuses jax and freddie_tpu; the finished process."""
    spec = "\x1e".join("\x1f".join(map(str, r)) for r in runs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", _ALONE, str(REPO), spec], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=timeout)


def ok(proc):
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return proc.stdout


def last_json(stdout):
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])


# ------------------------------------------------------------------ the bench

BENCH_FIELDS = [
    "metric", "value", "unit", "vs_host_oracle", "reads", "loci", "segment_s",
    "segment_hot_runs_s", "segment_cold_s", "host_oracle_segment_s",
    "segment_matches_host_oracle", "reference_segment_s", "segment_matches_reference",
    "split_s", "split_reads_per_s", "cluster_s", "cluster_loci_per_s",
    "cluster_timeout_min", "cluster_device_s", "isoforms_s", "pipeline_wall_s",
    "segment_k1_launches", "segment_k1_shapes", "kernels", "kernel_reads_per_s",
    "reported_transcripts", "truth_transcripts", "recovered_transcripts", "recovery_rate",
    "reachable_transcripts", "recovery_rate_reachable", "recovery_rate_mild", "device",
    "card", "backend",
]


@pytest.fixture(scope="module")
def bench_small(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench_small")
    out = ok(alone(("freddie_tpu_torch.bench.segment", "--small", "--device", "cpu",
                    "--json", d / "bench.json"), cwd=d))
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, "one JSON line expected"
    with open(d / "bench.json") as f:
        assert json.load(f) == json.loads(lines[0])
    return json.loads(lines[0])


@pytest.mark.parametrize("field", BENCH_FIELDS)
def test_bench_small_has_every_field(bench_small, field):
    assert field in bench_small


def test_bench_small_values(bench_small):
    r = bench_small
    assert r["metric"] == "segment_stage_reads_per_s" and r["unit"] == "reads/s"
    assert r["backend"] == "torch" and r["device"] == "cpu" and r["card"] is None
    assert r["segment_matches_host_oracle"] is True
    assert r["reference_segment_s"] is None and r["segment_matches_reference"] is None
    assert r["reads"] == 360 and r["loci"] == 6 and len(r["segment_hot_runs_s"]) == 3
    assert r["segment_s"] == min(r["segment_hot_runs_s"])
    assert r["value"] == pytest.approx(r["reads"] / r["segment_s"])
    assert r["segment_k1_launches"] == 0 and r["segment_k1_shapes"] == []  # no card here
    assert [k["name"] for k in r["kernels"]] == ["segdp", "segdp_pipelined"]
    for k in r["kernels"]:  # a CPU time is never written under a device metric's name
        assert (k["B"], k["P"], k["R"]) == (16, 16, 128)
        assert k["ms"] is None and k["bound_ms"] is None and k["plain_host_ms"] > 0
    assert 0 < r["recovered_transcripts"] <= r["truth_transcripts"] == 18
    assert 0 <= r["recovery_rate_mild"] <= 1


def test_bench_on_cuda_without_a_card_measures_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the error path cannot be reached")
    proc = alone(("freddie_tpu_torch.bench.segment", "--small"), cwd=tmp_path, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "metric" not in proc.stdout and "[bench]" not in proc.stdout


# ------------------------------------------------------------------ the entry


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip_on_cpu_devices(n, tmp_path):
    out = ok(alone(("freddie_tpu_torch.entry", "--device", "cpu", "--shards", n), cwd=tmp_path))
    assert f"'shards': {n}" in out and f"'devices': {['cpu'] * n}" in out
    assert "'polya': 64" in out and f"'dispatch': {n + 1}" in out
    # the B = n + 1 batch and the three (P, R) buckets, each split over n
    assert "'sharded_dispatches': 4" in out


def test_entry_forward_equals_the_jax_entry():
    """The one case that imports both packages: the port's forward on
    ``device="cpu"`` against ``__graft_entry__.entry()``'s on the same
    example batch."""
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    from freddie_tpu_torch import entry as tentry

    jforward, jargs = graft.entry()
    tforward, targs = tentry.entry(device="cpu")
    for a, b in zip(jargs, targs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = jax.jit(jforward)(*jargs)  # the entry returns a jittable step
    got = tforward(*targs)
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert (got[1] >= 0).any()


# --------------------------------------------------------- the scaling harnesses

def test_weak_scaling_mode_on_cpu_devices(tmp_path):
    out = ok(alone(("freddie_tpu_torch.parallel.bench", "--weak-scaling", "cpu,cpu,cpu",
                    "--reps", "1", "--json", tmp_path / "weak.json"), cwd=tmp_path))
    r = last_json(out)
    assert r["metric"] == "segdp_scaling_efficiency" and r["at_mesh"] == 3
    assert sorted(r["per_mesh"]) == ["1", "2", "3"] and all(v > 0 for v in r["per_mesh"].values())
    assert r["value"] == pytest.approx(r["per_mesh"]["3"] / (3 * r["per_mesh"]["1"]))
    assert r["devices"] == ["cpu"] * 3 and r["distinct_devices"] is False and r["cards"] is None
    assert "not a scaling measurement" in out
    with open(tmp_path / "weak.json") as f:
        assert json.load(f) == r


def test_scaling_pipeline_one_and_two_processes(tmp_path):
    """The 1-core curve at n = 1, 2 on the small corpus; every process has
    a finite timeout."""
    out = ok(alone(("freddie_tpu_torch.bench.scaling_pipeline", "--device", "cpu", "--small",
                    "--hosts", "1,2", "--points", "curve", "--reps", "1", "--timeout", "200"),
                   cwd=tmp_path, timeout=450))
    r = last_json(out)
    assert r["metric"] == "pipeline_scaling_efficiency" and r["backend"] == "torch"
    curve = r["curve"]
    assert curve["hosts"] == [1, 2] and curve["cores_per_host"] == 1
    assert len(curve["hot_s"]) == len(curve["cold_s"]) == 2 and min(curve["hot_s"]) > 0
    assert curve["efficiency"][0] == 1.0
    assert curve["efficiency"][1] == pytest.approx(curve["hot_s"][0] / (2 * curve["hot_s"][1]))
    assert r["card"] is None and r["reads"] == 360


# ------------------------------------------------------------------ the tools

TOOLS = ["audit_tiebreak", "stress_run", "profile_segment", "profile_split", "profile_cluster",
         "capture_hard_instances", "solver_experiment", "bound_device_experiment",
         "profile_kernel_phases", "warm_kernels", "run_fuzz_shifts"]
MODULES = ([f"freddie_tpu_torch.tools.{t}" for t in TOOLS]
           + ["freddie_tpu_torch.bench.segment", "freddie_tpu_torch.bench.scaling_pipeline",
              "freddie_tpu_torch.parallel.bench", "freddie_tpu_torch.entry",
              "freddie_tpu_torch.examples.simulate_and_run"])


@pytest.fixture(scope="module")
def helps(tmp_path_factory):
    """Every module's --help, in one interpreter."""
    return ok(alone(*[(m, "--help") for m in MODULES], cwd=tmp_path_factory.mktemp("helps")))


@pytest.mark.parametrize("module", MODULES)
def test_help(helps, module):
    assert f"RAN {module} 0" in helps
    assert f"usage: {module.rsplit('.', 1)[-1]}.py " in helps


def test_every_old_tool_has_its_module_or_a_stated_reason():
    old = sorted(p.stem for p in (REPO / "tools").iterdir() if p.suffix in (".py", ".sh"))
    assert sorted(TOOLS + ["sweep_kernel"]) == old
    readme = (REPO / "README.md").read_text()
    assert "sweep_kernel" in readme and "no counterpart" in readme
    for t in TOOLS:
        assert (REPO / "freddie_tpu_torch" / "tools" / f"{t}.py").is_file()
        assert f"freddie_tpu_torch.tools.{t}" in readme, t


def test_audit_tiebreak_tiny_run(tmp_path):
    out = ok(alone(("freddie_tpu_torch.tools.audit_tiebreak", "1", "--device", "cpu"),
                   cwd=tmp_path))
    assert "[gnarly shift=0] cumulative:" in out
    total = [ln for ln in out.splitlines() if ln.startswith("TOTAL ")][0]
    assert int(total.split()[1]) > 0 and "nonunique rate" in total


def test_stress_run_gen_then_run(tmp_path):
    corpus = tmp_path / "corpus"
    out = ok(alone(("freddie_tpu_torch.tools.stress_run", "gen", "--out", corpus,
                    "--contigs", "2", "--genes", "3"),
                   ("freddie_tpu_torch.tools.stress_run", "run", "--corpus", corpus,
                    "--device", "cpu", "--threads", "2", "--window", "1"), cwd=tmp_path))
    r = last_json(out)
    assert r["reads"] == 2 * 3 * 3 * 90 and r["transcripts"] > 0 and r["window"] == 1
    assert set(r["walls"]) == {"split", "segment", "cluster", "isoforms"}
    assert r["peak_rss_gb"] > 0 and r["device"] == "cpu"
    assert (corpus / "out" / "isoforms.gtf").is_file()


def test_bound_device_experiment_two_points(tmp_path):
    out = ok(alone(("freddie_tpu_torch.tools.bound_device_experiment", "--device", "cpu",
                    "--grid", "60:500,120:2000", "--dense", "40:10", "--reps", "1",
                    "--json", tmp_path / "bounds.json"), cwd=tmp_path))
    r = last_json(out)
    assert [(g["form"], g["N"]) for g in r["grid"]] == [("masks", 60), ("masks", 120),
                                                        ("dense", 40)]
    assert all(g["host_ms"] > 0 and g["device_ms"] > 0 for g in r["grid"])
    assert r["device"] == "cpu" and r["card"] is None and r["bounds_device_min"] > 0


def test_profile_segment_tiny_run(tmp_path):
    proc = alone(("freddie_tpu_torch.tools.profile_segment", "--small", "--device", "cpu",
                  "--lines", "5"), cwd=tmp_path)
    out = ok(proc)
    assert "run_segment" in out and "cumulative time" in out
    assert "[prof] profiled run" in proc.stderr and "on cpu" in proc.stderr


@pytest.mark.parametrize("args,said", [
    (("--device", "cpu"), "the kernels run only on a card"),
    (("--device", "cpu", "--launches", "--row-ring", "1"), "the kernels run only on a card"),
    (("--row-ring", "1"), "go with --launches"),
])
def test_profile_kernel_phases_refuses_before_any_launch(tmp_path, args, said):
    """The phase profile runs only on a card, in both of its modes, and a
    forced route belongs to --launches: each is refused with a usage
    error before a kernel is built, on any machine."""
    proc = alone(("freddie_tpu_torch.tools.profile_kernel_phases", *args), cwd=tmp_path)
    assert proc.returncode == 2 and said in proc.stderr and "[phases]" not in proc.stdout


def test_warm_kernels_fails_loudly_without_nvcc(tmp_path):
    from freddie_tpu_torch.ops import _build

    try:
        _build.find_nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is present: the build would succeed")
    proc = alone(("freddie_tpu_torch.tools.warm_kernels",), cwd=tmp_path, timeout=120)
    assert proc.returncode != 0
    assert "nvcc not found" in proc.stderr and "[warm]" not in proc.stdout


def test_run_fuzz_shifts_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    """With no --device the fuzz tool runs on the card and raises without
    one; with --device cpu it holds one shift's three corpora against the
    host-oracle route."""
    if not torch.cuda.is_available():
        proc = alone(("freddie_tpu_torch.tools.run_fuzz_shifts", "0", "0"), cwd=tmp_path)
        assert proc.returncode != 0 and "[fuzz]" not in proc.stdout
        assert "torch.cuda.is_available() is False" in proc.stderr
    out = ok(alone(("freddie_tpu_torch.tools.run_fuzz_shifts", "--device", "cpu", "0", "0"),
                   cwd=tmp_path))
    assert out.count("byte-identical to the host-oracle route on cpu") == 3
    assert "FUZZ SWEEP DONE: 3 corpora" in out


def test_example_script(tmp_path):
    out = ok(alone(("freddie_tpu_torch.examples.simulate_and_run", tmp_path / "ex",
                    "--device", "cpu"), cwd=tmp_path))
    assert "simulated 300 reads / 15 transcripts" in out
    assert "15/15 simulated structures recovered exactly" in out
    assert (tmp_path / "ex" / "run" / "isoforms.gtf").is_file()
    assert (tmp_path / "ex" / "annotation.gtf").is_file()


# ------------------------------------------------------------------ the command


def test_console_command_resolves_to_the_port_cli():
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    module, func = scripts["freddie-tpu-torch"].split(":")
    assert (module, func) == ("freddie_tpu_torch.cli", "main")
    main = getattr(importlib.import_module(module), func)
    assert callable(main)
    assert importlib.import_module(module).build_parser().prog == "freddie-tpu-torch"
    assert scripts["freddie-tpu"] == "freddie_tpu.cli:main"
