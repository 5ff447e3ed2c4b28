"""The port is a package of its own.

(a) No file of ``freddie_tpu_torch`` and not ``chip_smoke.py`` imports
    ``freddie_tpu`` or ``jax``, at top level or inside a function.
(b) In a fresh interpreter that refuses both imports, every subcommand of
    ``freddie_tpu_torch.cli`` runs on the CPU and writes, byte for byte,
    what the JAX package writes here for the same simulated sample (and
    the committed golden fixture).
(c) Every gate, constant and default that the port took from a JAX module
    is now its own, equal in value to the JAX package's today.
"""

import argparse
import ast
import dataclasses
import filecmp
import importlib
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from freddie_tpu import cli as jax_cli
from freddie_tpu.config import PipelineConfig
from freddie_tpu.stages.pipeline import run_pipeline as run_jax_pipeline
from freddie_tpu.utils.sim import simulate
from test_golden import GOLDEN, SIM_KWARGS

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "freddie_tpu_torch").rglob("*.py")
    if "build" not in p.relative_to(REPO).parts
) + ["chip_smoke.py"]
FORBIDDEN = ("freddie_tpu", "jax", "jaxlib")
NOISY_SIM = dict(seed=77, n_genes=6, isoforms_per_gene=2, reads_per_isoform=10,
                 end_jitter=25, indel_rate=0.1, junction_jitter=6)


def _is_forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_the_jax_package(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _is_forbidden(node.module):
                bad.append((node.lineno, node.module))
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(
                node.func, "attr", "")) in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _is_forbidden(node.args[0].value)):
            bad.append((node.lineno, node.args[0].value))
    assert not bad, f"{path} imports {bad}"


# Refuses `jax` and `freddie_tpu`, then runs every subcommand through the
# port's CLI entry: the stage-by-stage chain at the gates as they are, the
# pipeline and the workflow with the DP dispatch forced at test size.
_ALONE = textwrap.dedent("""
    import importlib.abc, os, runpy, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "freddie_tpu"):
                raise ImportError(f"{name} is refused here")
            return None

    sys.meta_path.insert(0, Refuse())
    for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "freddie_tpu")]:
        del sys.modules[m]
    repo, bam, fq, noisy_bam, noisy_fq, out = sys.argv[1:7]
    sys.path.insert(0, repo)

    def cli(*argv):
        sys.argv = ["freddie_tpu_torch.cli", *argv]
        try:
            runpy.run_module("freddie_tpu_torch.cli", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert e.code in (0, None), (argv, e.code)

    j = os.path.join
    cli("split", "-b", bam, "-r", fq, "-o", j(out, "steps", "split"))
    cli("segment", "-s", j(out, "steps", "split"), "-o", j(out, "steps", "segment"),
        "--device", "cpu")
    cli("cluster", "-s", j(out, "steps", "segment"), "-o", j(out, "steps", "cluster"),
        "--device", "cpu")
    cli("isoforms", "-s", j(out, "steps", "split"), "-c", j(out, "steps", "cluster"),
        "-o", j(out, "steps", "isoforms.gtf"))

    cli("pipeline", "-b", bam, "-r", fq, "-o", j(out, "pipeline"), "--device", "cpu")

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.stages import segment as tseg

    tseg.DEVICE_MIN_WORK = 0
    tseg.STREAM_CHUNK_MAX = 8
    calls = []
    orig = segdp_cuda._solve_batch_torch
    segdp_cuda._solve_batch_torch = lambda *a, **k: calls.append(1) or orig(*a, **k)
    cli("pipeline", "-b", noisy_bam, "-r", noisy_fq, "-o", j(out, "noisy"), "--device", "cpu")
    assert calls, "the pipeline's DP never reached the torch dispatch"
    with open(j(out, "wf.yaml"), "w") as f:
        f.write(f"outpath: {j(out, 'wf')}\\nsamples:\\n  S1:\\n    bam: {noisy_bam}\\n"
                f"    reads: [{noisy_fq}]\\n")
    cli("workflow", j(out, "wf.yaml"), "--device", "cpu")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "freddie_tpu"))
    assert not loaded, loaded
    print("STANDS_ALONE", len(calls))
""")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _dirs, fns in os.walk(root) for f in fns
                  if f.endswith((".tsv", ".gtf")))


def _same(a, b, what):
    names = _tree(a)
    assert names and names == _tree(b), what
    differ = [n for n in names
              if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)]
    assert not differ, (what, differ[:5])


@pytest.fixture(scope="module")
def alone(tmp_path_factory):
    """The golden simulation and a noisy one (whose DP problems are not
    trivial) through the JAX pipeline here, and through every subcommand
    of the port in an interpreter that refuses jax and freddie_tpu.
    Returns the JAX runs of both and the port's output directory."""
    d = tmp_path_factory.mktemp("standalone")
    paths, refs = [], []
    for name, kwargs in (("golden", SIM_KWARGS), ("noisy", NOISY_SIM)):
        sim = simulate(**kwargs)
        bam, fq = str(d / f"{name}.bam"), str(d / f"{name}.fastq")
        sim.write_bam(bam)
        sim.write_fastq(fq)
        paths += [bam, fq]
        refs.append(str(d / f"jax_{name}"))
        run_jax_pipeline(bam, [fq], refs[-1], PipelineConfig(), log=lambda *a: None)
    out = d / "port"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _ALONE, str(REPO), *paths, str(out)],
                          capture_output=True, text=True, env=env, timeout=600, cwd=str(d))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STANDS_ALONE" in proc.stdout
    return refs[0], refs[1], str(out)


@pytest.mark.parametrize("stage", ["split", "segment", "cluster"])
def test_stage_subcommands_alone_match_jax(alone, stage):
    ref, _noisy, out = alone
    _same(os.path.join(out, "steps", stage), os.path.join(ref, stage), stage)


@pytest.mark.parametrize("run", ["steps", "pipeline"])
def test_gtf_alone_matches_jax_and_golden(alone, run):
    ref, _noisy, out = alone
    gtf = os.path.join(out, run, "isoforms.gtf")
    assert filecmp.cmp(gtf, os.path.join(ref, "isoforms.gtf"), shallow=False)
    assert filecmp.cmp(gtf, os.path.join(GOLDEN, "isoforms.gtf"), shallow=False)


@pytest.mark.parametrize("run", ["noisy", os.path.join("wf", "results", "S1")])
def test_forced_dispatch_alone_matches_jax(alone, run):
    """The noisy sample through `pipeline` and `workflow` with the DP
    dispatch forced: every TSV and the GTF equal the JAX pipeline's."""
    _ref, noisy, out = alone
    _same(os.path.join(out, run), noisy, run)


@pytest.mark.parametrize("stage", ["split", "segment", "cluster"])
def test_pipeline_alone_matches_golden(alone, stage):
    _ref, _noisy, out = alone
    for fn in os.listdir(os.path.join(GOLDEN, stage)):
        assert filecmp.cmp(os.path.join(GOLDEN, stage, fn),
                           os.path.join(out, "pipeline", stage, "chr1", fn),
                           shallow=False), fn


GATES = [
    ("stages.segment", "POLYA_DEVICE_MIN_READS"),
    ("stages.segment", "DEVICE_MIN_WORK"),
    ("stages.segment", "STREAM_CHUNK_MAX"),
    ("stages.segment", "DEVICE_COVERAGE_MIN_TINTS"),
    ("stages.segment", "READBACK_THREAD"),
    ("stages.segment", "AUTO_WINDOW_MIN_TINTS"),
    ("stages.segment", "AUTO_WINDOW"),
    ("stages.segment", "MAX_INFLIGHT_CHUNKS"),
    ("stages.cluster", "POOL_MIN_BYTES"),
    ("solver.segenum", "MAX_SEGS"),
    ("solver.segenum", "WIDE_MAX_SEGS"),
    ("solver.segenum", "WIDE_CANDIDATE_CAP"),
    ("solver.segenum", "CLOSURE_MAX_SEGS"),
    ("solver.segenum", "CLOSURE_CAP"),
    ("solver.segenum", "BOUNDS_DEVICE_MIN"),
    ("solver.two_phase", "NODE_BUDGET"),
    ("ops.segdp", "MIN_SEG_LEN"),
    ("ops.segdp", "NEG"),
    ("ops.polya_batch", "MAX_WINDOW"),
    ("ops.polya_batch", "_L_BUCKETS"),
    ("ops.polya_batch", "_MAX_ROWS"),
    ("ops.polya", "_REV_COMP"),
    ("io.bam", "CIGAR_OPS"),
    ("io.bam", "CIGAR_OP_CODE"),
]


@pytest.mark.parametrize("module,name", GATES, ids=[f"{m}.{n}" for m, n in GATES])
def test_port_owns_each_gate_with_the_jax_value(module, name):
    ref = importlib.import_module(f"freddie_tpu.{module}")
    port = importlib.import_module(f"freddie_tpu_torch.{module}")
    assert getattr(port, name) == getattr(ref, name)
    assert name in vars(port), f"{module}.{name} is not the port's own name"
    src = (REPO / "freddie_tpu_torch" / (module.replace(".", "/") + ".py")).read_text()
    assigned = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == name for t in n.targets)]
    assert assigned, f"{module}.{name} is not assigned in the port's own module"


@pytest.mark.parametrize("name", ["SplitConfig", "SegmentConfig", "ClusterConfig",
                                  "IsoformsConfig", "PipelineConfig"])
def test_config_defaults_equal(name):
    import freddie_tpu.config as ref
    import freddie_tpu_torch.config as port

    a, b = getattr(port, name), getattr(ref, name)
    assert a is not b and a.__module__ == "freddie_tpu_torch.config"
    assert dataclasses.asdict(a()) == dataclasses.asdict(b())


@pytest.mark.parametrize("n_cand,n_reps", [(3, 1), (16, 128), (17, 129), (64, 512),
                                            (65, 1537), (200, 4000)])
def test_bucketing_and_batch_size_equal(n_cand, n_reps):
    from freddie_tpu.ops import segdp as ref
    from freddie_tpu_torch.ops import segdp as port

    assert port.bucket_shape(n_cand, n_reps) == ref.bucket_shape(n_cand, n_reps)
    P, R = port.bucket_shape(n_cand, n_reps)
    assert port.suggested_batch_size(P, R) == ref.suggested_batch_size(P, R)


def _options(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: sorted((tuple(a.option_strings) or (a.dest,), repr(a.default), a.nargs)
                         for a in p._actions if a.dest not in ("help", "device"))
            for name, p in sub.choices.items()}


def test_cli_offers_the_same_subcommands_and_flags():
    from freddie_tpu_torch import cli

    port, ref = _options(cli.build_parser()), _options(jax_cli.build_parser())
    assert port == ref
    sub = next(a for a in cli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    with_device = {name for name, p in sub.choices.items()
                   if any(a.dest == "device" for a in p._actions)}
    assert with_device == {"segment", "cluster", "pipeline", "workflow"}
