"""The port's pipeline end to end on the CPU: golden outputs, no jax.

The device route of the segment stage is forced at test size (no work
gate, device coverage from the first tint, chunks of 8), so the whole
port -- dispatch, coverage build, plain DP, chain walk, readback --
runs between the JAX package's split and cluster/isoforms stages.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from freddie_tpu.config import PipelineConfig
from freddie_tpu.stages.pipeline import run_pipeline as run_jax_pipeline
from freddie_tpu.utils.sim import simulate
from freddie_tpu_torch import cli
from freddie_tpu_torch.stages import pipeline as tpipe
from freddie_tpu_torch.stages import segment as tseg
from test_golden import GOLDEN, SIM_KWARGS

REPO = pathlib.Path(__file__).resolve().parent.parent


NOISY = dict(
    seed=77, n_genes=8, isoforms_per_gene=3, reads_per_isoform=12,
    end_jitter=25, indel_rate=0.1, junction_jitter=6, alt_splice=True,
    big_del_rate=0.06,
)


def _simulate(d, kwargs):
    sim = simulate(**kwargs)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    return d, bam, fq


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The golden corpus (tests/test_golden.py)."""
    return _simulate(tmp_path_factory.mktemp("torch_pipe"), SIM_KWARGS)


@pytest.fixture(scope="module")
def noisy(tmp_path_factory):
    """A noisy corpus whose DP problems are not trivial, with the JAX
    package's GTF for it."""
    d, bam, fq = _simulate(tmp_path_factory.mktemp("torch_noisy"), NOISY)
    ref = run_jax_pipeline(bam, [fq], str(d / "jax"), PipelineConfig(),
                           log=lambda *a: None)
    with open(ref["gtf"]) as f:
        return d, bam, fq, f.read()


@pytest.fixture
def forced_device_route(monkeypatch):
    """No work gate, device coverage from the first tint, chunks of 8;
    returns the list of dispatches made."""
    monkeypatch.setattr(tseg, "DEVICE_MIN_WORK", 0)
    monkeypatch.setattr(tseg, "DEVICE_COVERAGE_MIN_TINTS", 0)
    monkeypatch.setattr(tseg, "STREAM_CHUNK_MAX", 8)
    launches = []
    orig = tseg.dispatch_batch_device
    monkeypatch.setattr(tseg, "dispatch_batch_device",
                        lambda *a, **k: launches.append(1) or orig(*a, **k))
    return launches


def test_pipeline_matches_golden(corpus, forced_device_route):
    d, bam, fq = corpus
    out = str(d / "out")
    stats = tpipe.run_pipeline(bam, [fq], out, PipelineConfig(),
                               log=lambda *a: None, device="cpu")
    assert set(stats) >= {"split", "segment", "cluster", "isoforms", "gtf"}
    with open(os.path.join(GOLDEN, "isoforms.gtf")) as g, open(stats["gtf"]) as f:
        assert g.read() == f.read()
    for t in (0, 1):
        name = f"segment_chr1_{t}.tsv"
        with open(os.path.join(GOLDEN, "segment", name)) as g, \
                open(os.path.join(out, "segment", "chr1", name)) as f:
            assert g.read() == f.read(), name


def test_pipeline_matches_jax_pipeline(noisy, forced_device_route):
    d, bam, fq, want = noisy
    stats = tpipe.run_pipeline(bam, [fq], str(d / "torch"), PipelineConfig(),
                               log=lambda *a: None, device="cpu")
    assert forced_device_route, "the segment stage never dispatched"
    with open(stats["gtf"]) as f:
        assert f.read() == want


def test_pipeline_resume_skips_complete_stages(corpus):
    d, bam, fq = corpus
    out = str(d / "resume")
    tpipe.run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None,
                       device="cpu")
    msgs = []
    stats = tpipe.run_pipeline(bam, [fq], out, PipelineConfig(), resume=True,
                               log=msgs.append, device="cpu")
    assert all("complete, skipping" in m for m in msgs) and len(msgs) == 4
    assert set(stats) == {"gtf"}


_NO_JAX = textwrap.dedent("""
    import importlib.abc, json, sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"{name} imported on the port's path")
            return None

    sys.meta_path.insert(0, NoJax())
    sys.path.insert(0, sys.argv[1])
    from freddie_tpu.utils.sim import simulate
    from freddie_tpu_torch import cli
    from freddie_tpu_torch.stages import segment as tseg

    tseg.DEVICE_MIN_WORK = 0
    tseg.DEVICE_COVERAGE_MIN_TINTS = 0
    tseg.STREAM_CHUNK_MAX = 8
    calls = []
    import freddie_tpu_torch.ops.segdp_cuda as sc
    orig = sc._solve_batch_torch
    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    sc._solve_batch_torch = counted

    sim = simulate(**json.loads(sys.argv[3]))
    out = sys.argv[2]
    sim.write_bam(out + "/r.bam")
    sim.write_fastq(out + "/r.fastq")
    rc = cli.main(["pipeline", "-b", out + "/r.bam", "-r", out + "/r.fastq",
                   "-o", out + "/run", "--device", "cpu"])
    assert rc == 0 and calls, (rc, calls)
    assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    print("NO_JAX_OK", len(calls))
""")


def test_pipeline_never_imports_jax(noisy, tmp_path):
    """A fresh interpreter in which `import jax` raises runs the port's CLI
    pipeline end to end through the plain DP."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(REPO), str(tmp_path),
         json.dumps(NOISY)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    with open(tmp_path / "run" / "isoforms.gtf") as f:
        assert f.read() == noisy[3]


def test_port_sources_never_import_jax():
    pkg = REPO / "freddie_tpu_torch"
    files = sorted(pkg.rglob("*.py"))
    assert len(files) >= 10
    for path in files + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), (
                f"{path.relative_to(REPO)}: {s}")


def test_cli_device_flag():
    p = cli.build_parser()
    assert p.parse_args(["segment", "-s", "x"]).device == "cuda"
    assert p.parse_args(["pipeline", "-b", "b", "-r", "r", "-o", "o",
                         "--device", "cpu"]).device == "cpu"
    assert p.parse_args(["cluster", "-s", "x", "--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        p.parse_args(["isoforms", "-s", "x", "-c", "y", "--device", "cpu"])
