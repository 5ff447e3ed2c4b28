"""The port's workflow runner, and the fault it repairs.

The JAX package's ``workflow`` subcommand runs the JAX segment stage, whose
dispatch imports jax once the DP work passes DEVICE_MIN_WORK; a machine
without JAX (the GPU machine) fails there. In a fresh interpreter where
`import jax` raises, ``freddie_tpu.cli workflow`` fails with ImportError
at the segment stage, and ``freddie_tpu_torch.cli workflow --device cpu``
finishes through the plain DP; its GTF equals the JAX package's workflow
GTF, run here where JAX is present.
"""

import os
import subprocess
import sys
import textwrap

from freddie_tpu.stages.workflow import run_workflow as run_jax_workflow
from freddie_tpu.utils.sim import simulate
from freddie_tpu_torch import cli
from freddie_tpu_torch.stages import workflow as twf
from test_torch_dist import BLOCK_JAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = BLOCK_JAX + textwrap.dedent("""
    import os
    from freddie_tpu import cli as jax_cli
    from freddie_tpu.stages import segment as jseg

    cfg, jax_out, torch_out = sys.argv[2:5]
    jseg.DEVICE_MIN_WORK = 0  # the JAX stage's dispatch at test size
    try:
        jax_cli.main(["workflow", cfg, "--set", f"outpath={jax_out}"])
    except ImportError as e:
        assert "jax" in str(e), e
        assert os.path.isdir(os.path.join(jax_out, "results", "S1", "split"))
        print("JAX_WORKFLOW_IMPORT_ERROR")

    from freddie_tpu_torch import cli
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.stages import segment as tseg

    tseg.DEVICE_MIN_WORK = 0
    tseg.STREAM_CHUNK_MAX = 8
    calls = []
    orig = segdp_cuda._solve_batch_torch
    segdp_cuda._solve_batch_torch = lambda *a, **k: calls.append(1) or orig(*a, **k)
    rc = cli.main(["workflow", cfg, "--set", f"outpath={torch_out}", "--device", "cpu"])
    assert rc == 0 and calls, (rc, calls)
    assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    print("PORT_WORKFLOW_OK", len(calls))
""")


def _config(tmp_path):
    sim = simulate(seed=77, n_genes=6, isoforms_per_gene=2, reads_per_isoform=10,
                   end_jitter=25, indel_rate=0.1, junction_jitter=6)
    bam, fq = str(tmp_path / "S1.bam"), str(tmp_path / "S1.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    path = str(tmp_path / "wf.yaml")
    with open(path, "w") as f:
        f.write(f"outpath: {tmp_path}/unused\n"
                "samples:\n"
                "  S1:\n"
                f"    bam: {bam}\n"
                f"    reads: [{fq}]\n"
                "stages:\n"
                "  segment: {sigma: 5.0}\n")
    return path


def test_workflow_without_jax_matches_jax_workflow(tmp_path):
    cfg = _config(tmp_path)
    jax_out, torch_out = str(tmp_path / "jax_blocked"), str(tmp_path / "port")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _RUN, REPO, cfg, jax_out, torch_out],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_WORKFLOW_IMPORT_ERROR" in proc.stdout, proc.stdout[-2000:]
    assert "PORT_WORKFLOW_OK" in proc.stdout

    ref = twf.load_workflow_config(cfg, {"outpath": str(tmp_path / "jax")})
    run_jax_workflow(ref, log=lambda *a: None)
    gtfs = []
    for out in (torch_out, str(tmp_path / "jax")):
        with open(os.path.join(out, "results", "S1", "isoforms.gtf")) as f:
            gtfs.append(f.read())
    assert gtfs[0] == gtfs[1] and gtfs[0].count("\ttranscript\t") >= 6


def test_run_workflow_resume_and_stage_overrides(tmp_path):
    cfg = twf.load_workflow_config(_config(tmp_path), {"outpath": str(tmp_path / "o")})
    assert twf.apply_overrides(cfg, {"stages.cluster.timeout": 2.0}) is cfg
    quiet = dict(log=lambda *a: None)
    stats = twf.run_workflow(cfg, device="cpu", **quiet)
    assert set(stats) == {"S1"} and set(stats["S1"]) >= {"split", "segment", "gtf"}
    msgs = []
    again = twf.run_workflow(cfg, device="cpu", log=msgs.append)
    assert set(again["S1"]) == {"gtf"}
    assert sum("complete, skipping" in m for m in msgs) == 4


def test_cli_workflow_device_flag():
    p = cli.build_parser()
    args = p.parse_args(["workflow", "wf.yaml", "--set", "a.b=1", "--device", "cpu"])
    assert (args.device, args.overrides, args.no_resume) == ("cpu", ["a.b=1"], False)
    assert p.parse_args(["workflow", "wf.yaml"]).device == "cuda"
