"""The port's distributed pipeline on torch.distributed (gloo), on the CPU.

Two worker processes in which `import jax` raises join a gloo group on
localhost and run the port's collective merge and its whole distributed
pipeline; the merged GTF and every shard TSV must be byte-identical to
the port's single-process run and to ``freddie_tpu``'s (as
tests/test_dist_e2e.py holds the JAX package's own distributed run).
Every wait is bounded: the process group's timeout and the
``communicate`` timeout turn a hang into a failure.
"""

import filecmp
import os
import socket
import subprocess
import sys
import textwrap

from freddie_tpu.config import PipelineConfig
from freddie_tpu.parallel.dist import owns_tint
from freddie_tpu.stages.pipeline import run_pipeline as run_jax_pipeline
from freddie_tpu.utils.sim import simulate
from freddie_tpu_torch.parallel import dist as tdist
from freddie_tpu_torch.stages.pipeline import run_pipeline as run_torch_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 120  # seconds, the process group's own bound
WAIT = 300  # seconds a test waits for its workers

# A prelude that makes `import jax` raise, then puts the repo on the path.
BLOCK_JAX = textwrap.dedent("""
    import importlib.abc, sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"{name} imported on the port's path")
            return None

    sys.meta_path.insert(0, NoJax())
    sys.path.insert(0, sys.argv[1])
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script: str, args: list[str], n: int = 2) -> list[str]:
    """Run ``script`` as ranks 0..n-1 (argv: repo, rank, *args) and return
    their stdouts; kills every worker if one outlasts WAIT."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [
        subprocess.Popen([sys.executable, "-c", script, REPO, str(r), *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(n)
    ]
    try:
        outs = [p.communicate(timeout=WAIT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, out[-2000:], err[-3000:])
    return [out for out, _err in outs]


_MERGE = BLOCK_JAX + textwrap.dedent(f"""
    from freddie_tpu_torch.parallel import dist
    rank, world = dist.initialize(f"127.0.0.1:{{sys.argv[3]}}", 2, int(sys.argv[2]),
                                  timeout={GROUP_TIMEOUT})
    local = [(("chr1", 10 + rank),
              f"chr1\\tx\\ttranscript\\t{{11 + rank}}\\t100\\t.\\t+\\t.\\tp{{rank}}")]
    if rank == 1:  # a rank with two records, one on another contig
        local.append((("chr0", 4), "chr0\\tx\\ttranscript\\t5\\t9\\t.\\t-\\t.\\tq1"))
    merged = dist.merge_gtf_records(local)
    assert [t[-2:] for _k, t in merged] == ["q1", "p0", "p1"], merged
    assert merged[0][0] == ("chr0", 4), merged
    assert "jax" not in sys.modules
    dist.dist.destroy_process_group()
    print(f"OK{{rank}}/{{world}}")
""")


def test_two_process_merge():
    outs = run_workers(_MERGE, [str(free_port())])
    for r, out in enumerate(outs):
        assert f"OK{r}/2" in out


def test_single_process_merge_is_a_sort():
    recs = [(("chr2", 5), "b"), (("chr1", 9), "a"), (("chr1", 2), "c")]
    assert tdist.initialize() == (0, 1)
    assert tdist.merge_gtf_records(recs) == sorted(recs)


_PIPELINE = BLOCK_JAX + textwrap.dedent(f"""
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.parallel import dist
    from freddie_tpu_torch.stages import segment as tseg

    # The segment stage's device route at test size (no work gate, chunks
    # of 8), with its plain DP counted.
    tseg.DEVICE_MIN_WORK = 0
    tseg.STREAM_CHUNK_MAX = 8
    calls = []
    orig = segdp_cuda._solve_batch_torch
    segdp_cuda._solve_batch_torch = lambda *a, **k: calls.append(1) or orig(*a, **k)
    port, out, bam, fq = sys.argv[3:7]
    rank, world = dist.initialize(f"127.0.0.1:{{port}}", 2, int(sys.argv[2]),
                                  timeout={GROUP_TIMEOUT})
    merged = dist.run_pipeline_distributed(bam, [fq], out, log=lambda *a: None,
                                           device="cpu")
    assert "jax" not in sys.modules
    dist.dist.destroy_process_group()
    print(f"RECORDS{{rank}}={{len(merged)}}")
    print(f"DP{{rank}}={{len(calls)}}")
""")

# Noisy enough that the tints pose DP problems (tests/test_torch_pipeline.py).
SIM = dict(seed=77, n_genes=8, isoforms_per_gene=3, reads_per_isoform=12,
           end_jitter=25, indel_rate=0.1, junction_jitter=6, alt_splice=True,
           big_del_rate=0.06, minus_strand_genes=True, tail_prob=0.8)


def _walk(root):
    out = {}
    for r, _d, fns in os.walk(root):
        for fn in fns:
            if not fn.startswith("."):  # completion markers are infrastructure
                out[os.path.relpath(os.path.join(r, fn), root)] = os.path.join(r, fn)
    return out


def test_two_process_pipeline_matches_single_runs(tmp_path):
    # the 8 simulated tints split across both ranks
    assert {p for t in range(8) for p in range(2) if owns_tint("chr1", t, p, 2)} == {0, 1}
    sim = simulate(**SIM)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    dist_out = str(tmp_path / "dist")
    outs = run_workers(_PIPELINE, [str(free_port()), dist_out, bam, fq])
    counts = {line.split("=")[1] for out in outs for line in out.splitlines()
              if line.startswith("RECORDS")}
    assert len(counts) == 1, outs
    assert sum(int(line.split("=")[1]) for out in outs for line in out.splitlines()
               if line.startswith("DP")) > 0, "no rank ran the DP's device route"

    quiet = dict(log=lambda *a: None)
    torch_out, jax_out = str(tmp_path / "torch"), str(tmp_path / "jax")
    run_torch_pipeline(bam, [fq], torch_out, PipelineConfig(), device="cpu", **quiet)
    run_jax_pipeline(bam, [fq], jax_out, PipelineConfig(), **quiet)
    with open(os.path.join(dist_out, "isoforms.gtf")) as f:
        gtf = f.read()
    assert gtf.count("\ttranscript\t") == int(counts.pop()) >= 4
    for single in (torch_out, jax_out):
        with open(os.path.join(single, "isoforms.gtf")) as f:
            assert f.read() == gtf, single
        for stage in ("segment", "cluster"):
            got, want = _walk(os.path.join(dist_out, stage)), _walk(os.path.join(single, stage))
            assert got and sorted(got) == sorted(want), (single, stage)
            for rel in want:
                assert filecmp.cmp(got[rel], want[rel], shallow=False), (single, stage, rel)


def test_rank_device():
    assert tdist.rank_device("cpu", 3) == "cpu"
    assert tdist.rank_device("cuda:1", 0) == "cuda:1"


def test_emulated_shards_isoforms_match_single(tmp_path):
    """Three shards run one after another in one process (each merge is a
    local sort); their union, sorted, is the single-process GTF."""
    sim = simulate(seed=31, n_genes=3, isoforms_per_gene=2, reads_per_isoform=8)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(tmp_path / "out")
    stats = run_torch_pipeline(bam, [fq], out, PipelineConfig(), device="cpu",
                               log=lambda *a: None)
    shards = [
        tdist.run_isoforms_distributed(
            os.path.join(out, "split"), os.path.join(out, "cluster"),
            str(tmp_path / f"shard_{pi}.gtf"), process_index=pi, process_count=3,
        )
        for pi in range(3)
    ]
    assert sum(len(r) for r in shards) > 0
    merged = sorted(r for recs in shards for r in recs)
    with open(stats["gtf"]) as f:
        assert "".join(t + "\n" for _k, t in merged) == f.read()
