"""The JAX package's corpus tests, through the port.

The corpora of tests/test_multicontig.py, test_nonspliced.py,
test_many_loci.py and test_pipeline_hard.py are simulated once (with the
port's simulator, the seeds those tests use) and run through
``freddie_tpu``'s pipeline and through the port's with ``device="cpu"`` and
the segment stage's device route forced at this size. Every segment and
cluster TSV and the GTF must be byte-identical (tolerance: none). Those
corpora have clean splice sites, so none of their DP problems has more
than two candidates and the forced route finds nothing to dispatch (which
is held too: the stage must agree with the JAX package that there is
nothing to solve); a twelve-gene variant of the many-loci corpus with
alternative splice sites and large deletions does reach the dispatch.
Then the resume cases of tests/test_fault_recovery.py on the port's pipeline.
"""

import filecmp
import os
import random
import shutil

import pytest

from freddie_tpu.config import PipelineConfig as JaxPipelineConfig
from freddie_tpu.config import SplitConfig as JaxSplitConfig
from freddie_tpu.stages.pipeline import run_pipeline as run_jax_pipeline
from freddie_tpu_torch.config import ClusterConfig, PipelineConfig, SplitConfig
from freddie_tpu_torch.io.bam import FLAG_REVERSE, BamRecord, BamWriter
from freddie_tpu_torch.stages import segment as tseg
from freddie_tpu_torch.stages.cluster import run_cluster
from freddie_tpu_torch.stages.pipeline import run_pipeline
from freddie_tpu_torch.utils.fsio import MARKER, is_complete
from freddie_tpu_torch.utils.sim import (
    Simulation, make_gene, make_isoforms, random_genome, simulate, simulate_read)


def _two_contigs(d):
    """tests/test_multicontig.py's two-contig BAM and FASTQ."""
    rng = random.Random(5)
    sims = []
    for ci, contig in enumerate(("chr1", "chr2")):
        sim = Simulation(contig=contig, contig_len=2_000_000,
                         genome=random_genome(2_000_000, rng), transcripts=[])
        for tr in make_isoforms(rng, make_gene(rng, contig, 10_000, 4), 2, contig, ci):
            sim.transcripts.append(tr)
            sim.reads += [simulate_read(rng, sim, tr, i) for i in range(6)]
        sims.append(sim)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    with BamWriter(bam, ["chr1", "chr2"], [2_000_000, 2_000_000]) as w:
        for ci, sim in enumerate(sims):
            for r in sorted(sim.reads, key=lambda r: r.pos):
                w.write(BamRecord(
                    query_name=f"{r.name}.c{ci}", flag=FLAG_REVERSE if r.strand == "-" else 0,
                    reference_id=ci, reference_start=r.pos, mapq=60, cigartuples=r.cigar,
                    query_sequence=r.aligned_seq))
    with open(fq, "w") as f:
        for ci, sim in enumerate(sims):
            for r in sim.reads:
                f.write(f"@{r.name}.c{ci}\n{r.fastq_seq}\n+\n{'I' * len(r.fastq_seq)}\n")
    return bam, fq


def _simulated(**kwargs):
    def write(d):
        sim = simulate(**kwargs)
        bam, fq = str(d / "r.bam"), str(d / "r.fastq")
        sim.write_bam(bam)
        sim.write_fastq(fq)
        return bam, fq
    return write


# name -> (writer of the BAM and FASTQ, consider_nonspliced, transcripts
# expected at least); DISPATCHING: the corpora whose problems reach the DP.
DISPATCHING = {"twelve_genes_alt_splice"}
CORPORA = {
    "twelve_genes_alt_splice": (_simulated(seed=11, n_genes=12, isoforms_per_gene=3,
                                           reads_per_isoform=80, end_jitter=20,
                                           indel_rate=0.05, junction_jitter=4,
                                           alt_splice=True, big_del_rate=0.06), False, 36),
    "two_contigs": (_two_contigs, False, 4),
    "nonspliced": (_simulated(seed=77, n_genes=2, isoforms_per_gene=1, reads_per_isoform=8,
                              exons_per_gene=1), True, 2),
    "forty_genes": (_simulated(seed=11, n_genes=40, isoforms_per_gene=3,
                               reads_per_isoform=80, end_jitter=20, indel_rate=0.05,
                               junction_jitter=4), False, 120),
    "minus_strand": (_simulated(seed=21, n_genes=2, isoforms_per_gene=1,
                                reads_per_isoform=10, minus_strand_genes=True), False, 2),
    "truncated_tailless": (_simulated(seed=22, n_genes=2, isoforms_per_gene=2,
                                      reads_per_isoform=12, truncate_prob=0.3,
                                      tail_prob=0.8), False, 4),
    "single_exon_skipped": (_simulated(seed=23, n_genes=1, isoforms_per_gene=1,
                                       reads_per_isoform=8, exons_per_gene=1), False, 0),
}
FORCED = dict(DEVICE_MIN_WORK=0, DEVICE_COVERAGE_MIN_TINTS=0, STREAM_CHUNK_MAX=8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Runs each corpus once through both packages, on demand:
    runs(name) -> (JAX output dir, port output dir, the port's dispatches)."""
    done = {}

    def get(name):
        if name not in done:
            write, nonspliced, _n = CORPORA[name]
            d = tmp_path_factory.mktemp(f"corpus_{name}")
            bam, fq = write(d)
            quiet = dict(log=lambda *a: None)
            run_jax_pipeline(bam, [fq], str(d / "jax"), JaxPipelineConfig(
                split=JaxSplitConfig(consider_nonspliced=nonspliced)), **quiet)
            saved = {k: getattr(tseg, k) for k in FORCED}
            orig, calls = tseg.dispatch_batch_device, []
            try:
                for k, v in FORCED.items():
                    setattr(tseg, k, v)
                tseg.dispatch_batch_device = lambda *a, **k: calls.append(1) or orig(*a, **k)
                run_pipeline(bam, [fq], str(d / "torch"), PipelineConfig(
                    split=SplitConfig(consider_nonspliced=nonspliced)), device="cpu", **quiet)
            finally:
                tseg.dispatch_batch_device = orig
                for k, v in saved.items():
                    setattr(tseg, k, v)
            done[name] = (str(d / "jax"), str(d / "torch"), len(calls))
        return done[name]

    return get


def _tsvs(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _dn, fns in os.walk(root) for f in fns if f.endswith(".tsv"))


@pytest.mark.parametrize("stage", ["segment", "cluster"])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_corpus_tsvs_match_the_jax_package(runs, name, stage):
    ref, port, dispatches = runs(name)
    names = _tsvs(os.path.join(ref, stage))
    assert names == _tsvs(os.path.join(port, stage))
    assert bool(names) == bool(CORPORA[name][2])
    assert (dispatches > 0) == (name in DISPATCHING), dispatches
    differ = [n for n in names if not filecmp.cmp(os.path.join(ref, stage, n),
                                                  os.path.join(port, stage, n), shallow=False)]
    assert not differ, differ[:5]


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_corpus_gtf_matches_the_jax_package(runs, name):
    ref, port, _dispatches = runs(name)
    with open(os.path.join(ref, "isoforms.gtf")) as a, open(os.path.join(port, "isoforms.gtf")) as b:
        want, got = a.read(), b.read()
    assert got == want
    assert got.count("\ttranscript\t") >= CORPORA[name][2]
    if not CORPORA[name][2]:
        assert got == ""  # nonspliced reads are dropped by default


# ------------------------------------------------- resume after a crashed stage


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fault")
    bam, fq = _simulated(seed=13)(d)
    out = str(d / "out")
    run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *_: None, device="cpu")
    return bam, fq, out


def test_pipeline_stages_marked_complete(pipe):
    _bam, _fq, out = pipe
    for stage in ("split", "segment", "cluster"):
        assert is_complete(os.path.join(out, stage)), stage
    assert is_complete(os.path.join(out, "isoforms.gtf"))


def _read(path):
    with open(path) as f:
        return f.read()


def test_resume_skips_complete_and_redoes_crashed_stage(pipe):
    bam, fq, out = pipe
    work = out + "_resume"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(out, work)
    # A crash during cluster: the marker missing and a stray partial file.
    os.remove(os.path.join(work, "cluster", MARKER))
    stray = os.path.join(work, "cluster", "chr1", "cluster_chr1_0.tsv.tmp")
    with open(stray, "w") as f:
        f.write("partial")
    os.remove(os.path.join(work, "isoforms.gtf"))
    kept = {}
    for root, _dirs, fns in os.walk(os.path.join(work, "cluster")):
        for fn in fns:
            if fn.endswith(".tsv"):
                kept[os.path.join(root, fn)] = os.path.getmtime(os.path.join(root, fn))
    logs = []
    run_pipeline(bam, [fq], work, PipelineConfig(), resume=True, log=logs.append, device="cpu")
    for p, m in kept.items():  # completed tints were reused, not redone
        assert os.path.getmtime(p) == m, p
    text = "\n".join(logs)
    assert "split: complete, skipping" in text
    assert "segment: complete, skipping" in text
    assert "cluster: incomplete output, resuming in place" in text
    assert not os.path.exists(stray)
    assert is_complete(os.path.join(work, "cluster"))
    for root, _dirs, fns in os.walk(os.path.join(out, "cluster")):
        for fn in fns:
            if fn != MARKER:
                a = os.path.join(root, fn)
                assert _read(a) == _read(a.replace(out, work, 1)), fn
    assert _read(os.path.join(work, "isoforms.gtf")) == _read(os.path.join(out, "isoforms.gtf"))


def test_cluster_per_tint_resume_recomputes_only_missing(pipe, tmp_path):
    _bam, _fq, out = pipe
    redo = str(tmp_path / "cluster_redo")
    shutil.copytree(os.path.join(out, "cluster"), redo)
    victims = sorted(os.path.join(root, fn) for root, _dirs, fns in os.walk(redo)
                     for fn in fns if fn.startswith("cluster_") and fn.endswith(".tsv"))
    assert victims
    os.remove(victims[0])
    with open(victims[0] + ".tmp", "w") as f:
        f.write("partial")
    mtimes = {p: os.path.getmtime(p) for p in victims[1:]}
    run_cluster(os.path.join(out, "segment"), redo, ClusterConfig(), device="cpu")
    assert _read(victims[0]) == _read(victims[0].replace(redo, os.path.join(out, "cluster"), 1))
    for p, m in mtimes.items():
        assert os.path.getmtime(p) == m, f"{p} was rewritten"
