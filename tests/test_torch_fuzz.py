"""Seed-shift fuzz of the port against the JAX package (slow: not in tier-1).

``FREDDIE_PARITY_SEED`` shifts the seed of each of the parity suite's three
simulation configs (tests/test_reference_parity.py), as it does there.
Both packages run the whole pipeline on the CPU, the port with its
segment stage's device route forced at this size; every segment and
cluster TSV and the GTF must be byte-identical (tolerance: none).
``python -m freddie_tpu_torch.tools.run_fuzz_shifts FIRST LAST`` runs this
file once per shift.
"""

import filecmp
import os

import pytest

from freddie_tpu.config import PipelineConfig as JaxPipelineConfig
from freddie_tpu.stages.pipeline import run_pipeline as run_jax_pipeline
from freddie_tpu_torch.config import PipelineConfig
from freddie_tpu_torch.stages import segment as tseg
from freddie_tpu_torch.stages.pipeline import run_pipeline
from freddie_tpu_torch.utils.sim import PARITY_CORPORA, parity_corpus, simulate

pytestmark = pytest.mark.slow
_SEED_SHIFT = int(os.environ.get("FREDDIE_PARITY_SEED", "0"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _dn, fns in os.walk(root) for f in fns
                  if f.endswith((".tsv", ".gtf")))


@pytest.mark.parametrize("name", sorted(PARITY_CORPORA))
def test_shifted_corpus_matches_the_jax_package(name, tmp_path, monkeypatch):
    sim = simulate(**parity_corpus(name, _SEED_SHIFT))
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    quiet = dict(log=lambda *a: None)
    ref, port = str(tmp_path / "jax"), str(tmp_path / "torch")
    run_jax_pipeline(bam, [fq], ref, JaxPipelineConfig(), **quiet)
    monkeypatch.setattr(tseg, "DEVICE_MIN_WORK", 0)
    monkeypatch.setattr(tseg, "DEVICE_COVERAGE_MIN_TINTS", 0)
    monkeypatch.setattr(tseg, "STREAM_CHUNK_MAX", 8)
    run_pipeline(bam, [fq], port, PipelineConfig(), device="cpu", **quiet)
    names = _files(ref)
    assert names and names == _files(port)
    assert any(n.startswith("segment") for n in names) and "isoforms.gtf" in names
    differ = [n for n in names
              if not filecmp.cmp(os.path.join(ref, n), os.path.join(port, n), shallow=False)]
    assert not differ, (_SEED_SHIFT, name, differ[:5])
