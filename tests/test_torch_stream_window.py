"""The port's windowed streaming (``SegmentConfig.stream_window``) against
the unwindowed run and against the JAX package.

The three cases of tests/test_stream_window.py on ``freddie_tpu_torch``
with ``device="cpu"`` and the device route forced: the window set in the
config, by ``FREDDIE_SEGMENT_WINDOW``, and the automatic window of large
corpora. A window force-flushes partial buckets, so it makes more and
smaller dispatches; every segment TSV must stay byte-identical to the
port's unwindowed run and to ``freddie_tpu``'s (tolerance: none).
"""

import os

import pytest

from freddie_tpu.config import SegmentConfig as JaxSegmentConfig
from freddie_tpu.config import SplitConfig
from freddie_tpu.stages import segment as jseg
from freddie_tpu.stages.split import run_split
from freddie_tpu.utils.sim import simulate
from freddie_tpu_torch.config import SegmentConfig
from freddie_tpu_torch.stages import segment as tseg


def _tsv_bytes(outdir):
    files = sorted(os.path.join(dp, f) for dp, _dn, fns in os.walk(outdir)
                   for f in fns if f.endswith(".tsv"))
    assert files
    out = {}
    for f in files:
        with open(f, "rb") as fh:
            out[os.path.relpath(f, outdir)] = fh.read()
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The split directory of tests/test_stream_window.py's simulation and
    the JAX package's unwindowed segment TSVs for it (device route forced)."""
    work = tmp_path_factory.mktemp("torch_streamwin")
    sim = simulate(seed=58, n_genes=4, isoforms_per_gene=3, reads_per_isoform=25,
                   truncate_prob=0.2, end_jitter=15, junction_jitter=4, indel_rate=0.08,
                   alt_splice=True)
    bam, fq = str(work / "sim.bam"), str(work / "sim.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split = str(work / "split")
    run_split(bam, [fq], split, SplitConfig())
    saved = jseg.DEVICE_MIN_WORK
    jseg.DEVICE_MIN_WORK = 0
    try:
        jseg.run_segment(split, str(work / "jax"), JaxSegmentConfig())
    finally:
        jseg.DEVICE_MIN_WORK = saved
    return split, _tsv_bytes(str(work / "jax"))


@pytest.fixture
def dispatches(monkeypatch):
    """Forces the port's device route and counts its dispatches."""
    monkeypatch.setattr(tseg, "DEVICE_MIN_WORK", 0)
    calls = []
    orig = tseg.dispatch_batch_device
    monkeypatch.setattr(tseg, "dispatch_batch_device",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def _run(split, out, cfg=None):
    tseg.run_segment(split, str(out), cfg or SegmentConfig(), device="cpu")
    return _tsv_bytes(str(out))


def test_windowed_streaming_byte_identical(corpus, tmp_path, dispatches):
    split, jax_tsvs = corpus
    plain = _run(split, tmp_path / "plain")
    plain_calls = len(dispatches)
    assert plain_calls > 0
    del dispatches[:]
    windowed = _run(split, tmp_path / "win", SegmentConfig(stream_window=1))
    # window=1 flushes after every tint: strictly more, smaller launches.
    assert len(dispatches) > plain_calls
    assert windowed == plain == jax_tsvs


def test_window_env_override(corpus, tmp_path, dispatches, monkeypatch):
    split, jax_tsvs = corpus
    base = _run(split, tmp_path / "base")
    base_calls = len(dispatches)
    del dispatches[:]
    monkeypatch.setenv("FREDDIE_SEGMENT_WINDOW", "1")
    env = _run(split, tmp_path / "env")
    assert len(dispatches) > base_calls
    assert env == base == jax_tsvs


def test_auto_window_engages_on_huge_corpora(corpus, tmp_path, dispatches, monkeypatch):
    """Corpora of AUTO_WINDOW_MIN_TINTS tints or more get a window even at
    stream_window=0."""
    split, jax_tsvs = corpus
    monkeypatch.setattr(tseg, "AUTO_WINDOW_MIN_TINTS", 1)
    monkeypatch.setattr(tseg, "AUTO_WINDOW", 1)
    auto = _run(split, tmp_path / "auto")
    auto_calls = len(dispatches)
    del dispatches[:]
    monkeypatch.setattr(tseg, "AUTO_WINDOW_MIN_TINTS", 10**9)  # off
    plain = _run(split, tmp_path / "plain")
    assert auto_calls > len(dispatches)
    assert auto == plain == jax_tsvs


def test_buckets_wider_than_the_kernel_are_reported(corpus, tmp_path, monkeypatch, capfd):
    """A segment run for a card whose buckets are wider than K1 holds (the
    limit patched low, the card simulated: the dispatch's check needs only
    the device's type) says on stderr how many problems went to the host,
    the pipeline writes them into the stage's metrics, and the TSVs stay
    byte-identical. A run that routes nothing says nothing."""
    import torch

    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.stages import pipeline as tpipe

    split, jax_tsvs = corpus
    work = os.path.dirname(split)
    monkeypatch.setattr(tseg, "DEVICE_MIN_WORK", 0)
    stats = tpipe.run_pipeline(os.path.join(work, "sim.bam"), [os.path.join(work, "sim.fastq")],
                               str(tmp_path / "plain"), log=lambda *_: None, device="cpu")
    assert "wide_host_batches" not in stats["segment"]
    assert "solved on the host" not in capfd.readouterr().err

    monkeypatch.setattr(tseg, "resolve_device", lambda _d: torch.device("cpu"))
    monkeypatch.setattr(segdp_cuda, "K1_MAX_P", 8)
    real = tseg.run_segment
    monkeypatch.setattr(tpipe, "run_segment",
                        lambda s, o, c, device: real(s, o, c, device="cuda"))
    launches = segdp_cuda.LAUNCHES
    stats = tpipe.run_pipeline(os.path.join(work, "sim.bam"), [os.path.join(work, "sim.fastq")],
                               str(tmp_path / "wide"), log=lambda *_: None, device="cpu")
    seg = stats["segment"]
    assert seg["wide_host_batches"] > 0 and seg["wide_host_problems"] >= seg["wide_host_batches"]
    assert f"[segment] {seg['wide_host_problems']} DP problems" in capfd.readouterr().err
    assert segdp_cuda.LAUNCHES == launches
    assert _tsv_bytes(str(tmp_path / "wide" / "segment")) == jax_tsvs
