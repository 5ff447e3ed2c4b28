"""The readers of the program's spans and counters (``spans.py`` and its six
metrics) fed one recorded CPU pass, a program that records no spans, and
the device-idle split by span on made-up stamps."""

import pytest
import torch

from portbench import registry, spans
from portbench.frozen import sim
from portbench.harness import RunRecord

READERS = ("segment.prepare_s", "segment.dispatch_s", "segment.readback_wait_s",
           "segment.finalize_s", "cluster.concurrency", "route.native_pct")


@pytest.fixture(scope="module")
def recorded_pass(tmp_path_factory):
    """One CPU pass of run_pipeline under the profiler, with the segment
    stage's device route forced at this size and the cluster stage on 4
    threads: (its run record, its stage seconds)."""
    from freddie_tpu_torch.config import ClusterConfig, PipelineConfig
    from freddie_tpu_torch.stages import segment
    from freddie_tpu_torch.stages.pipeline import run_pipeline
    from freddie_tpu_torch.utils import metrics

    d = tmp_path_factory.mktemp("spans")
    s = sim.simulate(seed=2147483659, n_genes=6, isoforms_per_gene=3, reads_per_isoform=12,
                     end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6)
    s.write_bam(str(d / "r.bam"))
    s.write_fastq(str(d / "r.fastq"))
    mp = pytest.MonkeyPatch()
    mp.setattr(segment, "DEVICE_MIN_WORK", 0)
    mp.setattr(segment, "DEVICE_COVERAGE_MIN_TINTS", 0)
    mp.setattr(segment, "STREAM_CHUNK_MAX", 8)
    metrics.clear_recorded()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            stats = run_pipeline(str(d / "r.bam"), [str(d / "r.fastq")], str(d / "out"),
                                 PipelineConfig(cluster=ClusterConfig(threads=4)),
                                 log=lambda *a: None, device="cpu")
    finally:
        mp.undo()
    record = RunRecord(passes=[], window_s=1.0, setup_s=0.0,
                       traced=dict(passes=1, ops=[], k1_ops=[], k1_calls=[]))
    yield record, {k: v["seconds"] for k, v in stats.items() if isinstance(v, dict)}
    metrics.clear_recorded()


def test_the_six_readers_read_a_recorded_pass(recorded_pass):
    record, stage_s = recorded_pass
    got = {name: registry.reader(name)(record) for name in READERS}
    assert all(v is not None for v in got.values()), got
    phases = [got[n] for n in READERS[:4]]
    assert all(v > 0 for v in phases)
    # StageMetrics rounds to the ms
    assert sum(phases) <= stage_s["segment"] + 0.001
    assert 0 < got["cluster.concurrency"] <= 4
    assert got["route.native_pct"] == 100.0


def test_two_traced_passes_halve_the_seconds(recorded_pass):
    record, _ = recorded_pass
    two = RunRecord(passes=[], window_s=1.0, setup_s=0.0, traced=dict(record.traced, passes=2))
    for name in READERS[:4]:
        assert registry.reader(name)(two) == pytest.approx(registry.reader(name)(record) / 2)


def test_nothing_to_read_gives_none(recorded_pass, monkeypatch):
    from freddie_tpu_torch.utils import metrics

    untraced = RunRecord(passes=[], window_s=1.0, setup_s=0.0)
    traced = recorded_pass[0]
    for name in READERS:
        assert registry.reader(name)(untraced) is None
    # a program without spans, as before they were added
    monkeypatch.delattr(metrics, "recorded")
    for name in READERS:
        assert registry.reader(name)(traced) is None


def _span(sid, name, start, end, parent=None, thread=1):
    return dict(name=name, id=sid, parent=parent, pipeline=1, thread=thread, attrs={},
                counts={}, start_ns=start, end_ns=end)


def test_idle_time_is_named_by_the_innermost_span():
    got = [_span(1, "pipeline", 0, 100), _span(2, "stage.segment", 10, 90, 1),
           _span(3, "segment.prepare", 20, 40, 2), _span(4, "cluster.tint", 0, 100, 2, 2)]
    ops = [("k", 30, 35), ("k", 50, 60), ("k", 55, 70)]
    idle = spans.idle_by_span(got, ops)
    # the other thread's span names nothing; busy 30-35 and 50-70
    assert idle == pytest.approx({"pipeline": 20e-9, "stage.segment": 40e-9,
                                  "segment.prepare": 15e-9})
