"""The port's spans and counters (``utils.metrics.span``/``count``) on the
CPU: nothing recorded without a profiler, parents and pipeline ids under
one, the profiler's clock, pool threads, a whole pipeline's spans and
route counters, and the native loaders under concurrent threads."""

import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from freddie_tpu_torch.config import ClusterConfig, PipelineConfig
from freddie_tpu_torch.ops import _build
from freddie_tpu_torch.ops import polya
from freddie_tpu_torch.stages import pipeline as tpipe
from freddie_tpu_torch.stages import segment as tseg
from freddie_tpu_torch.utils import metrics
from freddie_tpu_torch.utils.sim import simulate

# Every span and counter the pipeline records, by name.
PIPELINE_SPANS = {
    "pipeline", "stage.split", "stage.segment", "stage.cluster", "stage.isoforms",
    "segment.prepare", "segment.dispatch", "segment.readback_wait", "segment.finalize",
    "segment.polya_batch", "cluster.tint",
}


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _clean():
    metrics.clear_recorded()
    yield
    metrics.clear_recorded()


def test_without_a_profiler_nothing_opens_or_records(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler event opened with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert metrics.span("a") is metrics.span("b", parent=None, x=1)
    with metrics.span("stage.segment", B=3) as rec:
        assert rec is None and metrics.current() is None
        metrics.count("route.native")
        with metrics.span("segment.prepare"):
            pass
    assert metrics.recorded() == []


def test_nested_spans_carry_parents_counts_and_one_pipeline_id():
    with _profile():
        with metrics.span("pipeline") as pipe:
            with metrics.span("stage.segment") as stage:
                with metrics.span("segment.dispatch", B=8, P=16, R=384) as chunk:
                    metrics.count("route.native", 2)
                    assert metrics.current() is chunk
                metrics.count("route.fallback")
                stage["attrs"]["route"] = "fallback"
        with metrics.span("pipeline") as pipe2:
            with metrics.span("stage.split") as split:
                pass
    got = metrics.recorded()
    assert [s["name"] for s in got] == ["pipeline", "stage.segment", "segment.dispatch",
                                       "pipeline", "stage.split"]
    assert pipe["parent"] is None and stage["parent"] == pipe["id"]
    assert chunk["parent"] == stage["id"]
    assert {s["pipeline"] for s in (pipe, stage, chunk)} == {pipe["id"]}
    assert split["pipeline"] == pipe2["id"] != pipe["id"]
    assert chunk["attrs"] == dict(B=8, P=16, R=384) and chunk["counts"] == {"route.native": 2}
    assert stage["counts"] == {"route.fallback": 1} and stage["attrs"] == {"route": "fallback"}
    for s in got:
        assert s["thread"] == threading.get_ident()
        assert s["start_ns"] <= s["end_ns"]
    assert pipe["start_ns"] <= stage["start_ns"] <= chunk["start_ns"]
    assert chunk["end_ns"] <= stage["end_ns"] <= pipe["end_ns"]


def test_a_span_starts_with_its_profiler_event():
    """Within 1 ms, and as a function-scope event: the profiler mirrors a
    user annotation onto the device's timeline over the kernels launched
    inside it, where a trace's reader would count it as device work."""
    with _profile() as prof:
        with metrics.span("pipeline"):
            with metrics.span("segment.prepare"):
                time.sleep(0.003)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in metrics.recorded():
        e = events["freddie." + s["name"]]
        assert abs(e.start_ns() - s["start_ns"]) < 1_000_000, s
        assert e.scope() == int(torch._C._profiler.RecordScope.FUNCTION)


def test_spans_in_pool_threads_name_the_submitting_span():
    def tint(i):
        with metrics.span("cluster.tint", parent=parent):
            metrics.count("route.native")
            time.sleep(0.002)
        return threading.get_ident()

    with _profile():
        with metrics.span("pipeline"):
            with metrics.span("stage.cluster") as stage:
                parent = metrics.current()
                with ThreadPoolExecutor(4) as ex:
                    threads = set(ex.map(tint, range(16)))
    tints = [s for s in metrics.recorded() if s["name"] == "cluster.tint"]
    assert len(tints) == 16 and threading.get_ident() not in threads
    assert {s["parent"] for s in tints} == {stage["id"]}
    assert {s["pipeline"] for s in tints} == {stage["pipeline"]}
    assert {s["thread"] for s in tints} == threads
    assert all(s["counts"] == {"route.native": 1} for s in tints)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_sample")
    sim = simulate(seed=77, n_genes=8, isoforms_per_gene=3, reads_per_isoform=12,
                   end_jitter=25, indel_rate=0.1, junction_jitter=6, alt_splice=True,
                   big_del_rate=0.06)
    sim.write_bam(str(d / "r.bam"))
    sim.write_fastq(str(d / "r.fastq"))
    return d


def _traced_pipeline(sample, out, monkeypatch):
    """One CPU pipeline run under the profiler with the segment stage's
    device route forced at this size and the cluster stage on 4 threads;
    returns its spans."""
    monkeypatch.setattr(tseg, "DEVICE_MIN_WORK", 0)
    monkeypatch.setattr(tseg, "DEVICE_COVERAGE_MIN_TINTS", 0)
    monkeypatch.setattr(tseg, "STREAM_CHUNK_MAX", 8)
    cfg = PipelineConfig(cluster=ClusterConfig(threads=4))
    with _profile():
        tpipe.run_pipeline(str(sample / "r.bam"), [str(sample / "r.fastq")], str(sample / out),
                           cfg, log=lambda *a: None, device="cpu")
    return list(metrics.recorded())


def _native_pct(spans):
    got = {}
    for s in spans:
        for k, v in s["counts"].items():
            got[k] = got.get(k, 0) + v
    return 100.0 * got.get("route.native", 0) / (got.get("route.native", 0)
                                                 + got.get("route.fallback", 0))


def test_a_pipeline_records_every_span_and_route(sample, monkeypatch):
    spans = _traced_pipeline(sample, "native", monkeypatch)
    names = {s["name"] for s in spans}
    assert PIPELINE_SPANS <= names, PIPELINE_SPANS - names
    (pipe,) = [s for s in spans if s["name"] == "pipeline"]
    assert all(s["pipeline"] == pipe["id"] for s in spans)
    by_id = {s["id"]: s for s in spans}
    stage = {s["name"]: s for s in spans if s["name"].startswith("stage.")}
    for s in spans:
        if s["name"].startswith("segment."):
            assert by_id[s["parent"]]["name"] == "stage.segment"
        if s["name"] == "cluster.tint":
            assert s["parent"] == stage["stage.cluster"]["id"]
            assert s["attrs"]["route"] == "native"
            assert stage["stage.cluster"]["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= stage["stage.cluster"]["end_ns"]
    for s in spans:
        if s["name"] == "segment.dispatch":
            assert {"B", "P", "R"} <= set(s["attrs"]) and s["attrs"]["B"] >= 1
    n_tints = sum(1 for s in spans if s["name"] == "segment.prepare")
    assert n_tints and n_tints == sum(1 for s in spans if s["name"] == "cluster.tint")
    assert _native_pct(spans) == 100.0


def test_the_route_counter_sees_the_python_cluster_path(sample, monkeypatch):
    monkeypatch.setenv("FREDDIE_CLUCORE", "0")
    spans = _traced_pipeline(sample, "fallback", monkeypatch)
    tints = [s for s in spans if s["name"] == "cluster.tint"]
    assert tints and all(s["attrs"]["route"] == "fallback" for s in tints)
    assert _native_pct(spans) < 100.0


def test_four_threads_loading_an_engine_into_a_fresh_directory_all_get_it(tmp_path,
                                                                         monkeypatch):
    """The smallest C engine (polyatok.c), built from nothing by four
    threads of one process at once: every thread loads it, and no
    temporary is left."""
    shutil.copy(os.path.join(_build.NATIVE_DIR, "polyatok.c"), tmp_path / "polyatok.c")
    monkeypatch.setattr(_build, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(polya, "_ctok_mod", None)
    monkeypatch.setattr(polya, "_ctok_failed", False)
    start = threading.Barrier(4)

    def load(_):
        start.wait()
        return polya._load_ctok()

    with _profile():
        with ThreadPoolExecutor(4) as ex:
            mods = list(ex.map(load, range(4)))
    assert all(m is not None and hasattr(m, "best_run") for m in mods)
    assert polya._ctok_mod is not None and not polya._ctok_failed
    assert sorted(os.listdir(tmp_path)) == ["polyatok.c", "polyatok.so"]
    assert any(s["name"] == "build.polyatok" for s in metrics.recorded())


def test_an_operators_trace_holds_every_stage_and_span(sample, tmp_path, monkeypatch):
    monkeypatch.setenv("FREDDIE_TRACE_DIR", str(tmp_path / "trace"))
    tpipe.run_pipeline(str(sample / "r.bam"), [str(sample / "r.fastq")], str(tmp_path / "out"),
                       PipelineConfig(), log=lambda *a: None, device="cpu")
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        text = f.read()
    for stage in ("split", "segment", "cluster", "isoforms"):
        assert f'"freddie.stage.{stage}"' in text
    assert '"freddie.segment.prepare"' in text and '"freddie.cluster.tint"' in text
