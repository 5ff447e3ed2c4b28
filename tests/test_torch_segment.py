"""The port's segment stage against freddie_tpu's, byte for byte.

The device route is forced at test size (no work gate, device coverage
from the first tint, chunks of 8), so the port's dispatch, coverage
build, plain DP, chain walk and readback thread all run on the CPU.
"""

import filecmp
import os

import pytest

from freddie_tpu.config import SegmentConfig, SplitConfig
from freddie_tpu.stages import segment as jseg
from freddie_tpu.stages.split import run_split
from freddie_tpu.utils.sim import simulate
from freddie_tpu_torch.ops import segdp as tsegdp
from freddie_tpu_torch.stages import segment as tseg


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_seg")
    sim = simulate(
        seed=77, n_genes=8, isoforms_per_gene=3, reads_per_isoform=12,
        end_jitter=25, indel_rate=0.1, junction_jitter=6, alt_splice=True,
        big_del_rate=0.06,
    )
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(d / "split")
    run_split(bam, [fq], out, SplitConfig())
    return out


def _tsv_set(outdir):
    return sorted(
        os.path.relpath(os.path.join(r, f), outdir)
        for r, _dirs, fns in os.walk(outdir) for f in fns
    )


def _assert_same_tree(a, b):
    names = _tsv_set(a)
    assert names and names == _tsv_set(b)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n


@pytest.fixture
def forced_device_route(monkeypatch):
    calls = []
    orig = tsegdp.dispatch_batch_device

    def spy(problems, thr, *a, **kw):
        calls.append((len(problems), kw.get("dev_cov")))
        return orig(problems, thr, *a, **kw)

    monkeypatch.setattr(tseg, "DEVICE_MIN_WORK", 0)
    monkeypatch.setattr(tseg, "DEVICE_COVERAGE_MIN_TINTS", 0)
    monkeypatch.setattr(tseg, "STREAM_CHUNK_MAX", 8)
    monkeypatch.setattr(tseg, "dispatch_batch_device", spy)
    return calls


def test_segment_matches_jax_stage(split_dir, tmp_path, forced_device_route):
    ref = str(tmp_path / "jax")
    jseg.run_segment(split_dir, ref, SegmentConfig())
    got = str(tmp_path / "torch")
    tseg.run_segment(split_dir, got, SegmentConfig(), device="cpu")
    assert len(forced_device_route) > 1, "the device route was not chunked"
    assert all(dev_cov for _n, dev_cov in forced_device_route)
    _assert_same_tree(ref, got)


def test_segment_matches_host_route(split_dir, tmp_path, forced_device_route,
                                    monkeypatch):
    """Dense C transfer (device coverage off), one chunk in flight, and the
    host oracle route all write the same bytes."""
    host = str(tmp_path / "host")
    tseg.run_segment(split_dir, host, SegmentConfig(use_device=False), device="cuda")
    assert not forced_device_route, "use_device=False must not dispatch"
    monkeypatch.setenv("FREDDIE_DEVICE_COVERAGE", "0")
    monkeypatch.setattr(tseg, "MAX_INFLIGHT_CHUNKS", 1)
    dense = str(tmp_path / "dense")
    tseg.run_segment(split_dir, dense, SegmentConfig(), device="cpu")
    assert forced_device_route
    _assert_same_tree(host, dense)


def test_segment_python_engine_route(split_dir, tmp_path, forced_device_route,
                                     monkeypatch):
    """With the native segcore engine off, tints take the Python phase A/C
    path (host polyA scorer) and still match the JAX stage."""
    monkeypatch.setenv("FREDDIE_SEGCORE", "0")
    ref = str(tmp_path / "jax")
    jseg.run_segment(split_dir, ref, SegmentConfig(use_device=False))
    got = str(tmp_path / "torch")
    tseg.run_segment(split_dir, got, SegmentConfig(), device="cpu")
    assert forced_device_route
    _assert_same_tree(ref, got)
