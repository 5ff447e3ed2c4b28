"""The port's batched polyA scan against the JAX package's, window by window.

The torch scan runs on the CPU here -- the plain version of what a CUDA
device runs -- under FREDDIE_POLYA_DEVICE=1, and is held against the JAX
module's packed associative scan (``_scan_batch_packed``), its numpy
twin (``_scan_np``) and the per-window host scorer. Every value is an
integer (found, first, length, count): equality is exact. The cases are
those of tests/test_polya_batch.py, plus the segment stage with the
batched route forced, byte for byte against the host route and the JAX
stage.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from freddie_tpu.config import SegmentConfig, SplitConfig
from freddie_tpu.ops import polya_batch as jpb
from freddie_tpu.stages import segment as jseg
from freddie_tpu.stages.split import run_split
from freddie_tpu.utils.sim import simulate
from freddie_tpu_torch.ops import polya_batch as tpb
from freddie_tpu_torch.stages import segment as tseg
from test_polya_batch import host_best, random_window


@pytest.fixture
def torch_scan(monkeypatch):
    """Route the CPU through the torch scan; returns a reader of the scans
    made since."""
    monkeypatch.setenv("FREDDIE_POLYA_DEVICE", "1")
    before = tpb.SCANS
    return lambda: tpb.SCANS - before


def _windows(seed, n, lo, hi, polya_prob=None):
    rng = np.random.default_rng(seed)
    windows, chars = [], []
    for _ in range(n):
        p = float(rng.uniform(0, 0.35)) if polya_prob is None else polya_prob
        windows.append(random_window(rng, int(rng.integers(lo, hi)), polya_prob=p))
        chars.append(str(rng.choice(["A", "T"])))
    return windows, chars


@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_scan_matches_jax_scan_and_numpy_twin(L, seed):
    """The packed scans on one grid: torch == JAX == _scan_np, every row."""
    windows, chars = _windows(seed, 300, 0, L + 1)
    rng = np.random.default_rng(seed + 100)
    windows += ["A" * L, "A" * 19, "", ("A" * 20 + "C" * 5) * (L // 25)]
    chars += ["A"] * 4
    B = len(windows)
    lens = np.array([len(w) for w in windows], np.int32)
    grid = np.zeros((B, L), np.uint8)
    grid[np.arange(L)[None, :] < lens[:, None]] = np.frombuffer("".join(windows).encode(),
                                                                np.uint8)
    match = grid == np.array([[ord(c)] for c in chars], np.uint8)
    match[rng.random(size=match.shape) < 0.05] |= True  # stray matches past the ends
    packed = np.packbits(match, axis=1)
    got = [t.numpy() for t in tpb._scan_batch_packed(torch.from_numpy(packed),
                                                      torch.from_numpy(lens))]
    want = [np.asarray(a) for a in jpb._scan_batch_packed(packed, lens)]
    twin = jpb._scan_np(match & (np.arange(L)[None, :] < lens[:, None]), lens)
    assert got[0].any(), "no run found: the case is vacuous"
    for g, w, t in zip(got, want, twin):
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.int64))
        np.testing.assert_array_equal(g, np.asarray(t).astype(np.int64))


def test_matches_host_random(torch_scan):
    windows, chars = _windows(0, 60, 0, 400, polya_prob=0.15)
    assert tpb.best_poly_batch(windows, chars, "cpu") == [
        host_best(w, c) for w, c in zip(windows, chars)]
    assert torch_scan() == 2  # one scan per length bucket


def test_edge_cases(torch_scan):
    windows = ["A" * 30, "A" * 17 + "C" + "A" * 2, "A" * 19, "", "C" * 100,
               ("A" * 20 + "C" * 5) * 4, "A" * 64, "T" * 65, "A" * 256]
    chars = ["A"] * len(windows)
    assert tpb.best_poly_batch(windows, chars, "cpu") == [
        host_best(w, c) for w, c in zip(windows, chars)]
    assert torch_scan() == 2


def test_long_window_fallback(torch_scan):
    w = random_window(np.random.default_rng(5), 3000, polya_prob=0.1)
    assert tpb.best_poly_batch([w, "A" * 257], ["A", "A"], "cpu") == [
        host_best(w, "A"), host_best("A" * 257, "A")]
    assert torch_scan() == 0  # both past MAX_WINDOW: the host scorer


@pytest.mark.parametrize("forced", [False, True])
def test_short_window_fuzz(forced, monkeypatch):
    """Lengths 1..256 at many purities: the torch scan (forced) and the CPU's
    host route both equal the per-window scorer and the JAX module."""
    windows, chars = _windows(17, 400, 1, 257)
    if forced:
        monkeypatch.setenv("FREDDIE_POLYA_DEVICE", "1")
    before = tpb.SCANS
    got = tpb.best_poly_batch(windows, chars, "cpu")
    assert (tpb.SCANS > before) == forced
    assert got == [host_best(w, c) for w, c in zip(windows, chars)]
    assert got == jpb.best_poly_batch(windows, chars)


def test_jax_forced_scan_agrees(torch_scan, monkeypatch):
    """Both packages' forced scans on the same windows, lengths 0..300."""
    windows, chars = _windows(29, 80, 0, 300, polya_prob=0.2)
    assert tpb.best_poly_batch(windows, chars, "cpu") == jpb.best_poly_batch(windows, chars)


def test_long_window_fuzz(torch_scan):
    windows, chars = _windows(11, 120, jpb.MAX_WINDOW + 1, 2200)
    assert tpb.best_poly_batch(windows, chars, "cpu") == [
        host_best(w, c) for w, c in zip(windows, chars)]


def test_annotate_batch_matches_host_per_read(torch_scan, tmp_path):
    """annotate_gaps_and_polya_batch == annotate_gaps_and_polya on simulated
    tints (both strands, noisy soft clips)."""
    from freddie_tpu.io.tsv import load_read_sequences, parse_split_tsv
    from freddie_tpu.ops.polya import annotate_gaps_and_polya
    from freddie_tpu.ops.thresholds import ScaledThresholds

    sim = simulate(seed=23)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split_dir = str(tmp_path / "split")
    counts = run_split(bam, [fq], split_dir, SplitConfig())
    cfg = SegmentConfig()
    thr = ScaledThresholds(cfg.threshold_rate)
    items, want = [], []
    for contig, n in counts.items():
        cdir = os.path.join(split_dir, contig)
        for t in range(n):
            tint = parse_split_tsv(os.path.join(cdir, f"split_{contig}_{t}.tsv"))
            load_read_sequences(tint, os.path.join(cdir, f"reads_{contig}_{t}.tsv"))
            work, problems = jseg.prepare_tint(tint, cfg, thr)
            sols = [jseg.solve_host(p, thr) if len(p.y) > 2 else [] for p in problems]
            _fp, segs = jseg.genotype_tint(work, sols, cfg, thr)
            for read in tint.reads:
                item = (read.data, segs, read.intervals, read.seq, read.strand)
                items.append(item)
                want.append(annotate_gaps_and_polya(*item))
    assert len(items) > 30
    got = tpb.annotate_gaps_and_polya_batch(items, "cpu")
    assert got == want
    assert torch_scan() > 0
    assert {tok[:2] for toks in got for tok in toks} & {"SA", "ST", "EA", "ET"}, \
        "no polyA token: the case is vacuous"


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_polya_seg")
    sim = simulate(seed=23, n_genes=6, isoforms_per_gene=2, reads_per_isoform=10,
                   minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(d / "split")
    run_split(bam, [fq], out, SplitConfig())
    return out


def _same_tree(a, b):
    names = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _d, fns in os.walk(a) for f in fns)
    assert names and names == sorted(os.path.relpath(os.path.join(r, f), b)
                                     for r, _d, fns in os.walk(b) for f in fns)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n


def test_segment_batched_polya_route(split_dir, tmp_path, monkeypatch):
    """Python-path tints (segcore off) with the batched polyA route forced
    (the read gate patched on each stage's own module) write
    the same bytes as the port's host route and the JAX stage's."""
    monkeypatch.setenv("FREDDIE_SEGCORE", "0")
    host = str(tmp_path / "host")
    tseg.run_segment(split_dir, host, SegmentConfig(), device="cpu")
    monkeypatch.setattr(jseg, "POLYA_DEVICE_MIN_READS", 0)
    monkeypatch.setattr(tseg, "POLYA_DEVICE_MIN_READS", 0)
    monkeypatch.setenv("FREDDIE_POLYA_DEVICE", "1")
    calls = []
    orig = tseg.annotate_gaps_and_polya_batch
    monkeypatch.setattr(tseg, "annotate_gaps_and_polya_batch",
                        lambda items, dev: calls.append(len(items)) or orig(items, dev))
    before = tpb.SCANS
    batched = str(tmp_path / "batched")
    tseg.run_segment(split_dir, batched, SegmentConfig(), device="cpu")
    assert len(calls) == 1 and calls[0] > 0 and tpb.SCANS > before
    ref = str(tmp_path / "jax")
    jseg.run_segment(split_dir, ref, SegmentConfig())
    _same_tree(host, batched)
    _same_tree(ref, batched)


def test_segment_polya_route_off_by_default(split_dir, tmp_path, monkeypatch):
    """Without the forcing variable a CPU device keeps the host scorer,
    whatever the read count."""
    monkeypatch.setenv("FREDDIE_SEGCORE", "0")
    monkeypatch.delenv("FREDDIE_POLYA_DEVICE", raising=False)
    monkeypatch.setattr(tseg, "POLYA_DEVICE_MIN_READS", 0)
    before = tpb.SCANS
    tseg.run_segment(split_dir, str(tmp_path / "out"), SegmentConfig(), device="cpu")
    assert tpb.SCANS == before
