"""The port's copies of the host modules against the JAX package's, module by
module.

The port keeps its own copy of every host module it uses. Here the same
inputs, made from a seed with numpy or with the read simulator, go through
the JAX package's function and the port's; the results are integers,
bytes, strings or exactly representable floats, so equality is exact.
Objects of one package are handed to the other only through
``from_reference`` (tests/torch_port_helpers.py).
"""

import filecmp
import importlib
import os
import random

import numpy as np
import pytest

from test_golden import GOLDEN, SIM_KWARGS
from test_segdp import random_problem
from test_solver import random_instance
from torch_port_helpers import from_reference, plain

NOISY_SIM = dict(seed=77, n_genes=6, isoforms_per_gene=2, reads_per_isoform=10,
                 end_jitter=25, indel_rate=0.1, junction_jitter=6, alt_splice=True,
                 minus_strand_genes=True, tail_prob=0.8, truncate_prob=0.2)


def both(module: str):
    """(JAX package's module, port's module) of the same dotted name."""
    return (importlib.import_module(f"freddie_tpu.{module}"),
            importlib.import_module(f"freddie_tpu_torch.{module}"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _dirs, fns in os.walk(root) for f in fns)


def _same_tree(a, b):
    names = _files(a)
    assert names and names == _files(b)
    differ = [n for n in names
              if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)]
    assert not differ, differ[:5]


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """A noisy simulated sample written by the JAX package's simulator and
    split by its split stage: (bam, fastq, split_dir)."""
    ref_sim, _ = both("utils.sim")
    ref_split, _ = both("stages.split")
    ref_cfg, _ = both("config")
    d = tmp_path_factory.mktemp("parity_sample")
    sim = ref_sim.simulate(**NOISY_SIM)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    ref_split.run_split(bam, [fq], str(d / "split"), ref_cfg.SplitConfig())
    return bam, fq, str(d / "split")


# ---------------------------------------------------------------- utils, io


@pytest.mark.parametrize("kwargs", [SIM_KWARGS, NOISY_SIM], ids=["golden", "noisy"])
def test_simulator_writes_the_same_sample(kwargs, tmp_path):
    ref, port = both("utils.sim")
    for name, mod in (("ref", ref), ("port", port)):
        sim = mod.simulate(**kwargs)
        (tmp_path / name).mkdir()
        sim.write_bam(str(tmp_path / name / "r.bam"))
        sim.write_fastq(str(tmp_path / name / "r.fastq"))
        sim.write_annotation_gtf(str(tmp_path / name / "a.gtf"))
    _same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))


def test_bam_and_fastx_codecs_read_each_other(sample, tmp_path):
    bam, fq, _split = sample
    ref_bam, port_bam = both("io.bam")
    ref_fx, port_fx = both("io.fastx")

    def records(mod, path):
        reader = mod.BamReader(path)
        try:
            return plain(reader.references), [plain(r) for r in reader]
        finally:
            reader.close()

    want = records(ref_bam, bam)
    assert len(want[1]) > 50 and records(port_bam, bam) == want
    # The port's writer, read back by both.
    out = str(tmp_path / "port.bam")
    reader = port_bam.BamReader(bam)
    writer = port_bam.BamWriter(out, reader.references, reader.lengths)
    for rec in reader:
        writer.write(rec)
    writer.close()
    reader.close()
    assert records(ref_bam, out) == want and records(port_bam, out) == want
    assert list(port_fx.read_fastx(fq)) == list(ref_fx.read_fastx(fq))


def test_native_bam_decoder_matches(sample):
    bam, _fq, _split = sample
    ref, port = both("io.bam_native")
    if not ref.native_bam_available():
        pytest.skip("no C++ toolchain for the native BAM decoder")
    assert port.native_bam_available()
    got = [plain(r) for r in port.NativeBamReader(bam)]
    assert got and got == [plain(r) for r in ref.NativeBamReader(bam)]


@pytest.mark.parametrize("seed", range(4))
def test_cigar_intervals_and_strings(seed):
    ref, port = both("core.cigar")
    ref_bam, _ = both("io.bam")
    rng = random.Random(seed)
    for _ in range(50):
        cigar, qlen = [], 0
        for i in range(rng.randint(1, 12)):
            op = rng.choice([ref_bam.CMATCH, ref_bam.CINS, ref_bam.CDEL, ref_bam.CREF_SKIP,
                             ref_bam.CEQUAL, ref_bam.CDIFF])
            if i == 0:
                op = ref_bam.CMATCH
            n = rng.randint(1, 60)
            cigar.append((op, n))
            if op in (ref_bam.CMATCH, ref_bam.CINS, ref_bam.CEQUAL, ref_bam.CDIFF):
                qlen += n
        text = ref.cigar_to_str(cigar)
        assert port.cigar_to_str(cigar) == text
        assert port.str_to_cigar(text) == ref.str_to_cigar(text)
        start = rng.randint(0, 10_000)
        assert (plain(port.alignment_intervals(cigar, start, qlen))
                == plain(ref.alignment_intervals(cigar, start, qlen)))


def test_tsv_parse_and_format(sample, tmp_path):
    _bam, _fq, split_dir = sample
    ref, port = both("io.tsv")
    n = 0
    for d, _dirs, fns in os.walk(split_dir):
        for fn in sorted(fns):
            if not fn.startswith("split_"):
                continue
            path = os.path.join(d, fn)
            reads = os.path.join(d, "reads_" + fn[len("split_"):])
            a, b = ref.parse_split_tsv(path), port.parse_split_tsv(path)
            ref.load_read_sequences(a, reads)
            port.load_read_sequences(b, reads)
            assert plain(a) == plain(b)
            assert plain(port._parse_split_tsv_py(path)) == plain(ref._parse_split_tsv_py(path))
            n += 1
    assert n >= 4
    for fn in sorted(os.listdir(os.path.join(GOLDEN, "segment"))):
        path = os.path.join(GOLDEN, "segment", fn)
        a, b = ref.parse_segment_tsv(path), port.parse_segment_tsv(path)
        assert plain(a) == plain(b)
        assert plain(port._parse_segment_tsv_py(path)) == plain(ref._parse_segment_tsv_py(path))
    for fn in sorted(os.listdir(os.path.join(GOLDEN, "cluster"))):
        path = os.path.join(GOLDEN, "cluster", fn)
        assert plain(port.parse_cluster_tsv(path)) == plain(ref.parse_cluster_tsv(path))


def test_fsio_markers_and_atomic_write(tmp_path):
    ref, port = both("utils.fsio")
    out = tmp_path / "stage"
    out.mkdir()
    with port.atomic_write(str(out / "a.tsv")) as f:
        f.write("x\n")
    assert (out / "a.tsv").read_text() == "x\n" and not list(out.glob("*.tmp"))
    assert not ref.is_complete(str(out)) and not port.is_complete(str(out))
    port.mark_complete(str(out))
    assert ref.is_complete(str(out)) and port.is_complete(str(out))
    port.protect_outputs(str(out))
    assert not os.access(str(out / "a.tsv"), os.W_OK) or os.geteuid() == 0
    ref.set_writable(str(out))
    assert os.access(str(out / "a.tsv"), os.W_OK)


def test_stage_metrics_and_solver_log(tmp_path):
    ref, port = both("utils.metrics")
    ref_exact, _ = both("solver.exact")
    inst = random_instance(np.random.default_rng(3), 6, 5)
    res = ref_exact.solve_exact(inst)
    for name, mod, obj in (("ref", ref, inst), ("port", port, from_reference(inst))):
        log = mod.SolverLog(str(tmp_path / name), 7)
        log.dump_instance(0, 0, obj)
        log.record(0, 0, 6, res, 0.25)
        log.dump_solution(0, 0, res)
        log.close()
    _same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))
    assert (port.summarize_solver_logs(str(tmp_path / "port"))
            == ref.summarize_solver_logs(str(tmp_path / "ref")))
    m = port.StageMetrics("segment")
    m.add("tints", 3)
    assert m.finish()["tints"] == 3


# ---------------------------------------------------------------------- ops


@pytest.mark.parametrize("rate", [0.9, 0.85, 0.95, 0.5])
def test_thresholds(rate):
    ref, port = both("ops.thresholds")
    a, b = ref.ScaledThresholds(rate), port.ScaledThresholds(rate)
    assert a.scale == b.scale and np.array_equal(a.lookup, b.lookup)
    lens = np.arange(0, 5000, 7)
    assert np.array_equal(a.high_scaled(lens), b.high_scaled(lens))
    assert np.array_equal(a.nay_eq_scaled(lens), b.nay_eq_scaled(lens))
    assert port.smooth_threshold_table(rate) == ref.smooth_threshold_table(rate)


def _signal(rng, n):
    y = rng.integers(0, 30, size=n).astype(np.float64)
    if rng.random() < 0.4:
        y[rng.random(n) < 0.5] = 0.0
    return y


@pytest.mark.parametrize("seed", range(3))
def test_signal_and_floatsig(seed):
    ref, port = both("ops.signal")
    ref_fs, port_fs = both("ops.floatsig")
    rng = np.random.default_rng(seed)
    n_broken = 0
    for _ in range(40):
        ys = [_signal(rng, int(rng.integers(5, 300))) for _ in range(int(rng.integers(1, 4)))]
        sigma = float(rng.choice([1.0, 2.5, 5.0]))
        assert port_fs.gaussian_kernel(sigma, 4.0) == ref_fs.gaussian_kernel(sigma, 4.0)
        sm_a, c_a = ref.smooth_and_candidates(ys, sigma)
        sm_b, c_b = port.smooth_and_candidates(ys, sigma)
        assert [s.tobytes() for s in sm_a] == [s.tobytes() for s in sm_b]
        assert plain(c_a) == plain(c_b)
        assert port.variance_threshold(sm_b, 3.0) == ref.variance_threshold(sm_a, 3.0)
        y, cands = ys[0], c_a[0]
        assert (plain(port.refine_segmentation(y, list(cands), sigma))
                == plain(ref.refine_segmentation(y, list(cands), sigma)))
        assert (plain(port.refine_segmentation_scipy(y, list(cands), sigma))
                == plain(ref.refine_segmentation_scipy(y, list(cands), sigma)))
        if len(cands) >= 30:
            fixed = {0, len(cands) - 1}
            assert (plain(port.break_large_problems(list(cands), set(fixed), sm_b[0], 12))
                    == plain(ref.break_large_problems(list(cands), set(fixed), sm_a[0], 12)))
            n_broken += 1
    assert n_broken > 3


@pytest.mark.parametrize("seed", range(4))
def test_host_coverage(seed):
    ref, port = both("ops.coverage")
    rng = np.random.default_rng(seed)
    n_iv, n_reps = int(rng.integers(1, 200)), int(rng.integers(1, 20))
    starts = rng.integers(0, 1000, size=n_iv)
    ends = starts + rng.integers(0, 300, size=n_iv)
    reps = rng.integers(0, n_reps, size=n_iv)
    cands = np.unique(rng.integers(0, 1300, size=int(rng.integers(2, 40))))
    want = ref.cumulative_coverage(starts, ends, reps, n_reps, cands, validate=True)
    got = port.cumulative_coverage(starts, ends, reps, n_reps, cands, validate=True)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_polya_annotation(sample):
    _bam, _fq, split_dir = sample
    ref, port = both("ops.polya")
    ref_tsv, _ = both("io.tsv")
    rng = np.random.default_rng(5)
    bases = np.array(list("ACGT"))
    for _ in range(200):
        L = int(rng.integers(0, 400))
        w = bases[rng.integers(0, 4, size=L)]
        if L > 30:
            lo = int(rng.integers(0, L - 25))
            w[lo : lo + int(rng.integers(20, 80))] = "A"
        seq = "".join(w)
        assert (list(port.longest_poly_runs(seq, 0, L, 1, "A"))
                == list(ref.longest_poly_runs(seq, 0, L, 1, "A")))
        for strand in "+-":
            assert (port._best_poly(seq, 0, L, strand) == ref._best_poly(seq, 0, L, strand)
                    == port._best_poly_py(seq, 0, L, strand))
        assert port.poly_window(seq, 0, L, "-", "T") == ref.poly_window(seq, 0, L, "-", "T")
    # On real reads: each tint genotyped by the JAX package's host path,
    # then every read annotated by both packages.
    ref_seg, _ = both("stages.segment")
    ref_cfg, _ = both("config")
    ref_thr, _ = both("ops.thresholds")
    cfg = ref_cfg.SegmentConfig()
    thr = ref_thr.ScaledThresholds(cfg.threshold_rate)
    n, tokens = 0, set()
    for d, _dirs, fns in os.walk(split_dir):
        for fn in sorted(f for f in fns if f.startswith("split_")):
            tint = ref_tsv.parse_split_tsv(os.path.join(d, fn))
            ref_tsv.load_read_sequences(tint, os.path.join(d, "reads_" + fn[len("split_"):]))
            work, problems = ref_seg.prepare_tint(tint, cfg, thr)
            sols = [ref_seg.solve_host(p, thr) if len(p.y) > 2 else [] for p in problems]
            _positions, segs = ref_seg.genotype_tint(work, sols, cfg, thr)
            for read in tint.reads:
                args = (read.data, segs, read.intervals, read.seq, read.strand)
                want = ref.annotate_gaps_and_polya(*args)
                assert port.annotate_gaps_and_polya(*args) == want
                assert (plain(port._clip_context_py(*args[:4]))
                        == plain(ref._clip_context_py(*args[:4])))
                tokens |= {tok[:2] for tok in want}
                n += 1
    assert n > 100 and tokens & {"SA", "ST", "EA", "ET"}, "no polyA token: vacuous"


@pytest.mark.parametrize("seed", range(6))
def test_solve_host(seed):
    ref, port = both("ops.segdp")
    ref_thr, port_thr = both("ops.thresholds")
    rng = np.random.default_rng(seed)
    pr = random_problem(rng, int(rng.integers(3, 30)), int(rng.integers(1, 40)))
    want = ref.solve_host(pr, ref_thr.ScaledThresholds(0.9))
    assert port.solve_host(from_reference(pr), port_thr.ScaledThresholds(0.9)) == want


# ------------------------------------------------------------------- solver


def _result(res):
    return (res.status, res.objective, list(res.assigned),
            None if res.isoform is None else np.asarray(res.isoform).tolist(), res.nodes)


@pytest.mark.parametrize("seed", range(6))
def test_exact_brute_lp_and_segenum(seed):
    ref_exact, port_exact = both("solver.exact")
    ref_brute, port_brute = both("solver.brute")
    ref_lp, port_lp = both("solver.lp_bound")
    ref_se, port_se = both("solver.segenum")
    ref_native, port_native = both("solver.native")
    rng = np.random.default_rng(seed)
    inst = random_instance(rng, int(rng.integers(2, 11)), int(rng.integers(2, 7)))
    twin = from_reference(inst)
    assert _result(port_exact.solve_exact(twin)) == _result(ref_exact.solve_exact(inst))
    assert port_brute.brute_force_optimum(twin) == ref_brute.brute_force_optimum(inst)
    assert port_lp.lp_lower_bound(twin) == ref_lp.lp_lower_bound(inst)
    assert (_result(port_se._solve_segment_enum_py(twin))
            == _result(ref_se._solve_segment_enum_py(inst)))
    assert _result(port_se.solve_segment_enum(twin)) == _result(ref_se.solve_segment_enum(inst))
    assert port_se._granularity(twin) == ref_se._granularity(inst)
    assert port_native.native_available() == ref_native.native_available()
    a, b = ref_native.solve_exact_native(inst, 60.0, 0), port_native.solve_exact_native(
        twin, 60.0, 0)
    assert (a is None) == (b is None) and (a is None or _result(a) == _result(b))


@pytest.mark.parametrize("seed", range(4))
def test_two_phase_default_gates(seed):
    ref, port = both("solver.two_phase")
    rng = np.random.default_rng(100 + seed)
    inst = random_instance(rng, int(rng.integers(8, 40)), int(rng.integers(4, 14)))
    want = ref.solve_two_phase(inst, 60.0)
    assert _result(port.solve_two_phase(from_reference(inst), 60.0, "cpu")) == _result(want)
    assert port._objective_granularity(from_reference(inst)) == ref._objective_granularity(inst)


def test_audit_verdicts_match():
    ref, port = both("solver.audit")
    for seed in range(5):
        inst = random_instance(np.random.default_rng(200 + seed), 8, 6)
        assert (port.audit_instance(from_reference(inst), 30.0, device="cpu")
                == ref.audit_instance(inst, 30.0))


# ------------------------------------------------------------------- stages


def test_split_stage(sample, tmp_path):
    bam, fq, ref_split_dir = sample
    _ref, port = both("stages.split")
    _rc, port_cfg = both("config")
    for engine in ("auto", "python"):
        out = str(tmp_path / engine)
        os.environ["FREDDIE_SPLIT_ENGINE"] = engine
        try:
            port.run_split(bam, [fq], out, port_cfg.SplitConfig())
        finally:
            os.environ.pop("FREDDIE_SPLIT_ENGINE", None)
        _same_tree(out, ref_split_dir)


def test_segment_stage_host_route_and_single_tint(sample, tmp_path):
    _bam, _fq, split_dir = sample
    ref, port = both("stages.segment")
    ref_cfg, port_cfg = both("config")
    ref_tsv, port_tsv = both("io.tsv")
    ref.run_segment(split_dir, str(tmp_path / "ref"), ref_cfg.SegmentConfig(use_device=False))
    port.run_segment(split_dir, str(tmp_path / "port"),
                     port_cfg.SegmentConfig(use_device=False), device="cpu")
    _same_tree(str(tmp_path / "ref"), str(tmp_path / "port"))
    # The single-tint path, Python phase A.
    contig = sorted(os.listdir(split_dir))[0]
    path = os.path.join(split_dir, contig, f"split_{contig}_0.tsv")
    reads = os.path.join(split_dir, contig, f"reads_{contig}_0.tsv")
    a, b = ref_tsv.parse_split_tsv(path), port_tsv.parse_split_tsv(path)
    ref_tsv.load_read_sequences(a, reads)
    port_tsv.load_read_sequences(b, reads)
    pos_a = ref.segment_tint(a, ref_cfg.SegmentConfig(use_device=False))
    pos_b = port.segment_tint(b, port_cfg.SegmentConfig(use_device=False), device="cpu")
    assert pos_a == pos_b
    assert port_tsv.format_segment_tsv(b, pos_b) == ref_tsv.format_segment_tsv(a, pos_a)


def test_cluster_preprocessing_and_instances():
    ref, port = both("stages.cluster")
    ref_cfg, port_cfg = both("config")
    ref_tsv, port_tsv = both("io.tsv")
    for fn in sorted(os.listdir(os.path.join(GOLDEN, "segment"))):
        path = os.path.join(GOLDEN, "segment", fn)
        ta, tb = ref_tsv.parse_segment_tsv(path), port_tsv.parse_segment_tsv(path)
        ca, cb = ref_cfg.ClusterConfig(), port_cfg.ClusterConfig()
        ia, ib = ref.preprocess(ta, ca), port.preprocess(tb, cb)
        assert plain(ia) == plain(ib)
        pa, pb = ref.partition_reads(ta, ia, ca.max_ilp), port.partition_reads(tb, ib, cb.max_ilp)
        assert plain(pa) == plain(pb) and pa
        for (rem_a, inc_a), (rem_b, inc_b) in zip(pa, pb):
            inf_a, inf_b = ref.informative_segs(ta, ia, rem_a), port.informative_segs(tb, ib, rem_b)
            assert inf_a == inf_b
            a = ref.build_instance(ta, ia, rem_a, inc_a, inf_a, ca)
            b = port.build_instance(tb, ib, rem_b, inc_b, inf_b, cb)
            assert plain(a.rows) == plain(b.rows)
            for name in ("seg_len", "incomp", "garbage_arr", "gap_counts", "gap_lo",
                         "gap_hi", "gap_len_arr", "exons_mat", "corr_mat"):
                assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_cluster_and_isoforms_stages(tmp_path):
    ref_cl, port_cl = both("stages.cluster")
    ref_iso, port_iso = both("stages.isoforms")
    ref_cfg, port_cfg = both("config")
    for stage in ("split", "segment"):
        os.makedirs(tmp_path / stage / "chr1")
        for fn in os.listdir(os.path.join(GOLDEN, stage)):
            with open(os.path.join(GOLDEN, stage, fn), "rb") as f:
                (tmp_path / stage / "chr1" / fn).write_bytes(f.read())
    seg, split = str(tmp_path / "segment"), str(tmp_path / "split")
    for env in ({}, {"FREDDIE_CLUCORE": "0"}):
        tag = "py" if env else "native"
        os.environ.update(env)
        try:
            ref_cl.run_cluster(seg, str(tmp_path / f"ref_{tag}"), ref_cfg.ClusterConfig())
            port_cl.run_cluster(seg, str(tmp_path / f"port_{tag}"), port_cfg.ClusterConfig(),
                                device="cpu")
        finally:
            for k in env:
                os.environ.pop(k, None)
        _same_tree(str(tmp_path / f"ref_{tag}"), str(tmp_path / f"port_{tag}"))
    n_ref = ref_iso.run_isoforms(split, str(tmp_path / "ref_native"), str(tmp_path / "ref.gtf"),
                                 ref_cfg.IsoformsConfig())
    n_port = port_iso.run_isoforms(split, str(tmp_path / "port_native"),
                                   str(tmp_path / "port.gtf"), port_cfg.IsoformsConfig())
    assert n_ref == n_port > 0
    assert filecmp.cmp(str(tmp_path / "ref.gtf"), str(tmp_path / "port.gtf"), shallow=False)
    assert filecmp.cmp(str(tmp_path / "port.gtf"), os.path.join(GOLDEN, "isoforms.gtf"),
                       shallow=False)


def test_owns_tint_and_workflow_loader(tmp_path):
    from freddie_tpu.parallel.dist import owns_tint as ref_owns
    from freddie_tpu_torch.parallel.dist import owns_tint as port_owns

    for world in (1, 2, 3, 8):
        for rank in range(world):
            for tint in range(40):
                assert (port_owns("chr7", tint, rank, world)
                        == ref_owns("chr7", tint, rank, world))
    ref_wf, port_wf = both("stages.workflow")
    cfg = tmp_path / "wf.yaml"
    cfg.write_text("outpath: out/\nsamples:\n  S1:\n    bam: a.bam\n    reads: [a.fq]\n"
                   "stages:\n  segment: {sigma: 5.0}\n")
    over = {"stages.segment.sigma": 4.0, "stages.cluster.timeout": 2.0, "outpath": "x/"}
    assert (port_wf.load_workflow_config(str(cfg), dict(over))
            == ref_wf.load_workflow_config(str(cfg), dict(over)))


def test_segment_vis_and_plot_modules(sample, tmp_path):
    """The tooling stages: the segmentation-QC pickle holds the same
    arrays, and the plot stage's parsers read the same structures."""
    import pickle

    _bam, _fq, split_dir = sample
    ref_vis, port_vis = both("stages.segment_vis")
    ref_sim, _ = both("utils.sim")
    ref_seg, _ = both("stages.segment")
    ref_cfg, _ = both("config")
    seg_dir = str(tmp_path / "segment")
    ref_seg.run_segment(split_dir, seg_dir, ref_cfg.SegmentConfig(use_device=False))
    gtf = str(tmp_path / "a.gtf")
    ref_sim.simulate(**NOISY_SIM).write_annotation_gtf(gtf)
    contig = sorted(os.listdir(split_dir))[0]
    splits = sorted(os.path.join(split_dir, contig, f) for f in os.listdir(
        os.path.join(split_dir, contig)) if f.startswith("split_"))
    segs = sorted(os.path.join(seg_dir, contig, f) for f in os.listdir(
        os.path.join(seg_dir, contig)))
    ref_vis.run_segment_vis(splits, segs, gtf, str(tmp_path / "ref.pickle"))
    port_vis.run_segment_vis(splits, segs, gtf, str(tmp_path / "port.pickle"))
    with open(tmp_path / "ref.pickle", "rb") as f, open(tmp_path / "port.pickle", "rb") as g:
        assert plain(pickle.load(f)) == plain(pickle.load(g))
