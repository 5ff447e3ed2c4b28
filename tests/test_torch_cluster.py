"""The port's cluster stage and its device bounds against the JAX package.

The wide and closure rungs of the cluster solver evaluate their bounds
through ``jax`` in ``freddie_tpu``; the port evaluates them with torch.
Here both run on the CPU from the same numpy-made instances. Every value
is an integer or a multiple of 0.5, so the tolerance is zero. The gates
are patched on ``freddie_tpu``'s modules, as tests/test_segenum_wide.py
patches them, and the port reads them from there.
"""

import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from freddie_tpu.config import ClusterConfig
from freddie_tpu.solver import segenum as jse
from freddie_tpu.solver import two_phase as jtp
from freddie_tpu.stages.cluster import run_cluster as run_jax_cluster
from freddie_tpu_torch import cli
from freddie_tpu_torch.solver import segenum as tse
from freddie_tpu_torch.solver.two_phase import solve_two_phase
from freddie_tpu_torch.stages.cluster import run_cluster
from freddie_tpu_torch.utils.sim import clustered_instance
from test_dense_conflicts import dense_instance
from test_golden import GOLDEN
from test_solver import random_instance

REPO = pathlib.Path(__file__).resolve().parent.parent

# Gate settings that send an instance to one rung (tests/test_segenum_wide.py):
# a node budget of 1 ends phase 1 at once; MAX_SEGS=8 declines the full
# enumeration; CLOSURE_CAP=0 declines the closure (-> wide), while
# BOUNDS_DEVICE_MIN=1 sends every closure's bounds to the device (the
# native round solver reads a gate <= 0 as "never").
RUNGS = {
    "wide": ({"MAX_SEGS": 8, "CLOSURE_CAP": 0}, "optimistic_device"),
    "closure": ({"MAX_SEGS": 8, "BOUNDS_DEVICE_MIN": 1}, "optimistic_masks_device"),
}


@pytest.fixture(params=sorted(RUNGS))
def rung(request, monkeypatch):
    """Forces one rung in both packages; returns (name, calls), where
    calls records every call of the port's device bound of that rung."""
    gates, bound = RUNGS[request.param]
    for name, value in gates.items():
        monkeypatch.setattr(jse, name, value)
    monkeypatch.setattr(jtp, "NODE_BUDGET", 1)
    calls = []
    real = getattr(tse, bound)
    monkeypatch.setattr(tse, bound, lambda *a, **k: calls.append(1) or real(*a, **k))
    return request.param, calls


def _same(a, b):
    assert a.status == b.status
    assert a.objective == b.objective
    assert a.assigned == b.assigned
    assert np.array_equal(np.asarray(a.isoform), np.asarray(b.isoform))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimistic_device_matches_jax(seed):
    inst = clustered_instance(np.random.default_rng(seed), 20, 21)
    want = jse._optimistic_device(inst, 1 << 21)
    got = tse.optimistic_device(inst, 1 << 21, "cpu")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    host = jse._PerStructure(inst).optimistic_block(np.arange(1 << 14, dtype=np.uint64))
    np.testing.assert_array_equal(got[: 1 << 14], host)


@pytest.mark.parametrize("Mi", [30, 70])  # one- and two-word masks
def test_optimistic_masks_device_matches_jax_and_host(Mi):
    rng = np.random.default_rng(Mi)
    ctx = jse._PerStructure(dense_instance(rng, 200, Mi, density=0.3))
    words = ctx.W
    masks = rng.integers(0, 1 << 62, size=(5000, words), dtype=np.uint64)
    masks[:, -1] &= np.uint64((1 << (Mi - 64 * (words - 1))) - 1)
    masks[:200] = ctx.I_int[:200]  # subsets that admit reads
    got = tse.optimistic_masks_device(ctx, masks, "cpu")
    np.testing.assert_array_equal(got, jse._optimistic_masks_device(ctx, masks))
    np.testing.assert_array_equal(got, ctx.optimistic_block(masks))
    assert (got < ctx.g_total).any(), "no mask admitted a read"


@pytest.mark.parametrize("make", [
    lambda: random_instance(np.random.default_rng(11), 16, 12),
    lambda: clustered_instance(np.random.default_rng(4), 40, 14),
    lambda: dense_instance(np.random.default_rng(6), 24, 13, density=0.4),
], ids=["random", "clustered", "dense"])
def test_two_phase_matches_jax(rung, make):
    name, calls = rung
    inst = make()
    want = jtp.solve_two_phase(inst, 120.0)
    got = solve_two_phase(inst, 120.0, "cpu")
    _same(got, want)
    assert got.nodes == want.nodes
    assert calls, f"the port's {name} rung did not evaluate its bounds"


def test_two_phase_wide_at_real_gates(monkeypatch):
    """Mi = 22 reaches the wide rung with MAX_SEGS and WIDE_MAX_SEGS as
    they are, once the closure is over its cap."""
    monkeypatch.setattr(jse, "CLOSURE_CAP", 0)
    monkeypatch.setattr(jtp, "NODE_BUDGET", 1)
    calls = []
    real = tse.solve_segment_enum_wide
    monkeypatch.setattr(tse, "solve_segment_enum_wide",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    inst = clustered_instance(np.random.default_rng(1), 20, 22)
    _same(solve_two_phase(inst, 120.0, "cpu"), jtp.solve_two_phase(inst, 120.0))
    assert calls


@pytest.fixture
def golden_segments(tmp_path):
    """The golden corpus's segment TSVs laid out as a segment stage
    writes them (one directory per contig)."""
    seg = tmp_path / "seg" / "chr1"
    seg.mkdir(parents=True)
    for fn in os.listdir(os.path.join(GOLDEN, "segment")):
        shutil.copy(os.path.join(GOLDEN, "segment", fn), seg / fn)
    return str(tmp_path / "seg")


def _tsvs(root):
    out = {}
    for d, _dirs, fns in os.walk(root):
        for fn in fns:
            if fn.endswith(".tsv"):
                with open(os.path.join(d, fn), "rb") as f:
                    out[os.path.relpath(os.path.join(d, fn), root)] = f.read()
    return out


def test_run_cluster_matches_jax(rung, golden_segments, tmp_path, monkeypatch):
    name, calls = rung
    if name == "wide":
        # The native whole-tint engine runs its own full enumeration at
        # Mi <= 20; the Python path takes the patched MAX_SEGS.
        monkeypatch.setenv("FREDDIE_CLUCORE", "0")
    run_jax_cluster(golden_segments, str(tmp_path / "jax"), ClusterConfig())
    n = run_cluster(golden_segments, str(tmp_path / "torch"), ClusterConfig(),
                    device="cpu")
    assert n == 2 and calls, f"the port's {name} rung never ran"
    want = _tsvs(tmp_path / "jax")
    assert len(want) == 2 and _tsvs(tmp_path / "torch") == want


def test_run_cluster_pool_matches_jax(golden_segments, tmp_path, monkeypatch):
    """The spawn-pool branch, forced through freddie_tpu's POOL_MIN_BYTES
    (read at call time), hands every worker device 'cpu' whatever the
    parent's device is, and writes what freddie_tpu's run_cluster writes.
    FREDDIE_CLUCORE=0 sends every tint through the port's cluster_tint in
    the workers."""
    import concurrent.futures as cf

    import torch

    from freddie_tpu.stages import cluster as jcl
    from freddie_tpu_torch import device as tdev

    monkeypatch.setenv("FREDDIE_CLUCORE", "0")
    run_jax_cluster(golden_segments, str(tmp_path / "jax"), ClusterConfig())
    monkeypatch.setattr(jcl, "POOL_MIN_BYTES", 0)
    # A parent device that no worker may inherit.
    monkeypatch.setattr(tdev, "resolve_device", lambda name: torch.device("meta"))
    jobs = []

    class SpyPool(cf.ProcessPoolExecutor):
        def map(self, fn, iterable, **kw):
            jobs.extend(iterable)
            return super().map(fn, jobs, **kw)

    def no_threads(*a, **k):
        raise AssertionError("the pool broke and fell back to threads")

    monkeypatch.setattr(cf, "ProcessPoolExecutor", SpyPool)
    monkeypatch.setattr(cf, "ThreadPoolExecutor", no_threads)
    n = run_cluster(golden_segments, str(tmp_path / "torch"), ClusterConfig(threads=2),
                    device="cuda")
    assert n == 2 and [j[4] for j in jobs] == ["cpu", "cpu"]
    want = _tsvs(tmp_path / "jax")
    assert len(want) == 2 and _tsvs(tmp_path / "torch") == want


def test_run_cluster_matches_golden(golden_segments, tmp_path):
    run_cluster(golden_segments, str(tmp_path / "out"), ClusterConfig(), device="cpu")
    for fn in os.listdir(os.path.join(GOLDEN, "cluster")):
        with open(os.path.join(GOLDEN, "cluster", fn)) as g, \
                open(tmp_path / "out" / "chr1" / fn) as f:
            assert g.read() == f.read(), fn


def test_run_cluster_cuda_without_gpu_raises(golden_segments, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the error path cannot be reached")
    with pytest.raises(RuntimeError, match="cuda"):
        run_cluster(golden_segments, str(tmp_path / "out"), ClusterConfig(),
                    device="cuda")


def test_cli_cluster(golden_segments, tmp_path):
    out = str(tmp_path / "cli")
    assert cli.main(["cluster", "-s", golden_segments, "-o", out, "--device", "cpu"]) == 0
    assert sorted(_tsvs(out)) == [f"chr1/cluster_chr1_{t}.tsv" for t in (0, 1)]


_NO_JAX = textwrap.dedent("""
    import importlib.abc, os, pickle, sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"{name} imported")
            return None

    sys.meta_path.insert(0, NoJax())
    sys.path.insert(0, sys.argv[1])
    from freddie_tpu.config import ClusterConfig
    from freddie_tpu.solver import segenum as jse
    from freddie_tpu.solver import two_phase as jtp
    from freddie_tpu_torch.solver.two_phase import solve_two_phase
    from freddie_tpu_torch.stages.cluster import run_cluster

    with open(sys.argv[2], "rb") as f:
        cases = pickle.load(f)
    seg_dir, work = sys.argv[3], sys.argv[4]
    saved = {k: getattr(jse, k) for k in ("MAX_SEGS", "CLOSURE_CAP", "BOUNDS_DEVICE_MIN")}
    out = {}
    for name, (gates, inst) in cases.items():
        for k, v in gates.items():
            setattr(jse, k, v)
        jtp.NODE_BUDGET = 1
        try:
            jtp.solve_two_phase(inst, 120.0)
        except ImportError as e:
            assert "jax" in str(e), e
        else:
            raise AssertionError(f"freddie_tpu solved the {name} rung without jax")
        res = solve_two_phase(inst, 120.0, "cpu")
        if name == "wide":
            os.environ["FREDDIE_CLUCORE"] = "0"
        run_cluster(seg_dir, os.path.join(work, name), ClusterConfig(), device="cpu")
        os.environ.pop("FREDDIE_CLUCORE", None)
        out[name] = (res.status, res.objective, res.assigned, res.isoform.tolist())
        for k, v in saved.items():
            setattr(jse, k, v)
    assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    with open(os.path.join(work, "results.pkl"), "wb") as f:
        pickle.dump(out, f)
    print("NO_JAX_OK")
""")


def test_port_cluster_runs_where_jax_is_missing(golden_segments, tmp_path, monkeypatch):
    """In a fresh interpreter where `import jax` raises, freddie_tpu's
    solver fails on both device rungs while the port's solver and cluster
    stage finish with what the JAX package computes here."""
    inst = random_instance(np.random.default_rng(11), 16, 12)
    cases, want_res, want_tsv = {}, {}, {}
    for name, (gates, _bound) in RUNGS.items():
        with monkeypatch.context() as m:
            for k, v in gates.items():
                m.setattr(jse, k, v)
            m.setattr(jtp, "NODE_BUDGET", 1)
            if name == "wide":
                m.setenv("FREDDIE_CLUCORE", "0")
            res = jtp.solve_two_phase(inst, 120.0)
            run_jax_cluster(golden_segments, str(tmp_path / f"jax_{name}"), ClusterConfig())
        want_res[name] = (res.status, res.objective, res.assigned, res.isoform.tolist())
        want_tsv[name] = _tsvs(tmp_path / f"jax_{name}")
        cases[name] = (gates, inst)
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    work = tmp_path / "nojax"
    work.mkdir()
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "FREDDIE_CLUCORE")}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(REPO), str(tmp_path / "cases.pkl"),
         golden_segments, str(work)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    with open(work / "results.pkl", "rb") as f:
        assert pickle.load(f) == want_res
    for name in RUNGS:
        assert _tsvs(work / name) == want_tsv[name], name
