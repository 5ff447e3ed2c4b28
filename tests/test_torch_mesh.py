"""The port's loci mesh on CPU devices against the JAX package's.

``solve_batch_sharded`` over n CPU devices must be bit-equal to
``freddie_tpu.parallel.mesh.solve_batch_sharded`` on the conftest's
8-device CPU mesh (backpointers and top pairs are integers: tolerance
zero), and the dispatch's multi-card route -- ``loci_devices`` patched to
return CPU devices, the work gate at zero -- must equal the host oracle,
padding and trim included.
"""

import numpy as np
import pytest
import torch

from freddie_tpu.ops.coverage import cumulative_coverage
from freddie_tpu.ops.segdp import DPProblem, solve_host
from freddie_tpu.ops.thresholds import ScaledThresholds
from freddie_tpu.parallel import mesh as jmesh
from freddie_tpu_torch.ops import segdp as tsegdp
from freddie_tpu_torch.parallel import mesh as tmesh
from test_segdp import random_problem

CPU = torch.device("cpu")


def _batch(seed, B=24, P=12, R=16, wide=False):
    rng = np.random.default_rng(seed)
    C = np.zeros((B, P, R), np.int32)
    y = np.zeros((B, P), np.int32)
    W = rng.integers(1, 5, size=(B, R)).astype(np.float32) * (97 if wide else 1)
    n = rng.integers(3, P + 1, size=B).astype(np.int32)
    for b in range(B):
        C[b] = np.cumsum(rng.integers(0, 10, size=(P, R)), axis=0)
        y[b] = np.sort(rng.choice(np.arange(2000), size=P, replace=False))
        C[b, n[b]:] = C[b, n[b] - 1]
        y[b, n[b]:] = y[b, n[b] - 1]
    return C, y, W, n


@pytest.mark.parametrize("return_chains", [False, True])
@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_sharded_matches_jax_mesh(n_dev, return_chains):
    thr = ScaledThresholds(0.9)
    C, y, W, n = _batch(n_dev, wide=n_dev == 3)
    args = (C, y, W, n, 3, np.asarray(thr.lookup), thr.scale)
    want = jmesh.solve_batch_sharded(*args, jmesh.loci_mesh(n_dev),
                                     return_chains=return_chains)
    got = tmesh.solve_batch_sharded(*args, [CPU] * n_dev, return_chains=return_chains)
    if return_chains:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, np.asarray(w))


def _iv_problem(rng, P, R, I=30):
    """A problem carrying its interval list, with C built from it on the host."""
    y = np.sort(rng.choice(np.arange(1, 5000), size=P, replace=False)).astype(np.int64)
    s = rng.integers(0, 4800, size=I)
    iv = np.stack([s, s + rng.integers(0, 300, size=I), rng.integers(0, R, size=I)],
                  axis=1).astype(np.int32)
    C = cumulative_coverage(iv[:, 0].astype(np.int64), iv[:, 1].astype(np.int64),
                            iv[:, 2].astype(np.int64), R, y, validate=True)[:P]
    W = rng.integers(1, 5, size=R).astype(np.int64)
    return DPProblem(C=C, y=y, W=W, read_support=2, iv=iv)


@pytest.fixture
def shards(monkeypatch):
    """Set the work gate to zero and spy on launch_sharded; returns the
    device counts it got, the keys of the arrays it was sent and their
    batch size."""
    monkeypatch.setattr(tmesh, "MESH_MIN_WORK", 0)
    calls = []
    orig = tmesh.launch_sharded

    def spy(arrays, *a, **k):
        calls.append((len(a[3]), sorted(arrays), len(arrays["n_cand"])))
        return orig(arrays, *a, **k)

    monkeypatch.setattr(tmesh, "launch_sharded", spy)
    return calls


@pytest.mark.parametrize("n_dev", [3, 4])
def test_dispatch_multi_card_route_matches_host(n_dev, shards, monkeypatch):
    """B=13 problems pad to 16, then to a multiple of the device count (18
    over 3); the trimmed chains equal solve_host."""
    monkeypatch.setattr(tmesh, "loci_devices", lambda: [CPU] * n_dev)
    thr = ScaledThresholds(0.9)
    rng = np.random.default_rng(40 + n_dev)
    problems = [random_problem(rng, int(rng.integers(2, 20)), int(rng.integers(1, 30)))
                for _ in range(13)]
    assert tsegdp.solve_batch_device(problems, thr, device="cuda") == [
        solve_host(p, thr) for p in problems]
    assert shards == [(n_dev, ["C", "W", "n_cand", "y"], 16 + (-16) % n_dev)]


@pytest.mark.parametrize("n_dev,route", [(4, "iv"), (3, "C")])
def test_dispatch_coverage_gate_on_the_mesh(n_dev, route, shards, monkeypatch):
    """The device-coverage route needs the padded batch to split evenly
    (as the JAX dispatch's gate); over 3 devices it ships dense C."""
    monkeypatch.setattr(tmesh, "loci_devices", lambda: [CPU] * n_dev)
    thr = ScaledThresholds(0.9)
    rng = np.random.default_rng(7)
    problems = [_iv_problem(rng, int(rng.integers(3, 14)), 5) for _ in range(13)]
    handles, work, res = tsegdp.dispatch_batch_device(problems, thr, dev_cov=True,
                                                      device="cuda")
    assert tsegdp.collect_batch_device(handles, work, res) == [
        solve_host(p, thr) for p in problems]
    assert shards[0][0] == n_dev and route in shards[0][1]


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_dispatch_over_an_explicit_device_list(n_dev):
    """``devices=`` splits the batch over exactly the devices listed, with
    no gate and nothing patched, and counts one sharded launch per batch
    split over more than one; the results equal solve_host."""
    thr = ScaledThresholds(0.9)
    rng = np.random.default_rng(60 + n_dev)
    problems = [random_problem(rng, int(rng.integers(2, 20)), int(rng.integers(1, 30)))
                for _ in range(9)]
    assert tmesh.MESH_MIN_WORK is None
    before = tmesh.SHARDED_LAUNCHES
    got = tsegdp.solve_batch_device(problems, thr, device="cuda", devices=[CPU] * n_dev)
    assert got == [solve_host(p, thr) for p in problems]
    assert tmesh.SHARDED_LAUNCHES - before == (n_dev > 1)


@pytest.mark.parametrize("gate,work,n_dev", [(100, 399, 1), (100, 400, 4), (None, 10**15, 1)])
def test_bare_cuda_shards_from_the_work_gate(gate, work, n_dev, monkeypatch):
    """The bare "cuda" splits over every card once each card's share of
    the batch reaches MESH_MIN_WORK; below it, or with no gate (the
    default), the current card."""
    monkeypatch.setattr(tmesh, "loci_devices", lambda: [CPU] * 4)
    monkeypatch.setattr(tmesh, "resolve_device", lambda dev: CPU)
    monkeypatch.setattr(tmesh, "MESH_MIN_WORK", gate)
    assert tmesh.devices_for("cuda", work) == [CPU] * n_dev


def test_devices_for_names_one_device():
    assert tmesh.devices_for("cpu", 10**12) == [CPU]
    with pytest.raises(ValueError):
        tmesh.launch_sharded(dict(y=np.zeros((5, 3), np.int32), W=np.zeros((5, 2), np.float32),
                                  n_cand=np.zeros(5, np.int32), C=np.zeros((5, 3, 2), np.int32)),
                             3, np.zeros(4, np.int32), 10, [CPU] * 2)
