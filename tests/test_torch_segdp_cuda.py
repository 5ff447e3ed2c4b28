"""The hand-written CUDA kernel against its plain PyTorch version, on the card.

This file imports no JAX (the machine with the card has none), so it
runs there on its own, without the suite's conftest (which imports jax):

    python -m pytest tests/test_torch_segdp_cuda.py -q --noconftest

Every test needs a GPU and skips without one. The tolerance is zero:
backpointers and top pairs are integers.
"""

import numpy as np
import pytest
import torch

from freddie_tpu_torch.ops import segdp as tseg
from freddie_tpu_torch.ops.segdp import ScaledThresholds, solve_host
from test_segdp import random_problem


def padded_batch(rng, B, P, R, wide):
    """B random problems (tests/test_segdp.py) of 6..P candidates padded to
    (P, R) as the dispatch pads them; weights x97 when ``wide``."""
    C = np.zeros((B, P, R), dtype=np.int32)
    y = np.zeros((B, P), dtype=np.int32)
    W = np.zeros((B, R), dtype=np.float32)
    n_cand = np.zeros((B,), dtype=np.int32)
    for b in range(B):
        p = int(rng.integers(6, P + 1))
        pr = random_problem(rng, p, R)
        C[b, :p] = pr.C
        C[b, p:] = pr.C[-1]
        y[b, :p] = pr.y
        y[b, p:] = pr.y[-1]
        W[b] = pr.W if not wide else pr.W * 97  # weights past 127
        n_cand[b] = p
    return C, y, W, n_cand


def segment_batch(rng, B, P, R, ties=False):
    """B problems of P candidates each with the structure of real
    coverage: candidates 5..40 bp apart, a quarter of them true
    breakpoints, and each rep covering each true segment fully or not at
    all, so that most pairs pass the thresholds and the DP has long chains
    to choose from; with ``ties`` unit weights, so that many sums are
    equal and the first-index rule decides."""
    C = np.zeros((B, P, R), dtype=np.int32)
    y = np.zeros((B, P), dtype=np.int32)
    for b in range(B):
        y[b] = np.concatenate([[0], np.cumsum(rng.integers(5, 41, size=P - 1))])
        seg = np.cumsum(rng.random(P) < 0.25)  # the true segment of candidate p's left gap
        covered = rng.random((seg[-1] + 1, R)) < 0.5
        gap = np.diff(y[b], prepend=0)[:, None]
        C[b] = np.cumsum(np.where(covered[seg], gap, 0), axis=0)
    W = (np.ones((B, R)) if ties else rng.integers(1, 5, size=(B, R))).astype(np.float32)
    return C, y, W, np.full((B,), P, dtype=np.int32)


@pytest.fixture
def cuda_device():
    """The card; the tests marked ``cuda`` skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("P,R", [(16, 128), (32, 512), (40, 100), (64, 512), (96, 256)])
def test_kernel_matches_plain(cuda_device, P, R, wide):
    """solve_batch_cuda == _solve_batch_torch: K rows 0..P-2, best_j and
    best_k bit-equal; K's last row carries (best_j, best_k) as the TPU
    kernel stores them. P=40/R=100 exercise ragged tiles, P=96 the
    multi-tile pair-statistics loop."""
    from freddie_tpu_torch.ops import segdp_cuda

    rng = np.random.default_rng(P + R + wide)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, 8, P, R, wide)
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    before = segdp_cuda.LAUNCHES
    Kc, bjc, bkc = segdp_cuda.solve_batch_cuda(*args)
    assert segdp_cuda.LAUNCHES == before + 1
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(bjc, bjt) and torch.equal(bkc, bkt)
    assert torch.equal(Kc[:, : P - 1], Kt[:, : P - 1])
    assert torch.equal(Kc[:, P - 1, 0], bjc) and torch.equal(Kc[:, P - 1, 1], bkc)


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("case", [
    dict(P=16, R=128), dict(P=32, R=384), dict(P=64, R=512),
    dict(P=64, R=384, short=True),  # n_cand far below P: dead blocks
    dict(P=32, R=96, wide=True, scale_w=300),  # three 7-bit limbs
    dict(P=16, R=6, scale_w=2**19),  # four limbs, a ragged stage
    dict(P=32, R=256, rs=1), dict(P=32, R=256, rs=40),  # the gate low and high
    dict(P=96, R=256),  # several 64 x 64 tiles
    dict(P=32, R=97, wide=True),  # odd R: reps padded to a whole stage
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_k1_live_tiles_limbs_gate_and_chains(cuda_device, case, tf32):
    """The redesigned K1 against the plain version (TF32 off and on: the
    integer products must not care) at candidate counts below P, wide
    weights, read_support at both ends, and its chains against
    _walk_chains."""
    from freddie_tpu_torch.ops import segdp_cuda

    P, R = case["P"], case["R"]
    rs, scale_w, short = case.get("rs", 3), case.get("scale_w", 1), case.get("short", False)
    rng = np.random.default_rng(P * 3 + R + rs)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, 16, max(6, P // 3) if short else P, R,
                                   case.get("wide", False))
    pad = P - C.shape[1]
    C = np.concatenate([C, np.repeat(C[:, -1:], pad, axis=1)], axis=1)
    y = np.concatenate([y, np.repeat(y[:, -1:], pad, axis=1)], axis=1)
    W = W * scale_w
    assert W.sum(1).max() < 2**24, "scores must stay exact in float32"
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], rs, lookup, thr.scale)
    Kc, bjc, bkc, chains = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    assert torch.equal(bjc, bjt) and torch.equal(bkc, bkt)
    assert torch.equal(Kc[:, : P - 1], Kt[:, : P - 1])
    assert torch.equal(chains, tseg._walk_chains(Kt, bjt, bkt))
    assert (bjt >= 0).any(), "no problem segmented: the case is vacuous"


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B,P,R", [(8, 16, 128), (8, 40, 100), (8, 64, 512), (3, 96, 256),
                                   (1, 32, 512), (401, 16, 128)])
def test_pipelined_kernel_matches_k1_and_plain(cuda_device, B, P, R, wide):
    """solve_batch_cuda(pipelined=True) runs K2 in one launch and equals K1
    and _solve_batch_torch: K rows 0..P-2, best_j, best_k bit-equal, K's
    last row (best_j, best_k), and its chains equal to K1's and to
    _walk_chains. B=1 is one block with one problem; B=401 has blocks that
    get two problems or more."""
    from freddie_tpu_torch.ops import segdp_cuda

    rng = np.random.default_rng(B + P + R + wide)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, B, P, R, wide)
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    before = (segdp_cuda.LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES)
    K2, bj2, bk2, chains2 = segdp_cuda.solve_batch_cuda(*args, pipelined=True,
                                                        with_chains=True)
    assert (segdp_cuda.LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES) == (before[0], before[1] + 1)
    K1, bj1, bk1, chains1 = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    for Kr, bjr, bkr in ((K1, bj1, bk1), (Kt, bjt, bkt)):
        assert torch.equal(bj2, bjr) and torch.equal(bk2, bkr)
        assert torch.equal(K2[:, : P - 1], Kr[:, : P - 1])
    assert torch.equal(K2[:, P - 1, 0], bj2) and torch.equal(K2[:, P - 1, 1], bk2)
    assert torch.equal(chains2, chains1)
    assert torch.equal(chains2, tseg._walk_chains(Kt, bjt, bkt))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=300, P=64, R=384, short=True),  # n_cand far below P: most k dead
    dict(B=300, P=32, R=96, wide=True, scale_w=300),  # three 7-bit limbs
    dict(B=40, P=16, R=6, scale_w=2**19),  # four limbs, a ragged stage
    dict(B=600, P=32, R=256, rs=1), dict(B=40, P=32, R=256, rs=40),  # the gate low and high
    dict(B=5, P=160, R=128),  # the widest bucket K2 takes
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_k2_live_k_limbs_gate_and_chains(cuda_device, case):
    """The redesigned K2 against K1 and the plain version at candidate
    counts below P, wide weights, read_support at both ends and the widest
    P, with more problems than blocks where the batch is large."""
    from freddie_tpu_torch.ops import segdp_cuda

    B, P, R = case["B"], case["P"], case["R"]
    rs, scale_w, short = case.get("rs", 3), case.get("scale_w", 1), case.get("short", False)
    rng = np.random.default_rng(P * 3 + R + rs)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, B, max(6, P // 3) if short else P, R,
                                   case.get("wide", False))
    pad = P - C.shape[1]
    C = np.concatenate([C, np.repeat(C[:, -1:], pad, axis=1)], axis=1)
    y = np.concatenate([y, np.repeat(y[:, -1:], pad, axis=1)], axis=1)
    W = W * scale_w
    assert W.sum(1).max() < 2**24, "scores must stay exact in float32"
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], rs, lookup, thr.scale)
    K2, bj2, bk2, chains2 = segdp_cuda.solve_batch_cuda(*args, pipelined=True,
                                                        with_chains=True)
    K1, bj1, bk1, chains1 = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    for Kr, bjr, bkr in ((K1, bj1, bk1), (Kt, bjt, bkt)):
        assert torch.equal(bj2, bjr) and torch.equal(bk2, bkr)
        assert torch.equal(K2[:, : P - 1], Kr[:, : P - 1])
    assert torch.equal(chains2, chains1)
    assert torch.equal(chains2, tseg._walk_chains(Kt, bjt, bkt))
    assert (bjt >= 0).any(), "no problem segmented: the case is vacuous"


@pytest.mark.cuda
@pytest.mark.parametrize("P", [192, 256])
def test_k2_above_its_shared_memory_keeps_h_in_device_memory(cuda_device, P):
    """Above K2_SMEM_MAX_P each block of K2's one-block route (forced:
    cluster_size=0) keeps its H in a plane of its own in device memory:
    K2 is bit-equal to K1 and to the plain version, chains included, with
    more problems than blocks so that blocks draw from the queue while
    others run."""
    from freddie_tpu_torch.ops import segdp_cuda

    assert P > segdp_cuda.K2_SMEM_MAX_P
    rng = np.random.default_rng(P)
    thr = ScaledThresholds(0.9)
    B = 3 * segdp_cuda.pipelined_grid(65535, P) + 1
    C, y, W, n_cand = padded_batch(rng, B, P, 64, False)
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    before = (segdp_cuda.PIPELINED_DEVICE_H_LAUNCHES, segdp_cuda.PIPELINED_CLUSTER_LAUNCHES)
    # The one-block route (by shape these widths take the cluster route).
    K2, bj2, bk2, chains2 = segdp_cuda.solve_batch_cuda(*args, pipelined=True,
                                                        with_chains=True, cluster_size=0)
    assert (segdp_cuda.PIPELINED_DEVICE_H_LAUNCHES, segdp_cuda.PIPELINED_CLUSTER_LAUNCHES) == (
        before[0] + 1, before[1])
    K1, bj1, bk1, chains1 = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    for Kr, bjr, bkr in ((K1, bj1, bk1), (Kt, bjt, bkt)):
        assert torch.equal(bj2, bjr) and torch.equal(bk2, bkr)
        assert torch.equal(K2[:, : P - 1], Kr[:, : P - 1])
    assert torch.equal(chains2, chains1)
    assert torch.equal(chains2, tseg._walk_chains(Kt, bjt, bkt))
    assert (bjt >= 0).any(), "no problem segmented: the case is vacuous"


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=8, P=256, R=128), dict(B=2, P=512, R=128),  # above K1_SMEM_MAX_P
    dict(B=8, P=224, R=128, cap=0), dict(B=8, P=64, R=512, cap=0, wide=True),  # forced
    dict(B=8, P=256, R=128, groups=3), dict(B=8, P=64, R=512, groups=8),  # forced groups
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_k1_with_h_in_device_memory_and_in_groups(cuda_device, case, monkeypatch):
    """K1 at the wide buckets (its cluster wavefront), with its
    wavefront's H in device memory at any P with the cap forced to 0 (the
    cluster kernel's device-memory instantiation), and over a batch cut
    into groups by a scratch budget forced low: bit-equal to the plain
    version, chains included, and to K1 with H in shared memory where
    that fits."""
    from freddie_tpu_torch.ops import segdp_cuda

    B, P, R = case["B"], case["P"], case["R"]
    rng = np.random.default_rng(B * P + R)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, B, P, R, case.get("wide", False))
    n_cand[0] = P
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    cap = case.get("cap")
    if "groups" in case:
        per = segdp_cuda.scratch_bytes(P)
        monkeypatch.setattr(segdp_cuda, "SCRATCH_BUDGET", per * (-(-B // case["groups"])))
        assert -(-B // segdp_cuda.group_size(B, P)) == case["groups"]
    before = (segdp_cuda.LAUNCHES, segdp_cuda.DEVICE_H_LAUNCHES, segdp_cuda.CLUSTER_LAUNCHES)
    K, bj, bk, chains = segdp_cuda.solve_batch_cuda(*args, with_chains=True, smem_max_p=cap)
    on_device = P > (segdp_cuda.cluster_smem_max_p() if cap is None else cap)
    on_cluster = on_device or P >= segdp_cuda.CLUSTER_MIN_P
    assert (segdp_cuda.LAUNCHES, segdp_cuda.DEVICE_H_LAUNCHES, segdp_cuda.CLUSTER_LAUNCHES) == (
        before[0] + 1, before[1] + on_device, before[2] + on_cluster)
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(bj, bjt) and torch.equal(bk, bkt)
    assert torch.equal(K[:, : P - 1], Kt[:, : P - 1])
    assert torch.equal(K[:, P - 1, 0], bj) and torch.equal(K[:, P - 1, 1], bk)
    assert torch.equal(chains, tseg._walk_chains(Kt, bjt, bkt))
    if P <= segdp_cuda.K1_SMEM_MAX_P:
        monkeypatch.undo()
        ref = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
        assert all(torch.equal(a, b) for a, b in zip((K, bj, bk, chains), ref))
    assert (bjt >= 0).any(), "no problem segmented: the case is vacuous"


@pytest.mark.cuda
def test_dispatch_on_card_matches_host(cuda_device):
    """The whole dispatch on the card (padding, int16 transfer, the kernel
    with its chain walk, pinned readback) against the host oracle."""
    rng = np.random.default_rng(42)
    thr = ScaledThresholds(0.9)
    problems = [
        random_problem(rng, int(rng.integers(2, 30)), int(rng.integers(1, 40)))
        for _ in range(17)
    ]
    host = [solve_host(p, thr) for p in problems]
    assert tseg.solve_batch_device(problems, thr, device=cuda_device) == host


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(cuda_device):
    from freddie_tpu_torch.ops import segdp_cuda

    thr = ScaledThresholds(0.9)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    y = torch.zeros((2, 16), dtype=torch.int32, device=cuda_device)
    W = torch.ones((2, 128), dtype=torch.float32, device=cuda_device)
    n = torch.full((2,), 16, dtype=torch.int32, device=cuda_device)
    C64 = torch.zeros((2, 16, 128), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        segdp_cuda.solve_batch_cuda(C64, y, W, n, 3, lookup, thr.scale)
    C = torch.zeros((2, 16, 128), dtype=torch.int32, device=cuda_device)
    for pipelined in (False, True):
        with pytest.raises(ValueError):
            segdp_cuda.solve_batch_cuda(C, y.cpu(), W, n, 3, lookup, thr.scale,
                                        pipelined=pipelined)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4])
def test_mesh_on_one_card_matches_k1_and_host(cuda_device, n_shards, monkeypatch):
    """solve_batch_sharded over the card listed n times (one stream per
    shard) is bit-equal to one K1 launch over the whole batch; the
    dispatch with loci_devices patched to those shards and the work gate
    at zero pads B=13 to a multiple of n and equals the host oracle."""
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.parallel import mesh

    rng = np.random.default_rng(n_shards)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, 16, 32, 128, False)
    devices = [cuda_device] * n_shards
    got = mesh.solve_batch_sharded(C, y, W, n_cand, 3, thr.lookup, thr.scale, devices)
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    want = segdp_cuda.solve_batch_cuda(t["C"], t["y"], t["W"], t["n_cand"], 3, lookup,
                                       thr.scale)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.cpu().numpy())

    monkeypatch.setattr(mesh, "loci_devices", lambda: devices)
    monkeypatch.setattr(mesh, "MESH_MIN_WORK", 0)
    problems = [random_problem(rng, int(rng.integers(2, 30)), int(rng.integers(1, 40)))
                for _ in range(13)]
    before = segdp_cuda.LAUNCHES
    assert tseg.solve_batch_device(problems, thr, device="cuda") == [
        solve_host(p, thr) for p in problems]
    assert segdp_cuda.LAUNCHES == before + n_shards


@pytest.mark.cuda
def test_wide_buckets_launch_on_the_card(cuda_device):
    """P = 224, the widest bucket whose H fits one block's shared memory,
    and P = 256, the first past it, are both launched (on clusters) and
    bit-equal to the plain version, chains included; problems of the P =
    256 bucket sent through the dispatch are solved by K1's cluster
    wavefront on the card, H in the cluster's shared memory, equal to the
    host oracle."""
    from freddie_tpu_torch.ops import segdp_cuda

    rng = np.random.default_rng(224)
    thr = ScaledThresholds(0.9)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    for P in (224, 256):
        C, y, W, n_cand = padded_batch(rng, 4, P, 64, False)
        n_cand[0] = P
        t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
        args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
        K, bj, bk, chains = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
        Kt, bjt, bkt = tseg._solve_batch_torch(*args)
        torch.cuda.synchronize()
        assert torch.equal(bj, bjt) and torch.equal(bk, bkt)
        assert torch.equal(K[:, : P - 1], Kt[:, : P - 1])
        assert torch.equal(chains, tseg._walk_chains(Kt, bjt, bkt))

    problems = [random_problem(rng, int(rng.integers(225, 250)), 16) for _ in range(3)]
    launches = (segdp_cuda.LAUNCHES, segdp_cuda.DEVICE_H_LAUNCHES, segdp_cuda.CLUSTER_LAUNCHES)
    got = tseg.solve_batch_device(problems, thr, pad_p_to=256, device=cuda_device)
    assert got == [solve_host(p, thr) for p in problems]
    assert (segdp_cuda.LAUNCHES, segdp_cuda.DEVICE_H_LAUNCHES, segdp_cuda.CLUSTER_LAUNCHES) == (
        launches[0] + 1, launches[1], launches[2] + 1)
    assert segdp_cuda.LAUNCH_SHAPES[-1][:2] == (4, 256)  # three problems pad to 4, not 8


def _wide_args(device, B, P, R, seed, structured=False, ties=False):
    """solve_batch_cuda's arguments for B random problems padded to (P, R)
    on ``device``, the first filling all P candidates; or, ``structured``,
    segment_batch's problems (with unit weights when ``ties``)."""
    rng = np.random.default_rng(seed)
    thr = ScaledThresholds(0.9)
    if structured:
        C, y, W, n_cand = segment_batch(rng, B, P, R, ties)
    else:
        C, y, W, n_cand = padded_batch(rng, B, P, R, False)
        n_cand[0] = P
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), device)
    lookup = torch.from_numpy(thr.lookup).to(device)
    return (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=8, P=256, R=128), dict(B=2, P=512, R=128),  # the wide buckets, by shape
    dict(B=8, P=224, R=128, cluster=0),  # against the one-block wavefront
    dict(B=8, P=256, R=128, cap=0), dict(B=2, P=512, R=128, cap=0),  # H in device memory
    dict(B=2, P=512, R=128, cluster=16),  # sixteen blocks a cluster
    dict(B=8, P=96, R=128, cluster=4), dict(B=8, P=64, R=512, cluster=2),  # forced, small P
    dict(B=1, P=160, R=128),  # one problem
    dict(B=8, P=192, R=64, structured=True),  # every candidate live, long chains
    dict(B=8, P=192, R=64, structured=True, ties=True),  # and unit weights: ties
    dict(B=2, P=512, R=128, structured=True, ties=True),
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_cluster_wavefront_matches_plain(cuda_device, case):
    """K1's cluster wavefront: K, best_j, best_k and the chains bit-equal to
    _solve_batch_torch (and, where given, to the one-block wavefront),
    with H in the cluster's shared memory and in device memory, on 2 to 16
    blocks a cluster; each call counts one CLUSTER_LAUNCHES."""
    from freddie_tpu_torch.ops import segdp_cuda

    B, P, R = case["B"], case["P"], case["R"]
    args = _wide_args(cuda_device, B, P, R, B * P + R, case.get("structured", False),
                      case.get("ties", False))
    N = case.get("cluster", 0) or None
    before = (segdp_cuda.CLUSTER_LAUNCHES, segdp_cuda.DEVICE_H_LAUNCHES)
    K, bj, bk, chains = segdp_cuda.solve_batch_cuda(*args, with_chains=True,
                                                    smem_max_p=case.get("cap"), cluster_size=N)
    assert (segdp_cuda.CLUSTER_LAUNCHES, segdp_cuda.DEVICE_H_LAUNCHES) == (
        before[0] + 1, before[1] + (case.get("cap") == 0))
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(bj, bjt) and torch.equal(bk, bkt)
    assert torch.equal(K[:, : P - 1], Kt[:, : P - 1])
    assert torch.equal(K[:, P - 1, 0], bj) and torch.equal(K[:, P - 1, 1], bk)
    assert torch.equal(chains, tseg._walk_chains(Kt, bjt, bkt))
    if case.get("cluster") == 0:
        one = segdp_cuda.solve_batch_cuda(*args, with_chains=True, cluster_size=0)
        assert all(torch.equal(a, b) for a, b in zip((K, bj, bk, chains), one))
    assert (bjt >= 0).any(), "no problem segmented: the case is vacuous"


@pytest.mark.cuda
def test_refused_cluster_launch_raises(cuda_device, monkeypatch):
    """A cluster launch the runtime refuses raises and falls back to
    nothing: here the cap is patched past what fits, so the P = 1024
    launch on 8 blocks, H's triangle in shared memory, asks a block for
    more shared memory than it has. The
    runtime reports at least one resident cluster of 8 and of 16 blocks at
    the wide widths, and cluster_size_for takes 16 exactly while the
    batch's clusters of 16 all fit."""
    from freddie_tpu_torch.ops import segdp_cuda

    for P in (segdp_cuda.CLUSTER_MIN_P, 256, 512):
        for N in (segdp_cuda.CLUSTER_SIZE, segdp_cuda.WIDE_CLUSTER_SIZE):
            assert segdp_cuda.cluster_occupancy(P, N)["max_active_clusters"] >= 1
        fit = segdp_cuda.cluster_occupancy(P, 16)["max_active_clusters"]
        assert segdp_cuda.cluster_size_for(fit, P) == 16
        assert segdp_cuda.cluster_size_for(fit + 1, P) == segdp_cuda.CLUSTER_SIZE
    args = _wide_args(cuda_device, 1, 1024, 64, 1024)
    monkeypatch.setattr(segdp_cuda, "cluster_smem_max_p", lambda N=None: 10**4)
    before = (segdp_cuda.LAUNCHES, segdp_cuda.CLUSTER_LAUNCHES)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        segdp_cuda.solve_batch_cuda(*args, cluster_size=8)
    assert (segdp_cuda.LAUNCHES, segdp_cuda.CLUSTER_LAUNCHES) == before


def _plain_in_parts(args, step=None):
    """_solve_batch_torch and _walk_chains over a batch, a few problems at
    a time (``step``, by default as many as 2^28 outside entries) so that
    the plain version's (b, P, P, P) tensors stay small."""
    C = args[0]
    B, P = C.shape[:2]
    step = step or max(1, 2**28 // P**3)
    parts = []
    for b0 in range(0, B, step):
        part = [a[b0:b0 + step] for a in args[:4]] + list(args[4:])
        res = tseg._solve_batch_torch(*part)
        parts.append(res + (tseg._walk_chains(*res),))
    return [torch.cat(x) for x in zip(*parts)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=1, P=192), dict(B=8, P=192), dict(B=2, P=224), dict(B=64, P=224),
    dict(B=1, P=256), dict(B=8, P=256), dict(B=64, P=256),
    dict(B=1, P=512), dict(B=2, P=512), dict(B=8, P=512),
    dict(B=8, P=256, cluster=8), dict(B=8, P=256, cluster=16),  # forced sizes
    dict(B=64, P=192, cluster=8),  # more problems than clusters of 8
    dict(B=8, P=256, cap=0), dict(B=2, P=512, cap=0),  # H in device memory
    dict(B=8, P=256, structured=True, ties=True),  # unit weights: ties
    dict(B=2, P=512, structured=True, ties=True),
    dict(B=8, P=192, structured=True),  # every candidate live, long chains
    dict(B=8, P=224, wide=True),  # weights past 127: two limbs
    dict(B=8, P=96), dict(B=128, P=96), dict(B=64, P=128), dict(B=5, P=160),  # from P = 96
    dict(B=8, P=64, cluster=4),  # forced below K2_CLUSTER_MIN_P
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_k2_cluster_route_matches_plain_and_k1(cuda_device, case):
    """K2's cluster route (segdp_pipelined_cluster_kernel): K, best_j,
    best_k and the chains bit-equal to the plain version and to K1, by
    shape (16 or 8 blocks a cluster, k2_cluster_size_for) and with the
    cluster size forced, H in the cluster's shared memory and in device
    memory, ties and wide weights; each call counts one
    PIPELINED_CLUSTER_LAUNCHES and no K1 launch."""
    from freddie_tpu_torch.ops import segdp_cuda

    B, P = case["B"], case["P"]
    R = 64 if B == 64 else 128
    if case.get("wide"):
        rng = np.random.default_rng(B * P)
        thr = ScaledThresholds(0.9)
        C, y, W, n_cand = padded_batch(rng, B, P, R, True)
        n_cand[0] = P
        t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
        args = (t["C"], t["y"], t["W"], t["n_cand"], 3,
                torch.from_numpy(thr.lookup).to(cuda_device), thr.scale)
    else:
        args = _wide_args(cuda_device, B, P, R, B * P + R + 9, case.get("structured", False),
                          case.get("ties", False))
    before = (segdp_cuda.LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES,
              segdp_cuda.PIPELINED_CLUSTER_LAUNCHES, segdp_cuda.PIPELINED_DEVICE_H_LAUNCHES)
    K2 = segdp_cuda.solve_batch_cuda(*args, pipelined=True, with_chains=True,
                                     smem_max_p=case.get("cap"), cluster_size=case.get("cluster"))
    assert (segdp_cuda.LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES,
            segdp_cuda.PIPELINED_CLUSTER_LAUNCHES, segdp_cuda.PIPELINED_DEVICE_H_LAUNCHES) == (
        before[0], before[1] + 1, before[2] + 1, before[3] + (case.get("cap") == 0))
    K1 = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
    plain = _plain_in_parts(args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(K2, K1))
    assert torch.equal(K2[1], plain[1]) and torch.equal(K2[2], plain[2])
    assert torch.equal(K2[0][:, : P - 1], plain[0][:, : P - 1])
    assert torch.equal(K2[3], plain[3])
    assert (plain[1] >= 0).any(), "no problem segmented: the case is vacuous"


@pytest.mark.cuda
def test_k2_refused_cluster_launch_raises(cuda_device, monkeypatch):
    """A launch of K2's cluster route that the runtime refuses raises and
    falls back to nothing: here the route's cap is patched past what
    fits, so P = 1024 on 8 blocks, H's triangle in shared memory, asks a
    block for more shared memory than it has (the runtime refuses it
    already when the wrapper asks how many such clusters fit). The runtime
    reports at least one resident cluster of the route
    at the wide widths, and k2_cluster_size_for takes 16 exactly while the
    batch needs at most K2_WIDE_PROBLEMS_PER_CLUSTER problems per resident
    cluster of 16."""
    from freddie_tpu_torch.ops import segdp_cuda

    for P in (192, 256):
        for N in (segdp_cuda.CLUSTER_SIZE, segdp_cuda.WIDE_CLUSTER_SIZE):
            assert segdp_cuda.k2_cluster_occupancy(P, N)["max_active_clusters"] >= 1
        most = (segdp_cuda.K2_WIDE_PROBLEMS_PER_CLUSTER
                * segdp_cuda.k2_cluster_occupancy(P, 16)["max_active_clusters"])
        assert segdp_cuda.k2_cluster_size_for(most, P) == 16
        assert segdp_cuda.k2_cluster_size_for(most + 1, P) == segdp_cuda.CLUSTER_SIZE
    assert segdp_cuda.k2_cluster_occupancy(512, 16)["max_active_clusters"] >= 1
    args = _wide_args(cuda_device, 1, 1024, 64, 1024)
    monkeypatch.setattr(segdp_cuda, "k2_cluster_smem_max_p", lambda N=None: 10**4)
    before = (segdp_cuda.PIPELINED_LAUNCHES, segdp_cuda.PIPELINED_CLUSTER_LAUNCHES)
    with pytest.raises(RuntimeError, match="failed"):
        segdp_cuda.solve_batch_cuda(*args, pipelined=True, cluster_size=8)
    assert (segdp_cuda.PIPELINED_LAUNCHES, segdp_cuda.PIPELINED_CLUSTER_LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("case", [
    # Past the widest P that a ring of two whole outside planes took (K1
    # refused these, K2 took its one-block route past 690): by shape.
    dict(B=8, P=704), dict(B=1, P=960), dict(B=2, P=960), dict(B=1, P=1312),
    # The ring of rows forced where the planes fit, so that it wraps
    # inside a step.
    dict(B=8, P=256, row_ring=True), dict(B=2, P=512, row_ring=True),
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_every_width_on_the_card_matches_plain(cuda_device, case, pipelined):
    """K1 and K2 at widths past their old ring's limit, and with the ring
    of rows forced: each call takes its kernel's
    cluster route (one CLUSTER_LAUNCHES or PIPELINED_CLUSTER_LAUNCHES) and
    K, best_j, best_k and the chains equal the plain version's, zero
    tolerance. P = 1312 is the first bucket whose outside tensor has more
    than 2^31 floats."""
    from freddie_tpu_torch.ops import segdp_cuda

    B, P = case["B"], case["P"]
    args = _wide_args(cuda_device, B, P, 128, B * P + 10)
    counts = lambda: (segdp_cuda.PIPELINED_CLUSTER_LAUNCHES if pipelined  # noqa: E731
                      else segdp_cuda.CLUSTER_LAUNCHES)
    before = counts()
    got = segdp_cuda.solve_batch_cuda(*args, pipelined=pipelined, with_chains=True,
                                      row_ring=case.get("row_ring"))
    torch.cuda.synchronize()
    assert counts() == before + 1
    plain = _plain_in_parts(args)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    assert torch.equal(got[0][:, : P - 1], plain[0][:, : P - 1])
    assert torch.equal(got[3], plain[3])
    assert (plain[1] >= 0).any(), "no problem segmented: the case is vacuous"
    del got, plain, args
    torch.cuda.empty_cache()


# Past what one K1 launch takes (segdp_cuda.K1_MAX_GRID_Y = 65,535).
BIG_B = 70_000


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True], ids=["k1", "k2"])
def test_a_batch_past_one_launch_matches_plain(cuda_device, pipelined):
    """K1 and K2 at B = 70,000, P = 16, R = 128 (the wrapper refused more
    than 65,535 problems): K1 in two group launches of 65,535 and 4,465,
    K2 in one; K, best_j, best_k and the chains equal to the plain version
    run in parts of 4,096 on the card, zero tolerance."""
    from freddie_tpu_torch.bench.common import synthetic_batch
    from freddie_tpu_torch.ops import segdp_cuda

    thr = ScaledThresholds(0.9)
    batch = synthetic_batch(np.random.default_rng(70_000), BIG_B, 16, 128, False)
    t = tseg.to_device(batch, cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3,
            torch.from_numpy(thr.lookup).to(cuda_device), thr.scale)
    before = (segdp_cuda.LAUNCHES, segdp_cuda.K1_GROUP_LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES)
    got = segdp_cuda.solve_batch_cuda(*args, pipelined=pipelined, with_chains=True)
    torch.cuda.synchronize()
    after = (segdp_cuda.LAUNCHES, segdp_cuda.K1_GROUP_LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == ([0, 0, 1] if pipelined else [1, 2, 0])
    plain = _plain_in_parts(args, step=4096)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    assert torch.equal(got[0][:, :15], plain[0][:, :15])
    assert torch.equal(got[3], plain[3])
    assert (plain[1] >= 0).any(), "no problem segmented: the case is vacuous"
    del got, plain, args, t
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_dispatch_past_one_launch_matches_parts(cuda_device):
    """solve_batch_device on 40,000 problems of at most 16 candidates,
    which the dispatch pads to 65,536 (it raised from 32,769): one K1 call
    in two group launches, and each problem's chain equal to the same
    problems solved through the same entry in parts of 4,096. The tests
    above hold that route against solve_host."""
    from freddie_tpu_torch.ops import segdp_cuda

    rng = np.random.default_rng(40_000)
    thr = ScaledThresholds(0.9)
    problems = [random_problem(rng, int(rng.integers(3, 17)), int(rng.integers(4, 40)))
                for _ in range(40_000)]
    before = (segdp_cuda.LAUNCHES, segdp_cuda.K1_GROUP_LAUNCHES)
    got = tseg.solve_batch_device(problems, thr, device=cuda_device)
    assert (segdp_cuda.LAUNCHES - before[0], segdp_cuda.K1_GROUP_LAUNCHES - before[1]) == (1, 2)
    assert segdp_cuda.LAUNCH_SHAPES[-1] == (65_536, 16, 128)
    want = []
    for b0 in range(0, len(problems), 4096):
        want += tseg.solve_batch_device(problems[b0:b0 + 4096], thr, device=cuda_device)
    assert got == want
    assert any(want), "no problem segmented: the case is vacuous"
