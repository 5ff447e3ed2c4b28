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
def test_k2_refuses_a_width_past_its_shared_memory(cuda_device):
    """Above K2_MAX_P a K2 block's shared memory does not fit: the wrapper
    raises and does not fall back; K1 takes the same batch."""
    from freddie_tpu_torch.ops import segdp_cuda

    P = 192
    assert P > segdp_cuda.K2_MAX_P
    rng = np.random.default_rng(P)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, 2, P, 64, False)
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    before = segdp_cuda.PIPELINED_LAUNCHES
    with pytest.raises(ValueError, match=f"P <= {segdp_cuda.K2_MAX_P}"):
        segdp_cuda.solve_batch_cuda(*args, pipelined=True)
    assert segdp_cuda.PIPELINED_LAUNCHES == before
    K1, bj1, bk1 = segdp_cuda.solve_batch_cuda(*args)
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    assert torch.equal(bj1, bjt) and torch.equal(K1[:, : P - 1], Kt[:, : P - 1])


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
def test_widest_bucket_launches_and_a_wider_one_goes_to_the_host(cuda_device):
    """P = 224, the widest bucket K1 holds, is launched and bit-equal to the
    plain version, chains included; problems of the P = 256 bucket sent
    through the dispatch are solved by the host oracle without a launch;
    the wrapper itself still raises at P = 256."""
    from freddie_tpu_torch.ops import segdp_cuda

    rng = np.random.default_rng(224)
    thr = ScaledThresholds(0.9)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    C, y, W, n_cand = padded_batch(rng, 4, 224, 64, False)
    n_cand[0] = 224
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    K, bj, bk, chains = segdp_cuda.solve_batch_cuda(*args, with_chains=True)
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(bj, bjt) and torch.equal(bk, bkt)
    assert torch.equal(K[:, :223], Kt[:, :223])
    assert torch.equal(chains, tseg._walk_chains(Kt, bjt, bkt))

    problems = [random_problem(rng, int(rng.integers(225, 250)), 16) for _ in range(3)]
    launches, routed = segdp_cuda.LAUNCHES, segdp_cuda.WIDE_HOST_BATCHES
    got = tseg.solve_batch_device(problems, thr, pad_p_to=256, device=cuda_device)
    assert got == [solve_host(p, thr) for p in problems]
    assert segdp_cuda.LAUNCHES == launches
    assert segdp_cuda.WIDE_HOST_BATCHES == routed + 1

    C, y, W, n_cand = padded_batch(rng, 1, 256, 64, False)
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        segdp_cuda.solve_batch_cuda(t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
