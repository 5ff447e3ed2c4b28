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
    Kc, bjc, bkc = segdp_cuda.solve_batch_cuda(*args, wide_weights=wide)
    assert segdp_cuda.LAUNCHES == before + 1
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(bjc, bjt) and torch.equal(bkc, bkt)
    assert torch.equal(Kc[:, : P - 1], Kt[:, : P - 1])
    assert torch.equal(Kc[:, P - 1, 0], bjc) and torch.equal(Kc[:, P - 1, 1], bkc)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B,P,R", [(8, 16, 128), (8, 40, 100), (8, 64, 512), (3, 96, 256),
                                   (1, 32, 512), (401, 16, 128)])
def test_pipelined_kernel_matches_k1_and_plain(cuda_device, B, P, R, wide):
    """solve_batch_cuda(pipelined=True) runs K2 in one launch and equals K1
    and _solve_batch_torch: K rows 0..P-2, best_j, best_k bit-equal, K's
    last row (best_j, best_k). B=1 is one block with one problem; B=401
    has blocks that own two problems or more."""
    from freddie_tpu_torch.ops import segdp_cuda

    rng = np.random.default_rng(B + P + R + wide)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, B, P, R, wide)
    t = tseg.to_device(dict(C=C, y=y, W=W, n_cand=n_cand), cuda_device)
    lookup = torch.from_numpy(thr.lookup).to(cuda_device)
    args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, thr.scale)
    before = (segdp_cuda.LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES)
    K2, bj2, bk2 = segdp_cuda.solve_batch_cuda(*args, wide_weights=wide, pipelined=True)
    assert (segdp_cuda.LAUNCHES, segdp_cuda.PIPELINED_LAUNCHES) == (before[0], before[1] + 1)
    K1, bj1, bk1 = segdp_cuda.solve_batch_cuda(*args, wide_weights=wide)
    Kt, bjt, bkt = tseg._solve_batch_torch(*args)
    torch.cuda.synchronize()
    for Kr, bjr, bkr in ((K1, bj1, bk1), (Kt, bjt, bkt)):
        assert torch.equal(bj2, bjr) and torch.equal(bk2, bkr)
        assert torch.equal(K2[:, : P - 1], Kr[:, : P - 1])
    assert torch.equal(K2[:, P - 1, 0], bj2) and torch.equal(K2[:, P - 1, 1], bk2)


@pytest.mark.cuda
def test_dispatch_on_card_matches_host(cuda_device):
    """The whole dispatch on the card (padding, int16 transfer, kernel,
    chain walk, pinned readback) against the host oracle."""
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
