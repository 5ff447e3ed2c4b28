"""The PyTorch segmentation DP against the JAX package, bit for bit.

Inputs are made from a numpy seed and fed to both sides. Every value is
an integer or an integer-valued f32, so the tolerance is zero: the
backpointer rows 0..P-2, best_j and best_k must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freddie_tpu.ops import segdp as jseg
from freddie_tpu.ops.segdp import DPProblem, solve_host
from freddie_tpu.ops.segdp_pallas import solve_batch_pallas
from freddie_tpu.ops.thresholds import ScaledThresholds
from freddie_tpu_torch.ops import segdp as tseg
from test_segdp import literal_oracle, random_problem
from test_torch_segdp_cuda import padded_batch as _padded_batch


def _torch_solve(C, y, W, n_cand, thr, rs=3):
    K, bj, bk = tseg._solve_batch_torch(
        torch.from_numpy(C), torch.from_numpy(y), torch.from_numpy(W),
        torch.from_numpy(n_cand), rs, torch.from_numpy(thr.lookup), thr.scale)
    return K.numpy(), bj.numpy(), bk.numpy()


@pytest.mark.parametrize("wide", [False, True])
def test_plain_matches_xla_and_pallas(wide):
    """_solve_batch_torch == _solve_batch_jax == solve_batch_pallas
    (interpret mode) on the same padded batch."""
    rng = np.random.default_rng(7 if wide else 11)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = _padded_batch(rng, 4, 16, 128, wide)
    P = C.shape[1]
    lookup = jnp.asarray(thr.lookup)
    args = (jnp.asarray(C), jnp.asarray(y), jnp.asarray(W), jnp.asarray(n_cand))
    Kx, bjx, bkx = jseg._solve_batch_jax(*args, 3, lookup, thr.scale)
    Kp, bjp, bkp = solve_batch_pallas(*args, 3, lookup, thr.scale,
                                      interpret=True, wide_weights=wide)
    Kt, bjt, bkt = _torch_solve(C, y, W, n_cand, thr)
    for bj_ref, bk_ref, K_ref in ((bjx, bkx, Kx), (bjp, bkp, Kp)):
        np.testing.assert_array_equal(np.asarray(bj_ref), bjt)
        np.testing.assert_array_equal(np.asarray(bk_ref), bkt)
        np.testing.assert_array_equal(np.asarray(K_ref)[:, : P - 1], Kt[:, : P - 1])
    # Row P-1 is never written by the wavefront (the twin of the XLA kernel).
    np.testing.assert_array_equal(np.asarray(Kx), Kt)
    assert (bjt >= 0).any(), "fixture should segment at least one problem"


@pytest.mark.parametrize("wide", [False, True])
def test_pipelined_entry_matches_pallas_pipelined(wide):
    """solve_batch_cuda(pipelined=True) on CPU tensors (the plain version
    beside K2) == solve_batch_pallas(pipelined=True) and the standard
    Pallas kernel, on the inputs of tests/test_segdp.py's pipelined test."""
    from freddie_tpu_torch.ops.segdp_cuda import solve_batch_cuda

    rng = np.random.default_rng(23 if wide else 29)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = _padded_batch(rng, 5, 16, 128, wide)
    P = C.shape[1]
    lookup = jnp.asarray(thr.lookup)
    args = (jnp.asarray(C), jnp.asarray(y), jnp.asarray(W), jnp.asarray(n_cand))
    want = [solve_batch_pallas(*args, 3, lookup, thr.scale, interpret=True,
                               wide_weights=wide, pipelined=pipe)
            for pipe in (True, False)]
    Kt, bjt, bkt = solve_batch_cuda(
        torch.from_numpy(C), torch.from_numpy(y), torch.from_numpy(W),
        torch.from_numpy(n_cand), 3, torch.from_numpy(thr.lookup), thr.scale,
        wide_weights=wide, pipelined=True)
    for Kp, bjp, bkp in want:
        np.testing.assert_array_equal(np.asarray(bjp), bjt.numpy())
        np.testing.assert_array_equal(np.asarray(bkp), bkt.numpy())
        np.testing.assert_array_equal(np.asarray(Kp)[:, : P - 1], Kt.numpy()[:, : P - 1])
    assert (bjt >= 0).any(), "fixture should segment at least one problem"


def test_plain_exact_under_reduced_precision_matmul():
    """The 7-bit weight limbs keep the contraction exact whatever the f32
    matmul precision setting allows."""
    rng = np.random.default_rng(5)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = _padded_batch(rng, 3, 16, 128, wide=True)
    want = _torch_solve(C, y, W, n_cand, thr)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = _torch_solve(C, y, W, n_cand, thr)
    finally:
        torch.set_float32_matmul_precision(prev)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_walk_chains_matches_jax():
    rng = np.random.default_rng(3)
    B, P = 9, 16
    # Random forward backpointer tables with some dead ends.
    K = np.full((B, P, P), -1, dtype=np.int32)
    for b in range(B):
        for j in range(P):
            for k in range(j + 1, P - 1):
                if rng.random() < 0.8:
                    K[b, j, k] = int(rng.integers(k + 1, P))
    bj = rng.integers(-1, P // 2, size=B).astype(np.int32)
    bk = np.where(bj >= 0, bj + 1 + rng.integers(0, P // 2, size=B), -1).astype(np.int32)
    want = np.asarray(jseg._walk_chains(jnp.asarray(K), jnp.asarray(bj), jnp.asarray(bk)))
    got = tseg._walk_chains(torch.from_numpy(K), torch.from_numpy(bj),
                            torch.from_numpy(bk)).numpy()
    np.testing.assert_array_equal(want, got)


def test_device_cpu_matches_host_batched():
    """The 17 mixed-size problems of tests/test_segdp.py through the whole
    torch dispatch (padding, transfer, plain solve, chain walk)."""
    rng = np.random.default_rng(42)
    thr = ScaledThresholds(0.9)
    problems = [
        random_problem(rng, int(rng.integers(2, 30)), int(rng.integers(1, 40)))
        for _ in range(17)
    ]
    host = [solve_host(p, thr) for p in problems]
    assert tseg.solve_batch_device(problems, thr, device="cpu") == host


@pytest.mark.parametrize("P,R", [(64, 512), (32, 512), (16, 128)])
def test_device_cpu_matches_host_production_shapes(P, R):
    """One problem at each production bucket (P, R) of the kernel."""
    rng = np.random.default_rng(7 + P)
    thr = ScaledThresholds(0.9)
    inc = rng.integers(0, 6, size=(P, R))
    inc[rng.random(size=(P, R)) < 0.5] = 0
    y = np.sort(rng.integers(1, 20_000, size=P).astype(np.int64))
    y[0] = 0
    pr = DPProblem(C=np.cumsum(inc, axis=0).astype(np.int64), y=y,
                   W=rng.integers(1, 5, size=R).astype(np.int64), read_support=3)
    got = tseg.solve_batch_device([pr], thr, pad_p_to=P, pad_r_to=R, device="cpu")
    assert got == [solve_host(pr, thr)]


def test_nay_equality_boundary():
    """A ratio exactly at 1-h counts as nay through the packed lookup's
    equality bit (tests/test_segdp.py::test_nay_equality_boundary)."""
    thr = ScaledThresholds(0.9)
    y = np.array([0, 29, 48, 231], dtype=np.int64)
    C = np.array([
        [0, 30, 36, 36],
        [0, 30, 30, 30],
        [0, 30, 30, 30],
        [0, 0, 0, 184],
        [0, 0, 0, 184],
        [0, 0, 0, 184],
    ], dtype=np.int64).T
    pr = DPProblem(C=C, y=y, W=np.ones(6, dtype=np.int64), read_support=3)
    chain = solve_host(pr, thr)
    assert sorted(set(chain) | {0, 3}) == literal_oracle(pr.C, pr.y, pr.W, thr, 3)
    assert tseg.solve_batch_device([pr], thr, device="cpu") == [chain]


def test_degenerate_cases():
    thr = ScaledThresholds(0.9)
    two = DPProblem(C=np.zeros((2, 3), dtype=np.int64),
                    y=np.array([0, 100], dtype=np.int64),
                    W=np.ones(3, dtype=np.int64), read_support=3)
    assert tseg.solve_batch_device([two], thr, device="cpu") == [[]]
    tiny = DPProblem(C=np.tile(np.arange(5)[:, None], (1, 2)).astype(np.int64),
                     y=np.arange(5, dtype=np.int64),
                     W=np.ones(2, dtype=np.int64), read_support=0)
    assert solve_host(tiny, thr) == []
    assert tseg.solve_batch_device([tiny, two], thr, device="cpu") == [[], []]


def test_scale_overflow_falls_back_to_host():
    """scale * coverage past int32 is solved on the host inline (no
    handle), with the host's results."""
    rng = np.random.default_rng(9)
    thr = ScaledThresholds(0.9)
    pr = random_problem(rng, 12, 8)
    pr.C = pr.C + 2**28  # scale 100 * 2^28 overflows int32
    handles, work, results = tseg.dispatch_batch_device([pr], thr, device="cpu")
    assert handles is None and work == []
    assert results == [solve_host(pr, thr)]


def test_to_device_widens_int16():
    C = np.arange(12, dtype=np.int16).reshape(1, 3, 4)
    W = np.ones((1, 4), dtype=np.float32)
    t = tseg.to_device(dict(C=C, W=W), "cpu")
    assert t["C"].dtype == torch.int32 and t["W"].dtype == torch.float32
    np.testing.assert_array_equal(t["C"].numpy(), C.astype(np.int32))


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the error path cannot be reached")
    from freddie_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
