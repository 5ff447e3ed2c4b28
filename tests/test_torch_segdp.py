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
from freddie_tpu.ops.coverage import cumulative_coverage
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
    Pallas kernel, on the inputs of tests/test_segdp.py's pipelined test;
    with_chains appends the chains that the JAX _walk_chains walks from
    the pipelined Pallas result."""
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
    targs = (torch.from_numpy(C), torch.from_numpy(y), torch.from_numpy(W),
             torch.from_numpy(n_cand), 3, torch.from_numpy(thr.lookup), thr.scale)
    Kt, bjt, bkt = solve_batch_cuda(*targs, pipelined=True)
    Kc, bjc, bkc, chains = solve_batch_cuda(*targs, pipelined=True, with_chains=True)
    assert torch.equal(Kc, Kt) and torch.equal(bjc, bjt) and torch.equal(bkc, bkt)
    np.testing.assert_array_equal(np.asarray(jseg._walk_chains(*want[0])), chains.numpy())
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


def _wide_problems(rng, with_intervals):
    """Three problems of 225-250 candidates (the P = 256 bucket), each with
    12 reps; with ``with_intervals`` each carries the interval list its C
    is built from, so the dispatch may take the device coverage route."""
    problems = []
    for _ in range(3):
        n = int(rng.integers(225, 251))
        if not with_intervals:
            problems.append(random_problem(rng, n, 12))
            continue
        y = np.sort(rng.choice(np.arange(1, 5000), size=n, replace=False)).astype(np.int64)
        s = rng.integers(0, 4800, size=60)
        iv = np.stack([s, s + rng.integers(0, 600, size=60), rng.integers(0, 12, size=60)],
                      axis=1).astype(np.int32)
        C = cumulative_coverage(iv[:, 0].astype(np.int64), iv[:, 1].astype(np.int64),
                                iv[:, 2].astype(np.int64), 12, y, validate=True)[:n]
        problems.append(DPProblem(C=C, y=y, W=rng.integers(1, 5, size=12).astype(np.int64),
                                  read_support=2, iv=iv))
    return problems


@pytest.mark.parametrize("with_intervals", [False, True], ids=["dense", "interval_lists"])
def test_wide_bucket_reaches_the_kernel_wrapper(monkeypatch, with_intervals):
    """A batch of the P = 256 bucket for a card goes where every other
    batch goes: through the mesh's device choice to solve_batch_cuda with
    P = 256, on the dense and on the interval-list route, and never to
    solve_host. The card is simulated, so the test needs no GPU: the mesh
    names the CPU for "cuda", and the wrapper runs its plain version on
    the CPU tensors it is handed. The results equal the JAX package's
    solve_batch_device on the same problems."""
    from freddie_tpu_torch.parallel import mesh

    rng = np.random.default_rng(256 + with_intervals)
    thr = ScaledThresholds(0.9)
    problems = _wide_problems(rng, with_intervals)
    want = jseg.solve_batch_device(
        [DPProblem(C=p.C, y=p.y, W=p.W, read_support=p.read_support) for p in problems], thr,
        pad_p_to=256, pad_r_to=16)
    cpu = torch.device("cpu")
    monkeypatch.setattr(mesh, "loci_devices", lambda: [cpu])
    monkeypatch.setattr(mesh, "resolve_device", lambda _dev: cpu)
    launched = []
    real = mesh.solve_batch_cuda
    monkeypatch.setattr(mesh, "solve_batch_cuda",
                        lambda C, *a, **k: launched.append(tuple(C.shape)) or real(C, *a, **k))
    monkeypatch.setattr(tseg, "solve_host", lambda *_a: pytest.fail("solve_host was called"))
    routes = []
    build = mesh.build_coverage_device
    monkeypatch.setattr(mesh, "build_coverage_device",
                        lambda *a: routes.append("iv") or build(*a))
    got = tseg.solve_batch_device(problems, thr, pad_p_to=256, pad_r_to=16, device="cuda")
    assert got == want and any(want)
    # A wide bucket on a card pads its three problems to 4, not to 8.
    assert launched == [(4, 256, 16)]
    assert routes == (["iv"] if with_intervals else [])


def _simulated_card(monkeypatch):
    """The mesh names the CPU for "cuda" (so the wrapper runs its plain
    version on the CPU tensors it is handed) and solve_batch_cuda records
    the (B, P, R) it is called with; returns that record."""
    from freddie_tpu_torch.parallel import mesh

    cpu = torch.device("cpu")
    monkeypatch.setattr(mesh, "loci_devices", lambda: [cpu])
    monkeypatch.setattr(mesh, "resolve_device", lambda _dev: cpu)
    launched = []
    real = mesh.solve_batch_cuda
    monkeypatch.setattr(mesh, "solve_batch_cuda",
                        lambda C, *a, **k: launched.append(tuple(C.shape)) or real(C, *a, **k))
    return launched


def test_wide_bucket_on_a_card_solves_only_its_real_problems(monkeypatch):
    """On a (simulated) card a bucket from CLUSTER_MIN_P pads B to the next
    power of two from 1: one problem of the P = 512 bucket reaches the
    wrapper as B = 1, in one scratch group, and three of the P = 256 bucket
    as B = 4 (the final partial chunk's pad_b_to is not applied there);
    P = 64 keeps the JAX layout, B padded to 8. Every result equals the
    JAX package's: its dispatch at P = 256 and 64, its host oracle at
    P = 512 (its dispatch would pad that problem to 8 rows of 512^3 f32,
    4 GiB, where the port's plain version holds one)."""
    from freddie_tpu_torch.ops import segdp_cuda

    rng = np.random.default_rng(512)
    thr = ScaledThresholds(0.9)
    launched = _simulated_card(monkeypatch)
    assert segdp_cuda.CLUSTER_MIN_P <= 256
    one = [random_problem(rng, 40, 10, span=8000)]
    got = tseg.solve_batch_device(one, thr, pad_p_to=512, pad_r_to=16, device="cuda")
    assert got == [jseg.solve_host(one[0], thr)] and got[0]
    assert launched == [(1, 512, 16)] and segdp_cuda.group_size(1, 512) == 1

    launched.clear()
    three = [random_problem(rng, int(rng.integers(200, 251)), 12) for _ in range(3)]
    handles, work, res = tseg.dispatch_batch_device(three, thr, pad_p_to=256, pad_r_to=16,
                                                    pad_b_to=8, device="cuda")
    got = tseg.collect_batch_device(handles, work, res)
    assert got == jseg.solve_batch_device(three, thr, pad_p_to=256, pad_r_to=16)
    assert launched == [(4, 256, 16)]

    launched.clear()
    narrow = [random_problem(rng, int(rng.integers(20, 60)), 12) for _ in range(3)]
    got = tseg.solve_batch_device(narrow, thr, pad_p_to=64, pad_r_to=16, device="cuda")
    assert got == jseg.solve_batch_device(narrow, thr, pad_p_to=64, pad_r_to=16)
    assert launched == [(8, 64, 16)]


def test_plain_matches_xla_at_p256():
    """_solve_batch_torch == _solve_batch_jax on one problem of the P = 256
    bucket (the width above what K1's shared memory holds H for)."""
    rng = np.random.default_rng(2560)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = _padded_batch(rng, 1, 256, 64, False)
    n_cand[:] = 250
    C[:, 250:] = C[:, 249:250]
    y[:, 250:] = y[:, 249:250]
    lookup = jnp.asarray(thr.lookup)
    Kx, bjx, bkx = jseg._solve_batch_jax(jnp.asarray(C), jnp.asarray(y), jnp.asarray(W),
                                         jnp.asarray(n_cand), 3, lookup, thr.scale)
    Kt, bjt, bkt = _torch_solve(C, y, W, n_cand, thr)
    np.testing.assert_array_equal(np.asarray(bjx), bjt)
    np.testing.assert_array_equal(np.asarray(bkx), bkt)
    np.testing.assert_array_equal(np.asarray(Kx), Kt)
    assert (bjt >= 0).all(), "the problem should segment"


@pytest.mark.parametrize("B,P,budget,pipelined,want", [
    (2048, 64, 4 << 30, False, 2048),  # the kernel benchmark: one group
    (8, 224, 4 << 30, False, 8),
    (8, 256, 4 << 30, False, 8),  # 64.5 MiB a problem
    (8, 512, 4 << 30, False, 7),  # 514 MiB a problem: groups of 7 and 1
    (8, 512, 1 << 20, False, 1),  # nothing fits: one problem at a time all the same
    (8, 256, 3 * (4 * (256**3 + 2 * 256**2)), False, 3),  # a budget of three problems
    (65535, 16, 4 << 30, False, 65535),
    (264, 256, 4 << 30, True, 31),  # K2's blocks at P = 256: two slots and H each
    (264, 64, 4 << 30, True, 264),  # the K2 benchmark's grid is untouched
    (132, 512, 4 << 30, True, 3),
])
def test_scratch_group_size(B, P, budget, pipelined, want):
    """group_size: the most problems (K1) or blocks (K2) whose scratch --
    the outside tensor, inside and, above the shared-memory cap, H --
    fits the budget, at least 1 and at most what there is."""
    from freddie_tpu_torch.ops import segdp_cuda

    got = segdp_cuda.group_size(B, P, pipelined, budget=budget)
    assert got == want
    unit = segdp_cuda.scratch_bytes(P, pipelined)
    assert got == 1 or got * unit <= budget
    assert got == B or (got + 1) * unit > budget


@pytest.mark.parametrize("B,P,want", [
    (70_000, 16, 65535),  # 17,408 B a problem: 4 GiB would hold 246,723
    (65_536, 8, 65535),
    (131_072, 24, 65535),  # 57,600 B a problem: 74,565 would fit
    (2048, 64, 2048),  # the kernel benchmark: one group, as before
    (8, 512, 7),  # the scratch budget binds, as before
])
def test_k1_group_size_is_capped_at_the_grid(B, P, want):
    """k1_group_size: group_size, at most K1_MAX_GRID_Y (gridDim.y of
    pair_stats_kernel's dim3(P, B) grid). The cap binds only where one
    problem's scratch is so small (P <= 24) that the 4 GiB budget would
    hold more problems than one launch takes."""
    from freddie_tpu_torch.ops import segdp_cuda

    assert segdp_cuda.K1_MAX_GRID_Y == 65535
    got = segdp_cuda.k1_group_size(B, P)
    assert got == want
    assert got == min(segdp_cuda.group_size(B, P), segdp_cuda.K1_MAX_GRID_Y)


@pytest.mark.parametrize("B,P,sizes", [
    (70_000, 16, [65535, 4465]),
    (65_535, 16, [65535]),
    (131_071, 8, [65535, 65535, 1]),
    (8, 512, [7, 1]),
])
def test_k1_groups_cover_every_problem_once(B, P, sizes):
    """K1's launches for a batch of any size (k1_groups over
    k1_group_size, as solve_batch_cuda's group loop takes them): each
    problem in exactly one launch, in order, no launch of more than
    K1_MAX_GRID_Y problems."""
    from freddie_tpu_torch.ops import segdp_cuda

    groups = segdp_cuda.k1_groups(B, segdp_cuda.k1_group_size(B, P))
    assert [g.stop - g.start for g in groups] == sizes
    assert max(sizes) <= segdp_cuda.K1_MAX_GRID_Y
    covered = np.concatenate([np.arange(B)[g] for g in groups])
    np.testing.assert_array_equal(covered, np.arange(B))


def test_launch_route_asks_for_one_launchs_problems(monkeypatch):
    """launch_route asks cluster_size_for about the problems that one K1
    launch holds, k1_group_size's answer, which the group loop of
    solve_batch_cuda also reads: 65,535 of 100,000 at P = 16 on the
    cluster wavefront (H forced into device memory), and all 8 at P = 256."""
    from freddie_tpu_torch.ops import segdp_cuda

    asked, sized = [], []
    real = segdp_cuda.k1_group_size

    def k1_group_size(*a, **k):
        sized.append(real(*a, **k))
        return sized[-1]

    def cluster_size_for(B, P, smem_max_p=None):
        asked.append(B)
        return segdp_cuda.WIDE_CLUSTER_SIZE

    monkeypatch.setattr(segdp_cuda, "k1_group_size", k1_group_size)
    monkeypatch.setattr(segdp_cuda, "cluster_size_for", cluster_size_for)
    assert segdp_cuda.launch_route(100_000, 16, smem_max_p=0)[:2] == (16, 0)
    assert segdp_cuda.launch_route(8, 256)[0] == 16
    assert asked == sized == [65535, 8]


def test_scratch_bytes_count_h_only_above_the_cap():
    """H is scratch in device memory only where it does not fit: above
    what K1's cluster wavefront keeps in its blocks' shared memory
    (cluster_smem_max_p; K2: K2_SMEM_MAX_P), or at any P when the caller
    forces the cap to 0; a cap above the kernel's own limit is refused."""
    from freddie_tpu_torch.ops import segdp_cuda

    for pipelined, top in ((False, segdp_cuda.cluster_smem_max_p()),
                           (True, segdp_cuda.K2_SMEM_MAX_P)):
        slots = 2 if pipelined else 1
        for P in (16, top, top + 1, 512, 700):
            plain = 4 * slots * (P**3 + P**2)
            h = 4 * P * P
            assert segdp_cuda.scratch_bytes(P, pipelined) == plain + (h if P > top else 0)
            assert segdp_cuda.scratch_bytes(P, pipelined, smem_max_p=0) == plain + h
        with pytest.raises(ValueError, match="fits shared memory up to"):
            segdp_cuda.scratch_bytes(64, pipelined, smem_max_p=top + 1)


def test_k1_max_p_is_the_widest_that_fits_a_block():
    """K1_SMEM_MAX_P is the widest P whose one-block wavefront state,
    4 P^2 + 4 P bytes, fits the shared memory the wrapper allows: that
    kernel could take the P = 224 bucket and not the P = 256 one.
    K2_SMEM_MAX_P is the same beside K2's phase-1 slots (PairSmem<128>,
    107,520 B) and 16 B of hand-off state."""
    from freddie_tpu_torch.ops import segdp_cuda

    P = segdp_cuda.K1_SMEM_MAX_P
    assert 4 * P * P + 4 * P <= segdp_cuda._MAX_SMEM < 4 * (P + 1) ** 2 + 4 * (P + 1)
    assert tseg.bucket_shape(224, 128)[0] == 224 <= P < tseg.bucket_shape(225, 128)[0] == 256
    P2, pair = segdp_cuda.K2_SMEM_MAX_P, 107_520
    assert segdp_cuda._PAIR_SMEM_WIDE == pair
    assert pair + 4 * P2 * P2 + 4 * P2 + 16 <= segdp_cuda._MAX_SMEM
    assert pair + 4 * (P2 + 1) ** 2 + 4 * (P2 + 1) + 16 > segdp_cuda._MAX_SMEM
    assert P2 == 176


# Past the widest P whose one-problem scratch, a (P, P, P) f32 tensor, an
# 80 GB card could hold at all (2,700^3 f32 is 78.7 GB).
PAST_THE_CARD = 3000


@pytest.mark.parametrize("N", [1, 2, 4, 8, 16])
def test_cluster_caps_are_the_widest_that_fit_a_block(N):
    """cluster_smem_max_p(N) is the widest P whose triangle of H rows
    (rank 0's, the largest: rows 0, N, 2N, ... with columns k+1..P-1)
    fits a block beside the ring of rows (RING_ROWS rows of P floats for
    each of the 8 warps), ys and the argmax slots. With H in device memory
    the layout fits at every P whose scratch a card could hold, so K1's
    cluster wavefront has no width limit of its own; the ring that
    row_ring_for picks fits wherever its H does, and it is the ring of two
    whole planes exactly where that fits. The triangle counts what a
    direct sum over the rows counts, and at the default cluster size the
    P = 512 bucket keeps H in shared memory."""
    from freddie_tpu_torch.ops import segdp_cuda

    for P in (1, 5, 16, 37, 96, 512):
        assert segdp_cuda._tri_floats(P, N) == sum(P - 1 - k for k in range(0, P, N))
    limit = segdp_cuda._MAX_SMEM
    cap = segdp_cuda.cluster_smem_max_p(N)
    assert segdp_cuda.cluster_smem_bytes(cap, N, True) <= limit
    assert segdp_cuda.cluster_smem_bytes(cap + 1, N, True) > limit
    assert segdp_cuda.cluster_smem_bytes(cap, N, True) == (
        4 * (segdp_cuda._tri_floats(cap, N) + 8 * segdp_cuda.RING_ROWS * cap + cap) + 8 * 16)
    assert segdp_cuda.cluster_smem_bytes(PAST_THE_CARD, N, False) <= limit
    for P in (16, 96, 256, cap, cap + 1, 1312, PAST_THE_CARD):
        rows = segdp_cuda.row_ring_for(P, N, P <= cap)
        assert segdp_cuda.cluster_smem_bytes(P, N, P <= cap, rows) <= limit
        assert rows == (segdp_cuda.cluster_smem_bytes(P, N, P <= cap, False) > limit)
    if N == segdp_cuda.CLUSTER_SIZE:
        assert segdp_cuda.cluster_smem_max_p() >= 512


@pytest.mark.parametrize("B,P,smem_max_p,want", [
    (35, 256, None, 16),  # every cluster of 16 resident at once
    (36, 256, None, 8),  # one more than fits: 8 blocks a cluster
    (1, 900, None, 16),  # H in device memory on 8 blocks, in shared memory on 16
    (1, 1000, None, 16),  # past what 16 blocks took before the row ring: 16 still
    (1, 600, 900, 16),  # a cap that only 16 blocks hold H at
    (36, 600, 800, 8),  # a cap that 8 hold too: by residency
])
def test_cluster_size_follows_the_resident_clusters(monkeypatch, B, P, smem_max_p, want):
    """cluster_size_for takes 16 blocks a cluster when the runtime keeps B
    such clusters resident at once, or when the cap given is one that
    only 16 blocks hold H at, and 8 otherwise; both take every P. Here
    the runtime's answer is simulated as 35 clusters."""
    from freddie_tpu_torch.ops import segdp_cuda

    assert segdp_cuda.cluster_smem_max_p(8) < 900 <= segdp_cuda.cluster_smem_max_p(16)
    monkeypatch.setattr(segdp_cuda, "cluster_occupancy",
                        lambda *a, **k: {"max_active_clusters": 35})
    assert segdp_cuda.cluster_size_for(B, P, smem_max_p) == want
    assert segdp_cuda._k1_route(P, smem_max_p, None, lambda: want)[0] == want


@pytest.mark.parametrize("P,smem_max_p,cluster_size,want", [
    (64, None, None, (0, None)),  # narrow: one block per problem, H in shared memory
    ("min", None, None, ("size", None)),  # from CLUSTER_MIN_P: a cluster per problem
    (512, None, None, ("size", None)),
    (64, 0, None, ("size", 0)),  # H forced to device memory: the cluster kernel's route
    (32, None, 4, (4, None)),  # the cluster route forced at small P
    (224, None, 0, (0, None)),  # the one-block route forced where it fits
    (256, None, 0, ValueError),  # and refused where it does not
    ("max+1", None, None, ("size", None)),  # past what the ring of whole planes took: a route
    (64, None, 17, ValueError),  # past the largest cluster
])
def test_k1_route_by_shape(P, smem_max_p, cluster_size, want):
    """K1's wavefront by shape, and what cluster_size forces or refuses;
    (N, cap) with cap None meaning the route's own limit."""
    from freddie_tpu_torch.ops import segdp_cuda

    N = segdp_cuda.CLUSTER_SIZE
    # 675: one past the widest P that clusters of 8 took while each block
    # held two whole outside planes.
    P = {"min": segdp_cuda.CLUSTER_MIN_P, "max+1": 675}.get(P, P)
    if want is ValueError:
        with pytest.raises(ValueError):
            segdp_cuda._k1_route(P, smem_max_p, cluster_size)
        return
    n, cap = want
    n = N if n == "size" else n
    if cap is None:
        cap = segdp_cuda.cluster_smem_max_p(n) if n else segdp_cuda.K1_SMEM_MAX_P
    if n == 0 and cluster_size is None:
        cap = segdp_cuda.cluster_smem_max_p()  # by shape: the default route's cap
    assert segdp_cuda._k1_route(P, smem_max_p, cluster_size) == (n, cap)


@pytest.mark.parametrize("P,smem_max_p,cluster_size,want", [
    (64, None, None, (0, "one")),  # narrow: one block per SM
    ("below", None, None, (0, "one")),  # the last width below K2_CLUSTER_MIN_P
    ("min", None, None, (16, None)),  # from K2_CLUSTER_MIN_P: a cluster per problem
    (512, None, None, (16, None)),
    (512, 0, None, (16, 0)),  # H forced to device memory, on the cluster route still
    (64, 0, None, (0, 0)),  # below it, the one-block route with H in device memory
    ("past16", None, None, (16, None)),  # past what 16 blocks took before: the cluster route
    (32, None, 4, (4, None)),  # the cluster route forced at small P
    (256, None, 8, (8, None)),
    (512, None, 0, (0, "one")),  # the one-block route forced at a wide P
    (512, None, 8, (8, None)),  # 8 blocks, which the ring of whole planes did not fit
    (64, None, 17, ValueError),  # past the largest cluster
    (64, None, -1, ValueError),
])
def test_k2_route_by_shape(P, smem_max_p, cluster_size, want):
    """K2's route by shape, and what cluster_size forces or refuses: (N,
    cap), N the blocks per cluster of its cluster route (0: the one-block
    route) and cap the widest P whose H stays in shared memory (None: the
    cluster route's own on N blocks; "one": the one-block route's,
    K2_SMEM_MAX_P). The cluster size by shape is given as 16 here (on the
    card: k2_cluster_size_for)."""
    from freddie_tpu_torch.ops import segdp_cuda

    # 691: one past the widest P that K2's clusters of 16 took while each
    # block held two whole outside planes.
    P = {"below": segdp_cuda.K2_CLUSTER_MIN_P - 1, "min": segdp_cuda.K2_CLUSTER_MIN_P,
         "past16": 691}.get(P, P)
    assert segdp_cuda.K2_CLUSTER_MIN_P <= segdp_cuda.K2_SMEM_MAX_P + 1
    route = lambda: segdp_cuda._k2_route(P, smem_max_p, cluster_size, lambda: 16)  # noqa: E731
    if want is ValueError:
        with pytest.raises(ValueError):
            route()
        return
    n, cap = want
    cap = {None: segdp_cuda.k2_cluster_smem_max_p(n) if n else None,
           "one": segdp_cuda.K2_SMEM_MAX_P}.get(cap, cap)
    assert route() == (n, cap)


@pytest.mark.parametrize("B,P,want", [
    (8, 256, 16),  # every cluster of 16 resident at once
    (24, 256, 16),  # three problems a resident cluster of 16
    (25, 256, 8),  # more: 8 blocks a cluster
    (64, 128, 8),
    (25, 512, 8),  # which 8 blocks take now, as every P: by residency
    (1, 96, 16),
])
def test_k2_cluster_size_follows_the_resident_clusters(monkeypatch, B, P, want):
    """k2_cluster_size_for takes 16 blocks a cluster where the batch needs
    at most K2_WIDE_PROBLEMS_PER_CLUSTER (3) problems per resident cluster
    of 16, and 8 otherwise; both take every P. The runtime's answer is
    simulated as 8 clusters."""
    from freddie_tpu_torch.ops import segdp_cuda

    assert segdp_cuda.K2_WIDE_PROBLEMS_PER_CLUSTER == 3
    monkeypatch.setattr(segdp_cuda, "k2_cluster_occupancy",
                        lambda *a, **k: {"max_active_clusters": 8})
    assert segdp_cuda.k2_cluster_size_for(B, P) == want


@pytest.mark.parametrize("N", [2, 4, 8, 16])
def test_k2_cluster_caps_are_the_widest_that_fit_a_block(N):
    """A block of K2's cluster route holds the producers' PairSmem<128>
    (107,520 B), 64 B of mbarriers and the cluster wavefront's layout for
    its 4 consumer warps (pipelined_cluster_smem_bytes in the .cuh);
    k2_cluster_smem_max_p(N) is the widest P for which that fits a block
    with H's triangle beside the ring of rows. With H in device memory it
    fits at every P whose scratch a card could hold, so the route has no
    width limit of its own, and the ring row_ring_for picks fits wherever
    its H does. The P = 512 bucket keeps H in shared memory on 16 blocks
    and on 8."""
    from freddie_tpu_torch.ops import segdp_cuda

    limit = segdp_cuda._MAX_SMEM
    for P in (1, 37, 256, 512):
        for smem_h in (True, False):
            for rows in (False, True):
                wave = segdp_cuda.cluster_smem_bytes(P, N, smem_h, rows)
                assert segdp_cuda.k2_cluster_smem_bytes(P, N, smem_h, rows) == (
                    107_520 + 64 + wave - rows * 4 * 4 * segdp_cuda.RING_ROWS * P)  # 4 warps, not 8
    cap = segdp_cuda.k2_cluster_smem_max_p(N)
    assert segdp_cuda.k2_cluster_smem_bytes(cap, N, True) <= limit
    assert segdp_cuda.k2_cluster_smem_bytes(cap + 1, N, True) > limit
    assert segdp_cuda.k2_cluster_smem_bytes(PAST_THE_CARD, N, False) <= limit
    for P in (16, 96, 256, cap, cap + 1, 1312, PAST_THE_CARD):
        rows = segdp_cuda.row_ring_for(P, N, P <= cap, pipelined=True)
        assert segdp_cuda.k2_cluster_smem_bytes(P, N, P <= cap, rows) <= limit
        assert rows == (segdp_cuda.k2_cluster_smem_bytes(P, N, P <= cap, False) > limit)
    assert cap < segdp_cuda.cluster_smem_max_p(N)
    if N >= 8:
        assert cap >= 512


def test_k2_cluster_scratch_counts_two_slots_a_cluster(monkeypatch):
    """The cluster route's scratch is held per cluster: two slots of the
    outside tensor and inside each, and H only above the route's own cap
    (or a lower one the caller gives); its grid is the resident clusters
    (simulated as 8 here), cut to what SCRATCH_BUDGET holds and to B."""
    from freddie_tpu_torch.ops import segdp_cuda

    for P, N in ((256, 16), (512, 16), (192, 8)):
        two = 4 * 2 * (P**3 + P**2)
        assert segdp_cuda.scratch_bytes(P, True, N=N) == two  # H in the cluster's shared memory
        assert segdp_cuda.scratch_bytes(P, True, 0, N=N) == two + 4 * P * P
    P = segdp_cuda.k2_cluster_smem_max_p(16) + 1
    assert segdp_cuda.scratch_bytes(P, True, N=16) == 4 * (2 * (P**3 + P**2) + P * P)
    monkeypatch.setattr(segdp_cuda, "k2_cluster_occupancy",
                        lambda *a, **k: {"max_active_clusters": 8})
    assert segdp_cuda.pipelined_cluster_grid(2, 256, 16) == 2
    assert segdp_cuda.pipelined_cluster_grid(64, 256, 16) == 8
    assert segdp_cuda.pipelined_cluster_grid(64, 512, 16) == 3  # 1.07 GB a cluster of 4 GiB
    monkeypatch.setattr(segdp_cuda, "SCRATCH_BUDGET", 1)
    assert segdp_cuda.pipelined_cluster_grid(64, 256, 16) == 1


@pytest.mark.parametrize("pipelined", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("B,P", [(8, 704), (36, 704), (1, 960), (1, 1024), (1, 1312)])
def test_every_width_takes_a_cluster_route(monkeypatch, B, P, pipelined):
    """Widths past what each block's ring of two whole outside planes held
    (P > 674 on 8 blocks, 948 on 16; K2 past 690 on 16), which K1 refused
    and K2 left to its one-block route: by shape, with the cluster size
    that cluster_size_for and k2_cluster_size_for pick for the batch under
    a simulated runtime that keeps 7 clusters resident, each kernel takes
    its cluster route, on 16 or 8 blocks, with a ring that fits a block
    (two whole planes where they fit, else rows); nothing raises. The JAX
    package solves these widths too (its XLA twin has no width limit)."""
    from freddie_tpu_torch.ops import segdp_cuda

    occupancy = lambda *a, **k: {"max_active_clusters": 7}  # noqa: E731
    monkeypatch.setattr(segdp_cuda, "cluster_occupancy", occupancy)
    monkeypatch.setattr(segdp_cuda, "k2_cluster_occupancy", occupancy)
    N, cap, rows = segdp_cuda.launch_route(B, P, pipelined)
    assert N in (segdp_cuda.CLUSTER_SIZE, segdp_cuda.WIDE_CLUSTER_SIZE)
    size = segdp_cuda.k2_cluster_smem_bytes if pipelined else segdp_cuda.cluster_smem_bytes
    assert rows == segdp_cuda.row_ring_for(P, N, P <= cap, pipelined)
    assert size(P, N, P <= cap, rows) <= segdp_cuda._MAX_SMEM
    assert cap == (segdp_cuda.k2_cluster_smem_max_p(N) if pipelined
                   else segdp_cuda.cluster_smem_max_p(N))
    route = segdp_cuda._k2_route if pipelined else segdp_cuda._k1_route
    assert route(P, None, None, lambda: N) == (N, cap)


def test_k1_cluster_size_is_asked_for_the_problems_one_launch_holds(monkeypatch):
    """K1 solves a batch in scratch groups, so the cluster size is asked
    for the problems one launch holds, as many as clusters of 16 would
    hold (group_size): at P = 704 a group of 3 under the 4 GiB budget,
    which 7 resident clusters of 16 take, where the batch of 8 would not
    fit them; with a budget that holds all 8 in one launch, 8 blocks a
    cluster. K2 holds its whole batch in one launch and is asked for it."""
    from freddie_tpu_torch.ops import segdp_cuda

    asked = []

    def occupancy(P, N=None, smem_max_p=None, row_ring=None):
        asked.append(N)
        return {"max_active_clusters": 7}

    monkeypatch.setattr(segdp_cuda, "cluster_occupancy", occupancy)
    assert segdp_cuda.group_size(8, 704, N=16) == 3
    assert segdp_cuda.cluster_size_for(8, 704) == 8  # the whole batch would not fit
    assert segdp_cuda.launch_route(8, 704)[0] == 16
    assert segdp_cuda.launch_route(36, 704)[0] == 16
    monkeypatch.setattr(segdp_cuda, "SCRATCH_BUDGET", 64 << 30)
    assert segdp_cuda.group_size(8, 704, N=16) == 8
    assert segdp_cuda.launch_route(8, 704)[0] == 8
    assert set(asked) == {16}
    monkeypatch.setattr(segdp_cuda, "k2_cluster_occupancy",
                        lambda *a, **k: {"max_active_clusters": 2})
    assert segdp_cuda.launch_route(6, 704, pipelined=True)[0] == 16
    assert segdp_cuda.launch_route(7, 704, pipelined=True)[0] == 8


@pytest.mark.parametrize("P,pipelined,cluster_size,rows,ok", [
    (96, False, 4, True, True), (96, True, 2, True, True),  # rows where planes fit too
    (256, True, 16, False, True),  # the ring of two whole planes, where it fits
    (704, False, 8, False, False),  # and where it does not: two planes of 704 on 8 blocks
    (1312, True, 8, False, False),  # nor K2's beside its producers' slots at 1312
    (64, False, 0, True, False),  # the one-block wavefront has no ring
    (64, True, 0, False, False),  # nor K2's one-block route
])
def test_forced_ring_is_checked(P, pipelined, cluster_size, rows, ok):
    """solve_batch_cuda's ``row_ring`` forces the cluster wavefront's
    ring: True the ring of rows (how the tests make it wrap inside a step
    at small P), False two whole planes. A ring that does not fit a block,
    or one given for a one-block route, is refused before any launch, on
    the CPU as on the card."""
    from freddie_tpu_torch.ops import segdp_cuda

    route = lambda: segdp_cuda.launch_route(2, P, pipelined, None, cluster_size, rows)  # noqa
    if ok:
        assert route()[2] is rows
        return
    with pytest.raises(ValueError):
        route()
    C = torch.zeros((1, P, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        segdp_cuda.solve_batch_cuda(C, torch.zeros((1, P), dtype=torch.int32),
                                    torch.zeros((1, 4)), torch.full((1,), 6, dtype=torch.int32),
                                    3, torch.zeros(2, dtype=torch.int32), 1, pipelined,
                                    cluster_size=cluster_size, row_ring=rows)


@pytest.mark.parametrize("wide", [False, True])
def test_k2_cluster_route_on_a_simulated_card_matches_pallas_pipelined(monkeypatch, wide):
    """A K2 batch of the P = 256 bucket on a (simulated) card takes the
    cluster route by shape, on 16 blocks a cluster while 8 such clusters
    are resident, with H in their shared memory; and the route forced at
    a small P (cluster_size=4) on CPU tensors, where the wrapper runs its
    plain version, equals the JAX package's solve_batch_pallas(pipelined=
    True) in interpret mode, chains included, as the K2 parity test above
    runs it. A forced route the card would refuse is refused on the CPU
    too."""
    from freddie_tpu_torch.ops import segdp_cuda
    from freddie_tpu_torch.ops.segdp_cuda import solve_batch_cuda

    monkeypatch.setattr(segdp_cuda, "k2_cluster_occupancy",
                        lambda *a, **k: {"max_active_clusters": 8})
    assert segdp_cuda.launch_route(8, 256, pipelined=True) == (
        16, segdp_cuda.k2_cluster_smem_max_p(16), False)  # the ring of planes fits at 256

    rng = np.random.default_rng(31 if wide else 37)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = _padded_batch(rng, 5, 16, 128, wide)
    P = C.shape[1]
    lookup = jnp.asarray(thr.lookup)
    want = solve_batch_pallas(jnp.asarray(C), jnp.asarray(y), jnp.asarray(W),
                              jnp.asarray(n_cand), 3, lookup, thr.scale, interpret=True,
                              wide_weights=wide, pipelined=True)
    targs = (torch.from_numpy(C), torch.from_numpy(y), torch.from_numpy(W),
             torch.from_numpy(n_cand), 3, torch.from_numpy(thr.lookup), thr.scale)
    Kt, bjt, bkt, chains = solve_batch_cuda(*targs, pipelined=True, with_chains=True,
                                            cluster_size=4)
    np.testing.assert_array_equal(np.asarray(want[1]), bjt.numpy())
    np.testing.assert_array_equal(np.asarray(want[2]), bkt.numpy())
    np.testing.assert_array_equal(np.asarray(want[0])[:, : P - 1], Kt.numpy()[:, : P - 1])
    np.testing.assert_array_equal(np.asarray(jseg._walk_chains(*want)), chains.numpy())
    assert (bjt >= 0).any(), "fixture should segment at least one problem"
    with pytest.raises(ValueError):
        solve_batch_cuda(*targs, pipelined=True, cluster_size=17)
