"""The CUDA kernels' source, run on the CPU, against the plain PyTorch DP.

There is no GPU or nvcc here, so ``freddie_tpu_torch/csrc/segdp_kernels.cuh``
is compiled by the host C++ compiler against a thread-per-CUDA-thread
stand-in (``tests/cuda_emu/emu.h``) and run at small shapes, including a
ragged P and R and the multi-tile (P > 64) path: K1's two launches (the
live-tile pair statistics, whose tensor-core step and asynchronous copies
the stand-in implements in plain C++ with the documented fragment
layout, then the wavefront with its chain walk, on one block per problem
or on a thread-block cluster of N blocks per problem, whose blocks the
stand-in runs at once with a cluster barrier and mapped shared memory),
and K2's one
warp-specialised launch (the same two bodies in a producer and a consumer
group with a per-slot hand-off) at grid sizes where a block gets one
problem, several, or all of them, with either group stalled so that the
hand-off is walked with the producer ahead and with the consumer ahead,
with the blocks run in turn (block 0 drains the work queue) and all at
once (every block draws several problems while the others draw too);
each kernel with its wavefront's H in shared memory and, the cap forced
to 0, in device memory, the route of P above what a block holds (K1's
cluster kernel then keeps its rows there; K2's blocks each own a plane
of H, which blocks run at once must not share). The scratch starts as
garbage, so an entry that phase 1 leaves unwritten and the wavefront
reads would show. It checks the
kernels' indexing, live-tile logic, weight limbs, masks, reductions, tie
order, barriers and hand-off, not their speed or anything
the GPU compiler decides; ``tests/test_torch_segdp_cuda.py`` and
``chip_smoke.py`` check the real build on the card. Zero tolerance.
"""

import os
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from freddie_tpu_torch.ops import segdp as tseg
from freddie_tpu_torch.ops.segdp import ScaledThresholds
from freddie_tpu_torch.ops.segdp_cuda import (
    K1_SMEM_MAX_P, K2_SMEM_MAX_P, REP_STAGE, cluster_smem_max_p,
    k2_cluster_smem_max_p, kernel_inputs, row_ring_for)
from test_segdp import random_problem
from test_torch_segdp_cuda import padded_batch, segment_batch

REPO = pathlib.Path(__file__).resolve().parent.parent
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
DYN_SMEM = "extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];"
# A static shared array, `__shared__ T name[n];`: under the stand-in a
# pointer into the running block's state, so that blocks run at once do
# not share it.
STATIC_SMEM = re.compile(r"__shared__\s+(\w+)\s+(\w+)\[(\w+)\];")


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    d = tmp_path_factory.mktemp("segdp_emu")
    src = (REPO / "freddie_tpu_torch" / "csrc" / "segdp_kernels.cuh").read_text()
    assert DYN_SMEM in src, "the kernel's dynamic shared memory declaration moved"
    src = src.replace(DYN_SMEM, "unsigned char* segdp_dyn_smem = emu_dyn_smem;")
    src, n_static = STATIC_SMEM.subn(r"\1* \2 = emu_shared<\1>(\3, __COUNTER__);", src)
    assert n_static >= 2, "the wavefront's reduction scratch declarations moved"
    code = re.sub(r"//[^\n]*", "", src)
    assert "__shared__" not in code, "a __shared__ declaration the stand-in does not rewrite"
    (d / "segdp_kernels_emu.cuh").write_text(src)
    exe = d / "segdp_emu"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-pthread", f"-I{EMU}", f"-I{d}",
         "-o", str(exe), str(EMU / "segdp_main.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return exe


def _full_short_batch(rng, B, P, R):
    """Problems of P candidates and of 6..8 padded to P, two of each in
    turn: with one block, each of K2's two scratch slots holds a full
    problem, then a short one, then a full one."""
    C = np.zeros((B, P, R), dtype=np.int32)
    y = np.zeros((B, P), dtype=np.int32)
    W = np.zeros((B, R), dtype=np.float32)
    n_cand = np.zeros((B,), dtype=np.int32)
    for b in range(B):
        p = P if b % 4 < 2 else 6 + b % 3
        pr = random_problem(rng, p, R)
        C[b, :p], C[b, p:] = pr.C, pr.C[-1]
        y[b, :p], y[b, p:] = pr.y, pr.y[-1]
        W[b], n_cand[b] = pr.W, p
    return C, y, W, n_cand


def _run_and_check(emulator, tmp_path, B, P, R, wide, full, grid=(), rs=3, scale_w=1,
                   short=False, full_short=False, stall=None, at_once=None, cap=None,
                   cluster=None, segments=False, ties=False, skew=100, k2_cluster=None,
                   row_ring=None):
    """Runs the emulated kernels on a random padded batch (K2 when
    ``grid`` holds G, on G clusters of ``k2_cluster`` blocks when that is
    given; K1's wavefront on clusters of ``cluster`` blocks when it is
    given) and holds them
    against _solve_batch_torch, and their chains against _walk_chains.
    ``cap``: the widest P whose H stays in shared memory (default the
    kernel's own limit; 0 puts H in device memory);
    ``segments``: the structured batch of segment_batch (long chains),
    with unit weights when ``ties``, so that many sums are equal and the
    first-index rule decides most maxima; ``skew``: with a cluster, rank r
    sleeps r*skew us a step (EMU_CLUSTER_SKEW), so ranks drift apart where
    no barrier holds them; ``row_ring``: whether the cluster wavefront
    takes each warp's ring of rows (default ``row_ring_for`` by shape);
    ``short``: few candidates in a wide padding (dead blocks);
    ``scale_w``: weights past two 7-bit limbs; ``full_short``: the batch of
    _full_short_batch; ``stall``: "id:ms", every wait at named barrier id
    delayed by ms milliseconds; ``at_once``: how many of K2's blocks (or
    clusters) run concurrently (default: in turn)."""
    rng = np.random.default_rng(P * 7 + R + wide)
    thr = ScaledThresholds(0.9)
    if full_short:
        C, y, W, n_cand = _full_short_batch(rng, B, P, R)
    elif segments:
        C, y, W, n_cand = segment_batch(rng, B, P if not short else max(6, P // 3), R, ties)
    else:
        C, y, W, n_cand = padded_batch(rng, B, P if not short else max(6, P // 3), R, wide)
    if short:
        pad = P - C.shape[1]
        C = np.concatenate([C, np.repeat(C[:, -1:], pad, axis=1)], axis=1)
        y = np.concatenate([y, np.repeat(y[:, -1:], pad, axis=1)], axis=1)
    W = W * scale_w
    assert W.sum(1).max() < 2**24, "scores must stay exact in float32"
    if full:
        n_cand[:] = P
    yt, lookup = torch.from_numpy(y), torch.from_numpy(thr.lookup)
    Cs, T_hi, T_lo, Wi, w_sum, w_max = kernel_inputs(
        torch.from_numpy(C), yt, torch.from_numpy(W), lookup, thr.scale)
    assert Cs.shape[2] % REP_STAGE == 0 and Cs.shape[2] - R < REP_STAGE
    inputs = dict(Cs=Cs, Thi=T_hi, Tlo=T_lo, W=Wi, wsum=w_sum, wmax=w_max,
                  y=yt, n=torch.from_numpy(n_cand))
    for name, a in inputs.items():
        np.ascontiguousarray(a.numpy(), dtype=np.int32).tofile(tmp_path / f"{name}.bin")
    if cap is None:
        cap = (k2_cluster_smem_max_p(k2_cluster) if k2_cluster else K2_SMEM_MAX_P if grid else
               cluster_smem_max_p(cluster) if cluster else K1_SMEM_MAX_P)
    if (cluster or k2_cluster) and row_ring is None:
        row_ring = row_ring_for(P, cluster or k2_cluster, P <= cap, bool(k2_cluster))
    ring = "r" if row_ring else ""
    subprocess.run([str(emulator), str(B), str(P), str(Cs.shape[2]), str(rs), str(cap),
                    *([f"k{k2_cluster}{ring}"] if k2_cluster else []),
                    *map(str, grid), *([f"c{cluster}{ring}"] if cluster else []),
                    *([str(at_once)] if at_once else [])],
                   cwd=tmp_path, check=True, capture_output=True, timeout=300,
                   env={**os.environ, **({"EMU_STALL": stall} if stall else {}),
                        **({"EMU_CLUSTER_SKEW": str(skew)} if cluster or k2_cluster else {})})
    K = np.fromfile(tmp_path / "K.bin", np.int32).reshape(B, P, P)
    bj = np.fromfile(tmp_path / "bj.bin", np.int32)
    bk = np.fromfile(tmp_path / "bk.bin", np.int32)
    Kt, bjt, bkt = tseg._solve_batch_torch(
        torch.from_numpy(C), yt, torch.from_numpy(W), torch.from_numpy(n_cand),
        rs, lookup, thr.scale)
    np.testing.assert_array_equal(bj, bjt.numpy())
    np.testing.assert_array_equal(bk, bkt.numpy())
    np.testing.assert_array_equal(K[:, : P - 1], Kt.numpy()[:, : P - 1])
    np.testing.assert_array_equal(K[:, P - 1, :2], np.stack([bj, bk], 1))
    chains = np.fromfile(tmp_path / "chains.bin", np.int32).reshape(B, P + 2)
    np.testing.assert_array_equal(chains, tseg._walk_chains(Kt, bjt, bkt).numpy())
    if segments:
        assert (bjt >= 0).any(), "no structured problem segmented: the case is vacuous"
    if not grid:
        _check_live_scratch(tmp_path, C, y, W, n_cand, rs, thr)
    elif not k2_cluster:
        # Each block draws until it is handed a problem past the last: G
        # first problems by block index, then B draws from the queue in all.
        assert np.fromfile(tmp_path / "queue.bin", np.int32).tolist() == [B]


def _check_live_scratch(tmp_path, C, y, W, n_cand, rs, thr):
    """K1's phase 1 alone: the entries of its scratch that the wavefront
    reads -- outside(j, k, k_) for j < k < k_ <= end, inside(j, k) for
    j < k <= end -- equal the host oracle's pair tensors. Every other
    entry may hold anything and is not looked at."""
    B, P, _R = C.shape
    OT = np.fromfile(tmp_path / "OT.bin", np.float32).reshape(B, P, P, P)
    INS = np.fromfile(tmp_path / "INS.bin", np.float32).reshape(B, P, P)
    idx = np.arange(P)
    for b in range(B):
        inside, outside, _ = tseg._pair_tensors(
            C[b].astype(np.int64), y[b].astype(np.int64), W[b].astype(np.int64), thr)
        outside = np.where(outside < rs, -np.inf, outside).astype(np.float32)
        end = int(n_cand[b]) - 1
        pair = (idx[:, None] < idx[None, :]) & (idx[None, :] <= end)  # j < k <= end
        live = pair[:, :, None] & pair[None, :, :]  # and k < k_ <= end
        np.testing.assert_array_equal(OT[b][live], outside[live])
        np.testing.assert_array_equal(INS[b][pair], inside[pair])


@pytest.mark.parametrize("B,P,R,wide,full", [
    (3, 16, 128, False, False),
    (3, 16, 128, True, False),
    (2, 40, 100, True, False),  # ragged tile rows and rep stages
    (1, 72, 40, False, True),  # two output tiles per side
    (1, 80, 128, True, False),  # the same with varied pairs, two stages, two limbs
])
def test_emulated_kernels_match_plain(emulator, tmp_path, B, P, R, wide, full):
    _run_and_check(emulator, tmp_path, B, P, R, wide, full)


@pytest.mark.parametrize("case", [
    dict(B=3, P=32, R=64, wide=False, full=False, short=True),  # n_cand << P: dead blocks
    dict(B=2, P=16, R=96, wide=True, full=False, scale_w=300),  # three weight limbs
    dict(B=2, P=16, R=6, wide=False, full=True, scale_w=2**19),  # four limbs, a stage mostly padding
    dict(B=3, P=16, R=128, wide=False, full=False, rs=1),  # the gate at its lowest
    dict(B=3, P=16, R=128, wide=False, full=False, rs=40),  # the gate above most sums
    dict(B=2, P=24, R=32, wide=False, full=True),  # one stage, a half-live row tile
    dict(B=2, P=16, R=97, wide=True, full=False),  # odd R: reps padded to a stage
], ids=["short", "limbs3", "limbs4", "rs1", "rs40", "one_stage", "odd_R"])
def test_emulated_k1_live_tiles_limbs_and_gate(emulator, tmp_path, case):
    case = dict(case)
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"),
                   case.pop("wide"), case.pop("full"), **case)


@pytest.mark.parametrize("B,P,R,wide,full,G", [
    (5, 16, 128, False, False, 1),  # one block owns every problem
    (5, 16, 128, True, False, 2),  # blocks own 3 and 2 problems
    (5, 16, 128, False, False, 5),  # one problem a block: no overlap
    (3, 40, 100, True, False, 2),
    (2, 72, 40, False, True, 1),
])
def test_emulated_pipelined_kernel_matches_plain(emulator, tmp_path, B, P, R, wide,
                                                 full, G):
    _run_and_check(emulator, tmp_path, B, P, R, wide, full, grid=(G,))


# Named barriers of K2's two groups (kProducerBar, kConsumerBar in the .cuh).
PRODUCER_BAR, CONSUMER_BAR = 1, 2


@pytest.mark.parametrize("case", [
    dict(B=3, P=32, R=64, wide=False, full=False, short=True, G=2),  # n_cand << P: dead k
    dict(B=2, P=16, R=96, wide=True, full=False, scale_w=300, G=1),  # three weight limbs
    dict(B=2, P=16, R=6, wide=False, full=True, scale_w=2**19, G=2),  # four limbs
    dict(B=3, P=16, R=128, wide=False, full=False, rs=1, G=2),  # the gate at its lowest
    dict(B=3, P=16, R=128, wide=False, full=False, rs=40, G=1),  # the gate above most sums
    dict(B=2, P=16, R=97, wide=True, full=False, G=1),  # odd R: reps padded to a stage
    dict(B=1, P=80, R=128, wide=True, full=False, G=1),  # two tiles per side, two limbs
], ids=["short", "limbs3", "limbs4", "rs1", "rs40", "odd_R", "wide_P"])
def test_emulated_k2_live_k_limbs_and_gate(emulator, tmp_path, case):
    """K2 at what K1 is held to above: its producer is the same body over
    k = 1..end, its chains come from the kernel."""
    case = dict(case)
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"),
                   case.pop("wide"), case.pop("full"), grid=(case.pop("G"),), **case)


@pytest.mark.parametrize("case", [
    # One block: each slot holds a full problem, a short one, a full one.
    dict(B=6, P=16, R=64, G=1, full_short=True),
    dict(B=6, P=16, R=64, G=1, full_short=True, stall=f"{CONSUMER_BAR}:4"),
    dict(B=6, P=16, R=64, G=1, full_short=True, stall=f"{PRODUCER_BAR}:2"),
    dict(B=6, P=40, R=64, G=1, full_short=True),  # the same with ragged tiles
    # Blocks run in turn here, so block 0 draws problems 0, 3, 4, 5, 6
    # from the queue and the others find it empty after their first.
    dict(B=7, P=16, R=64, G=3),
    dict(B=7, P=16, R=64, G=3, stall=f"{CONSUMER_BAR}:4"),
    dict(B=7, P=16, R=64, G=3, stall=f"{PRODUCER_BAR}:2"),
    dict(B=3, P=16, R=64, G=3),  # one problem a block: the end marker in slot 1
    dict(B=3, P=72, R=40, G=2, full=True, stall=f"{CONSUMER_BAR}:2"),  # two tiles per side
], ids=["reuse", "reuse_slow_consumer", "reuse_slow_producer", "reuse_ragged", "uneven",
        "uneven_slow_consumer", "uneven_slow_producer", "one_each", "wide_P_slow_consumer"])
def test_emulated_k2_handoff_slot_reuse_and_ownership(emulator, tmp_path, case):
    """K2's hand-off: slots reused by problems of unlike size, blocks with
    unequal numbers of problems, and either group held back so that the
    other runs ahead of it."""
    case = dict(case)
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"),
                   case.pop("wide", False), case.pop("full", False),
                   grid=(case.pop("G"),), **case)


@pytest.mark.parametrize("case", [
    dict(B=8, P=16, R=64, G=2),
    dict(B=12, P=16, R=64, G=3),
    dict(B=12, P=16, R=64, G=3, full_short=True),  # slots reused by unlike sizes
    dict(B=8, P=16, R=64, G=2, stall=f"{CONSUMER_BAR}:3"),
    dict(B=8, P=16, R=64, G=2, stall=f"{PRODUCER_BAR}:2"),
    dict(B=12, P=16, R=64, G=3, wide=True, stall=f"{CONSUMER_BAR}:2"),
    dict(B=8, P=24, R=32, G=2, full=True),  # a half-live row tile
], ids=["two_blocks", "three_blocks", "three_blocks_reuse", "two_slow_consumers",
        "two_slow_producers", "three_wide_slow_consumers", "two_blocks_full"])
def test_emulated_k2_blocks_draw_from_the_queue_at_once(emulator, tmp_path, case):
    """K2's G blocks run concurrently with B >= 4 G: every block, not only
    block 0, draws several problems from the work queue while the others
    draw too, each into its own pair of scratch slots. K, best_j, best_k
    and the chains equal the plain version's, and the queue ends at B."""
    case = dict(case)
    G = case.pop("G")
    assert case["B"] >= 4 * G
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"),
                   case.pop("wide", False), case.pop("full", False), grid=(G,),
                   at_once=G, **case)


@pytest.mark.parametrize("case", [
    dict(B=3, P=16, R=128, wide=False, full=False, cluster=2),
    dict(B=2, P=40, R=100, wide=True, full=False, cluster=4),  # wide weights, ragged tiles
    dict(B=1, P=72, R=40, wide=False, full=True, cluster=4),  # two output tiles per side
    dict(B=1, P=80, R=128, wide=True, full=False, cluster=2),  # two stages, two limbs
    dict(B=3, P=32, R=64, wide=False, full=False, short=True, cluster=4),  # dead blocks
], ids=["3-16-128", "wide_2-40-100", "full_1-72-40", "limbs2_1-80-128", "short"])
def test_emulated_k1_wavefront_with_h_in_device_memory(emulator, tmp_path, case):
    """K1 with the cap forced to 0: the cluster wavefront's device-memory
    instantiation, each block's rows of H in a (B, P, P) plane per problem
    in device memory that starts as garbage, as above
    cluster_smem_max_p() on the card. K, best_j, best_k, the chains and
    phase 1's live scratch equal the plain version's."""
    case = dict(case)
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"),
                   case.pop("wide"), case.pop("full"), cap=0, **case)


@pytest.mark.parametrize("case", [
    dict(B=3, P=16, R=128, cluster=2),
    dict(B=2, P=18, R=64, cluster=4),  # P not a multiple of N
    dict(B=2, P=37, R=100, cluster=2),  # odd P, ragged tiles
    dict(B=2, P=40, R=64, cluster=4, short=True),  # a short problem in a wide padding
    dict(B=3, P=24, R=64, cluster=4, ties=True),  # unit weights: first index wins
    dict(B=2, P=30, R=64, cluster=2, ties=True),
    dict(B=2, P=34, R=64, cluster=4, ties=True, cap=0),  # ties with H in device memory
    dict(B=2, P=33, R=64, cluster=4, cap=0),
    dict(B=1, P=72, R=40, cluster=4),  # two output tiles per side
    dict(B=2, P=8, R=64, cluster=4),  # each block owns two rows
    dict(B=2, P=7, R=64, cluster=8),  # ranks that own no row
], ids=["n2", "n4_ragged_p", "n2_odd_p", "n4_short", "n4_ties", "n2_ties", "n4_ties_device_h",
        "n4_device_h", "n4_two_tiles", "n4_p8", "n8_p7"])
def test_emulated_k1_cluster_wavefront(emulator, tmp_path, case):
    """K1's wavefront on a thread-block cluster of N blocks per problem,
    forced at small P (on the card it runs from CLUSTER_MIN_P), on
    structured problems whose every candidate is live and which all
    segment: rows owned cyclically, H in the blocks' shared memory (or,
    cap 0, in device memory) written across blocks through the mapped
    shared memory, the outside planes copied a step ahead, the argmaxes
    merged in rank 0. The N blocks of a cluster run at once, drifting
    apart by rank wherever no barrier holds them, and a block's shared
    memory turns to garbage when it exits. Zero tolerance against the
    plain version, chains included."""
    case = dict(case)
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"),
                   False, False, segments=True, **case)


@pytest.mark.parametrize("case", [
    dict(B=5, P=16, R=128, G=2, wide=True),  # blocks in turn
    dict(B=3, P=72, R=40, G=2, full=True, stall=f"{CONSUMER_BAR}:2"),  # two tiles per side
    # At once, with problems of unlike size, so that the blocks' draws
    # drift apart and any two of them may hold problems at the same time.
    dict(B=10, P=24, R=32, G=2, at_once=2),
    dict(B=12, P=16, R=64, G=3, full_short=True, at_once=3),
    dict(B=12, P=24, R=32, G=3, at_once=3, stall=f"{CONSUMER_BAR}:2"),
], ids=["in_turn", "wide_P_slow_consumer", "two_blocks_at_once", "three_blocks_at_once",
        "three_slow_consumers_at_once"])
def test_emulated_k2_with_h_in_device_memory(emulator, tmp_path, case):
    """K2 with the cap forced to 0: each block's consumer runs the
    wavefront on its own (P, P) plane of a (G, P, P) scratch in device
    memory, as above P = 176 on the card; with its blocks in turn and
    all at once, each drawing several problems from the queue while the
    others run, so a plane shared by two blocks would show."""
    case = dict(case)
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"),
                   case.pop("wide", False), case.pop("full", False), grid=(case.pop("G"),),
                   cap=0, **case)


@pytest.mark.parametrize("case", [
    dict(B=2, P=16, R=64, G=2, N=2),  # one problem a cluster
    dict(B=3, P=18, R=64, G=1, N=4),  # one cluster, both slots reused; P not a multiple of N
    dict(B=5, P=24, R=64, G=2, N=2, at_once=2),  # several a cluster, clusters at once
    dict(B=4, P=20, R=64, G=1, N=4, cap=0),  # H in device memory, one plane reused
    dict(B=5, P=24, R=64, G=2, N=2, cap=0, at_once=2),  # a plane per cluster, at once
    dict(B=4, P=16, R=64, G=1, N=2, stall=f"{PRODUCER_BAR}:2"),  # producers behind
    dict(B=4, P=16, R=64, G=1, N=4, stall=f"{CONSUMER_BAR}:1"),  # consumers behind
    dict(B=3, P=24, R=64, G=1, N=4, ties=True),  # unit weights: first index wins
    dict(B=3, P=30, R=64, G=2, N=2, ties=True, cap=0, at_once=2),  # ties, H in device memory
    dict(B=2, P=72, R=40, G=1, N=4),  # two output tiles per side
    dict(B=2, P=7, R=64, G=1, N=8),  # ranks that own no row and no middle index
], ids=["n2_one_each", "n4_reuse", "n2_two_clusters_at_once", "n4_device_h",
        "n2_device_h_at_once", "n2_slow_producers", "n4_slow_consumers", "n4_ties",
        "n2_ties_device_h", "n4_two_tiles", "n8_p7"])
def test_emulated_k2_cluster_route(emulator, tmp_path, case):
    """K2's cluster route (segdp_pipelined_cluster_kernel) forced at small
    P (on the card it runs from K2_CLUSTER_MIN_P) on G clusters of N
    blocks, on structured problems that all segment: each block's
    producers run phase 1 for every N-th middle index, its consumers the
    cluster wavefront, the slots handed over by the cluster's mbarriers,
    one cluster's problems after another in its two slots; the ranks
    drift apart wherever no barrier holds them (EMU_CLUSTER_SKEW, also at
    every remote arrival), a group is held back (EMU_STALL), and a
    block's shared memory, its mbarriers included, turns to garbage when
    it exits. Zero tolerance against the plain version, chains included."""
    case = dict(case)
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"), False,
                   False, grid=(case.pop("G"),), k2_cluster=case.pop("N"), segments=True,
                   **case)


@pytest.mark.parametrize("case", [
    dict(B=3, P=32, R=64, short=True, G=1, N=4),  # n_cand << P: dead middle indices
    dict(B=2, P=40, R=100, wide=True, G=1, N=2),  # weights past 127, ragged tiles and stages
    dict(B=2, P=16, R=96, wide=True, scale_w=300, G=2, N=2),  # three weight limbs
    dict(B=4, P=16, R=64, full_short=True, G=1, N=2),  # slots reused by unlike sizes
], ids=["short", "wide_ragged", "limbs3", "full_short"])
def test_emulated_k2_cluster_route_random_problems(emulator, tmp_path, case):
    """The cluster route at what K2's one-block route is held to above:
    random padded problems with dead middle indices, wide weights and
    slots reused by problems of unlike size."""
    case = dict(case)
    _run_and_check(emulator, tmp_path, case.pop("B"), case.pop("P"), case.pop("R"),
                   case.pop("wide", False), False, grid=(case.pop("G"),),
                   k2_cluster=case.pop("N"), **case)


# The ring of rows forced (two rows a warp), so that it wraps inside a
# step wherever a warp walks more than two rows: every
# width and cluster size, each with H in the cluster's shared memory and
# in device memory (cap 0).
ROW_RING = [dict(P=40, N=2), dict(P=40, N=4, cap=0), dict(P=40, N=16),
            dict(P=67, N=2, cap=0), dict(P=67, N=4), dict(P=67, N=16, cap=0),
            dict(P=96, N=2), dict(P=96, N=4, cap=0), dict(P=96, N=16)]
ROW_RING_IDS = [f"p{c['P']}_n{c['N']}{'_device_h' if 'cap' in c else ''}" for c in ROW_RING]


@pytest.mark.parametrize("case", ROW_RING, ids=ROW_RING_IDS)
def test_emulated_k1_cluster_wavefront_row_ring(emulator, tmp_path, case):
    """K1's cluster wavefront with the ring of rows forced (by shape it
    runs only where two whole planes do not fit a block): the stream of a
    warp's rows runs a row ahead of its walk and across the step barrier,
    copies land only at the wait
    that covers their group, and the ranks drift apart
    (EMU_CLUSTER_SKEW). K, best_j, best_k and the chains equal the plain
    version's on structured problems that all segment."""
    case = dict(case)
    P = case.pop("P")
    _run_and_check(emulator, tmp_path, 1 if P > 64 else 2, P, 64, False, False, segments=True,
                   cluster=case.pop("N"), row_ring=True, **case)


@pytest.mark.parametrize("case", ROW_RING, ids=ROW_RING_IDS)
def test_emulated_k2_cluster_route_row_ring(emulator, tmp_path, case):
    """K2's cluster route with its consumer warps' rings of rows forced, on
    one cluster that takes the problems in turn (two, one in each scratch
    slot, at P = 40; one above): as the K1 case above, the consumers'
    stream of rows also crossing their mbarrier step barrier."""
    case = dict(case)
    P = case.pop("P")
    _run_and_check(emulator, tmp_path, 1 if P > 64 else 2, P, 64, False, False, grid=(1,),
                   k2_cluster=case.pop("N"), segments=True, row_ring=True, **case)


@pytest.mark.parametrize("N", [2, 8, 16])
def test_emulated_layout_bytes_match_the_wrapper(emulator, N):
    """The shared memory the cluster launches ask for (cluster_smem_bytes
    and pipelined_cluster_smem_bytes in the .cuh, compiled here) equals
    what the wrapper counts for its caps and rings, with H in shared
    memory and not, for the ring of two planes and of rows."""
    from freddie_tpu_torch.ops import segdp_cuda

    for P in (7, 96, 257, 704, 1312):
        for smem_h in (False, True):
            for rows in (False, True):
                out = subprocess.run([str(emulator), "smem", str(P), str(N), str(int(smem_h)),
                                      str(int(rows))], check=True, capture_output=True, text=True)
                assert list(map(int, out.stdout.split())) == [
                    segdp_cuda.cluster_smem_bytes(P, N, smem_h, rows),
                    segdp_cuda.k2_cluster_smem_bytes(P, N, smem_h, rows)]
