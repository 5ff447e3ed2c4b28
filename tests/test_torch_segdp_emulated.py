"""The CUDA kernels' source, run on the CPU, against the plain PyTorch DP.

There is no GPU or nvcc here, so ``freddie_tpu_torch/csrc/segdp_kernels.cuh``
is compiled by the host C++ compiler against a thread-per-CUDA-thread
stand-in (``tests/cuda_emu/emu.h``) and run at small shapes, including a
ragged P and R and the multi-tile (P > 64) path: K1's two launches (the
live-tile pair statistics, whose tensor-core step and asynchronous copies
the stand-in implements in plain C++ with the documented fragment
layout, then the wavefront with its chain walk), and K2's one
warp-specialised launch (the same two bodies in a producer and a consumer
group with a per-slot hand-off) at grid sizes where a block gets one
problem, several, or all of them, with either group stalled so that the
hand-off is walked with the producer ahead and with the consumer ahead,
with the blocks run in turn (block 0 drains the work queue) and all at
once (every block draws several problems while the others draw too). The scratch starts as
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
from freddie_tpu_torch.ops.segdp_cuda import REP_STAGE, kernel_inputs
from test_segdp import random_problem
from test_torch_segdp_cuda import padded_batch

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
                   short=False, full_short=False, stall=None, at_once=None):
    """Runs the emulated kernels on a random padded batch (K2 when
    ``grid`` holds G) and holds them
    against _solve_batch_torch, and their chains against _walk_chains.
    ``short``: few candidates in a wide padding (dead blocks);
    ``scale_w``: weights past two 7-bit limbs; ``full_short``: the batch of
    _full_short_batch; ``stall``: "id:ms", every wait at named barrier id
    delayed by ms milliseconds; ``at_once``: how many of K2's blocks run
    concurrently (default: in turn)."""
    rng = np.random.default_rng(P * 7 + R + wide)
    thr = ScaledThresholds(0.9)
    if full_short:
        C, y, W, n_cand = _full_short_batch(rng, B, P, R)
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
    subprocess.run([str(emulator), str(B), str(P), str(Cs.shape[2]), str(rs),
                    *map(str, grid), *([str(at_once)] if at_once else [])],
                   cwd=tmp_path, check=True, capture_output=True, timeout=300,
                   env={**os.environ, **({"EMU_STALL": stall} if stall else {})})
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
    if not grid:
        _check_live_scratch(tmp_path, C, y, W, n_cand, rs, thr)
    else:
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
