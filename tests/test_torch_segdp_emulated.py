"""The CUDA kernels' source, run on the CPU, against the plain PyTorch DP.

There is no GPU or nvcc here, so ``freddie_tpu_torch/csrc/segdp_kernels.cuh``
is compiled by the host C++ compiler against a thread-per-CUDA-thread
stand-in (``tests/cuda_emu/emu.h``) and run at small shapes, including a
ragged P and R and the multi-tile (P > 64) path: K1's two launches (the
live-tile pair statistics, whose tensor-core step and asynchronous copies
the stand-in implements in plain C++ with the documented fragment
layout, then the wavefront with its chain walk), and K2's one
warp-specialised launch at grid sizes where a block owns one problem,
several, or all of them. The scratch starts as garbage, so an entry that
K1 leaves unwritten and the wavefront reads would show. It checks the
kernels' indexing, live-tile logic, weight limbs, masks, reductions, tie
order and barriers, not their speed or anything
the GPU compiler decides; ``tests/test_torch_segdp_cuda.py`` and
``chip_smoke.py`` check the real build on the card. Zero tolerance.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from freddie_tpu_torch.ops import segdp as tseg
from freddie_tpu_torch.ops.segdp import ScaledThresholds
from freddie_tpu_torch.ops.segdp_cuda import REP_STAGE, kernel_inputs
from test_torch_segdp_cuda import padded_batch

REPO = pathlib.Path(__file__).resolve().parent.parent
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
DYN_SMEM = "extern __shared__ __align__(16) unsigned char segdp_dyn_smem[];"


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    d = tmp_path_factory.mktemp("segdp_emu")
    src = (REPO / "freddie_tpu_torch" / "csrc" / "segdp_kernels.cuh").read_text()
    assert DYN_SMEM in src, "the kernel's dynamic shared memory declaration moved"
    (d / "segdp_kernels_emu.cuh").write_text(
        src.replace(DYN_SMEM, "unsigned char* segdp_dyn_smem = emu_dyn_smem;"))
    exe = d / "segdp_emu"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-pthread", f"-I{EMU}", f"-I{d}",
         "-o", str(exe), str(EMU / "segdp_main.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return exe


def _run_and_check(emulator, tmp_path, B, P, R, wide, full, grid=(), rs=3, scale_w=1,
                   short=False):
    """Runs the emulated kernels on a random padded batch (K2 when
    ``grid`` holds G) and holds them against _solve_batch_torch, and K1's
    chains against _walk_chains. ``short``: few candidates in a wide
    padding (dead blocks); ``scale_w``: weights past two 7-bit limbs."""
    rng = np.random.default_rng(P * 7 + R + wide)
    thr = ScaledThresholds(0.9)
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
                    *map(str, grid)],
                   cwd=tmp_path, check=True, capture_output=True, timeout=300)
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
    if not grid:
        chains = np.fromfile(tmp_path / "chains.bin", np.int32).reshape(B, P + 2)
        np.testing.assert_array_equal(chains, tseg._walk_chains(Kt, bjt, bkt).numpy())
        _check_live_scratch(tmp_path, C, y, W, n_cand, rs, thr)


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
