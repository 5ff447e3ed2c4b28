"""The CUDA kernels' source, run on the CPU, against the plain PyTorch DP.

There is no GPU or nvcc here, so ``freddie_tpu_torch/csrc/segdp_kernels.cuh``
is compiled by the host C++ compiler against a thread-per-CUDA-thread
stand-in (``tests/cuda_emu/emu.h``) and run at small shapes, including a
ragged P and R and the multi-tile (P > 64) path: K1's two launches, and
K2's one warp-specialised launch at grid sizes where a block owns one
problem, several, or all of them. It checks the kernels' indexing,
masks, reductions, tie order and barriers, not their speed or anything
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


def _run_and_check(emulator, tmp_path, B, P, R, wide, full, grid=()):
    """Runs the emulated kernels on a random padded batch (K2 when
    ``grid`` holds G) and holds them against _solve_batch_torch."""
    rng = np.random.default_rng(P * 7 + R + wide)
    thr = ScaledThresholds(0.9)
    C, y, W, n_cand = padded_batch(rng, B, P, R, wide)
    if full:
        n_cand[:] = P
    yt, lookup = torch.from_numpy(y), torch.from_numpy(thr.lookup)
    T_hi, T_lo = tseg.threshold_products(yt, lookup, thr.scale)
    Wi = W.astype(np.int32)
    inputs = dict(Cs=C * thr.scale, Thi=T_hi.numpy(), Tlo=T_lo.numpy(), W=Wi,
                  wsum=Wi.sum(1), y=y, n=n_cand)
    for name, a in inputs.items():
        np.ascontiguousarray(a, dtype=np.int32).tofile(tmp_path / f"{name}.bin")
    subprocess.run([str(emulator), str(B), str(P), str(R), "3", *map(str, grid)],
                   cwd=tmp_path, check=True, capture_output=True, timeout=300)
    K = np.fromfile(tmp_path / "K.bin", np.int32).reshape(B, P, P)
    bj = np.fromfile(tmp_path / "bj.bin", np.int32)
    bk = np.fromfile(tmp_path / "bk.bin", np.int32)
    Kt, bjt, bkt = tseg._solve_batch_torch(
        torch.from_numpy(C), yt, torch.from_numpy(W), torch.from_numpy(n_cand),
        3, lookup, thr.scale)
    np.testing.assert_array_equal(bj, bjt.numpy())
    np.testing.assert_array_equal(bk, bkt.numpy())
    np.testing.assert_array_equal(K[:, : P - 1], Kt.numpy()[:, : P - 1])
    np.testing.assert_array_equal(K[:, P - 1, :2], np.stack([bj, bk], 1))


@pytest.mark.parametrize("B,P,R,wide,full", [
    (3, 16, 128, False, False),
    (3, 16, 128, True, False),
    (2, 40, 100, True, False),  # ragged tile rows and rep stages
    (1, 72, 40, False, True),  # two output tiles per side
])
def test_emulated_kernels_match_plain(emulator, tmp_path, B, P, R, wide, full):
    _run_and_check(emulator, tmp_path, B, P, R, wide, full)


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
