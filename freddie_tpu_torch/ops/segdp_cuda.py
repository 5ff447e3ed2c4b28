"""The segmentation DP kernel for Hopper (``csrc/segdp.cu``) and its wrapper.

Replaces ``freddie_tpu/ops/segdp_pallas.py:_kernel`` (entered there
through ``solve_batch_pallas``): ``solve_batch_cuda`` has the same
contract and returns (K, best_j, best_k), with best_j/best_k also stored
in K's last row as the TPU kernel stores them.

What bounds it on the H100, and what the design does about it (details
in ``csrc/segdp_kernels.cuh``):

- phase 1, the pair statistics, is ~P^3 R compare/multiply-adds per
  problem on CUDA cores: one block per (problem, middle index k), a
  register-tiled exact int32 contraction over 32-rep stages in shared
  memory, the (P, P, P) outside tensor written j-major to global memory
  (L2-resident at the stage's chunk sizes) because it cannot fit one
  SM's shared memory as it fit the TPU's VMEM;
- phase 2, the backward wavefront, is P strictly dependent steps: one
  block per problem keeps H in shared memory and each step runs its
  independent row maxima one warp per row.

The wrapper takes the plain version (``_solve_batch_torch``) only for
tensors that lie on the CPU. For CUDA tensors it launches the kernel or
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .segdp import _solve_batch_torch, threshold_products

# Kernel launches made through solve_batch_cuda (one per solved batch).
LAUNCHES = 0

# Shared memory a Hopper block may use (dynamic, after opting in).
_MAX_SMEM = 232_448 - 256  # less the wavefront's static reduction scratch


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them to 32 bits)."""
    lib = load_library("segdp").lib
    lib.segdp_solve.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    lib.segdp_solve.restype = ctypes.c_int
    lib.segdp_wavefront_smem.argtypes = [ctypes.c_int]
    lib.segdp_wavefront_smem.restype = ctypes.c_size_t
    lib.segdp_error_string.argtypes = [ctypes.c_int]
    lib.segdp_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def solve_batch_cuda(C, y, W, n_cand, read_support, lookup, scale,
                     wide_weights=True):
    """Same contract as ``ops.segdp._solve_batch_torch`` and
    ``freddie_tpu``'s ``solve_batch_pallas``: C (B, P, R) int32, y (B, P)
    int32, W (B, R) f32 integer-valued, n_cand (B,) int32, lookup (L+1,)
    int32. ``wide_weights`` is accepted for parity with the dispatch: the
    kernel's int32 contraction is exact for every weight, so it needs no
    weight split."""
    global LAUNCHES
    if C.device.type == "cpu":
        return _solve_batch_torch(C, y, W, n_cand, read_support, lookup, scale)
    if C.device.type != "cuda":
        raise ValueError(f"unsupported device {C.device}")
    dev = C.device
    B, P, R = C.shape
    _check("C", C, torch.int32, (B, P, R), dev)
    _check("y", y, torch.int32, (B, P), dev)
    _check("W", W, torch.float32, (B, R), dev)
    _check("n_cand", n_cand, torch.int32, (B,), dev)
    _check("lookup", lookup, torch.int32, lookup.shape, dev)
    if not 0 < B <= 65535:
        raise ValueError(f"batch of {B} problems: the kernel takes 1..65535")
    if not 0 <= int(read_support) < 2**31:
        raise ValueError(f"read_support {read_support} out of int32 range")
    lib = _lib()
    if lib.segdp_wavefront_smem(P) > _MAX_SMEM:
        raise ValueError(f"P={P}: H does not fit one block's shared memory")

    T_hi, T_lo = threshold_products(y, lookup, scale)
    Cs = C * scale  # pre-scaled; the dispatch keeps scale*C below 2^31
    Wi = W.to(torch.int32)
    w_sum = Wi.sum(dim=1, dtype=torch.int32)
    OT = torch.empty((B, P, P, P), dtype=torch.float32, device=dev)
    INS = torch.empty((B, P, P), dtype=torch.float32, device=dev)
    K = torch.empty((B, P, P), dtype=torch.int32, device=dev)
    best_j = torch.empty((B,), dtype=torch.int32, device=dev)
    best_k = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segdp_solve(
            Cs.data_ptr(), T_hi.data_ptr(), T_lo.data_ptr(), Wi.data_ptr(),
            w_sum.data_ptr(), y.data_ptr(), n_cand.data_ptr(), OT.data_ptr(),
            INS.data_ptr(), K.data_ptr(), best_j.data_ptr(), best_k.data_ptr(),
            B, P, R, int(read_support), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"segdp kernel launch failed: {lib.segdp_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return K, best_j, best_k
