"""The segmentation DP kernels for Hopper (``csrc/segdp.cu``) and their wrapper.

``solve_batch_cuda`` has the contract of ``freddie_tpu``'s
``solve_batch_pallas`` and returns (K, best_j, best_k), with best_j and
best_k also stored in K's last row as the TPU kernels store them. It
runs one of two kernels that compute the same values (details and what
bounds each on the H100 in ``csrc/segdp_kernels.cuh``):

- K1 (the default; replaces ``segdp_pallas.py:_kernel``): two launches.
  Phase 1, the pair statistics, on one block per (problem, middle index
  k): only the entries the wavefront reads (j < k < k_ <= n_cand-1), the
  contraction as s8 x s8 -> s32 ``mma.sync`` products on the tensor cores
  (exact; weights above 127 in 7-bit limbs; the reps padded to whole
  stages of ``REP_STAGE`` with zero weights), written to the (P, P, P)
  outside tensor in global memory because it cannot fit one SM's shared
  memory as it fit the TPU's VMEM; then phases 2-3, the backward
  wavefront (P strictly dependent steps), on one block per problem with
  H in shared memory, which ends by walking each problem's breakpoint
  chain (``with_chains``), so the dispatch launches nothing after it.
- K2 (``pipelined=True``; replaces ``segdp_pallas.py:_kernel_pipelined``):
  one persistent, warp-specialised launch of as many blocks as the card
  holds at once (two of 12 warps per SM at P <= 64, one above). In each
  block two producer warpgroups run K1's phase-1 body (the tensor-core
  contraction, live entries only) over k = 1..n_cand-1 of one problem
  after another, into two scratch slots in global memory, while one
  consumer warpgroup runs the wavefront, the argmax and the chain walk on
  the slot that is full. The slots change hands through per-slot "full"
  and "free" named barriers, never a block-wide one, and the blocks draw
  their problems from a counter on the card. Bound like K1's
  phase 1, by instruction issue in the indicator build. A block's shared
  memory holds the phase-1 slots beside H, so K2 takes P <= ``K2_MAX_P``
  and raises above it.

Both kernels return the chains themselves (``with_chains``); on the card
nothing is launched after them.

The wrapper takes the plain version (``_solve_batch_torch``) only for
tensors that lie on the CPU. For CUDA tensors it launches the chosen
kernel or raises; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from ._build import load_library
from .segdp import _solve_batch_torch, _walk_chains, threshold_products

# Kernel launches made through solve_batch_cuda, one per solved batch:
# K1's (both of its launches count once) and K2's.
LAUNCHES = 0
PIPELINED_LAUNCHES = 0
# The (B, P, R) of K1's latest launches as the caller gave them, oldest
# first: what a benchmark reads to name the shapes a stage launched.
LAUNCH_SHAPES: collections.deque = collections.deque(maxlen=256)
# Batches that ``ops.segdp.dispatch_batch_device`` solved on the host
# because their padded P is wider than K1 holds (``K1_MAX_P``), and the
# problems in them.
WIDE_HOST_BATCHES = 0
WIDE_HOST_PROBLEMS = 0

# Shared memory a Hopper block may use (dynamic, after opting in).
_BLOCK_SMEM = 232_448
_MAX_SMEM = _BLOCK_SMEM - 256  # less the wavefront's static reduction scratch

# What the runtime reports for K2, by (device index, P): SMs, blocks an SM
# holds at once, registers per thread, shared memory per block.
_PIPE_BLOCKS: dict[tuple[int, int], tuple[int, int, int, int]] = {}

# The widest problem K1 takes (240): the wavefront's H (4 P^2 B) and ys
# (4 P B) fit _MAX_SMEM up to here, 4 P^2 + 4 P = (2 P + 1)^2 - 1. The
# dispatch's P buckets are multiples of 32, so 224 is the widest it
# launches; it solves wider batches on the host.
K1_MAX_P = (math.isqrt(_MAX_SMEM + 1) - 1) // 2

# The widest problem K2 takes: above it one block's phase-1 slots
# (PairSmem<128>, 107,520 B), H (4 P^2 B) and ys do not fit _BLOCK_SMEM.
# The dispatch's P buckets are multiples of 32, so 160 is the widest in use.
K2_MAX_P = 176


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them to 32 bits)."""
    lib = load_library("segdp").lib
    lib.segdp_solve.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    lib.segdp_solve.restype = ctypes.c_int
    lib.segdp_wavefront_smem.argtypes = [ctypes.c_int]
    lib.segdp_wavefront_smem.restype = ctypes.c_size_t
    lib.segdp_solve_pipelined.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p
    ]
    lib.segdp_solve_pipelined.restype = ctypes.c_int
    lib.segdp_pipelined_smem.argtypes = [ctypes.c_int]
    lib.segdp_pipelined_smem.restype = ctypes.c_size_t
    lib.segdp_pipelined_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.segdp_pipelined_occupancy.restype = ctypes.c_int
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


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.segdp_error_string(err).decode()}")


def pipelined_occupancy(P: int) -> dict[str, int]:
    """What the runtime reports for K2 at width P on the current device:
    ``sms``, ``blocks_per_sm`` (resident at once), ``registers`` per thread
    and ``smem_bytes`` per block (static + dynamic). Queried once per
    (device, P); ``solve_batch_cuda`` asks under ``torch.cuda.device`` of
    its tensors, so on any card the key and the query (through the context
    torch made current) name that card. Raises ValueError for P above
    ``K2_MAX_P``: such a block's shared memory does not fit, and nothing
    falls back."""
    key = (torch.cuda.current_device(), P)
    if key not in _PIPE_BLOCKS:
        lib = _lib()
        smem = lib.segdp_pipelined_smem(P)
        if P > K2_MAX_P or not 0 < smem <= _BLOCK_SMEM:
            raise ValueError(f"P={P}: a K2 block needs {smem} B of shared memory (the "
                             f"pair statistics' slots, H and ys; the card gives at most "
                             f"{_BLOCK_SMEM} B): K2 takes P <= {K2_MAX_P}")
        out = (ctypes.c_int * 4)()
        _raise_on(lib, lib.segdp_pipelined_occupancy(P, ctypes.addressof(out)),
                  "K2 occupancy query")
        _PIPE_BLOCKS[key] = tuple(out)
    return dict(zip(("sms", "blocks_per_sm", "registers", "smem_bytes"), _PIPE_BLOCKS[key]))


def pipelined_grid(B: int, P: int) -> int:
    """K2's number of blocks for B problems at width P on the current
    device: as many as the card holds at once, at most B. Raises ValueError
    for P above ``K2_MAX_P``."""
    occ = pipelined_occupancy(P)
    return min(B, occ["sms"] * occ["blocks_per_sm"])


def _pipelined_scratch(B: int, P: int, dev):
    """K2's grid G and its per-block scratch slots OT (G, 2, P, P, P) and
    INS (G, 2, P, P); raises ValueError when the card cannot hold them."""
    G = pipelined_grid(B, P)
    try:
        OT = torch.empty((G, 2, P, P, P), dtype=torch.float32, device=dev)
        INS = torch.empty((G, 2, P, P), dtype=torch.float32, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        need = G * 2 * (P**3 + P**2) * 4
        raise ValueError(f"K2 scratch for G={G} blocks at P={P} needs "
                         f"{need / 2**20:.0f} MiB of device memory; the card "
                         "does not have it free") from e
    return G, OT, INS


# Reps per shared-memory stage of phase 1 (kMmaStage in the .cuh):
# the kernels take R as a multiple of it.
REP_STAGE = 64


def kernel_inputs(C, y, W, lookup, scale):
    """The kernels' int32 inputs from a padded batch: scale*C, the
    threshold products T_hi and T_lo, the weights, and each problem's
    weight sum and largest weight. The reps are padded to a multiple of
    ``REP_STAGE`` with zero weights, which add nothing to any sum (the
    segment stage's R buckets are multiples already). Runs on the tensors'
    device."""
    T_hi, T_lo = threshold_products(y, lookup, scale)
    Cs = C * scale  # pre-scaled; the dispatch keeps scale*C below 2^31
    Wi = W.to(torch.int32)
    w_sum = Wi.sum(dim=1, dtype=torch.int32)
    w_max = Wi.amax(dim=1) if W.shape[1] else torch.zeros_like(w_sum)
    pad = -W.shape[1] % REP_STAGE
    if pad:
        Cs = torch.nn.functional.pad(Cs, (0, pad))
        Wi = torch.nn.functional.pad(Wi, (0, pad))
    return Cs, T_hi, T_lo, Wi, w_sum, w_max


def solve_batch_cuda(C, y, W, n_cand, read_support, lookup, scale, pipelined=False,
                     with_chains=False):
    """Same contract as ``ops.segdp._solve_batch_torch`` and
    ``freddie_tpu``'s ``solve_batch_pallas``: C (B, P, R) int32, y (B, P)
    int32, W (B, R) f32 integer-valued, n_cand (B,) int32, lookup (L+1,)
    int32. ``pipelined`` runs K2 instead of K1, as it runs
    ``_kernel_pipelined`` there. Both kernels are exact for every weight
    (K1 splits wide weights into limbs itself), so they take no
    ``wide_weights`` flag. ``with_chains`` appends the (B, P+2)
    -1-terminated breakpoint chains to the result: both kernels walk them
    themselves; the CPU route takes ``_walk_chains``. Raises ValueError for
    P above ``K1_MAX_P`` (K2: ``K2_MAX_P``); the dispatch routes such
    batches to the host before it calls this."""
    global LAUNCHES, PIPELINED_LAUNCHES
    if C.device.type == "cpu":
        res = _solve_batch_torch(C, y, W, n_cand, read_support, lookup, scale)
        return res + (_walk_chains(*res),) if with_chains else res
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
        raise ValueError(f"batch of {B} problems: the kernels take 1..65535")
    if not 0 <= int(read_support) < 2**31:
        raise ValueError(f"read_support {read_support} out of int32 range")
    lib = _lib()
    if P > K1_MAX_P:
        raise ValueError(f"P={P}: H does not fit one block's shared memory "
                         f"(the kernels take P <= {K1_MAX_P})")

    Cs, T_hi, T_lo, Wi, w_sum, w_max = kernel_inputs(C, y, W, lookup, scale)
    R = Wi.shape[1]  # padded
    K = torch.empty((B, P, P), dtype=torch.int32, device=dev)
    best_j = torch.empty((B,), dtype=torch.int32, device=dev)
    best_k = torch.empty((B,), dtype=torch.int32, device=dev)
    chains = torch.empty((B, P + 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pipelined:
            G, OT, INS = _pipelined_scratch(B, P, dev)
            queue = torch.zeros(1, dtype=torch.int32, device=dev)  # the blocks' work counter
            err = lib.segdp_solve_pipelined(
                Cs.data_ptr(), T_hi.data_ptr(), T_lo.data_ptr(), Wi.data_ptr(),
                w_sum.data_ptr(), w_max.data_ptr(), y.data_ptr(), n_cand.data_ptr(),
                OT.data_ptr(), INS.data_ptr(), K.data_ptr(), best_j.data_ptr(),
                best_k.data_ptr(), chains.data_ptr(), queue.data_ptr(),
                B, P, R, int(read_support), G, stream,
            )
        else:
            OT = torch.empty((B, P, P, P), dtype=torch.float32, device=dev)
            INS = torch.empty((B, P, P), dtype=torch.float32, device=dev)
            err = lib.segdp_solve(
                Cs.data_ptr(), T_hi.data_ptr(), T_lo.data_ptr(), Wi.data_ptr(),
                w_sum.data_ptr(), w_max.data_ptr(), y.data_ptr(), n_cand.data_ptr(),
                OT.data_ptr(), INS.data_ptr(), K.data_ptr(), best_j.data_ptr(),
                best_k.data_ptr(), chains.data_ptr(), B, P, R, int(read_support), stream,
            )
    _raise_on(lib, err, f"segdp{'_pipelined' if pipelined else ''} kernel launch")
    if pipelined:
        PIPELINED_LAUNCHES += 1
    else:
        LAUNCHES += 1
        LAUNCH_SHAPES.append((B, P, C.shape[2]))
    return (K, best_j, best_k, chains) if with_chains else (K, best_j, best_k)
