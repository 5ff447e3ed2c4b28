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
  wavefront (P strictly dependent steps), which ends by walking each
  problem's breakpoint chain (``with_chains``), so the dispatch launches
  nothing after it. The wavefront runs by shape: below ``CLUSTER_MIN_P``
  on one block per problem with H in its shared memory; from there on a
  thread-block cluster of N = 16 or 8 blocks per problem
  (``cluster_size_for``: 16 where the clusters of one launch all fit at
  once), each block owning every N-th row of H in its shared memory (up
  to ``cluster_smem_max_p(N)``, in device memory above) and copying the
  rows of the outside planes it will walk into shared memory ahead of
  the step (``row_ring_for``: two whole planes a block where they fit,
  else a ring of two rows for each warp, filled a row ahead of its walk).
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
  memory holds the phase-1 slots beside H up to ``K2_SMEM_MAX_P``; above
  it each block's H is a plane of its own in device memory. From
  ``K2_CLUSTER_MIN_P`` on, K2 runs by shape on its cluster route: one
  persistent thread-block cluster of N = 16 or 8 blocks per problem
  (``k2_cluster_size_for``), each block's producers running phase 1 for
  every N-th middle index and its consumers K1's cluster wavefront on the
  rows those producers wrote, the slots changing hands through mbarriers
  across the cluster. From there on the one-block route runs only when
  forced (``cluster_size=0``), as the card tests' independent witness.

Both kernels take every P whose scratch fits the card: past the widths
where two whole outside planes fit a block, the wavefront's ring holds
rows, whose shared memory grows with P and not with P^2. The scratch --
the (P, P, P)
outside tensor, inside and, above the shared-memory cap, H -- is held
for a group of problems (K1), blocks (K2) or clusters (K2's cluster
route) at once, as many as ``SCRATCH_BUDGET`` allows and at least one
(``group_size``); K1 solves a batch group by group on one set of
scratch buffers. Where the card cannot hold even one, the wrapper raises
ValueError naming the bytes.

Both kernels return the chains themselves (``with_chains``); on the card
nothing is launched after them.

The wrapper takes the plain version (``_solve_batch_torch``) only for
tensors that lie on the CPU. For CUDA tensors it launches the chosen
kernel or raises; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from ._build import load_library
from .segdp import _solve_batch_torch, _walk_chains, threshold_products

# Kernel launches made through solve_batch_cuda, one per solved batch:
# K1's (its two launches, over every group of the batch, count once) and
# K2's; of K1's, the ones whose wavefront ran on clusters, and of K2's,
# the ones on its cluster route; and of both, the ones whose wavefront
# held H in device memory.
LAUNCHES = 0
PIPELINED_LAUNCHES = 0
CLUSTER_LAUNCHES = 0
PIPELINED_CLUSTER_LAUNCHES = 0
DEVICE_H_LAUNCHES = 0
PIPELINED_DEVICE_H_LAUNCHES = 0
# The (B, P, R) of K1's latest launches as the caller gave them, oldest
# first: what a benchmark reads to name the shapes a stage launched.
LAUNCH_SHAPES: collections.deque = collections.deque(maxlen=256)

# Shared memory a Hopper block may use (dynamic, after opting in).
_BLOCK_SMEM = 232_448
_MAX_SMEM = _BLOCK_SMEM - 256  # less the wavefront's static reduction scratch

# What the runtime reports for K2, by (device index, P, H in shared
# memory): SMs, blocks an SM holds at once, registers per thread, shared
# memory per block.
_PIPE_BLOCKS: dict[tuple[int, int, bool], tuple[int, int, int, int]] = {}
# The same for K1's cluster wavefront, by (device index, P, N, H in shared
# memory): clusters resident at once, shared memory per block, registers.
_CLUSTER_OCC: dict[tuple[int, int, int, bool], tuple[int, int, int]] = {}
# And for K2's cluster route.
_K2_CLUSTER_OCC: dict[tuple[int, int, int, bool], tuple[int, int, int]] = {}

# The widest problem K1's one-block wavefront (wavefront_kernel) takes
# (240): H (4 P^2 B) and ys (4 P B) fit _MAX_SMEM up to here, 4 P^2 + 4 P
# = (2 P + 1)^2 - 1.
K1_SMEM_MAX_P = (math.isqrt(_MAX_SMEM + 1) - 1) // 2

# K1's wavefront runs on thread-block clusters from this width on, and on
# one block per problem below it: narrow buckets come in batches that fill
# the card one block each, wide ones in batches of a few problems.
CLUSTER_MIN_P = 96
# Blocks per cluster: WIDE_CLUSTER_SIZE (16, past the portable 8) when the
# clusters of every problem of the batch fit the card at once, as the
# runtime reports it (cluster_size_for), else CLUSTER_SIZE. On one H100
# the wavefront's launch on 16 blocks took less device time than on 8 at
# every (P, B) of chip_smoke's sweep whose clusters of 16 were all
# resident, and more where they were not (B = 64 at P = 128, B = 128 at
# P = 96; 35 clusters of 16 fit at those P).
CLUSTER_SIZE = 8
WIDE_CLUSTER_SIZE = 16
MAX_CLUSTER = 16  # kMaxCluster in the .cuh
# The warps that run the cluster wavefront in a block: K1's whole block
# (kWarps), K2's consumer group (kConsumerWarps).
WAVE_WARPS = 8
CONSUMER_WARPS = 4
# The cluster wavefront's rings: OT_STAGES whole outside planes a block
# (kOtStages triangles), or RING_ROWS rows of P floats for each warp
# (kRingRows). row_ring_for chooses by shape, solve_batch_cuda's
# ``row_ring`` forces.
OT_STAGES = 2
RING_ROWS = 2


def _tri_floats(P: int, N: int) -> int:
    """Floats of the packed triangle of rows that rank 0 of an N-block
    cluster owns at width P (tri_floats in the .cuh): rows k = 0, N, 2N, ...
    with columns k+1..P-1 each."""
    rows = (P - 1) // N + 1
    return rows * (P - 1) - N * rows * (rows - 1) // 2


def _wave_bytes(P: int, N: int, smem_h: bool, nwarps: int, row_ring: bool) -> int:
    """cluster_smem_bytes in the .cuh: H's triangle when it lives there,
    the ring (``row_ring``: RING_ROWS rows of P floats for each of
    ``nwarps`` warps; else OT_STAGES triangles), ys and the argmax slots."""
    tri = _tri_floats(P, N)
    ring = nwarps * RING_ROWS * P if row_ring else OT_STAGES * tri
    return 4 * ((tri if smem_h else 0) + ring + P) + 8 * MAX_CLUSTER


def cluster_smem_bytes(P: int, N: int, smem_h: bool, row_ring: bool = True) -> int:
    """Dynamic shared memory of a block of K1's cluster wavefront at
    width P on N blocks with the ring of rows (``row_ring``) or of planes."""
    return _wave_bytes(P, N, smem_h, WAVE_WARPS, row_ring)


def row_ring_for(P: int, N: int, smem_h: bool, pipelined: bool = False) -> bool:
    """Whether the cluster wavefront (K1's, or with ``pipelined`` K2's
    consumers') at width P on N blocks takes each warp's ring of rows:
    only where two whole outside planes do not fit a block beside the
    rest of its layout (on one H100 the rows took 1.10-1.15x the planes'
    launch time where both fit)."""
    size = k2_cluster_smem_bytes if pipelined else cluster_smem_bytes
    return size(P, N, smem_h, False) > _MAX_SMEM


@functools.cache
def _widest(N: int, pipelined: bool = False) -> int:
    """The widest P whose H's triangle fits a block of K1's cluster
    wavefront (pipelined: of K2's cluster route) on N blocks beside the
    ring of rows. Where the planes fit a block only with H in device
    memory, H in shared memory beside the rows took 0.49-0.76x their
    launch time on one H100, so H stays in shared memory up to here."""
    size = k2_cluster_smem_bytes if pipelined else cluster_smem_bytes
    P = 1
    while size(P + 1, N, True) <= _MAX_SMEM:
        P += 1
    return P


def cluster_smem_max_p(N: int | None = None) -> int:
    """The widest P whose H stays in the shared memory of an N-block
    cluster (default ``CLUSTER_SIZE``) of K1's wavefront."""
    return _widest(N or CLUSTER_SIZE)

# The same for K2 (176), whose block holds the phase-1 slots beside H:
# PairSmem<128> (sizeof in the .cuh), H, ys and 16 B of hand-off state.
_PAIR_SMEM_WIDE = 2 * 128 * 32 * 8 + 2 * 128 * 160 + 128 * 8
K2_SMEM_MAX_P = (math.isqrt(_MAX_SMEM - _PAIR_SMEM_WIDE - 16 + 1) - 1) // 2
_MBAR_BYTES = 64  # kPipeMbarBytes: K2's cluster route's mbarriers

# K2 runs on its cluster route (segdp_pipelined_cluster_kernel) by shape
# from this width on, and on one block per SM below it. On one H100 the
# cluster route's launch took less device time than the one-block route's
# at every (P, B) of chip_smoke's K2 sweep, from P = 96 (its narrowest)
# up, B = 1 and 8 and the stage's full chunks at P = 96 and 128 included.
K2_CLUSTER_MIN_P = 96
# K2's cluster route takes WIDE_CLUSTER_SIZE blocks a cluster while the
# batch needs at most this many problems per resident cluster of that
# size (k2_cluster_size_for): on one H100, 16 blocks beat 8 on the
# launch's device time at B = 1 at every width and at the P = 256 chunk
# of 16 problems on 7 clusters, and lost at the P = 96 and 128 chunks (128
# and 64 problems).
K2_WIDE_PROBLEMS_PER_CLUSTER = 3


def k2_cluster_smem_bytes(P: int, N: int, smem_h: bool, row_ring: bool = True) -> int:
    """Dynamic shared memory of a block of K2's cluster route
    (pipelined_cluster_smem_bytes in the .cuh): the producers'
    PairSmem<128>, the mbarriers and the cluster wavefront's layout for
    its consumer warps with the ring of rows (``row_ring``) or of planes."""
    return _PAIR_SMEM_WIDE + _MBAR_BYTES + _wave_bytes(P, N, smem_h, CONSUMER_WARPS, row_ring)


def k2_cluster_smem_max_p(N: int | None = None) -> int:
    """The widest P whose H stays in the shared memory of K2's cluster
    route on N blocks (default ``WIDE_CLUSTER_SIZE``)."""
    return _widest(N or WIDE_CLUSTER_SIZE, True)

# Device memory the kernels' scratch may hold at once (the budget of
# ops.segdp.suggested_batch_size); read at call time.
SCRATCH_BUDGET = 4 << 30


def scratch_bytes(P: int, pipelined: bool = False, smem_max_p: int | None = None,
                  N: int | None = None) -> int:
    """Scratch of one K1 problem, one K2 block or one cluster of K2's
    cluster route at width P: the outside tensor (P^3 f32; K2 has two
    slots), inside (P^2; two) and, when P is above the shared-memory cap
    (``_cap``), H (P^2)."""
    return _unit_bytes(P, pipelined, P > _cap(pipelined, smem_max_p, N))


def _unit_bytes(P: int, pipelined: bool, device_h: bool) -> int:
    slots = 2 if pipelined else 1
    return 4 * (slots * (P**3 + P**2) + (P * P if device_h else 0))


def group_size(n: int, P: int, pipelined: bool = False, smem_max_p: int | None = None,
               budget: int | None = None, N: int | None = None) -> int:
    """How many of ``n`` K1 problems (or K2 blocks, or clusters of its
    cluster route on N blocks) keep their scratch at once: the most whose
    ``scratch_bytes`` fit ``budget`` (default ``SCRATCH_BUDGET``), never
    fewer than one."""
    return _fit(n, scratch_bytes(P, pipelined, smem_max_p, N), budget)


def _fit(n: int, unit: int, budget: int | None = None) -> int:
    budget = SCRATCH_BUDGET if budget is None else budget
    return max(1, min(n, budget // unit))


def _cap(pipelined: bool, smem_max_p: int | None, N: int | None = None) -> int:
    """The widest P whose H stays in shared memory: the kernel's own limit
    (K1: its cluster wavefront's on N blocks, default ``CLUSTER_SIZE``;
    K2: its one-block route's, or with N its cluster route's on N
    blocks), or a lower cap the caller gives (0 puts H in device memory
    at any P)."""
    if pipelined:
        top = k2_cluster_smem_max_p(N) if N else K2_SMEM_MAX_P
    else:
        top = cluster_smem_max_p(N)
    if smem_max_p is None:
        return top
    if not 0 <= smem_max_p <= top:
        raise ValueError(f"smem_max_p={smem_max_p}: H fits shared memory up to P={top}")
    return smem_max_p


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them to 32 bits)."""
    lib = load_library("segdp").lib
    lib.segdp_solve.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    lib.segdp_solve.restype = ctypes.c_int
    lib.segdp_solve_pipelined.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    lib.segdp_solve_pipelined.restype = ctypes.c_int
    lib.segdp_solve_pipelined_cluster.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p
    ]
    lib.segdp_solve_pipelined_cluster.restype = ctypes.c_int
    lib.segdp_pipelined_cluster_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.segdp_pipelined_cluster_occupancy.restype = ctypes.c_int
    lib.segdp_pipelined_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.segdp_pipelined_occupancy.restype = ctypes.c_int
    lib.segdp_cluster_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.segdp_cluster_occupancy.restype = ctypes.c_int
    lib.segdp_cluster_barrier_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.segdp_cluster_barrier_probe.restype = ctypes.c_int
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


def pipelined_occupancy(P: int, smem_max_p: int | None = None) -> dict[str, int]:
    """What the runtime reports for K2 at width P on the current device,
    with H in shared memory up to the cap (``K2_SMEM_MAX_P`` by default):
    ``sms``, ``blocks_per_sm`` (resident at once), ``registers`` per
    thread and ``smem_bytes`` per block (static + dynamic). Queried once
    per (device, P, home of H); ``solve_batch_cuda`` asks under
    ``torch.cuda.device`` of its tensors, so on any card the key and the
    query (through the context torch made current) name that card."""
    cap = _cap(True, smem_max_p)
    key = (torch.cuda.current_device(), P, P <= cap)
    if key not in _PIPE_BLOCKS:
        lib = _lib()
        out = (ctypes.c_int * 4)()
        _raise_on(lib, lib.segdp_pipelined_occupancy(P, cap, ctypes.addressof(out)),
                  "K2 occupancy query")
        _PIPE_BLOCKS[key] = tuple(out)
    return dict(zip(("sms", "blocks_per_sm", "registers", "smem_bytes"), _PIPE_BLOCKS[key]))


def cluster_occupancy(P: int, N: int | None = None, smem_max_p: int | None = None,
                      row_ring: bool | None = None) -> dict[str, int]:
    """What the runtime reports for K1's cluster wavefront at width P on
    clusters of N blocks (default ``CLUSTER_SIZE``) on the current device,
    H in shared memory up to the cap, the ring ``row_ring`` (default
    ``row_ring_for``): ``max_active_clusters``
    (cudaOccupancyMaxActiveClusters), ``smem_bytes`` per block (static +
    dynamic) and ``registers`` per thread. Queried once per (device, P, N,
    home of H, ring)."""
    return _cluster_occupancy(False, P, N or CLUSTER_SIZE, smem_max_p, row_ring)


def _cluster_occupancy(pipelined: bool, P: int, N: int, smem_max_p: int | None,
                       row_ring: bool | None):
    """cluster_occupancy (K1) or k2_cluster_occupancy (pipelined), queried
    once per (device, P, N, home of H, ring)."""
    smem_h = P <= _cap(pipelined, smem_max_p, N)
    row_ring = row_ring_for(P, N, smem_h, pipelined) if row_ring is None else bool(row_ring)
    cache = _K2_CLUSTER_OCC if pipelined else _CLUSTER_OCC
    key = (torch.cuda.current_device(), P, N, smem_h, row_ring)
    if key not in cache:
        lib = _lib()
        query = lib.segdp_pipelined_cluster_occupancy if pipelined else lib.segdp_cluster_occupancy
        out = (ctypes.c_int * 3)()
        _raise_on(lib, query(P, N, int(smem_h), int(row_ring), ctypes.addressof(out)),
                  f"{'K2' if pipelined else 'K1'} cluster occupancy query")
        cache[key] = tuple(out)
    return dict(zip(("max_active_clusters", "smem_bytes", "registers"), cache[key]))


def k2_cluster_occupancy(P: int, N: int | None = None, smem_max_p: int | None = None,
                         row_ring: bool | None = None) -> dict[str, int]:
    """What the runtime reports for K2's cluster route at width P on
    clusters of N blocks (default ``WIDE_CLUSTER_SIZE``) on the current
    device, H in shared memory up to the cap: ``max_active_clusters``,
    ``smem_bytes`` per block and ``registers`` per thread, as
    ``cluster_occupancy`` reports them for K1."""
    return _cluster_occupancy(True, P, N or WIDE_CLUSTER_SIZE, smem_max_p, row_ring)


def _row_ring(P: int, N: int, smem_h: bool, pipelined: bool, row_ring: bool | None) -> bool:
    """The cluster wavefront's ring: ``row_ring_for`` by shape, or
    ``row_ring`` as the caller forces it, which must fit the block's
    shared memory."""
    if row_ring is None:
        return row_ring_for(P, N, smem_h, pipelined)
    size = k2_cluster_smem_bytes if pipelined else cluster_smem_bytes
    if size(P, N, smem_h, row_ring) > _MAX_SMEM:
        raise ValueError(f"row_ring={row_ring}: that ring does not fit a block's shared memory "
                         f"at P={P} on {N} blocks a cluster")
    return bool(row_ring)


def cluster_barrier_probe(B: int, N: int, steps: int) -> None:
    """Launches ``steps`` rounds of the cluster barrier alone on B
    clusters of N blocks on the current stream: what chip_smoke times as
    the cluster wavefront's latency floor at P = steps + 1."""
    lib = _lib()
    _raise_on(lib, lib.segdp_cluster_barrier_probe(
        B, N, steps, torch.cuda.current_stream().cuda_stream), "cluster barrier probe")


def pipelined_grid(B: int, P: int, smem_max_p: int | None = None) -> int:
    """K2's number of blocks for B problems at width P on the current
    device: as many as the card holds at once and as ``SCRATCH_BUDGET``
    gives scratch for, at most B, at least 1."""
    occ = pipelined_occupancy(P, smem_max_p)
    return group_size(min(B, occ["sms"] * occ["blocks_per_sm"]), P, True, smem_max_p)


def pipelined_cluster_grid(B: int, P: int, N: int, smem_max_p: int | None = None,
                           row_ring: bool | None = None) -> int:
    """The clusters of K2's cluster route on N blocks for B problems at
    width P on the current device: as many as are resident at once and
    as ``SCRATCH_BUDGET`` gives scratch for, at most B, at least 1."""
    occ = k2_cluster_occupancy(P, N, smem_max_p, row_ring)
    return group_size(min(B, max(1, occ["max_active_clusters"])), P, True, smem_max_p, N=N)


def _scratch(n: int, P: int, pipelined: bool, cap: int, dev):
    """Scratch for ``n`` K1 problems or K2 blocks: OT, INS and (above the
    cap) H, f32 (K2: two OT and INS slots per block). Where the card
    cannot hold n units, n halves; raises ValueError naming the bytes when
    it cannot hold one. Returns n and the three tensors (H None)."""
    slots = (2,) if pipelined else ()
    shapes = [slots + (P, P, P), slots + (P, P), (P, P) if P > cap else None]
    while True:
        try:
            return n, [None if s is None else
                       torch.empty((n,) + s, dtype=torch.float32, device=dev) for s in shapes]
        except torch.cuda.OutOfMemoryError as e:
            if n == 1:
                need = _unit_bytes(P, pipelined, P > cap)
                raise ValueError(f"P={P}: one {'K2 block' if pipelined else 'problem'}'s "
                                 f"scratch needs {need} B ({need / 2**20:.0f} MiB) of "
                                 "device memory; the card does not have it free") from e
            n = (n + 1) // 2


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


def cluster_size_for(B: int, P: int, smem_max_p: int | None = None) -> int:
    """The blocks per cluster of K1's wavefront for a launch of B problems
    at width P on the current device: WIDE_CLUSTER_SIZE when the runtime
    can keep B such clusters resident at once
    (cudaOccupancyMaxActiveClusters) or when a cap is given that only
    that many blocks hold H at; else CLUSTER_SIZE. Either takes every P."""
    N = WIDE_CLUSTER_SIZE
    if smem_max_p is not None and smem_max_p > cluster_smem_max_p(CLUSTER_SIZE):
        return N
    if cluster_occupancy(P, N, smem_max_p)["max_active_clusters"] >= B:
        return N
    return CLUSTER_SIZE


def _k1_route(P: int, smem_max_p: int | None, cluster_size: int | None,
              wide_size=lambda: CLUSTER_SIZE) -> tuple[int, int]:
    """K1's wavefront at width P: (N, cap), N the blocks per cluster (0:
    the one-block wavefront) and cap the widest P whose H stays in shared
    memory. By shape unless ``cluster_size`` forces a route: from
    ``CLUSTER_MIN_P`` on (or where H has to be in device memory) the
    cluster kernel on ``wide_size()`` blocks (solve_batch_cuda passes
    cluster_size_for), below it the one-block kernel; ``cluster_size`` 0
    takes the one-block kernel, N >= 1 the cluster kernel on N blocks.
    The cluster kernel takes every P."""
    if cluster_size is None:
        if P < CLUSTER_MIN_P and P <= _cap(False, smem_max_p):
            return 0, _cap(False, smem_max_p)
        N = wide_size()
    elif cluster_size == 0:
        cap = K1_SMEM_MAX_P if smem_max_p is None else smem_max_p
        if P > min(cap, K1_SMEM_MAX_P):
            raise ValueError(f"P={P}: the one-block wavefront keeps H in shared memory, which "
                             f"holds it up to P={K1_SMEM_MAX_P} (cap {cap})")
        return 0, cap
    elif 1 <= cluster_size <= MAX_CLUSTER:
        N = cluster_size
    else:
        raise ValueError(f"cluster_size={cluster_size}: 0 or 1..{MAX_CLUSTER}")
    return N, _cap(False, smem_max_p, N)


def k2_cluster_size_for(B: int, P: int, smem_max_p: int | None = None) -> int:
    """The blocks per cluster of K2's cluster route for B problems at
    width P on the current device: WIDE_CLUSTER_SIZE where the batch needs
    at most K2_WIDE_PROBLEMS_PER_CLUSTER problems per cluster of that size
    the runtime keeps resident at once, or where a cap is given that only
    that many blocks hold H at; else CLUSTER_SIZE. Either takes every P."""
    N = WIDE_CLUSTER_SIZE
    if smem_max_p is not None and smem_max_p > k2_cluster_smem_max_p(CLUSTER_SIZE):
        return N
    if B <= K2_WIDE_PROBLEMS_PER_CLUSTER * k2_cluster_occupancy(
            P, N, smem_max_p)["max_active_clusters"]:
        return N
    return CLUSTER_SIZE


def _k2_route(P: int, smem_max_p: int | None, cluster_size: int | None,
              wide_size=lambda: WIDE_CLUSTER_SIZE) -> tuple[int, int]:
    """K2's route at width P: (N, cap), N the blocks per cluster of its
    cluster route (0: the one-block route) and cap the widest P whose H
    stays in shared memory. By shape unless ``cluster_size`` forces a
    route: from ``K2_CLUSTER_MIN_P`` on the cluster route on
    ``wide_size()`` blocks (solve_batch_cuda passes k2_cluster_size_for),
    the one-block route below; ``cluster_size`` 0 takes the one-block
    route, N >= 1 the cluster route on N blocks. Both take every P."""
    if cluster_size is None:
        if P < K2_CLUSTER_MIN_P:
            return 0, _cap(True, smem_max_p)
        N = wide_size()
    elif cluster_size == 0:
        return 0, _cap(True, smem_max_p)
    elif 1 <= cluster_size <= MAX_CLUSTER:
        N = cluster_size
    else:
        raise ValueError(f"cluster_size={cluster_size}: 0 or 1..{MAX_CLUSTER}")
    return N, _cap(True, smem_max_p, N)


def launch_route(B: int, P: int, pipelined: bool = False, smem_max_p: int | None = None,
                 cluster_size: int | None = None, row_ring: bool | None = None
                 ) -> tuple[int, int, bool]:
    """What solve_batch_cuda launches for B problems at width P: (N, cap,
    row_ring), N the blocks per cluster (0: one block a problem, K2's one
    block per SM), cap the widest P whose H stays in shared memory, and
    row_ring whether the cluster wavefront takes its ring of rows
    (``row_ring_for``; False off the cluster routes). By shape, the
    cluster size asked of the runtime for the problems that one launch
    holds: K1 launches a batch in groups of ``group_size`` (the group that
    clusters of WIDE_CLUSTER_SIZE would hold), K2 all of it at once.
    ``cluster_size`` and ``row_ring`` force; a forced value the kernels
    do not take raises ValueError."""
    if pipelined:
        N, cap = _k2_route(P, smem_max_p, cluster_size,
                           lambda: k2_cluster_size_for(B, P, smem_max_p))
    else:
        N, cap = _k1_route(P, smem_max_p, cluster_size, lambda: cluster_size_for(
            group_size(B, P, smem_max_p=smem_max_p, N=WIDE_CLUSTER_SIZE), P, smem_max_p))
    if not N:
        if row_ring is not None:
            raise ValueError(f"row_ring={row_ring}: only the cluster wavefront has a ring")
        return N, cap, False
    return N, cap, _row_ring(P, N, P <= cap, pipelined, row_ring)


def solve_batch_cuda(C, y, W, n_cand, read_support, lookup, scale, pipelined=False,
                     with_chains=False, smem_max_p=None, cluster_size=None, row_ring=None):
    """Same contract as ``ops.segdp._solve_batch_torch`` and
    ``freddie_tpu``'s ``solve_batch_pallas``: C (B, P, R) int32, y (B, P)
    int32, W (B, R) f32 integer-valued, n_cand (B,) int32, lookup (L+1,)
    int32. ``pipelined`` runs K2 instead of K1, as it runs
    ``_kernel_pipelined`` there. Both kernels are exact for every weight
    (K1 splits wide weights into limbs itself), so they take no
    ``wide_weights`` flag. ``with_chains`` appends the (B, P+2)
    -1-terminated breakpoint chains to the result: both kernels walk them
    themselves; the CPU route takes ``_walk_chains``. K1's wavefront runs
    by shape (``CLUSTER_MIN_P``; the cluster's size by
    ``cluster_size_for``), and so does K2 (``K2_CLUSTER_MIN_P``;
    ``k2_cluster_size_for``); ``launch_route`` says which.
    ``cluster_size`` forces a route (0: one block per problem, K2's one
    block per SM; N: clusters of N blocks, which is how the tests reach the
    cluster kernels at small P), ``row_ring`` the cluster wavefront's ring
    (default ``row_ring_for``: two whole planes a block where they fit,
    else rows; True forces the rows, which wrap inside a step at small P,
    False the planes where they fit).
    The wavefront keeps H in shared
    memory up to ``smem_max_p`` (default: the widest that fits,
    ``cluster_smem_max_p(N)`` for K1's clusters, ``K1_SMEM_MAX_P`` for its
    one block, ``K2_SMEM_MAX_P`` for K2's one block,
    ``k2_cluster_smem_max_p(N)`` for its clusters; a lower cap, 0
    included, puts H in device memory, K1's on the cluster route) and in
    device memory above. Raises ValueError when one problem's scratch
    (one cluster's, on K2's cluster route) cannot be allocated, or when a
    forced route, cap or ring is one the kernels do not take; a launch the
    runtime refuses raises RuntimeError."""
    global LAUNCHES, PIPELINED_LAUNCHES, CLUSTER_LAUNCHES, DEVICE_H_LAUNCHES
    global PIPELINED_DEVICE_H_LAUNCHES, PIPELINED_CLUSTER_LAUNCHES
    if C.device.type == "cpu":
        if cluster_size is not None:  # a forced route is refused here as on the card
            launch_route(C.shape[0], C.shape[1], pipelined, smem_max_p, cluster_size, row_ring)
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

    Cs, T_hi, T_lo, Wi, w_sum, w_max = kernel_inputs(C, y, W, lookup, scale)
    R = Wi.shape[1]  # padded
    K = torch.empty((B, P, P), dtype=torch.int32, device=dev)
    best_j = torch.empty((B,), dtype=torch.int32, device=dev)
    best_k = torch.empty((B,), dtype=torch.int32, device=dev)
    chains = torch.empty((B, P + 2), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):  # the runtime's answers the route asks for are this card's
        N, cap, row_ring = launch_route(B, P, pipelined, smem_max_p, cluster_size, row_ring)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pipelined and N:
            G, (OT, INS, H) = _scratch(pipelined_cluster_grid(B, P, N, cap, row_ring), P, True,
                                       cap, dev)
            err = lib.segdp_solve_pipelined_cluster(
                Cs.data_ptr(), T_hi.data_ptr(), T_lo.data_ptr(), Wi.data_ptr(),
                w_sum.data_ptr(), w_max.data_ptr(), y.data_ptr(), n_cand.data_ptr(),
                OT.data_ptr(), INS.data_ptr(), ptr(H), K.data_ptr(), best_j.data_ptr(),
                best_k.data_ptr(), chains.data_ptr(), B, P, R, int(read_support), G, N, cap,
                int(row_ring), stream,
            )
        elif pipelined:
            G, (OT, INS, H) = _scratch(pipelined_grid(B, P, cap), P, True, cap, dev)
            queue = torch.zeros(1, dtype=torch.int32, device=dev)  # the blocks' work counter
            err = lib.segdp_solve_pipelined(
                Cs.data_ptr(), T_hi.data_ptr(), T_lo.data_ptr(), Wi.data_ptr(),
                w_sum.data_ptr(), w_max.data_ptr(), y.data_ptr(), n_cand.data_ptr(),
                OT.data_ptr(), INS.data_ptr(), ptr(H), K.data_ptr(), best_j.data_ptr(),
                best_k.data_ptr(), chains.data_ptr(), queue.data_ptr(),
                B, P, R, int(read_support), G, cap, stream,
            )
        else:
            # Group by group on one set of scratch buffers; the stream
            # orders a group's launches after the previous group's.
            g, (OT, INS, H) = _scratch(_fit(B, _unit_bytes(P, False, P > cap)), P, False, cap,
                                       dev)
            err = 0
            for b0 in range(0, B, g):
                part = slice(b0, min(B, b0 + g))
                err = lib.segdp_solve(
                    Cs[part].data_ptr(), T_hi[part].data_ptr(), T_lo[part].data_ptr(),
                    Wi[part].data_ptr(), w_sum[part].data_ptr(), w_max[part].data_ptr(),
                    y[part].data_ptr(), n_cand[part].data_ptr(), OT.data_ptr(),
                    INS.data_ptr(), ptr(H), K[part].data_ptr(), best_j[part].data_ptr(),
                    best_k[part].data_ptr(), chains[part].data_ptr(),
                    part.stop - b0, P, R, int(read_support), cap, N, int(row_ring), stream,
                )
                if err:
                    break
    _raise_on(lib, err, f"segdp{'_pipelined' if pipelined else ''} kernel launch")
    if pipelined:
        PIPELINED_LAUNCHES += 1
        PIPELINED_CLUSTER_LAUNCHES += N > 0
        PIPELINED_DEVICE_H_LAUNCHES += P > cap
    else:
        LAUNCHES += 1
        CLUSTER_LAUNCHES += N > 0
        DEVICE_H_LAUNCHES += P > cap
        LAUNCH_SHAPES.append((B, P, C.shape[2]))
    return (K, best_j, best_k, chains) if with_chains else (K, best_j, best_k)
