"""The loci mesh on PyTorch: one DP batch split over several cards.

Port of ``freddie_tpu/parallel/mesh.py``. JAX shards a batch over a 1-D
``loci`` mesh and lets jit place the pieces; here the batch is cut into
``len(devices)`` contiguous shards and each shard is sent to its device
on a CUDA stream of its own, so the shards' copies and launches overlap
across cards (and, where one card is listed more than once, across
streams on that card). Each shard runs the same steps as a one-device
launch: the coverage build when interval lists are given, then K1
(``solve_batch_cuda``), whose wavefront launch also walks the chains. A
CPU device runs the plain versions. Results are bit-identical to one launch over the whole batch:
the DP is independent per problem.

Which cards a call uses (``devices_for``): the bare ``"cuda"`` shards
over every visible card (``loci_devices``), as the JAX dispatch shards
over ``loci_mesh(local=True)``, once each card's share of the batch
reaches ``MESH_MIN_WORK``; otherwise, and by default, it stays on the
current card. ``"cuda:N"`` pins the call to card N, because in torch
every process sees every card of its host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..ops.coverage import build_coverage_device
from ..ops.segdp import _Launch, to_device
from ..ops.segdp_cuda import solve_batch_cuda


# Per-card DP work, B*P^3*R, from which the bare "cuda" splits a batch
# over several cards; None: never. ``python -m
# freddie_tpu_torch.parallel.bench`` measures the crossover: on four
# H100s the split dispatch lost to one card at every segment-stage shape,
# because the dispatch's host work (padding, casts, copies), which a split
# does not shrink, dwarfs K1 (PERF.md).
MESH_MIN_WORK: int | None = None

# Batches that launch_sharded split over more than one shard.
SHARDED_LAUNCHES = 0


def loci_devices() -> list[torch.device]:
    """The visible cards; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("loci_devices: torch.cuda.is_available() is False")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def devices_for(device, work: int) -> list[torch.device]:
    """The devices a batch of ``work`` (B*P^3*R, padded) sent to ``device``
    is split over: for the bare "cuda", every visible card when each
    card's share reaches MESH_MIN_WORK (never when it is None), else the
    current card; otherwise the one device named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = loci_devices()
        if (len(cards) > 1 and MESH_MIN_WORK is not None
                and work >= MESH_MIN_WORK * len(cards)):
            return cards
    return [resolve_device(dev)]


# The side stream of each (card, shard position), kept for the process:
# the caching allocator reuses a freed block only on the stream that
# allocated it, so a fresh stream per call would allocate every shard's
# inputs and scratch anew (and free the cache to find room).
_STREAMS: dict[tuple[int, int], torch.cuda.Stream] = {}


@contextlib.contextmanager
def _on(dev: torch.device, shard: int | None):
    """Run the block on ``dev``: for a card, under its device context and
    on the side stream of shard position ``shard`` (None: the card's
    current stream)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev):
        if shard is None:
            stream = torch.cuda.current_stream(dev)
        else:
            stream = _STREAMS.get((dev.index, shard))
            if stream is None:
                stream = _STREAMS[dev.index, shard] = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            yield


def launch_sharded(arrays: dict, read_support: int, lookup, scale: int, devices,
                   return_chains: bool = True) -> list[_Launch]:
    """Send the padded numpy batch ``arrays`` (``C`` or ``iv``, with ``y``,
    ``W``, ``n_cand``) to ``devices`` in contiguous shards WITHOUT waiting.

    Returns one ``_Launch`` of the (B, P+2) chains, or three of (K,
    best_j, best_k) when not ``return_chains``; ``np.asarray`` on each
    waits for every shard and concatenates them in batch order. B must be
    a multiple of ``len(devices)`` (callers pad). One device runs on its
    current stream, several each on a side stream of their own."""
    global SHARDED_LAUNCHES
    devices = [torch.device(d) for d in devices]
    B, R = arrays["W"].shape
    if not devices or B % len(devices):
        raise ValueError(f"batch of {B} does not split over {len(devices)} devices")
    per = B // len(devices)
    lookup = np.asarray(lookup, dtype=np.int32)
    outs = [_Launch() for _ in range(1 if return_chains else 3)]
    SHARDED_LAUNCHES += len(devices) > 1
    for i, dev in enumerate(devices):
        shard = {k: a[i * per : (i + 1) * per] for k, a in arrays.items()}
        with _on(dev, i if len(devices) > 1 else None):
            t = to_device(shard, dev)
            C = build_coverage_device(t["iv"], t["y"], R) if "iv" in t else t["C"]
            res = solve_batch_cuda(C, t["y"], t["W"], t["n_cand"], read_support,
                                   torch.from_numpy(lookup).to(dev), scale,
                                   with_chains=return_chains)
            if return_chains:
                res = res[3:]
            for out, r in zip(outs, res):
                out.add(r)
    return outs


def solve_batch_sharded(C, y, W, n_cand, read_support, lookup, scale, devices,
                        return_chains: bool = False):
    """The batched DP with the batch split over ``devices`` -- the contract
    of ``freddie_tpu``'s ``solve_batch_sharded`` on numpy inputs: C (B, P,
    R) int32 or int16, y (B, P), W (B, R), n_cand (B,), lookup (L+1,).
    Returns numpy (K, best_j, best_k), or the (B, P+2) chains when
    ``return_chains``."""
    arrays = dict(C=C, y=y, W=W, n_cand=n_cand)
    outs = launch_sharded(arrays, read_support, lookup, scale, devices, return_chains)
    res = tuple(np.asarray(o) for o in outs)
    return res[0] if return_chains else res
