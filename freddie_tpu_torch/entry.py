"""Entry points of the port for a harness: one forward step on the DP kernel,
and a dry run of every multi-device path.

The compute core of the pipeline is the batched segmentation DP
(``ops.segdp``). ``entry(device)`` returns that solver with a
representative padded batch on ``device``; ``dryrun_multichip(n, device)``
runs the same kernel split over n shards of a loci mesh, then the
production dispatch, the stage's bucketed dispatch and the batched polyA
scan, each against its host oracle.

    python -m freddie_tpu_torch.entry [--device cuda|cpu] [--shards N]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .config import SegmentConfig
from .device import resolve_device
from .ops import segdp_cuda
from .ops.polya import annotate_gaps_and_polya
from .ops.polya_batch import annotate_gaps_and_polya_batch
from .ops.segdp import (
    DPProblem, ScaledThresholds, solve_batch_device, solve_host, to_device)
from .parallel import mesh
from .stages.segment import solve_problems


def _example_batch(B=8, P=16, R=128, seed=0):
    rng = np.random.default_rng(seed)
    thr = ScaledThresholds(0.9)
    inc = rng.integers(0, 12, size=(B, P, R))
    inc[rng.random(size=(B, P, R)) < 0.5] = 0
    C = np.cumsum(inc, axis=1).astype(np.int32)
    y = np.sort(rng.integers(1, 2000, size=(B, P)).astype(np.int32), axis=1)
    y[:, 0] = 0
    W = np.ones((B, R), dtype=np.float32)
    n_cand = np.full((B,), P, dtype=np.int32)
    return C, y, W, n_cand, thr


def entry(device="cuda"):
    """(forward, example_args): one forward step of the batched DP on
    tensors that lie on ``device``. On a card ``forward`` launches K1
    (``solve_batch_cuda``); its plain version runs only for
    ``device="cpu"``."""
    dev = resolve_device(device)
    C, y, W, n_cand, thr = _example_batch()
    t = to_device(dict(C=C, y=y, W=W, n_cand=n_cand), dev)
    lookup = torch.from_numpy(thr.lookup).to(dev)

    def forward(C, y, W, n_cand, lookup):
        return segdp_cuda.solve_batch_cuda(C, y, W, n_cand, 3, lookup, thr.scale)

    return forward, (t["C"], t["y"], t["W"], t["n_cand"], lookup)


def _problems(C, y, W):
    return [DPProblem(C=C[i].astype(np.int64), y=y[i].astype(np.int64),
                      W=W[i].astype(np.int64), read_support=3) for i in range(len(C))]


def _chain(K, best_j, best_k, b):
    j, k = int(best_j[b]), int(best_k[b])
    if j < 0:
        return []
    out = [j, k]
    while K[b, j, k] >= 0:
        k_ = int(K[b, j, k])
        out.append(k_)
        j, k = k, k_
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run every multi-device path once over ``n_devices`` shards on tiny
    shapes and hold each against its host oracle; raises on a mismatch.

    The shards: for the bare "cuda", the first ``n_devices`` visible cards
    when there are that many; otherwise ``device`` listed ``n_devices``
    times (one card, "cuda:N": a side stream per shard; the CPU: the plain
    versions in turn). Returns the K1 launches made and the number of
    problems checked per path."""
    dev = resolve_device(device)
    if torch.device(device).index is None and dev.type == "cuda" \
            and torch.cuda.device_count() >= n_devices > 1:
        devices = mesh.loci_devices()[:n_devices]
    else:
        devices = [dev] * n_devices
    on_card = devices[0].type == "cuda"
    launches = segdp_cuda.LAUNCHES
    checked = {}

    # The sharded solve, its chains walked on the host, against the oracle.
    B = n_devices * 2
    C, y, W, n_cand, thr = _example_batch(B=B, P=8, R=32)
    K, best_j, best_k = mesh.solve_batch_sharded(
        C, y, W, n_cand, 3, thr.lookup, thr.scale, devices)
    if K.shape != (B, 8, 8):
        raise RuntimeError(f"sharded K has shape {K.shape}")
    want = [solve_host(p, thr) for p in _problems(C, y, W)]
    got = [_chain(K, best_j, best_k, b) for b in range(B)]
    if got != want:
        raise RuntimeError(f"solve_batch_sharded over {n_devices} shards != solve_host")
    checked["sharded"] = B

    # The production dispatch split over the shards at B = n + 1 (so the
    # batch is padded to a multiple of them), the stage's bucketed dispatch
    # over its (P, R) buckets, and a check that they took the mesh.
    Cb, yb, Wb, _n, thr2 = _example_batch(B=n_devices + 1, P=8, R=32, seed=1)
    problems = _problems(Cb, yb, Wb)
    rng = np.random.default_rng(7)
    prod = []
    for P_, R_ in ((64, 512), (32, 512), (16, 128)):
        for _ in range(n_devices + 1):
            inc = rng.integers(0, 6, size=(P_, R_))
            inc[rng.random(size=(P_, R_)) < 0.5] = 0
            yp = np.sort(rng.integers(1, 20_000, size=P_).astype(np.int64))
            yp[0] = 0
            prod.append(DPProblem(C=np.cumsum(inc, axis=0).astype(np.int64), y=yp,
                                  W=rng.integers(1, 5, size=R_).astype(np.int64),
                                  read_support=3))
    sharded = mesh.SHARDED_LAUNCHES
    got_batch = solve_batch_device(problems, thr2, devices=devices)
    got_prod = solve_problems(prod, SegmentConfig(), thr2, devices=devices)
    sharded = mesh.SHARDED_LAUNCHES - sharded
    if n_devices > 1 and sharded < 4:  # the B = n + 1 batch and three buckets
        raise RuntimeError(f"the production dispatch did not use the loci mesh: "
                           f"{sharded} sharded launches")
    if got_batch != [solve_host(p, thr2) for p in problems]:
        raise RuntimeError("the production dispatch over the mesh != solve_host")
    if got_prod != [solve_host(p, thr2) for p in prod]:
        raise RuntimeError("production-shape sharded dispatch mismatch")
    checked["dispatch"] = len(problems)
    checked["buckets"] = len(prod)

    # The batched polyA scan forced onto the device, against the per-read
    # host scorer.
    bases = np.array(list("ACGT"))
    items = []
    for _ in range(64):
        L = int(rng.integers(150, 400))  # room for the 80M alignment
        seq = "".join(rng.choice(bases, size=L, p=[0.4, 0.1, 0.1, 0.4]))
        items.append(([1, 1], [(0, 40), (40, 80)], [(0, 80, 30, 110, [(0, 80)])], seq, "+"))
    saved = os.environ.get("FREDDIE_POLYA_DEVICE")
    os.environ["FREDDIE_POLYA_DEVICE"] = "1"
    try:
        got_tok = annotate_gaps_and_polya_batch(items, device=devices[0])
    finally:
        if saved is None:
            os.environ.pop("FREDDIE_POLYA_DEVICE", None)
        else:
            os.environ["FREDDIE_POLYA_DEVICE"] = saved
    if got_tok != [annotate_gaps_and_polya(*it) for it in items]:
        raise RuntimeError("batched polyA mismatch on the mesh's device")
    checked["polya"] = len(items)

    made = segdp_cuda.LAUNCHES - launches
    if on_card and made <= 0:
        raise RuntimeError("the dry run on a card launched no kernel")
    return dict(shards=n_devices, devices=[str(d) for d in devices], k1_launches=made,
                sharded_dispatches=sharded, checked=checked)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    forward, example = entry(args.device)
    K, best_j, _best_k = forward(*example)
    print(f"entry: forward on {K.device}: K {tuple(K.shape)}, "
          f"{int((best_j >= 0).sum())}/{len(best_j)} segmented", flush=True)
    print(f"dryrun_multichip: {dryrun_multichip(args.shards, args.device)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
