"""Host-against-device crossover of the cluster solver's optimistic bound.

    python -m freddie_tpu_torch.tools.bound_device_experiment [--device cuda|cpu]
        [--grid N:K,N:K,...] [--dense N:Mi,...] [--reps 3] [--json PATH]

The cluster solver's only dense per-instance arithmetic is the optimistic
bound over candidate structures: for masks E and reads i,
bound(E) = g_total - sum_i max(g_i - popcount(C_i & E), 0) over the reads
with I_i a subset of E. ``solver.segenum`` evaluates it on the host
(``_PerStructure.optimistic_block``) or on ``--device``: over an explicit
mask list as two 0/1 (N, Mi) x (Mi, K) matrix products
(``optimistic_masks_device``; the closure rung takes it from N*K >=
``BOUNDS_DEVICE_MIN``), and over all 2^Mi masks (``optimistic_device``;
the wide rung). This tool times both engines over a grid of (N reads, K
masks) at Mi = 40 and of (N, Mi) for the dense form, requires equal
values, and names the winner at each point: what setting
``BOUNDS_DEVICE_MIN`` for a card needs. Times are on the host clock,
transfers and readback included, the fastest of ``--reps`` after one
warm-up call; the last line is JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

GRID = [(N, K) for N in (100, 250, 1000) for K in (1_000, 4_000, 20_000, 100_000, 500_000)]
DENSE = [(N, Mi) for N in (300, 1000) for Mi in (14, 16, 18)]
BLOCK = 1 << 12


def _fastest(fn, reps: int, sync):
    out = fn()  # warm-up
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append(time.perf_counter() - t0)
    return out, min(times) * 1e3


def host_bounds(ctx, masks) -> np.ndarray:
    out = np.empty(len(masks), dtype=np.float64)
    for lo in range(0, len(masks), BLOCK):
        out[lo : lo + BLOCK] = ctx.optimistic_block(masks[lo : lo + BLOCK])
    return out


def run(device, grid, dense, reps: int, log=print) -> dict:
    import torch

    from ..device import resolve_device
    from ..solver import segenum as se
    from ..utils.sim import clustered_instance

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    for N, K in grid:
        rng = np.random.default_rng(N * 1000003 + K)
        ctx = se._PerStructure(clustered_instance(rng, N, 40, k_true=2))
        masks = np.unique(rng.integers(0, 1 << 40, size=K, dtype=np.uint64))[:, None]
        want, host_ms = _fastest(lambda: host_bounds(ctx, masks), 1, lambda: None)
        got, dev_ms = _fastest(lambda: se.optimistic_masks_device(ctx, masks, dev), reps, sync)
        if not np.array_equal(got, want):
            raise RuntimeError(f"optimistic_masks_device != host at N={N} K={len(masks)}")
        rows.append(dict(form="masks", N=N, K=len(masks), Mi=40, work=N * len(masks),
                         host_ms=host_ms, device_ms=dev_ms,
                         winner="device" if dev_ms < host_ms else "host"))
        log(rows[-1])
    for N, Mi in dense:
        inst = clustered_instance(np.random.default_rng(N * 97 + Mi), N, Mi)
        masks = np.arange(1 << Mi, dtype=np.uint64)
        ctx = se._PerStructure(inst)
        want, host_ms = _fastest(lambda: host_bounds(ctx, masks), 1, lambda: None)
        got, dev_ms = _fastest(lambda: se.optimistic_device(inst, 1 << Mi, dev), reps, sync)
        if not np.array_equal(got, want):
            raise RuntimeError(f"optimistic_device != host at N={N} Mi={Mi}")
        rows.append(dict(form="dense", N=N, K=1 << Mi, Mi=Mi, work=N << Mi, host_ms=host_ms,
                         device_ms=dev_ms, winner="device" if dev_ms < host_ms else "host"))
        log(rows[-1])
    wins = sorted(r["work"] for r in rows if r["form"] == "masks" and r["winner"] == "device")
    loses = [r["work"] for r in rows if r["form"] == "masks" and r["winner"] == "host"]
    card = None
    if dev.type == "cuda":
        from ..bench.common import card_line

        card = card_line()
    return dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", card=card,
        bounds_device_min=se.BOUNDS_DEVICE_MIN,
        # the smallest N*K from which the device won at every larger grid point
        crossover_work=next((w for w in wins if all(w > x for x in loses)), None),
        grid=rows,
    )


def _pairs(spec: str) -> list[tuple[int, int]]:
    return [tuple(int(x) for x in item.split(":")) for item in spec.split(",") if item]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    ap.add_argument("--grid", type=_pairs, default=GRID, help="N:K points of the mask-list form")
    ap.add_argument("--dense", type=_pairs, default=DENSE, help="N:Mi points of the dense form")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", help="also write the summary here")
    args = ap.parse_args(argv)
    summary = run(args.device, args.grid, args.dense, args.reps,
                  log=lambda r: print(r, flush=True))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
