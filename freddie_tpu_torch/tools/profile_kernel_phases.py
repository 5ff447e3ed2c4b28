"""Phase profile of the DP kernels on a card.

    python -m freddie_tpu_torch.tools.profile_kernel_phases [--shape B,P,R] [--device cuda:N]

At the shape given (default: the kernel benchmark's 2048,64,512), from
``torch.profiler`` and CUDA events:

- K1 by phase: its pair-statistics launch, its wavefront launch (which
  also walks the chains; on thread-block clusters from
  ``segdp_cuda.CLUSTER_MIN_P``, ``wavefront_cluster_kernel``), and what
  is left of the whole ``solve_batch_cuda`` call, the wrapper's torch
  prologue;
- K2 on the route it takes by shape: its one launch's device time
  beside the whole call and what the runtime reports for it -- on the
  one-block route (below ``segdp_cuda.K2_CLUSTER_MIN_P``; above
  K2_SMEM_MAX_P its H is in device memory) blocks per SM, registers,
  shared memory and grid, on the cluster route
  (``segdp_pipelined_cluster_kernel``) the blocks a cluster, resident
  clusters, registers, shared memory and the clusters it runs on; from
  K2_CLUSTER_MIN_P on also the one-block route's launch and occupancy at
  the same shape, forced, beside it; and its tail: the whole call at
  B = G, 2G, 8G and B problems (G its grid) beside K1 and a step
  model.

The kernels run only on a card: ``--device cpu`` is refused.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..bench.common import KERNEL_SHAPE, TIMED_REPS, card_line, synthetic_batch, time_ms
from ..device import resolve_device
from ..ops import segdp_cuda
from ..ops.segdp import ScaledThresholds, to_device

KERNELS = ("pair_stats_kernel", "wavefront_kernel", "wavefront_cluster_kernel",
           "segdp_pipelined_kernel", "segdp_pipelined_cluster_kernel")


def _device_us(evt) -> float:
    """A profiler event's total device time in microseconds (the
    attribute's name differs between PyTorch versions)."""
    total = getattr(evt, "device_time_total", None)
    return total if total is not None else getattr(evt, "cuda_time_total", 0.0)


def batch_args(dev, shape, seed=7):
    """solve_batch_cuda's arguments for a synthetic batch of ``shape`` on ``dev``."""
    thr = ScaledThresholds(0.9)
    t = to_device(synthetic_batch(np.random.default_rng(seed), *shape, False), dev)
    return (t["C"], t["y"], t["W"], t["n_cand"], 3,
            torch.from_numpy(thr.lookup).to(dev), thr.scale)


def device_ms_by_kernel(calls, reps: int = 3) -> dict[str, float]:
    """Runs every callable of ``calls`` ``reps`` times under torch.profiler;
    each kernel's device ms per repetition, by the names in KERNELS (a
    kernel the profiler did not see is absent)."""
    from torch.profiler import ProfilerActivity, profile

    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for call in calls:
                call()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        for name in KERNELS:
            if name in evt.key:
                out[name] = out.get(name, 0.0) + _device_us(evt) / 1000.0 / reps
    return out


def k2_grid(B: int, P: int) -> tuple[int, int]:
    """K2's route by shape for B problems of width P on this card: (N,
    G), N its blocks a cluster (0: the one-block route) and G its grid in
    blocks or clusters."""
    N, cap = segdp_cuda._k2_route(P, None, None, lambda: segdp_cuda.k2_cluster_size_for(B, P))
    if N:
        return N, segdp_cuda.pipelined_cluster_grid(B, P, N, cap)
    return 0, segdp_cuda.pipelined_grid(B, P)


def k2_tail(dev, P: int, R: int, B_full: int, lookup, scale) -> dict:
    """K2's whole call at B = G, 2G, 8G and B_full problems of width P (G
    its grid on this card, in blocks or clusters) beside K1 and beside a
    step model: a block (cluster) takes about ceil(B/G) problems in turn,
    so T(B) = T(G) + (ceil(B/G) - 1) * p with the step p read off T(8G).
    What a measured time has above the model is the tail: blocks that
    wait for the last one. Returns G, the step and one row per B (medians
    of TIMED_REPS, ms)."""
    G = k2_grid(65535, P)[1]
    sizes = (G, 2 * G, 8 * G, B_full)
    k1_ms, k2_ms = {}, {}
    for B in sizes:
        t = to_device(synthetic_batch(np.random.default_rng(B), B, P, R, False), dev)
        args = (t["C"], t["y"], t["W"], t["n_cand"], 3, lookup, scale)
        k1_ms[B] = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args))
        k2_ms[B] = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True))
        del t, args
        torch.cuda.empty_cache()
    step = (k2_ms[8 * G] - k2_ms[G]) / 7
    rows = [dict(B=B, steps=-(-B // G), k2_ms=k2_ms[B],
                 model_ms=k2_ms[G] + (-(-B // G) - 1) * step, k1_ms=k1_ms[B]) for B in sizes]
    return dict(G=G, step_ms=step, rows=rows)


def profile_shape(dev, shape, log=print) -> dict:
    """Everything the module's docstring lists at ``shape``; also logged."""
    B, P, R = shape
    card = card_line()
    args = batch_args(dev, shape)
    k1_call = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args))
    k1 = device_ms_by_kernel([lambda: segdp_cuda.solve_batch_cuda(*args)])
    # The wavefront launch is wavefront_cluster_kernel from CLUSTER_MIN_P on.
    pair = k1.get("pair_stats_kernel")
    wave = k1.get("wavefront_kernel", k1.get("wavefront_cluster_kernel"))
    out = dict(shape=list(shape), card=card, k1_call_ms=k1_call, k1_pair_stats_ms=pair,
               k1_wavefront_ms=wave,
               k1_prologue_ms=None if pair is None or wave is None else k1_call - pair - wave)
    log(f"[phases] K1 at B,P,R={shape}: whole call {k1_call:.3f} ms (median of {TIMED_REPS}); "
        f"pair_stats {pair} ms + wavefront with the chain walk {wave} ms on the device "
        f"(profiler, mean of 3; None: not measured); the wrapper's prologue is the rest, "
        f"{out['k1_prologue_ms']} ms; on {card}")
    k2_call = time_ms(lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True))
    k2 = device_ms_by_kernel([lambda: segdp_cuda.solve_batch_cuda(*args, pipelined=True)])
    N, G = k2_grid(B, P)
    out.update(k2_call_ms=k2_call, k2_cluster_size=N, k2_grid=G,
               k2_launch_ms=k2.get("segdp_pipelined_cluster_kernel" if N
                                   else "segdp_pipelined_kernel"),
               k2_occupancy=(segdp_cuda.k2_cluster_occupancy(P, N) if N
                             else segdp_cuda.pipelined_occupancy(P)))
    route = f"cluster route, {G} clusters of {N} blocks" if N else f"one-block route, grid {G}"
    log(f"[phases] K2 at B,P,R={shape} ({route}): whole call {k2_call:.3f} ms, its launch "
        f"{out['k2_launch_ms']} ms on the device; the runtime reports "
        f"{json.dumps(out['k2_occupancy'])}; on {card}")
    if P >= segdp_cuda.K2_CLUSTER_MIN_P:
        def one():
            return segdp_cuda.solve_batch_cuda(*args, pipelined=True, cluster_size=0)

        out.update(k2_one_block_call_ms=time_ms(one),
                   k2_one_block_launch_ms=device_ms_by_kernel([one]).get("segdp_pipelined_kernel"),
                   k2_one_block_occupancy=segdp_cuda.pipelined_occupancy(P))
        log(f"[phases] K2's one-block route at B,P,R={shape} (forced): whole call "
            f"{out['k2_one_block_call_ms']:.3f} ms, its launch {out['k2_one_block_launch_ms']} "
            f"ms on the device; the runtime reports "
            f"{json.dumps(out['k2_one_block_occupancy'])}, grid "
            f"{segdp_cuda.pipelined_grid(B, P)}; on {card}")
    out["k2_tail"] = tail = k2_tail(dev, P, R, B, args[5], args[6])
    for r in tail["rows"]:
        log(f"[phases] K2 tail, B={r['B']} (G={tail['G']}, {r['steps']} steps) P={P} R={R}: "
            f"{r['k2_ms']:.3f} ms, step model {r['model_ms']:.3f} ms (step "
            f"{tail['step_ms']:.3f} ms); K1 {r['k1_ms']:.3f} ms (medians of {TIMED_REPS}), "
            f"on {card}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default=",".join(map(str, KERNEL_SHAPE)), help="B,P,R")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cuda:N")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        ap.error("the kernels run only on a card: give --device cuda or cuda:N")
    shape = tuple(int(x) for x in args.shape.split(","))
    if len(shape) != 3:
        ap.error("--shape takes B,P,R")
    with torch.cuda.device(dev):
        out = profile_shape(dev, shape, lambda *a: print(*a, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
