"""The loci mesh's times on a host with several cards.

    python -m freddie_tpu_torch.parallel.bench [--json PATH]
    python -m freddie_tpu_torch.parallel.bench --weak-scaling DEVICES [--json PATH]

The first form needs two cards or more and uses every card it sees. It
measures:

1. at the kernel benchmark shape (B=2048, P=64, R=512), K1 alone on
   resident inputs -- the whole batch on card 0 against one shard per
   card -- and ``solve_batch_sharded`` from numpy (transfers and
   readback included) over every card against card 0;
2. the dispatch (``solve_batch_device``: padding, transfer, K1, chain
   walk, readback) over every card, with the work gate at zero, against
   ``cuda:0`` at the segment stage's (P, R) buckets and batch sizes; the
   two routes' results must be equal. From these it picks the gate: the
   smallest per-card work (B*P^3*R / cards) from which the sharded route
   won at that shape and at every swept shape with more;
3. the segment stage over the benchmark corpus with the bare "cuda" at
   the picked gate and at zero (every batch sharded) against ``cuda:0``;
   the TSVs must be byte-identical.

Every time is on the host clock, a median over repetitions that
alternate the routes in one process, after one warm-up call of each.
Prints one line per measurement, the cards' names and power limits, and
a JSON summary as the last line (also written to ``--json``).

``--weak-scaling`` takes the devices to shard over (``all``: every
visible card; or a comma-separated list such as ``cuda:0,cuda:1`` or
``cpu,cpu,cpu,cpu``) and reports the weak-scaling figure of the sharded
DP: B = 64 n problems at P=64, R=256 over the first n = 1, 2 and all of
the devices, reads/s per mesh size and ``segdp_scaling_efficiency`` =
rate(n) / (n rate(1)). Over distinct cards that is a scaling measurement;
over one device listed several times (a card's side streams, or CPU
shards run in turn) it checks the sharded dispatch and measures no
scaling, and the JSON says which (``distinct_devices``).
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..ops import segdp_cuda
from ..ops.segdp import DPProblem, ScaledThresholds, solve_batch_device, to_device
from . import mesh

KERNEL_SHAPE = (2048, 64, 512)
# The segment stage's (P, R) buckets and chunk sizes (its chunks hold at
# most 512 problems), and the kernel benchmark shape.
SWEEP = [(B, P, R) for P in (16, 32, 64) for R in (128, 512) for B in (64, 128, 256, 512)]
SWEEP.append(KERNEL_SHAPE)


def cards_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(out.stdout.strip().splitlines())


def alternate(fns: dict, reps: int) -> dict:
    """Median host-clock seconds of each callable, after one warm-up call
    of each, the callables alternating in every repetition."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[name].append(time.perf_counter() - t0)
    return {name: statistics.median(t) for name, t in times.items()}


def padded_batch(rng, B, P, R):
    """A padded DP batch: monotone coverage with plateaus and jumps,
    sorted positions, 3..P candidates, weights 1..4."""
    inc = rng.integers(0, 12, size=(B, P, R))
    inc[rng.random(size=(B, P, R)) < 0.5] = 0
    C = np.cumsum(inc, axis=1).astype(np.int32)
    y = np.sort(rng.integers(1, 20_000, size=(B, P)), axis=1).astype(np.int32)
    y[:, 0] = 0
    n_cand = rng.integers(3, P + 1, size=B).astype(np.int32)
    for b in range(B):
        C[b, n_cand[b]:] = C[b, n_cand[b] - 1]
        y[b, n_cand[b]:] = y[b, n_cand[b] - 1]
    W = rng.integers(1, 5, size=(B, R)).astype(np.float32)
    return dict(C=C, y=y, W=W, n_cand=n_cand)


def kernel_shape(cards, thr, reps: int) -> dict:
    """K1 on resident inputs and solve_batch_sharded, one card vs all."""
    B, P, R = KERNEL_SHAPE
    batch = padded_batch(np.random.default_rng(1), B, P, R)
    per = B // len(cards)
    parts = []
    for i, card in enumerate(cards):
        t = to_device({k: a[i * per : (i + 1) * per] for k, a in batch.items()}, card)
        parts.append((t["C"], t["y"], t["W"], t["n_cand"], 3,
                      torch.from_numpy(thr.lookup).to(card), thr.scale))
    t = to_device(batch, cards[0])
    whole = (t["C"], t["y"], t["W"], t["n_cand"], 3,
             torch.from_numpy(thr.lookup).to(cards[0]), thr.scale)

    def k1_one():
        out = segdp_cuda.solve_batch_cuda(*whole)
        torch.cuda.synchronize(cards[0])
        return out

    def k1_all():
        outs = [segdp_cuda.solve_batch_cuda(*p) for p in parts]
        for card in cards:
            torch.cuda.synchronize(card)
        return outs

    want, got = k1_one(), k1_all()
    for i, g in enumerate(got):
        for a, b in zip(g, want):
            if not torch.equal(a.cpu(), b[i * per : (i + 1) * per].cpu()):
                raise RuntimeError("K1 shards differ from one K1 launch")
    np_args = (batch["C"], batch["y"], batch["W"], batch["n_cand"], 3, thr.lookup, thr.scale)
    one = mesh.solve_batch_sharded(*np_args, cards[:1])
    sharded = mesh.solve_batch_sharded(*np_args, cards)
    if not all(np.array_equal(a, b) for a, b in zip(one, sharded)):
        raise RuntimeError("solve_batch_sharded over the cards differs from one card")
    t = alternate({"k1_one_card_ms": k1_one, "k1_all_cards_ms": k1_all,
                   "sharded_one_card_ms": lambda: mesh.solve_batch_sharded(*np_args, cards[:1]),
                   "sharded_all_cards_ms": lambda: mesh.solve_batch_sharded(*np_args, cards)},
                  reps)
    return {k: v * 1e3 for k, v in t.items()}


def problems_at(rng, B, P, R) -> list[DPProblem]:
    out = []
    for _ in range(B):
        inc = rng.integers(0, 6, size=(P, R))
        inc[rng.random(size=(P, R)) < 0.5] = 0
        y = np.sort(rng.choice(np.arange(1, 20_000), size=P, replace=False)).astype(np.int64)
        y[0] = 0
        out.append(DPProblem(C=np.cumsum(inc, axis=0).astype(np.int64), y=y,
                             W=rng.integers(1, 5, size=R).astype(np.int64), read_support=3))
    return out


def sweep(cards, thr, reps: int, log) -> list[dict]:
    """The dispatch over every card (gate at zero) against cuda:0."""
    rng = np.random.default_rng(2)
    rows = []
    saved = mesh.MESH_MIN_WORK
    try:
        mesh.MESH_MIN_WORK = 0
        for B, P, R in SWEEP:
            probs = problems_at(rng, B, P, R)

            def run(device, probs=probs, P=P, R=R):
                return solve_batch_device(probs, thr, pad_p_to=P, pad_r_to=R, device=device)

            if run("cuda") != run("cuda:0"):
                raise RuntimeError(f"the dispatch over the cards differs at B,P,R={B},{P},{R}")
            t = alternate({"one": lambda: run("cuda:0"), "all": lambda: run("cuda")}, reps)
            row = dict(B=B, P=P, R=R, work_per_card=B * P**3 * R // len(cards),
                       one_card_ms=t["one"] * 1e3, all_cards_ms=t["all"] * 1e3)
            rows.append(row)
            log(f"[sweep] B,P,R={B},{P},{R} work/card {row['work_per_card']:.3e}: cuda:0 "
                f"{row['one_card_ms']:.3f} ms, {len(cards)} cards {row['all_cards_ms']:.3f} ms")
    finally:
        mesh.MESH_MIN_WORK = saved
    return rows


def pick_gate(rows: list[dict]) -> int | None:
    """The smallest per-card work from which the sharded route won at
    every swept shape with as much work or more; None when it never did
    at the largest."""
    gate = None
    for row in sorted(rows, key=lambda r: -r["work_per_card"]):
        if row["all_cards_ms"] >= row["one_card_ms"]:
            break
        gate = row["work_per_card"]
    return gate


def tsv_names(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _dirs, fns in os.walk(root) for f in fns if f.endswith(".tsv"))


def segment_stage(gate: int | None, reps: int, workdir: str, log) -> dict:
    """The segment stage on the benchmark corpus: bare "cuda" at ``gate``
    and at zero against cuda:0; K1 launches per run and hot seconds."""
    import shutil

    from ..config import SegmentConfig, SplitConfig
    from ..stages.segment import run_segment
    from ..stages.split import run_split
    from ..utils.sim import BENCH_CORPUS, simulate

    sim = simulate(**BENCH_CORPUS)
    bam, fq = os.path.join(workdir, "reads.bam"), os.path.join(workdir, "reads.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split = os.path.join(workdir, "split")
    run_split(bam, [fq], split, SplitConfig())
    routes = {"cuda:0": ("cuda:0", mesh.MESH_MIN_WORK),
              "cuda, picked gate": ("cuda", gate),
              "cuda, gate 0": ("cuda", 0)}
    launches, firsts = {}, {}
    saved = mesh.MESH_MIN_WORK

    def run(name):
        device, mesh.MESH_MIN_WORK = routes[name]
        out = tempfile.mkdtemp(dir=workdir)
        before = segdp_cuda.LAUNCHES
        try:
            run_segment(split, out, SegmentConfig(), device=device)
            torch.cuda.synchronize()
        finally:
            mesh.MESH_MIN_WORK = saved
        launches[name] = segdp_cuda.LAUNCHES - before
        if name in firsts:
            shutil.rmtree(out)
        else:
            firsts[name] = out

    t = alternate({name: (lambda name=name: run(name)) for name in routes}, reps)
    ref = firsts["cuda:0"]
    for name, out in firsts.items():
        names = tsv_names(out)
        if not names or names != tsv_names(ref) or not all(
                filecmp.cmp(os.path.join(out, n), os.path.join(ref, n), shallow=False)
                for n in names):
            raise RuntimeError(f"segment TSVs of {name} differ from cuda:0's")
    res = {name: dict(hot_s=t[name], k1_launches=launches[name]) for name in routes}
    for name, r in res.items():
        log(f"[segment] {name}: hot {r['hot_s']:.3f} s (median of {reps}), "
            f"{r['k1_launches']} K1 launches per run, TSVs byte-identical to cuda:0's")
    return res


def weak_scaling(devices, reps: int = 3, per_device: int = 64, P: int = 64,
                 R: int = 256) -> dict:
    """Weak scaling of ``solve_batch_sharded``: per_device * n problems over
    the first n of ``devices`` for n = 1, 2 and all of them; reads/s
    (B * R over the fastest of ``reps`` host-clock calls, transfers and
    readback included, after one warm-up call) and the efficiency at the
    largest mesh. The results at every n are held equal, problem by
    problem, to the one-device solve of the same rows."""
    devices = [torch.device(d) for d in devices]
    thr = ScaledThresholds(0.9)
    full = padded_batch(np.random.default_rng(0), per_device * len(devices), P, R)
    full["W"][:] = 1.0
    full["n_cand"][:] = P
    sizes = sorted({1, 2, len(devices)} & set(range(1, len(devices) + 1)))
    rates, first = {}, None
    for n in sizes:
        B = per_device * n
        args = (full["C"][:B], full["y"][:B], full["W"][:B], full["n_cand"][:B], 3,
                thr.lookup, thr.scale)
        got = mesh.solve_batch_sharded(*args, devices[:n])  # warm-up, and the check
        if first is None:
            first = got
        elif not all(np.array_equal(g[:per_device], f) for g, f in zip(got, first)):
            raise RuntimeError(f"the sharded solve over {n} devices differs from one device's")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            mesh.solve_batch_sharded(*args, devices[:n])
            times.append(time.perf_counter() - t0)
        rates[n] = B * R / min(times)
    head = sizes[-1]
    on_cards = devices[0].type == "cuda"
    return dict(
        metric="segdp_scaling_efficiency",
        value=rates[head] / (head * rates[sizes[0]] / sizes[0]),
        unit="fraction",
        at_mesh=head,
        per_mesh={str(n): r for n, r in rates.items()},
        shape=dict(per_device=per_device, P=P, R=R),
        devices=[str(d) for d in devices],
        distinct_devices=len({str(d) for d in devices}) == len(devices),
        cards=cards_line() if on_cards else None,
    )


def _weak_scaling_main(spec: str, reps: int, json_path: str | None, log) -> int:
    devices = mesh.loci_devices() if spec == "all" else [torch.device(d) for d in spec.split(",")]
    summary = weak_scaling(devices, reps)
    what = ("a scaling measurement" if summary["distinct_devices"] else
            "one device listed several times: a check of the sharded dispatch, not a "
            "scaling measurement")
    log(f"[weak-scaling] reads/s per mesh size {summary['per_mesh']}, efficiency "
        f"{summary['value']:.3f} at {summary['at_mesh']} over {summary['devices']} ({what})")
    _write_json(summary, json_path)
    log(json.dumps(summary))
    return 0


def _write_json(summary: dict, path: str | None) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(summary, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the summary here")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--weak-scaling", metavar="DEVICES",
                    help="only the weak-scaling figure, over 'all' cards or a "
                         "comma-separated device list")
    args = ap.parse_args(argv)

    def log(*a):
        print(*a, flush=True)

    if args.weak_scaling:
        return _weak_scaling_main(args.weak_scaling, args.reps, args.json, log)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("needs two CUDA devices or more", file=sys.stderr)
        return 2
    cards = mesh.loci_devices()
    card = cards_line()
    log(card)
    thr = ScaledThresholds(0.9)
    kern = kernel_shape(cards, thr, args.reps)
    log(f"[kernel] B,P,R={KERNEL_SHAPE}: K1 on resident inputs {kern['k1_one_card_ms']:.3f} ms "
        f"on cuda:0, {kern['k1_all_cards_ms']:.3f} ms over {len(cards)} cards; "
        f"solve_batch_sharded {kern['sharded_one_card_ms']:.3f} ms on cuda:0, "
        f"{kern['sharded_all_cards_ms']:.3f} ms over {len(cards)} cards")
    rows = sweep(cards, thr, args.reps, log)
    gate = pick_gate(rows)
    log(f"[gate] the sharded dispatch won at every swept per-card work from {gate} "
        f"up (None: not at the largest); MESH_MIN_WORK is {mesh.MESH_MIN_WORK}")
    with tempfile.TemporaryDirectory() as workdir:
        seg = segment_stage(gate, 3, workdir, log)
    summary = dict(cards=card, count=len(cards), kernel_shape_ms=kern, sweep=rows,
                   picked_gate=gate, mesh_min_work=mesh.MESH_MIN_WORK, segment=seg)
    _write_json(summary, args.json)
    log(card)
    log(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
