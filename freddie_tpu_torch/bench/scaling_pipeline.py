"""Pipeline-level scaling: the locus-sharded stages (segment, cluster,
isoforms with the collective GTF merge) on 1, 2 and 4 processes of a
gloo group, each pinned to its own cores.

    python -m freddie_tpu_torch.bench.scaling_pipeline [--device cuda|cpu]
        [--small] [--hosts 1,2,4] [--points half,curve] [--reps 2]
        [--timeout SECONDS] [--json PATH]

The multi-process program of ``parallel.dist`` measured end to end, strong
scaling: the same corpus, split once and untimed, one "host" = one
process on a fixed set of cores (``os.sched_setaffinity``) and, with
``--device cuda``, on card ``rank % count``. Efficiency_n = T1 / (n Tn)
with the same cores per host at every point, so the loss is sharding
skew, dispatch and the collectives. Two measurements (``--points``):

- ``half``: 1 against 2 hosts of half the machine's cores each, the
  headline ``pipeline_scaling_efficiency``;
- ``curve``: 1 core per host for every n of ``--hosts`` that the machine
  has cores for.

Each worker runs the sharded stages twice: the first pass, which pays the
per-process costs (kernel build or load, native libraries), is reported
as cold; the second, after a barrier, as hot. Each point is the best of
``--reps`` runs; a run's time is its slowest rank's. Every process has a
finite timeout and is killed when one outlasts it. Prints one JSON line
(also written to ``--json``); with cards it names them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker(args) -> int:
    """One rank: pin, join the group, run the sharded stages twice."""
    os.sched_setaffinity(0, {int(c) for c in args.cores.split(",")})
    from ..config import PipelineConfig
    from ..parallel import dist
    from ..stages.cluster import run_cluster
    from ..stages.segment import run_segment

    rank, world = args.rank, args.world
    if world > 1:
        dist.initialize(f"127.0.0.1:{args.port}", world, rank, timeout=args.timeout)
    dev = dist.rank_device(args.device, rank)
    threads = len(args.cores.split(","))
    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        segment=dataclasses.replace(cfg.segment, threads=threads),
        cluster=dataclasses.replace(cfg.cluster, threads=threads),
        isoforms=dataclasses.replace(cfg.isoforms, threads=threads),
    )
    split_dir = os.path.join(args.corpus, "split")

    def owns(contig, tint_id):
        return dist.owns_tint(contig, tint_id, rank, world)

    def full(out):
        run_segment(split_dir, os.path.join(out, "segment"), cfg.segment, owns=owns,
                    device=dev)
        run_cluster(os.path.join(out, "segment"), os.path.join(out, "cluster"),
                    cfg.cluster, owns=owns, device=dev)
        merged = dist.run_isoforms_distributed(
            split_dir, os.path.join(out, "cluster"), os.path.join(out, "isoforms.gtf"),
            cfg.isoforms, process_index=rank, process_count=world)
        if dev.startswith("cuda"):
            import torch

            torch.cuda.synchronize()
        return len(merged)

    # The first pass goes to a directory of the rank's own: it only warms.
    t0 = time.perf_counter()
    full(f"{args.out}_warm{rank}")
    cold = time.perf_counter() - t0
    if world > 1:
        dist.dist.barrier()
    t0 = time.perf_counter()
    records = full(args.out)
    hot = time.perf_counter() - t0
    if world > 1:
        dist.dist.destroy_process_group()
    print("RESULT " + json.dumps(dict(rank=rank, hot=hot, cold=cold, records=records,
                                      device=dev)), flush=True)
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(n: int, corpus: str, out: str, core_sets: list[list[int]], device: str,
                timeout: float) -> dict:
    """Runs n ranks at once, rank r on ``core_sets[r]``; the slowest rank's
    hot and cold seconds and the merged record count. Kills every rank if
    one outlasts ``timeout``; a failed rank raises."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "freddie_tpu_torch.bench.scaling_pipeline", "--worker",
             "--rank", str(r), "--world", str(n), "--port", str(port), "--corpus", corpus,
             "--out", out, "--cores", ",".join(map(str, core_sets[r])), "--device", device,
             "--timeout", str(timeout)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)
    ]
    deadline = time.monotonic() + timeout
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for p, (stdout, stderr) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"rank exited {p.returncode}:\n{stdout[-1000:]}\n{stderr[-3000:]}")
        res += [json.loads(ln[len("RESULT "):]) for ln in stdout.splitlines()
                if ln.startswith("RESULT ")]
    if len(res) != n or len({r["records"] for r in res}) != 1:
        raise RuntimeError(f"{n} ranks reported {res}")
    return dict(hot=max(r["hot"] for r in res), cold=max(r["cold"] for r in res),
                records=res[0]["records"], devices=[r["device"] for r in res])


def measure(device: str, small: bool, hosts: list[int], points: list[str], reps: int,
            timeout: float, log=print) -> dict:
    from ..config import SplitConfig
    from ..stages.split import run_split
    from ..utils.sim import BENCH_CORPUS
    from .common import SMALL_CORPUS, build_dataset, card_line

    cores = sorted(os.sched_getaffinity(0))
    workdir = tempfile.mkdtemp(prefix="freddie_torch_scale_")
    try:
        corpus = os.path.join(workdir, "corpus")
        os.makedirs(corpus)
        bam, fq, n_reads, _truth, _reach = build_dataset(
            corpus, SMALL_CORPUS if small else BENCH_CORPUS)
        run_split(bam, [fq], os.path.join(corpus, "split"), SplitConfig(threads=len(cores)))
        runs = [0]

        def best(n, per):
            sets = [cores[r * per:(r + 1) * per] for r in range(n)]
            got = []
            for _ in range(reps):
                runs[0] += 1
                got.append(run_workers(n, corpus, os.path.join(workdir, f"run{runs[0]}"),
                                       sets, device, timeout))
            log(f"[pipe-scaling] {n} host(s) x {per} core(s): hot "
                f"{min(g['hot'] for g in got):.3f} s, cold {min(g['cold'] for g in got):.3f} s, "
                f"{got[0]['records']} records, on {got[0]['devices']}")
            return min(g["hot"] for g in got), min(g["cold"] for g in got)

        result = dict(metric="pipeline_scaling_efficiency", value=None, unit="fraction",
                      reads=n_reads, small=small, device=device, backend="torch",
                      cores=len(cores), card=card_line() if device != "cpu" else None)
        if "half" in points and len(cores) >= 2:
            per = len(cores) // 2
            t1, t1c = best(1, per)
            t2, t2c = best(2, per)
            result.update(value=t1 / (2 * t2), hosts=2, cores_per_host=per, t1_s=t1, t2_s=t2,
                          cold=dict(t1_s=t1c, t2_s=t2c, efficiency=t1c / (2 * t2c)))
        if "curve" in points:
            ns = [n for n in hosts if n <= len(cores)]
            hot, cold = zip(*(best(n, 1) for n in ns))
            result["curve"] = dict(cores_per_host=1, hosts=ns, hot_s=list(hot),
                                   cold_s=list(cold),
                                   efficiency=[hot[0] * ns[0] / (n * h) for n, h in zip(ns, hot)])
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (rank r on card r %% count) or cpu")
    ap.add_argument("--small", action="store_true", help="the 6-gene corpus")
    ap.add_argument("--hosts", default="1,2,4", help="process counts of the 1-core curve")
    ap.add_argument("--points", default="half,curve")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a run's processes may take")
    ap.add_argument("--json", help="also write the result line here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    for name in ("--rank", "--world", "--port"):
        ap.add_argument(name, type=int, help=argparse.SUPPRESS)
    for name in ("--corpus", "--out", "--cores"):
        ap.add_argument(name, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    if args.device != "cpu":
        from ..device import resolve_device

        resolve_device(args.device)  # raises without a card

    def log(*a):
        print(*a, flush=True)

    result = measure(args.device, args.small, [int(n) for n in args.hosts.split(",")],
                     args.points.split(","), args.reps, args.timeout, log)
    line = json.dumps(result)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
