"""Observability: stage metrics, structured per-locus logs, profiling.

The reference's observability is stdout prints plus optional Gurobi logs
(.glog/.lp/.sol + timeout.log, py/freddie_cluster.py:577-600,710-749).
Equivalents here:

- StageMetrics: wall-clock + item counters per stage, JSON-serializable
  (the 'reads/s' numbers the BASELINE targets are computed from these);
- SolverLog: per-instance status table (tint, partition, round, reads,
  status, objective, nodes, seconds) -- the timeout.log equivalent -- plus
  optional instance dumps (.json, the .lp equivalent) for replay;
- profile_trace(): context manager around torch.profiler for device traces.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class StageMetrics:
    stage: str
    t_start: float = field(default_factory=time.perf_counter)
    counters: dict = field(default_factory=dict)

    def add(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def finish(self) -> dict:
        wall = time.perf_counter() - self.t_start
        out = dict(stage=self.stage, seconds=round(wall, 3), **self.counters)
        for key in ("reads", "tints", "problems"):
            if key in self.counters and wall > 0:
                out[f"{key}_per_s"] = round(self.counters[key] / wall, 1)
        return out


class SolverLog:
    """Per-tint solver status table + optional instance dumps."""

    def __init__(self, logs_dir: str | None, tint_id: int):
        self.dir = None
        self.fh = None
        if logs_dir is not None:
            self.dir = os.path.join(logs_dir, str(tint_id))
            os.makedirs(self.dir, exist_ok=True)
            self.fh = open(os.path.join(self.dir, "solver.log"), "w")
            self.fh.write(
                "status\ttint\tpartition\tround\tn_reads\tobjective\tnodes\tseconds\n"
            )
        self.tint_id = tint_id

    def record(self, partition: int, round_num: int, n_reads: int, res, seconds: float) -> None:
        if self.fh is None:
            return
        self.fh.write(
            "\t".join(
                map(
                    str,
                    [
                        res.status,
                        self.tint_id,
                        partition,
                        round_num,
                        n_reads,
                        res.objective,
                        res.nodes,
                        round(seconds, 4),
                    ],
                )
            )
            + "\n"
        )

    def dump_instance(self, partition: int, round_num: int, inst) -> None:
        """Serialize a solver instance (the reference's .lp dump analog)."""
        if self.dir is None:
            return
        path = os.path.join(self.dir, f"partition.{partition}.round.{round_num}.json")
        with open(path, "w") as f:
            json.dump(
                dict(
                    seg_len=inst.seg_len.tolist(),
                    epsilon=inst.epsilon,
                    offset=inst.offset,
                    incomp=np.asarray(inst.incomp, dtype=np.int64)
                    .reshape(-1, 2)
                    .tolist(),
                    rows=[
                        dict(
                            exons=[int(x) for x in r.exons],
                            corr=[int(x) for x in r.corr],
                            garbage=r.garbage,
                            gaps=[
                                ([int(x) for x in m], int(l)) for m, l in r.gaps
                            ],
                        )
                        for r in inst.rows
                    ],
                ),
                f,
            )

    def dump_solution(self, partition: int, round_num: int, res) -> None:
        """Serialize one solve's result (the reference's Gurobi .sol dump
        analog, py/freddie_cluster.py:595-600): status, objective, the
        isoform exon bitstring over informative segments, and the
        assigned read-rep positions."""
        if self.dir is None:
            return
        path = os.path.join(
            self.dir, f"partition.{partition}.round.{round_num}.sol.json"
        )
        with open(path, "w") as f:
            json.dump(
                dict(
                    status=res.status,
                    objective=res.objective,
                    isoform=(
                        None
                        if res.isoform is None
                        else "".join(str(int(x)) for x in np.asarray(res.isoform))
                    ),
                    assigned=[int(i) for i in res.assigned],
                    nodes=int(res.nodes),
                ),
                f,
            )

    def close(self) -> None:
        if self.fh is not None:
            self.fh.close()


def summarize_solver_logs(logs_dir: str) -> dict:
    """Stage-level roll-up of every tint's solver.log under logs_dir
    (recursive): solve counts by status, objective/node/second totals.
    The reference's closest analog is eyeballing timeout.log across
    tints; this writes one machine-readable summary."""
    import glob

    counts: dict[str, int] = {}
    solves = 0
    nodes = 0
    seconds = 0.0
    for path in sorted(
        glob.glob(os.path.join(logs_dir, "**", "solver.log"), recursive=True)
    ):
        with open(path) as f:
            next(f, None)  # header
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 8:
                    continue
                counts[parts[0]] = counts.get(parts[0], 0) + 1
                solves += 1
                nodes += int(parts[6])
                seconds += float(parts[7])
    return dict(
        solves=solves,
        by_status=dict(sorted(counts.items())),
        nodes=nodes,
        solver_seconds=round(seconds, 3),
    )


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """torch.profiler trace around a region, written as a Chrome trace
    into ``trace_dir`` (no-op when trace_dir is None). Records CUDA
    activity when a GPU is present."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace.{os.getpid()}.json")
    )
