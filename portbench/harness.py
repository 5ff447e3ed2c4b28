"""One run of one cell: set-up, the measured window, the traced passes, the
check, and the result line.

The cell's traffic mix (``traffic/<mix>.json``) is driven by the one
generator (``generator``): passes back to back, each taking the mix's
samples through the program's entry. Set-up (``setup_s``: process start
to the first timed pass) loads the samples (``corpus``: simulated from
the seed, or read back from the checkout's cache) and runs the mix's
warm-up passes, which build the native engines and the kernels into the
checkout's caches and touch every shape the window will use. The window
then runs passes until ``--seconds`` have passed since the first one
began; the last pass always runs to its end, and the window ends with
it. With ``--trace 1`` the profiler records the window's first
``traced_passes`` passes.

The last pass's outputs are checked (``reference.check``) once the window
has closed, the device's memory peak has been read and the program's
state freed. Each pass's directory is removed before the next pass; the
whole work directory lives under TMPDIR and is removed at the end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

from . import generator, registry
from .corpus import load_sample
from .frozen.recovery import recovery
from .reference.check import run_checks
from .trace import profiler_events, reduce_trace, top_ops

STAGES = list(generator.STAGES)
# The DP kernel K1's launches, by the names its kernels carry.
K1_KERNELS = ("pair_stats_kernel", "wavefront")


@dataclasses.dataclass
class PassRecord:
    start: float
    end: float
    reads: int
    ok: bool
    stage_s: dict
    k1_launches: int
    cpu_s: float = 0.0  # this process's CPU seconds (its threads and waited-for children)


@dataclasses.dataclass
class RunRecord:
    """What the metric readers (``metrics/<name>.py``) read."""

    passes: list
    window_s: float
    setup_s: float
    traced: dict | None = None  # trace.reduce_trace's dict, with k1_calls and passes
    power_limit_w: float | None = None


def boot_seconds_since_start() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def cache_root(root: str) -> str:
    return os.path.join(root, ".portbench_cache")


def cache_env(root: str) -> None:
    """Every kernel cache the run may fill, at fixed paths in the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache_root(root), sub)


def pipeline_config(config: dict):
    from freddie_tpu_torch.config import (ClusterConfig, IsoformsConfig, PipelineConfig,
                                          SegmentConfig, SplitConfig)

    p = config["pipeline"]
    return PipelineConfig(split=SplitConfig(**p["split"]), segment=SegmentConfig(**p["segment"]),
                          cluster=ClusterConfig(**p["cluster"]),
                          isoforms=IsoformsConfig(**p["isoforms"]))


class Capture:
    """Harness-side wraps around two calls into the program's layers.

    - ``stages.segment.final_positions_per_interval``, where phase C takes
      a tint's DP answers: for each sample of the pass, each tint's
      intervals as phase A left them and the answers of their problems.
      Only references and the answers are kept in the window; ``tints``
      reads out what the check compares once the window has closed;
    - with ``k1`` set, ``parallel.mesh.solve_batch_cuda``, the DP kernel
      K1's entry: each call's (B, P, R) and a device copy of its
      ``n_cand``, for K1's bound.
    """

    def __init__(self):
        import freddie_tpu_torch.parallel.mesh as mesh
        import freddie_tpu_torch.stages.segment as segment

        self.seen: list[dict] = [{}]
        self.sample = 0
        self.k1_calls: list = []
        self.k1 = False
        self._segment, self._mesh = segment, mesh
        self._final = segment.final_positions_per_interval
        self._solve = mesh.solve_batch_cuda
        segment.final_positions_per_interval = self._wrap_final
        mesh.solve_batch_cuda = self._wrap_solve

    def begin_pass(self, n_samples: int) -> None:
        self.seen = [{} for _ in range(n_samples)]
        self.sample = 0

    def begin_sample(self, i: int) -> None:
        self.sample = i

    def _wrap_final(self, work, solutions, cfg):
        key = ((work.chrom, work.tint_id) if hasattr(work, "chrom")
               else (work.tint.chrom, work.tint.id))
        answers = {pid: list(solutions[pid]) for iw in work.intervals for pid in iw.problems}
        self.seen[self.sample][key] = (list(work.intervals), work.weights, answers)
        return self._final(work, solutions, cfg)

    def _wrap_solve(self, C, y, W, n_cand, *args, **kwargs):
        if self.k1:
            self.k1_calls.append((tuple(C.shape), n_cand.clone()))
        return self._solve(C, y, W, n_cand, *args, **kwargs)

    def tints(self, i: int) -> dict:
        """Sample ``i``'s tints: {(contig, tint): (intervals, problems)},
        intervals [(candidates, fixed, problem bounds, problem ids)] and
        problems {pid: (C, y, W, answer)}, C the rows of phase A's
        cumulative coverage at the problem's candidates y."""
        out = {}
        for key, (intervals, weights, answers) in self.seen[i].items():
            ivs, probs = [], {}
            for iw in intervals:
                ivs.append((list(iw.candidates), sorted(iw.fixed), list(iw.problem_bounds),
                            list(iw.problems)))
                for pid, (s_c, e_c) in zip(iw.problems, iw.problem_bounds):
                    probs[pid] = (iw.C[s_c : e_c + 1], iw.candidates[s_c : e_c + 1], weights,
                                  answers[pid])
            out[key] = (ivs, probs)
        return out

    def close(self):
        self._segment.final_positions_per_interval = self._final
        self._mesh.solve_batch_cuda = self._solve


def power_limit_w() -> float | None:
    """The card's power limit as nvidia-smi reports it (one call, waited for)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run_cell(args, root: str = registry.ROOT, sample: dict | None = None, device: str = "cuda",
             warmup: int | None = None, control: bool = False) -> tuple[int, dict | None]:
    """Runs the cell ``args.workload`` once. Returns (exit code, the result
    dict or None). The benchmark's runs take the defaults. The tests and
    ``control.py`` may set ``sample`` (simulator keys over the
    configuration's), ``device="cpu"`` (the CPU rehearsal), ``warmup``
    (passes, over the mix's) and ``control`` (the result then also holds
    ``control_checks``: the numbers with the control in the program's
    place)."""
    bench = registry.load_benchmark(root)
    cell = registry.workload(bench, args.workload)
    config = registry.config(bench, cell["config"], root)
    mix = generator.check_mix(cell["traffic"], registry.traffic(cell["traffic"],
                                                                os.path.join(root, "portbench")))
    if sample is not None:
        config = dict(config, simulator=dict(config["simulator"], **sample))
    cache_env(root)
    t_import = time.perf_counter()
    import torch

    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        log(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2, None

    import freddie_tpu_torch.ops.segdp_cuda as segdp_cuda

    pcfg = pipeline_config(config)
    capture = Capture()
    t_cuda = time.perf_counter()
    if on_card:
        torch.empty(1, device="cuda")  # the CUDA context, counted apart from the rest
    workdir = tempfile.mkdtemp(prefix="portbench-")
    prof = None
    try:
        t_sample = time.perf_counter()
        samples = [load_sample(cell["config"], config["simulator"], args.seed + i,
                               cache_root(root)) for i in range(mix["samples_per_pass"])]
        n_reads = sum(s.n_reads for s in samples)
        t_warm = time.perf_counter()
        tracing = [False]

        def mark(name):
            if tracing[0]:
                with torch.profiler.record_function("portbench." + name):
                    pass

        def stage_log(msg):
            parts = str(msg).split()
            if len(parts) > 2 and parts[0] == "[pipeline]" and parts[2] == "done":
                mark("stage_done:" + parts[1].rstrip(":"))

        def one_pass(tag, cfg=pcfg) -> tuple[PassRecord, list]:
            out = os.path.join(workdir, f"pass-{tag}")
            stage_s, dirs = {}, []
            capture.begin_pass(len(samples))
            launches = segdp_cuda.LAUNCHES
            mark("pass_begin")
            c0 = os.times()
            t0 = time.perf_counter()
            ok = True
            try:
                dirs, stage_s = generator.run_pass(mix, samples, out, cfg, device, stage_log,
                                                   capture.begin_sample)
                if on_card:
                    torch.cuda.synchronize()
            except Exception as exc:  # a failed pass is counted, and the window goes on
                ok = False
                log(f"portbench: pass {tag} failed: {type(exc).__name__}: {exc}")
            t1 = time.perf_counter()
            c1 = os.times()
            mark("pass_end")
            return PassRecord(t0, t1, n_reads if ok else 0, ok, stage_s,
                              segdp_cuda.LAUNCHES - launches, sum(c1[:4]) - sum(c0[:4])), dirs

        n_warm = mix["warmup_passes"] if warmup is None else warmup
        for i in range(n_warm):
            cfg = generator.with_threads(pcfg, mix["warmup_threads"]) if i == 0 else pcfg
            one_pass(f"warmup{i}", cfg)
            shutil.rmtree(os.path.join(workdir, f"pass-warmup{i}"), ignore_errors=True)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = boot_seconds_since_start()
        t_end = time.perf_counter()
        log(f"portbench: set-up {setup_s:.3f} s: interpreter start and imports (torch among "
            f"them) {setup_s - (t_end - t_import):.3f}, the program imported "
            f"{t_cuda - t_import:.3f}, CUDA context "
            f"{t_sample - t_cuda:.3f}, {len(samples)} sample(s) of {n_reads} reads "
            f"{'read back' if all(s.cached for s in samples) else 'simulated'} in "
            f"{t_warm - t_sample:.3f}, {n_warm} warm-up pass(es) {t_end - t_warm:.3f}")

        passes: list[PassRecord] = []
        n_traced = mix["traced_passes"] if args.trace else 0
        rm_s = 0.0
        while True:
            if passes:
                t_rm = time.perf_counter()
                shutil.rmtree(os.path.join(workdir, f"pass-{len(passes) - 1}"), ignore_errors=True)
                rm_s += time.perf_counter() - t_rm
            if len(passes) == 0 and n_traced:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                              + ([torch.profiler.ProfilerActivity.CUDA]
                                                 if on_card else []))
                prof.start()
                tracing[0] = capture.k1 = True
            rec, dirs = one_pass(len(passes))
            passes.append(rec)
            done = passes[-1].end - passes[0].start >= args.seconds
            if tracing[0] and (done or len(passes) == n_traced):
                prof.stop()
                tracing[0] = capture.k1 = False
            if done:
                break
        window_s = passes[-1].end - passes[0].start
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

        record = RunRecord(passes=passes, window_s=window_s, setup_s=setup_s,
                           power_limit_w=power_limit_w() if on_card else None)
        for i, p in enumerate(passes):
            log(f"portbench: pass {i}: {p.end - p.start:.3f} s, stages {json.dumps(p.stage_s)}, "
                f"{p.k1_launches} K1 launches, CPU {p.cpu_s:.3f} s")
        log(f"portbench: {len(passes)} passes in {window_s:.3f} s; set-up {setup_s:.3f} s; "
            f"removing the passes' outputs {rm_s:.3f} s of the window; "
            f"card {torch.cuda.get_device_name(0) if on_card else 'none'}, "
            f"power limit {record.power_limit_w} W")
        if prof is not None:
            traced = reduce_trace(profiler_events(prof), STAGES)
            traced["passes"] = min(n_traced, len(passes))
            traced["k1_calls"] = [(shape, nc.cpu().numpy()) for shape, nc in capture.k1_calls]
            traced["k1_ops"] = [op for op in traced["ops"]
                                if any(k in op[0] for k in K1_KERNELS)]
            record.traced = traced
            prof = None
        capture.close()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        numbers, controls = {}, {}
        if not passes[-1].ok:
            numbers = {"last_pass_failed": [1, 0]}
        for i, (s, last) in enumerate(zip(samples, dirs) if passes[-1].ok else ()):
            got, seen, low = run_checks(config, s.bam, last, capture.tints(i), device, control)
            for name, value, limit in got:
                numbers.setdefault(name, [0, limit])[0] += value
            for name, value, limit in low or []:
                controls.setdefault(name, [0, limit])[0] += value
            log(f"portbench: checked sample {i} of the last pass: {json.dumps(seen)}")
            sizes = {d: sum(os.path.getsize(os.path.join(r, f))
                            for r, _d, fs in os.walk(os.path.join(last, d)) for f in fs)
                     for d in ("split", "segment", "cluster")}
            log(f"portbench: sample {i} of the last pass wrote {json.dumps(sizes)} bytes")
            sim = config["simulator"]
            found, reported = recovery(os.path.join(last, "isoforms.gtf"), s.truth,
                                       2 * sim["junction_jitter"] + 2, sim["end_jitter"] + 15)
            log(f"portbench: sample {i}'s GTF recovers {found} of {len(s.truth)} simulated "
                f"isoforms ({reported} transcripts reported; not compared)")
        log(f"portbench: the check took {time.perf_counter() - t0:.3f} s")
        result = build_result(bench, args, cell, record, numbers, memory_peak, on_card, root)
        if control:
            result["control_checks"] = {n: dict(value=v, limit=lim)
                                        for n, (v, lim) in controls.items()}
    finally:
        capture.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return 0, result


def build_result(bench, args, cell, record: RunRecord, numbers: dict, memory_peak, on_card,
                 root: str = registry.ROOT) -> dict:
    """The result line's object. Each metric is read by its own reader
    (``metrics/<name>.py``); one that finds nothing to read is left out."""
    import torch

    attempted = len(record.passes)
    failed = sum(1 for p in record.passes if not p.ok)
    metrics = {}
    for m in registry.metrics(bench, cell["name"], traced=bool(args.trace)):
        value = registry.reader(m["name"], os.path.join(root, "portbench"))(record)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    device = dict(platform="gpu" if on_card else "cpu",
                  kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                  count=cell["chips"] if on_card else 0, memory_peak_bytes=int(memory_peak))
    result = dict(correct=failed == 0 and all(v <= lim for v, lim in numbers.values()),
                  attempted=attempted, failed=failed, metrics=metrics, device=device)
    if record.traced is not None:
        t = record.traced
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        result["breakdown"] = dict(device_ops=top_ops(t["ops"]),
                                   idle_gaps=[[n, s] for n, s in t["gaps"][:10]])
    result["checks"] = {n: dict(value=v, limit=lim) for n, (v, lim) in numbers.items()}
    return result
