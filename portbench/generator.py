"""The one generator of traffic: it reads a mix (``traffic/<mix>.json``)
and drives the program with it.

A mix is data. Its keys:

- ``loop``: ``"closed"``, the only loop a batch tool has here: the next
  pass starts when the previous one ends;
- ``clients``: 1 (passes never overlap);
- ``entry``: the program's entry each pass goes through, ``"pipeline"``
  (``stages.pipeline.run_pipeline``, once for each sample of the pass)
  or ``"workflow"`` (``stages.workflow.run_workflow`` over a sample sheet
  of all the pass's samples);
- ``samples_per_pass``: how many samples a pass takes through the entry;
  sample ``i`` is the configuration's sample at the seed ``seed + i``
  (``corpus``);
- ``warmup_passes``: the passes set-up runs before the window, the first
  of them with every stage on one thread (``warmup_threads``), so that a
  fresh checkout builds each of the program's native engines from one
  thread;
- ``traced_passes``: the passes the profiler records with ``--trace 1``;
- ``what``: one line that says what the mix is, for the reader.

A mix asks for nothing that this generator does not do: a key it does not
know, or a value it does not drive, stops the run before set-up.
"""

from __future__ import annotations

import dataclasses
import os

KEYS = {"loop", "clients", "entry", "samples_per_pass", "warmup_passes", "warmup_threads",
        "traced_passes", "what"}
ENTRIES = ("pipeline", "workflow")
STAGES = ("split", "segment", "cluster", "isoforms")


def check_mix(name: str, mix: dict) -> dict:
    """``mix`` as the generator drives it; raises ValueError where it asks
    for anything else."""
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"traffic {name}: keys {sorted(unknown)} are not the generator's")
    want = dict(loop="closed", clients=1)
    for key, value in want.items():
        if mix.get(key) != value:
            raise ValueError(f"traffic {name}: {key} {mix.get(key)!r}; the generator drives "
                             f"{value!r}")
    if mix.get("entry") not in ENTRIES:
        raise ValueError(f"traffic {name}: entry {mix.get('entry')!r} is not one of {ENTRIES}")
    for key in ("samples_per_pass", "warmup_passes", "warmup_threads", "traced_passes"):
        if not isinstance(mix.get(key), int) or mix[key] < 1:
            raise ValueError(f"traffic {name}: {key} must be a whole number from 1")
    return mix


def with_threads(pcfg, threads: int):
    """``pcfg`` with every stage's ``threads`` set to ``threads``."""
    return dataclasses.replace(pcfg, **{
        s: dataclasses.replace(getattr(pcfg, s), threads=threads) for s in STAGES})


def run_pass(mix: dict, samples: list, outdir: str, pcfg, device: str, log, on_sample):
    """One pass: every sample through the mix's entry, outputs under
    ``outdir``. Calls ``on_sample(i)`` as sample ``i`` begins. Returns each
    sample's output directory and the stage seconds summed over them."""
    names = [f"s{i}" for i in range(len(samples))]
    if mix["entry"] == "pipeline":
        from freddie_tpu_torch.stages.pipeline import run_pipeline

        dirs = [os.path.join(outdir, n) for n in names]
        stats = []
        for i, (s, d) in enumerate(zip(samples, dirs)):
            on_sample(i)
            stats.append(run_pipeline(s.bam, [s.fastq], d, pcfg, log=log, device=device))
    else:
        from freddie_tpu_torch.stages.workflow import run_workflow

        dirs = [os.path.join(outdir, "results", n) for n in names]
        index = {n: i for i, n in enumerate(names)}

        def sheet_log(msg):
            parts = str(msg).split()
            if len(parts) > 2 and parts[:2] == ["[workflow]", "sample"] and parts[2] in index:
                on_sample(index[parts[2]])
            log(msg)

        sheet = dict(outpath=outdir,
                     samples={n: dict(bam=s.bam, reads=[s.fastq]) for n, s in zip(names, samples)},
                     stages={st: dataclasses.asdict(getattr(pcfg, st)) for st in STAGES})
        got = run_workflow(sheet, resume=False, log=sheet_log, device=device)
        stats = [got[n] for n in names]
    stage_s: dict = {}
    for st in stats:
        for k, v in st.items():
            if isinstance(v, dict) and "seconds" in v:
                stage_s[k] = stage_s.get(k, 0.0) + v["seconds"]
    return dirs, stage_s
