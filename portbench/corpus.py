"""A configuration's samples, simulated from the run's seed and cached in
the checkout.

The configuration file's ``simulator`` keys are ``frozen.sim.simulate``'s
keywords. Sample ``i`` of a pass is simulated from the seed ``seed + i``,
so a one-sample mix runs on the run's own seed. Each sample is written
once into ``.portbench_cache/samples/<key>/`` of the checkout, where the
key is the configuration's name, the seed and a hash of the simulator's
keywords and of the sources that make the sample (``frozen/sim.py``,
``frozen/bamio.py`` and this file): a later run with the same seed reads
it back instead of simulating it again. A sample is simulated into a
directory of its own and renamed into place whole, so a run that stops
midway leaves no sample half written.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil

from .frozen.sim import simulate

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(HERE, "frozen", "sim.py"), os.path.join(HERE, "frozen", "bamio.py"),
           os.path.abspath(__file__)]


@dataclasses.dataclass
class Sample:
    bam: str
    fastq: str
    n_reads: int
    truth: list  # every simulated isoform's exon chain, sorted
    cached: bool  # read back from the cache, not simulated in this run


def sample_key(name: str, simulator: dict, seed: int) -> str:
    h = hashlib.sha256(json.dumps(simulator, sort_keys=True).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return f"{name}-{seed}-{h.hexdigest()[:16]}"


def load_sample(name: str, simulator: dict, seed: int, cache_root: str) -> Sample:
    """The sample of ``simulator`` at ``seed``, from the cache under
    ``cache_root`` or simulated into it."""
    final = os.path.join(cache_root, "samples", sample_key(name, simulator, seed))
    meta = os.path.join(final, "sample.json")
    cached = os.path.exists(meta)
    if not cached:
        part = f"{final}.part-{os.getpid()}"
        shutil.rmtree(part, ignore_errors=True)
        os.makedirs(part)
        sim = simulate(seed=seed, **simulator)
        sim.write_bam(os.path.join(part, "reads.bam"))
        sim.write_fastq(os.path.join(part, "reads.fastq"))
        with open(os.path.join(part, "sample.json"), "w") as f:
            json.dump(dict(n_reads=len(sim.reads),
                           truth=sorted(tuple(t.exons) for t in sim.transcripts)), f)
        try:
            os.rename(part, final)
        except OSError:  # another run put the same sample in place first
            shutil.rmtree(part, ignore_errors=True)
    with open(meta) as f:
        info = json.load(f)
    truth = sorted(tuple(tuple(e) for e in chain) for chain in info["truth"])
    return Sample(os.path.join(final, "reads.bam"), os.path.join(final, "reads.fastq"),
                  info["n_reads"], truth, cached)
