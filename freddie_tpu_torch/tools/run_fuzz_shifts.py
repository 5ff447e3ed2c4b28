"""Seed-shift fuzz of the port over the parity suite's three configs.

    python -m freddie_tpu_torch.tools.run_fuzz_shifts [--device cuda|cuda:N|cpu] [FIRST] [LAST]

Per shift in FIRST..LAST and config it simulates the corpus, runs the
pipeline on the device (the card unless ``--device cpu``) with the segment
stage's device route forced at this size, and holds every segment and
cluster TSV and the GTF byte-identical to the host-oracle route's
(``use_device=False``). Exits 1 at the first difference.

The parity of the port with the JAX package under the same shifts is a
test, not this tool: ``FREDDIE_PARITY_SEED=n pytest -m slow
tests/test_torch_fuzz.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import os
import sys
import tempfile


def fuzz_device_against_host(device, shifts, log=print) -> int:
    """The loop over ``shifts`` on ``device``; the number of (shift, config)
    corpora compared. Raises RuntimeError at the first difference."""
    from ..bench.common import same_tsvs
    from ..config import PipelineConfig
    from ..stages import segment as tseg
    from ..stages.pipeline import run_pipeline
    from ..utils.sim import PARITY_CORPORA, parity_corpus, simulate

    forced = dict(DEVICE_MIN_WORK=0, DEVICE_COVERAGE_MIN_TINTS=0, STREAM_CHUNK_MAX=8)
    saved = {k: getattr(tseg, k) for k in forced}
    cfg = PipelineConfig()
    host_cfg = dataclasses.replace(
        cfg, segment=dataclasses.replace(cfg.segment, use_device=False))
    done = 0
    try:
        for k, v in forced.items():
            setattr(tseg, k, v)
        for shift in shifts:
            for name in PARITY_CORPORA:
                with tempfile.TemporaryDirectory() as d:
                    sim = simulate(**parity_corpus(name, shift))
                    bam, fq = os.path.join(d, "r.bam"), os.path.join(d, "r.fastq")
                    sim.write_bam(bam)
                    sim.write_fastq(fq)
                    outs = {}
                    for route, c in (("device", cfg), ("host", host_cfg)):
                        outs[route] = os.path.join(d, route)
                        run_pipeline(bam, [fq], outs[route], c, log=lambda *_: None,
                                     device=device)
                    what = f"shift {shift}, {name}"
                    n = sum(len(same_tsvs(os.path.join(outs["device"], stage),
                                          os.path.join(outs["host"], stage),
                                          f"{what}, {stage}"))
                            for stage in ("segment", "cluster"))
                    if not filecmp.cmp(os.path.join(outs["device"], "isoforms.gtf"),
                                       os.path.join(outs["host"], "isoforms.gtf"),
                                       shallow=False):
                        raise RuntimeError(f"{what}: the GTF differs from the host route's")
                    log(f"[fuzz] {what}: {n} TSVs and the GTF byte-identical to the "
                        f"host-oracle route on {device}")
                    done += 1
    finally:
        for k, v in saved.items():
            setattr(tseg, k, v)
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("first", nargs="?", type=int, default=84)
    ap.add_argument("last", nargs="?", type=int, default=110)
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)  # raises when the card is asked for and absent
    try:
        n = fuzz_device_against_host(dev, range(args.first, args.last + 1),
                                     lambda *a: print(*a, flush=True))
    except RuntimeError as e:
        print(f"FUZZ SWEEP FAILED: {e}", file=sys.stderr)
        return 1
    print(f"FUZZ SWEEP DONE: {n} corpora")
    return 0


if __name__ == "__main__":
    sys.exit(main())
