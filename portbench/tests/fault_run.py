"""The harness's CPU rehearsal with the timed path broken underneath:

    python -m portbench.tests.fault_run <fault> --workload <cell> --seed <n> --seconds <s>

Faults, each planted where the program produces the thing it alters:

- ``coverage``: in every tint, phase A's cumulative coverage of its first
  interval counts one more base of one read-rep before every candidate
  from the second on (in the interval's C and its problems' C);
- ``dp_answer``: every DP answer that segments loses its last breakpoint,
  where the dispatch reads the answers back;
- ``half_batch``: the second half of every DP batch is left out (its
  answers come back empty);
- ``genotype``: one read's first genotype flips in the segment TSV that
  phase C writes;
- ``gtf``: one exon of the GTF that the isoforms stage writes moves by a
  base;
- ``unseen``: phase C reaches the tints' final positions by a path the
  harness's capture does not wrap;
- ``none``: nothing broken, the same route.

The DP goes to the device route (the plain twin on the CPU) from the
first problem (``DEVICE_MIN_WORK = 0``).
"""

import sys


def plant(fault: str) -> None:
    import freddie_tpu_torch.stages.pipeline as pipeline
    import freddie_tpu_torch.stages.segment as segment

    segment.DEVICE_MIN_WORK = 0
    prepare = segment.prepare_tint_native
    collect, finalize, isoforms = (segment.collect_batch_device, segment.finalize_tint_native,
                                   pipeline.run_isoforms)
    positions = segment.final_positions_per_interval  # bound before the harness wraps it

    def prepare_miscounting(*args):
        import dataclasses

        work, problems = prepare(*args)
        iw = next((iw for iw in work.intervals if iw.problems), None)
        if iw is not None:
            iw.C = iw.C.copy()
            iw.C[1:, 0] += 1
            for pid, (s_c, e_c) in zip(iw.problems, iw.problem_bounds):
                problems[pid] = dataclasses.replace(problems[pid], C=iw.C[s_c : e_c + 1].copy())
        return work, problems

    def collect_dropping_last(handles, work, results):
        return [r[:-1] if r else r for r in collect(handles, work, results)]

    def collect_half(handles, work, results):
        got = collect(handles, work, results)
        half = set(work[len(work) // 2:])
        return [[] if i in half else r for i, r in enumerate(got)]

    def finalize_flipping(work, solutions, cfg, thr, eng):
        text = finalize(work, solutions, cfg, thr, eng).decode()
        lines = text.split("\n")
        fields = lines[1].split("\t")
        fields[5] = ("1" if fields[5][0] != "1" else "0") + fields[5][1:]
        lines[1] = "\t".join(fields)
        return "\n".join(lines).encode()

    def isoforms_moving_an_exon(split_dir, cluster_dir, gtf, cfg):
        n = isoforms(split_dir, cluster_dir, gtf, cfg)
        lines = open(gtf).read().split("\n")
        i = next(k for k, line in enumerate(lines) if "\texon\t" in line)
        fields = lines[i].split("\t")
        fields[3] = str(int(fields[3]) + 1)
        lines[i] = "\t".join(fields)
        open(gtf, "w").write("\n".join(lines))
        return n

    def finalize_unseen(work, solutions, cfg, thr, eng):
        import numpy as np

        final_ys = positions(work, solutions, cfg)
        lookup = np.ascontiguousarray(thr.lookup, dtype=np.int32)
        return eng.finalize(work.handle, final_ys, lookup.tobytes(), thr.scale)

    if fault == "coverage":
        segment.prepare_tint_native = prepare_miscounting
    elif fault == "dp_answer":
        segment.collect_batch_device = collect_dropping_last
    elif fault == "half_batch":
        segment.collect_batch_device = collect_half
    elif fault == "genotype":
        segment.finalize_tint_native = finalize_flipping
    elif fault == "gtf":
        pipeline.run_isoforms = isoforms_moving_an_exon
    elif fault == "unseen":
        segment.finalize_tint_native = finalize_unseen
    elif fault != "none":
        raise ValueError(f"no fault {fault!r}")


def main() -> int:
    from portbench.run import main as run_main

    plant(sys.argv[1])
    return run_main(sys.argv[2:] + ["--rehearse-cpu"])


if __name__ == "__main__":
    sys.exit(main())
