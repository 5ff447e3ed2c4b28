"""Stage 6 (optional) -- per-isoform visualization.

Equivalent of the reference's freddie_plot.py: for every tint/partition/
isoform, draw member reads against annotation transcripts in the
reference's gridspec layout (py/freddie_plot.py:81-276):

- one subplot column per plotting segment, column widths from the
  grid_width_ratios length table (py/freddie_plot.py:30-40); plotting
  segments are rebuilt from the annotation transcripts' exon boundaries
  (py/freddie_plot.py:442-449);
- reads colored by their simulation-truth transcript id parsed from the
  read name prefix (py/freddie_plot.py:359-376) -- the reference's primary
  visual validation workflow (OUTPUT.md:17-43); unknown-truth reads gray;
- polyA-tail side panels (Extra SC / polyA length / gap, both ends,
  py/freddie_plot.py:85-167) -- populated with the reads' actual tail
  tokens from the cluster TSV (the reference sets these axes up but its
  data drawing is commented out at :196-227; here they are drawn);
- per-exon unaligned-gap sizes as red/black text on read rows (the
  reference's commented :197-199, implemented);
- annotation exon numbers centered on exon boxes; black consensus track.

Differences from the reference (intentional):
- multi-page PDFs use matplotlib.backends.PdfPages (the reference shells
  through per-isoform PDFs + PyPDF2, py/freddie_plot.py:481-487);
- the transcript-name filter is a parameter (the reference hardcodes its
  dev gene's names 'AR-UNION'/'AR-204'/... at py/freddie_plot.py:413);
  default: all annotation transcripts overlapping the tint;
- truth transcript ids accept any ENST-prefixed name-prefix (the
  reference requires NanoSim's exact 15-char ENST ids, :359-363);
- plotting segments are computed per partition without mutating the tint
  (the reference overwrites tint['segs'] as it iterates, :442-449).
"""

from __future__ import annotations

import os
import re
from itertools import groupby

COLORS = [
    "#a6cee3", "#1f78b4", "#b2df8a", "#33a02c", "#fb9a99", "#e31a1c",
    "#fdbf6f", "#ff7f00", "#cab2d6", "#6a3d9a", "#ffff99", "#b15928",
]
# (min segment length, relative column width): py/freddie_plot.py:30-40.
GRID_WIDTH_RATIOS = [
    (5000, 9), (2000, 8), (1000, 7), (500, 6), (200, 5), (100, 4),
    (50, 3), (20, 2), (0, 2),
]


def _grid_len(length: int) -> int:
    for threshold, value in GRID_WIDTH_RATIOS:
        if length > threshold:
            return value
    return GRID_WIDTH_RATIOS[-1][1]


def truth_tid(read_name: str) -> str | None:
    """Simulation-truth transcript id from a read name ('<tid>_<idx>');
    None when the prefix does not look like a transcript id."""
    tid = read_name.split("_")[0]
    return tid if tid.startswith("ENST") else None


def parse_annotation_gtf(path: str) -> dict:
    """transcript_id -> {chrom, name, intervals, enum} from exon records."""
    transcripts: dict = {}
    for line in open(path):
        if line[0] == "#":
            continue
        f = line.rstrip("\n").split("\t")
        if f[2] != "exon":
            continue
        m = re.search(r'transcript_id "(?P<tid>[^"]+)"', f[8])
        if not m:
            continue
        tid = m.group("tid")
        nm = re.search(r'transcript_name "(?P<tname>[^"]+)"', f[8])
        en = re.search(r'exon_number "(?P<enum>[^"]+)"', f[8])
        t = transcripts.setdefault(
            tid,
            dict(chrom=f[0], intervals=[], enum=[], name=nm.group("tname") if nm else tid),
        )
        t["intervals"].append((int(f[3]), int(f[4])))
        t["enum"].append(en.group("enum") if en else str(len(t["enum"]) + 1))
    return transcripts


def data_to_intervals(segs, data: str):
    """Genomic intervals of the '1'-runs of a data string over segments."""
    out = []
    for d, grp in groupby(enumerate(data), lambda t: t[1]):
        if d != "1":
            continue
        grp = list(grp)
        out.append((segs[grp[0][0]][0], segs[grp[-1][0]][1]))
    return out


def _parse_tail(tokens: list[str]) -> dict:
    """Start/end polyA info from cluster-TSV tail tokens: the cluster
    writer emits '<S|E><A|T>:(<length>, <gap>)' (io/tsv.py
    format_cluster_tsv, mirroring py/freddie_cluster.py:688)."""
    out = dict(ssc=0, esc=0, s_len=0, s_gap=0, e_len=0, e_gap=0)
    for tok in tokens:
        if ":" not in tok:
            continue
        k, v = tok.split(":", 1)
        m = re.fullmatch(r"\((\d+),\s*(\d+)\)", v.strip())
        if m is None or len(k) != 2 or k[0] not in "SE" or k[1] not in "AT":
            continue
        length, gap = int(m.group(1)), int(m.group(2))
        if k[0] == "S":
            out["s_len"], out["s_gap"] = length, gap
        else:
            out["e_len"], out["e_gap"] = length, gap
    return out


def load_tints(cluster_tsv: str, segment_tsv: str, tint_ids=frozenset()) -> dict:
    """Join cluster + segment TSVs into per-tint partition/isoform read
    groups (the reference's get_tints, py/freddie_plot.py:312-396)."""
    rid_to_data = {}
    for line in open(segment_tsv):
        if line[0] == "#":
            continue
        f = line.rstrip("\n").split("\t")
        rid_to_data[int(f[0])] = f[5]
    tints: dict = {}
    for line in open(cluster_tsv):
        if line.startswith("#"):
            chrom, tid_s, seg_s = line.rstrip("\n")[1:].split("\t")
            tint_id = int(tid_s)
            if tint_ids and tint_id not in tint_ids:
                continue
            pos = seg_s.split(",")
            segs = [(int(s), int(e)) for s, e in zip(pos[:-1], pos[1:])]
            tints[tint_id] = dict(id=tint_id, chrom=chrom, segs=segs, partitions={})
        elif line.startswith("isoform_"):
            continue
        else:
            f = line.rstrip("\n").split("\t")
            tint = int(f[4])
            if tint not in tints:
                continue
            rid = int(f[0])
            pid = int(f[5])
            iid = "garbage" if f[7] == "*" else f[7]
            part = tints[tint]["partitions"].setdefault(
                pid, dict(id=pid, tids=set(), isoforms={})
            )
            iso = part["isoforms"].setdefault(iid, dict(id=iid, reads=[]))
            data = rid_to_data[rid]
            M = len(data)
            exon_cols = f[9 : 9 + M]
            gaps = [
                int(x[:-1].split("(")[1]) if "(" in x else 0 for x in exon_cols
            ]
            tid = truth_tid(f[1])
            part["tids"].add(tid)
            iso["reads"].append(
                dict(
                    rid=rid,
                    name=f[1],
                    tid=tid,
                    strand=f[3],
                    tail_cat=f[6],
                    data=data,
                    gaps=gaps,
                    tail=_parse_tail(f[9 + M :]),
                    intervals=data_to_intervals(tints[tint]["segs"], data),
                )
            )
    # consensus interval track per isoform
    for tint in tints.values():
        for part in tint["partitions"].values():
            for iso in part["isoforms"].values():
                M = len(tint["segs"])
                votes = [0] * M
                for read in iso["reads"]:
                    for j in range(M):
                        votes[j] += read["data"][j] == "1"
                cons = "".join(
                    "1" if v / len(iso["reads"]) > 0.3 else "0" for v in votes
                )
                iso["cons_intervals"] = data_to_intervals(tint["segs"], cons)
    return tints


def _plot_segments(tint: dict, plot_tids: list, transcripts: dict):
    """Annotation-boundary-derived plotting segments + column widths
    (py/freddie_plot.py:442-455), computed without mutating the tint."""
    bounds = {tint["segs"][0][0], tint["segs"][-1][1]}
    for tid in plot_tids:
        for s, e in transcripts[tid]["intervals"]:
            bounds.add(s)
            bounds.add(e)
    bounds = sorted(bounds)
    segs = [(s, e) for s, e in zip(bounds[:-1], bounds[1:])]
    grid_lens = [_grid_len(e - s) for s, e in segs]
    return segs, grid_lens


def _seg_spans(intervals, segs):
    """Map genomic intervals onto per-segment (column, x0, x1) spans
    (py/freddie_plot.py:196-214)."""
    out = []
    for s, e in intervals:
        for idx, (seg_s, seg_e) in enumerate(segs):
            if not (s <= seg_e and e >= seg_s):
                continue
            seg_l = max(seg_e - seg_s, 1)
            x0 = (s - seg_s) / seg_l if seg_s < s else 0.0
            x1 = 1.0 if seg_e < e else (e - seg_s) / seg_l
            out.append((idx, x0, x1))
    return out


def plot_tint(tint: dict, transcripts: dict, out_dir: str, name_filter=None) -> list[str]:
    """One PDF per partition, one page per isoform; returns written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib import patches

    os.makedirs(out_dir, exist_ok=True)
    tint_s, tint_e = tint["segs"][0][0], tint["segs"][-1][1]
    overlapping = [
        tid
        for tid, tr in transcripts.items()
        if tr["chrom"] == tint["chrom"]
        and tr["intervals"][0][0] <= tint_e
        and tint_s <= tr["intervals"][-1][1]
        and (name_filter is None or tr["name"] in name_filter)
    ]
    overlapping.sort(key=lambda tid: transcripts[tid]["name"])
    written = []
    for pid, part in sorted(tint["partitions"].items()):
        # Color only truth tids observed in this partition (others gray),
        # like the reference's tid_colors (py/freddie_plot.py:457-464).
        tid_colors = {}
        color_idx = 0
        for tid in overlapping:
            if tid in part["tids"] or None in part["tids"]:
                tid_colors[tid] = COLORS[color_idx % len(COLORS)]
                color_idx += 1
            else:
                tid_colors[tid] = "gray"
        segs, grid_lens = _plot_segments(tint, overlapping, transcripts)
        path = os.path.join(out_dir, f"{pid}.pdf")
        with PdfPages(path) as pdf:
            for iid, iso in sorted(part["isoforms"].items(), key=lambda kv: str(kv[0])):
                n_reads = max(len(iso["reads"]), 1)
                s_ratios = [3, 4, 3]
                e_ratios = [3, 4, 3]
                fig = plt.figure(
                    figsize=(min(60, 6 + len(grid_lens) * 0.6 + 4), 16),
                    constrained_layout=False,
                )
                out_gs = fig.add_gridspec(
                    ncols=3, nrows=1,
                    width_ratios=[sum(s_ratios), max(sum(grid_lens), 1), sum(e_ratios)],
                    wspace=0.05,
                )
                gs_s = out_gs[0].subgridspec(
                    ncols=3, nrows=2, height_ratios=[1, 5],
                    width_ratios=s_ratios, hspace=0.1, wspace=0.1,
                )
                s_axes = [fig.add_subplot(gs_s[1, i]) for i in range(3)]
                gs_e = out_gs[2].subgridspec(
                    ncols=3, nrows=2, height_ratios=[1, 5],
                    width_ratios=e_ratios, hspace=0.1, wspace=0.1,
                )
                e_axes = [fig.add_subplot(gs_e[1, i]) for i in range(3)]
                gs_m = out_gs[1].subgridspec(
                    ncols=max(len(grid_lens), 1), nrows=2,
                    height_ratios=[1, 5], width_ratios=grid_lens or [1],
                    hspace=0.1, wspace=0,
                )
                t_axes = [fig.add_subplot(gs_m[0, i]) for i in range(max(len(grid_lens), 1))]
                r_axes = [fig.add_subplot(gs_m[1, i]) for i in range(max(len(grid_lens), 1))]
                t_axes[len(t_axes) // 2].set_title(
                    f"tint {tint['id']}, partition {pid}, isoform {iid} "
                    f"(n={len(iso['reads'])})"
                )

                # Tail side panels (py/freddie_plot.py:85-167): log-scale
                # soft-clip/gap panels facing outward, linear polyA panels.
                sm = 2000
                for ax in (s_axes[0], s_axes[2]):
                    ax.set_xticks([50, 100, 500, 1000, 2000])
                    ax.set_ylim(0, n_reads)
                    ax.set_yticks([])
                    ax.set_xscale("log")
                    ax.set_xlim(sm, 1)
                s_axes[0].set_title("Extra SC", loc="left", y=-0.025)
                s_axes[2].set_title("Gap", loc="right", y=-0.025)
                s_axes[1].set_title("Start polyA/T")
                s_axes[1].xaxis.tick_top()
                s_axes[1].set_ylim(0, n_reads)
                s_axes[1].set_yticks([])
                s_axes[1].set_xlim(150, 0)
                for ax in (e_axes[0], e_axes[2]):
                    ax.set_xticks([50, 100, 500, 1000, 2000])
                    ax.set_ylim(0, n_reads)
                    ax.set_yticks([])
                    ax.set_xscale("log")
                    ax.set_xlim(1, sm)
                e_axes[0].set_title("Gap", loc="left", y=-0.025)
                e_axes[2].set_title("Extra SC", loc="right", y=-0.025)
                e_axes[1].set_title("End polyA/T")
                e_axes[1].xaxis.tick_top()
                e_axes[1].set_ylim(0, n_reads)
                e_axes[1].set_yticks([])
                e_axes[1].set_xlim(0, 150)

                # Per-segment axis frames (py/freddie_plot.py:168-189).
                first_pos = segs[0][0] if segs else tint_s
                for axes, ylim in ((t_axes, len(overlapping) + 1), (r_axes, n_reads)):
                    for col, ax in enumerate(axes):
                        s, e = segs[col] if segs else (tint_s, tint_e)
                        ax.grid(zorder=0)
                        ax.set_ylim(0, ylim)
                        ax.set_xlim(0, 1)
                        ax.set_xticks([0])
                        ax.set_xticklabels([s - first_pos], rotation=45, fontsize=6)
                        if col == 0:
                            ax.set_xticklabels([first_pos], rotation=45, fontsize=6)
                        elif col == len(axes) - 1:
                            ax.yaxis.tick_right()
                            ax.set_xticks([0, 1])
                            ax.set_xticklabels([s, e], rotation=45, fontsize=6)
                        else:
                            ax.set_yticklabels([])
                names = [transcripts[t]["name"] for t in overlapping] + ["Consensus"]
                t_axes[0].set_yticks([p + 0.5 for p in range(len(names))])
                t_axes[0].set_yticklabels(names, fontsize=6)

                # Annotation transcripts + exon numbers + consensus.
                for p, tid in enumerate(overlapping):
                    tr = transcripts[tid]
                    for enum, (s, e) in zip(tr["enum"], tr["intervals"]):
                        cols = _seg_spans([(s, e)], segs)
                        for idx, x0, x1 in cols:
                            t_axes[idx].add_patch(patches.Rectangle(
                                (x0, p), x1 - x0, 1, color=tid_colors[tid]))
                        if cols:
                            mid = cols[len(cols) // 2][0]
                            t_axes[mid].text(
                                0.5, p + 0.5, enum, ha="center", va="center",
                                fontsize=6,
                            )
                for idx, x0, x1 in _seg_spans(iso["cons_intervals"], segs):
                    t_axes[idx].add_patch(patches.Rectangle(
                        (x0, len(overlapping)), x1 - x0, 1, color="black"))

                # Reads: sorted by (truth tid, data), colored by truth tid
                # (py/freddie_plot.py:191-214); gaps as red/black text; tail
                # panels from the cluster TSV tokens.
                for p, read in enumerate(
                    sorted(iso["reads"], key=lambda r: (r["tid"] or "", r["data"]))
                ):
                    color = tid_colors.get(read["tid"], "gray")
                    for idx, x0, x1 in _seg_spans(read["intervals"], segs):
                        r_axes[idx].add_patch(patches.Rectangle(
                            (x0, p), x1 - x0, 1, color=color))
                    for j, gap in enumerate(read["gaps"]):
                        if gap <= 0:
                            continue
                        gpos = tint["segs"][j][1]
                        for idx, (seg_s, seg_e) in enumerate(segs):
                            if seg_s <= gpos <= seg_e:
                                r_axes[idx].text(
                                    0.9, p + 0.5, str(gap), size="xx-small",
                                    ha="right",
                                    color="red" if gap > 99 else "black",
                                )
                                break
                    tail = read["tail"]
                    if tail["ssc"]:
                        s_axes[0].barh(p + 0.5, tail["ssc"], height=0.9, color=color)
                    if tail["s_len"]:
                        s_axes[1].barh(p + 0.5, tail["s_len"], height=0.9, color=color)
                        s_axes[2].barh(p + 0.5, max(tail["s_gap"], 1), height=0.9, color=color)
                    if tail["esc"]:
                        e_axes[2].barh(p + 0.5, tail["esc"], height=0.9, color=color)
                    if tail["e_len"]:
                        e_axes[1].barh(p + 0.5, tail["e_len"], height=0.9, color=color)
                        e_axes[0].barh(p + 0.5, max(tail["e_gap"], 1), height=0.9, color=color)

                pdf.savefig(fig, bbox_inches="tight")
                plt.close(fig)
        written.append(path)
    return written


def _plot_one(args) -> int:
    """Pool worker: render one tint's PDFs (top-level for spawn pickling)."""
    tint, transcripts, tint_dir, name_filter = args
    return len(plot_tint(tint, transcripts, tint_dir, name_filter))


def run_plot(
    annotation_gtf: str,
    segment_tsv: str,
    cluster_tsv: str,
    out_dir: str,
    tint_ids=frozenset(),
    name_filter=None,
    threads: int = 1,
) -> int:
    """Render every tint's per-isoform PDFs; returns the PDF count.

    With threads > 1, tints fan out over a spawn process pool (the
    reference parallelizes per tint the same way,
    py/freddie_plot.py:60-64,472-487): matplotlib rendering is CPU-bound
    Python, so threads would serialize on the GIL. Each tint writes into
    its own directory, so the schedules are output-identical; a broken
    pool degrades to the serial path (idempotent per-tint outputs)."""
    transcripts = parse_annotation_gtf(annotation_gtf)
    tints = load_tints(cluster_tsv, segment_tsv, tint_ids=set(tint_ids))
    os.makedirs(out_dir, exist_ok=True)
    jobs = [
        (tint, transcripts, os.path.join(out_dir, str(tint["id"])), name_filter)
        for tint in tints.values()
    ]
    if threads > 1 and len(jobs) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        from concurrent.futures.process import BrokenProcessPool

        from ..utils.procenv import cpu_worker_env

        # Biggest tints first: render wall time tracks read count, and a
        # large tint scheduled last would own the stage's tail.
        jobs.sort(key=lambda j: -len(j[0]["reads"]))
        try:
            with cpu_worker_env(), ProcessPoolExecutor(
                max_workers=threads,
                mp_context=multiprocessing.get_context("spawn"),
            ) as ex:
                return sum(ex.map(_plot_one, jobs))
        except BrokenProcessPool:
            pass
    return sum(_plot_one(job) for job in jobs)
