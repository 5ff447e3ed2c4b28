"""Per-read soft-clip / polyA-tail / unaligned-gap annotation.

Semantics match the reference (py/freddie_segment.py:289-472):

- Map segment boundaries back to query coordinates by walking the CIGAR
  (forward_thread_cigar) with negative "slack" when the alignment interval
  does not reach the boundary.
- In the query soft-clip regions (before the first covered segment / after
  the last), find the best-scoring polyA/polyT run (Kadane-style max run,
  match +1 / mismatch -2), keeping runs of length >= 20 and purity >= 0.85,
  best by purity; sequences of '-'-strand reads are scanned reverse-
  complemented because the raw FASTQ sequence is in read orientation.
- Between consecutive covered segment-runs, record the unaligned query gap.

Tokens emitted (sorted): 'SSC:x', 'ESC:x', 'S<A|T>_<len>:<gap>',
'E<A|T>_<len>:<gap>', and '<j1>-<j2>:<gapsize>'.
"""

from __future__ import annotations

from itertools import groupby

from ..io.bam import CDEL, CDIFF, CEQUAL, CINS, CMATCH

_REV_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}

_ctok_mod = None
_ctok_failed = False


def _load_ctok():
    """Build/load the C clip-context/token extension (native/polyatok.c)
    on first use; None without a toolchain (callers fall back to the
    Python twins transparently -- results are identical,
    tests/test_polyatok.py)."""
    global _ctok_mod, _ctok_failed
    if _ctok_mod is not None or _ctok_failed:
        return _ctok_mod
    try:
        import sysconfig

        from ._build import import_extension, load_native

        inc = sysconfig.get_paths()["include"]
        _ctok_mod = load_native("polyatok", "polyatok.so", ["polyatok.c"],
                                ["gcc", "-O2", "-shared", "-fPIC", f"-I{inc}"],
                                import_extension)
    except Exception:
        _ctok_failed = True
        _ctok_mod = None
    return _ctok_mod


def walk_cigar_to(cigar: list[tuple[int, int]], t_goal: int, t_pos: int, q_pos: int) -> int:
    """Query position aligned at target position t_goal (>= t_pos)."""
    assert t_pos <= t_goal
    i = 0
    while t_pos < t_goal:
        t, c = cigar[i]
        c = min(c, t_goal - t_pos)
        if t in (CMATCH, CEQUAL, CDIFF):
            t_pos += c
            q_pos += c
        elif t == CDEL:
            t_pos += c
        elif t == CINS:
            q_pos += c
        i += 1
    assert t_pos == t_goal
    return q_pos


def query_pos_at_start(start: int, intervals) -> tuple[int, int]:
    """First query position aligned at/after target `start`, with slack <= 0
    when the covering interval begins after `start`."""
    for t_start, t_end, q_start, q_end, cigar in intervals:
        if t_end < start:
            continue
        if start < t_start:
            q_pos, slack = q_start, start - t_start
        else:
            q_pos, slack = walk_cigar_to(cigar, start, t_start, q_start), 0
        assert slack <= 0
        assert q_start <= q_pos <= q_end
        return q_pos, slack
    raise AssertionError("no interval reaches start")


def query_pos_at_end(end: int, intervals) -> tuple[int, int]:
    """Last query position aligned at/before target `end`."""
    for t_start, t_end, q_start, q_end, cigar in reversed(list(intervals)):
        if t_start > end:
            continue
        if t_end < end:
            q_pos, slack = q_end, t_end - end
        else:
            q_pos, slack = walk_cigar_to(cigar, end, t_start, q_start), 0
        assert slack <= 0
        assert 0 <= q_pos <= q_end
        return q_pos, slack
    raise AssertionError("no interval reaches end")


def longest_poly_runs(seq: str, s: int, e: int, step: int, char: str,
                      match: int = 1, mismatch: int = -2):
    """Max-scoring runs of `char` in seq[s:e:step] (Kadane over runs).

    Yields (run_start_offset, run_length, purity) per positive-score run,
    where run_length extends to the run's best-scoring position (ties:
    latest position, matching the reference's max(zip(S, i)))."""
    if e - s == 0:
        return
    window = seq[s:e:step]
    scores = [match if window[0] == char else 0]
    for c in window[1:]:
        scores.append(max(0, scores[-1] + (match if c == char else mismatch)))
    for positive, grp in groupby(enumerate(scores), lambda t: t[1] > 0):
        if not positive:
            continue
        grp = list(grp)
        first = grp[0][0]
        best_i = max(grp, key=lambda t: (t[1], t[0]))[0]
        length = best_i + 1 - first
        run = window[first : first + length]
        yield first, length, run.count(char) / length


def poly_window(seq: str, lo: int, hi: int, strand: str, char: str) -> tuple[str, str]:
    """The (window string, scan char) a polyA scorer scans for `char` in
    query window [lo, hi): on '-' strand the raw sequence is read-oriented,
    so the alignment-orientation window is the mirrored slice reversed and
    the char complemented. Offsets into the window string are in alignment
    orientation for both strands (the batch scorer shares this contract)."""
    if strand == "-":
        L = len(seq)
        return seq[L - hi : L - lo][::-1], _REV_COMP[char]
    return seq[lo:hi], char


def _best_poly(seq: str, lo: int, hi: int, strand: str,
               min_len: int = 20, min_purity: float = 0.85):
    """Best polyA/polyT candidate in query window [lo, hi) (read-orientation
    adjusted); returns (offset, length, purity, char) or None. `offset` is
    measured from the window start in alignment orientation.

    Dispatches to the C Kadane scorer (native/polyatok.c best_run) at the
    default thresholds; the Python twin below is the semantic oracle and
    transparent fallback (tests/test_polyatok.py fuzzes them equal)."""
    mod = _load_ctok() if (min_len, min_purity) == (20, 0.85) else None
    if mod is not None and hasattr(mod, "best_run"):
        try:
            minus = 1 if strand == "-" else 0
            best = None
            best_p = -1.0
            for char in ("A", "T"):
                r = mod.best_run(seq, lo, hi, minus, char)
                if r is None:
                    continue
                first, length, cnt = r
                p = cnt / length
                if p > best_p:  # strict: A wins ties, like max() below
                    best_p = p
                    best = (first, length, p, char)
            return best
        except Exception:
            pass
    return _best_poly_py(seq, lo, hi, strand, min_len, min_purity)


def _best_poly_py(seq: str, lo: int, hi: int, strand: str,
                  min_len: int = 20, min_purity: float = 0.85):
    """Pure-Python twin of _best_poly (the semantic oracle)."""
    cands = []
    for char in ("A", "T"):
        if strand == "-":
            s, e, step, sc_char = -lo - 1, -hi - 1, -1, _REV_COMP[char]
        else:
            s, e, step, sc_char = lo, hi, 1, char
        for i, l, p in longest_poly_runs(seq, s, e, step, sc_char):
            if l < min_len or p < min_purity:
                continue
            cands.append((i, l, p, char))
    if not cands:
        return None
    return max(cands, key=lambda t: t[2])  # best purity; first wins ties


def clip_context(data: list[int], segs: list[tuple[int, int]], intervals, seq: str):
    """Covered-run structure of one read: (q_ssc, q_esc, runs) where runs
    are the maximal runs of 1s in `data` and q_ssc/q_esc are the query
    positions of the first/last covered base -- or None when the read
    covers no segment (its token set is empty). Dispatches to the C
    twin when built; falls back to the Python path on any C exception
    (so acceptance never depends on the toolchain)."""
    mod = _load_ctok()
    if mod is not None:
        try:
            return mod.clip_context(data, segs, intervals, len(seq))
        except Exception:
            pass
    return _clip_context_py(data, segs, intervals, seq)


def _clip_context_py(data: list[int], segs: list[tuple[int, int]], intervals, seq: str):
    """Pure-Python twin of clip_context (the semantic oracle)."""
    if 1 not in data:
        return None
    runs = []
    run_start = -1
    for i, d in enumerate(data):
        if d == 1:
            if run_start < 0:
                run_start = i
        elif run_start >= 0:
            runs.append((run_start, i - 1))
            run_start = -1
    if run_start >= 0:
        runs.append((run_start, len(data) - 1))
    assert runs, data
    read_len = len(seq)
    start = segs[runs[0][0]][0]
    q_ssc, _ = query_pos_at_start(start, intervals)
    end = segs[runs[-1][1]][1]
    q_esc, _ = query_pos_at_end(end, intervals)
    assert 0 <= q_ssc <= q_esc <= read_len
    return q_ssc, q_esc, runs


def emit_tokens(
    q_ssc: int,
    q_esc: int,
    runs: list[tuple[int, int]],
    best_s,
    best_e,
    segs: list[tuple[int, int]],
    intervals,
    read_len: int,
) -> list[str]:
    """Token set from a clip context plus the two resolved polyA candidates
    (each (offset, length, char) or None). Shared by the host path and the
    batched device path so the wire format has a single definition.
    Dispatches to the C twin when built (every token is unique by
    construction -- distinct prefixes per category, ascending gap keys --
    so the C list sort equals the Python sorted-set)."""
    mod = _load_ctok()
    if mod is not None:
        try:
            return mod.emit_tokens(
                q_ssc, q_esc, runs, best_s, best_e, segs, intervals, read_len
            )
        except Exception:
            pass
    return _emit_tokens_py(
        q_ssc, q_esc, runs, best_s, best_e, segs, intervals, read_len
    )


def _emit_tokens_py(
    q_ssc: int,
    q_esc: int,
    runs: list[tuple[int, int]],
    best_s,
    best_e,
    segs: list[tuple[int, int]],
    intervals,
    read_len: int,
) -> list[str]:
    """Pure-Python twin of emit_tokens (the semantic oracle)."""
    gaps: set[str] = set()
    if best_s is not None:
        i, l, char = best_s
        gap = q_ssc - i - l
        assert 0 <= gap < q_ssc
        gaps.add(f"S{char}_{l}:{gap}")
        gaps.add(f"SSC:{i}")
    else:
        gaps.add(f"SSC:{q_ssc}")

    if best_e is not None:
        i, l, char = best_e
        gap = i
        assert 0 <= gap < read_len - q_esc
        gaps.add(f"E{char}_{l}:{gap}")
        gaps.add(f"ESC:{read_len - q_esc - gap}")
        assert read_len - q_esc - gap > 0
    else:
        gaps.add(f"ESC:{read_len - q_esc}")

    for (r1_f, r1_l), (r2_f, r2_l) in zip(runs[:-1], runs[1:]):
        g_start, s_slack = query_pos_at_end(segs[r1_l][1], intervals)
        g_end, e_slack = query_pos_at_start(segs[r2_f][0], intervals)
        assert 0 < g_start <= g_end < read_len, (g_start, g_end, read_len)
        size = max(0, g_end - g_start + s_slack + e_slack)
        assert 0 <= size < read_len
        assert r1_l < r2_f
        gaps.add(f"{r1_l}-{r2_f}:{size}")
    return sorted(gaps)


def annotate_gaps_and_polya(
    data: list[int],
    segs: list[tuple[int, int]],
    intervals,
    seq: str,
    strand: str,
) -> list[str]:
    """Gap/polyA token set for one read (sorted), given its 0/1/2 segment
    data, the tint's segments, its alignment intervals, and its raw
    sequence."""
    ctx = clip_context(data, segs, intervals, seq)
    if ctx is None:
        return []
    q_ssc, q_esc, runs = ctx
    read_len = len(seq)

    def strip(best):
        return None if best is None else (best[0], best[1], best[3])

    best_s = strip(_best_poly(seq, 0, q_ssc, strand))
    best_e = strip(_best_poly(seq, q_esc, read_len, strand))
    return emit_tokens(q_ssc, q_esc, runs, best_s, best_e, segs, intervals, read_len)
