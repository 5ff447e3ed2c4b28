"""Crash-safe filesystem helpers for stage outputs.

The stage boundary IS the checkpoint (SURVEY.md §5): later stages and the
pipeline's resume logic treat an existing output as complete. That is only
sound if outputs appear ATOMICALLY -- a process killed mid-write must not
leave a truncated TSV that resume then trusts. Two mechanisms:

- atomic_write(path): write to `<path>.tmp` and os.replace() into place on
  clean close (POSIX rename atomicity); a crash leaves only the .tmp,
  which no reader globs (readers match `split_*`/`segment_*`/... names).
- stage completion markers: a `.freddie_complete` file written after a
  whole stage finishes; the pipeline's resume skips a stage only when the
  marker confirms it actually completed (a crashed run's partial
  directory is re-run instead of silently trusted).
"""

from __future__ import annotations

import contextlib
import os

MARKER = ".freddie_complete"


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w"):
    """Open `<path>.tmp` for writing and atomically rename into place on
    clean exit; the temp file is removed on error."""
    tmp = path + ".tmp"
    f = open(tmp, mode)
    try:
        yield f
    except BaseException:
        f.close()
        try:
            os.remove(tmp)
        finally:
            raise
    else:
        f.close()
        os.replace(tmp, path)


def mark_complete(out_path: str) -> None:
    """Record that a stage finished writing `out_path` (directory outputs
    get a marker file inside; file outputs are atomic already)."""
    if os.path.isdir(out_path):
        with open(os.path.join(out_path, MARKER), "w") as f:
            f.write("ok\n")


def is_complete(out_path: str) -> bool:
    """True when `out_path` exists AND was completely written: directory
    outputs need the marker, file outputs are atomic by construction."""
    if os.path.isdir(out_path):
        return os.path.exists(os.path.join(out_path, MARKER))
    return os.path.exists(out_path)


def protect_outputs(out_path: str) -> None:
    """Make a completed stage's outputs read-only -- the reference
    Snakefile's protected() analog (Snakefile:35-36,112). Directories
    keep their execute/list bits; the completion marker stays writable
    so resume logic can always manage it."""
    import stat

    def ro(p):
        os.chmod(p, os.stat(p).st_mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))

    if os.path.isdir(out_path):
        for root, _dirs, fns in os.walk(out_path):
            for fn in fns:
                if fn != MARKER:
                    ro(os.path.join(root, fn))
    else:
        ro(out_path)


def set_writable(out_path: str) -> None:
    """Undo protect_outputs before a forced re-run removes the outputs."""
    import stat

    def rw(p):
        os.chmod(p, os.stat(p).st_mode | stat.S_IWUSR)

    if os.path.isdir(out_path):
        for root, _dirs, fns in os.walk(out_path):
            for fn in fns:
                rw(os.path.join(root, fn))
    elif os.path.exists(out_path):
        rw(out_path)
