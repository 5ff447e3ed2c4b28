"""What a run leaves behind: processes, and modules it may not load.

``end_descendants`` lists every process below this one (read from
``/proc/<pid>/task/*/children``, walked down), ends them, waits for them
and returns their command lines; multiprocessing's resource tracker is
stopped first through its own shutdown, since it ignores SIGTERM.
``foreign_modules`` names the modules of ``sys.modules`` whose top-level
name is JAX's or the JAX package's, compared whole (``freddie_tpu_torch``
is not ``freddie_tpu``).
"""

from __future__ import annotations

import glob
import os
import signal
import sys
import time

FOREIGN = frozenset({"jax", "jaxlib", "flax", "freddie_tpu"})


def children(pid: int) -> list[int]:
    out = []
    for path in glob.glob(f"/proc/{pid}/task/*/children"):
        try:
            with open(path) as f:
                out.extend(int(p) for p in f.read().split())
        except OSError:
            pass  # the task ended while we read
    return out


def descendants(pid: int | None = None) -> list[int]:
    seen, todo = [], children(os.getpid() if pid is None else pid)
    while todo:
        p = todo.pop()
        if p not in seen:
            seen.append(p)
            todo.extend(children(p))
    return seen


def cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip() or "?"
    except OSError:
        return "?"


def _alive(pid: int) -> bool:
    """True while ``pid`` runs; a child of ours that has exited is reaped."""
    try:
        done, _status = os.waitpid(pid, os.WNOHANG)
        if done == pid:
            return False
    except ChildProcessError:
        pass  # not our child: look at its state instead
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def stop_resource_tracker() -> int | None:
    """Shut multiprocessing's resource tracker down and wait for it, if
    this process started one (a spawn pool does); returns its pid."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    pid = getattr(tracker, "_pid", None)
    if pid is not None:
        tracker._stop()
    return pid


def end_descendants(grace_s: float = 10.0) -> list[str]:
    """End every process below this one; returns their command lines
    (empty when none was left)."""
    found = descendants()
    if not found:
        return []
    names = [f"pid {p}: {cmdline(p)}" for p in found]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in found:
            try:
                os.kill(p, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            found = [p for p in found if _alive(p)]
            if not found:
                return names
            time.sleep(0.05)
    return names


def foreign_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FOREIGN)
