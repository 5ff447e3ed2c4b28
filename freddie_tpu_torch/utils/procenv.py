"""Environment scoping for spawned CPU-only worker pools.

The cluster, isoforms and plot stages fan per-tint work over spawn process
pools. Workers are CPU-only by design: only the parent process holds a
CUDA context, and the jobs it hands them name the CPU as their device.

``cpu_worker_env`` scopes the parent's environment so that children see
no card at all (``CUDA_VISIBLE_DEVICES`` empty): a worker that reached
for one would raise instead of opening a context per worker on a card
the parent is using. The parent's value is restored on exit.
"""

from __future__ import annotations

import os
from contextlib import contextmanager


@contextmanager
def cpu_worker_env():
    """Scope os.environ so spawned children boot as plain CPU workers.

    Spawn reads the parent's environment at child launch, so this must
    wrap the pool's whole lifetime (workers launch lazily on submit).
    The parent must not initialise CUDA for the first time inside the
    scope (the stages only wait on their pool there); a context it
    already holds is unaffected.
    """
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
