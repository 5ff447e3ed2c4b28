"""Profiling for the port: ``profile_trace`` on ``torch.profiler``.

Counterpart of ``freddie_tpu/utils/metrics.py:profile_trace`` (which wraps
``jax.profiler``). Stage metrics and solver logs are the JAX package's
own (``freddie_tpu.utils.metrics``), which import no JAX.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """torch.profiler trace around a region, written as a Chrome trace
    into ``trace_dir`` (no-op when trace_dir is None). Records CUDA
    activity when a GPU is present."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace.{os.getpid()}.json")
    )
