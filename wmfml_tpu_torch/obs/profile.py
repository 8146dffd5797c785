"""Profiling hooks: ``torch.profiler`` traces and simple step timing
(``wmfml_tpu/obs/profile.py``).

``profile_trace(log_dir)`` wraps a region in a ``torch.profiler`` trace of
the host and, where a card is present, the card (CUPTI), and writes it into
``log_dir`` as a Chrome trace (``trace.json``, viewable in Perfetto or
``chrome://tracing``); the JAX package writes a TensorBoard-viewable XLA
trace there. ``StepTimer`` is the same wall-clock timer, skipping the
first ``skip_first`` steps (builds, captures, compiles).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace the region into ``log_dir/trace.json``; yields the profiler
    (None when not ``enabled``), whose ``key_averages()`` the caller may
    read after the region."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


class StepTimer:
    """Wall-clock timer that skips warmup/compile steps."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self.count >= self.skip_first:
            self.total += dt
        self.count += 1
        return False

    @property
    def steps_timed(self):
        return max(self.count - self.skip_first, 0)

    @property
    def mean_step_s(self):
        return self.total / self.steps_timed if self.steps_timed else float("nan")
